from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_schedule,
    linear_schedule,
)

__all__ = [
    "AdamWConfig", "OptState", "adamw_init", "adamw_update", "global_norm",
    "constant_schedule", "cosine_schedule", "linear_schedule",
]
