from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.optim.compression import (
    CompressionState,
    compress_int8,
    compressed_allreduce,
    decompress_int8,
    init_compression,
)
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_schedule,
    linear_schedule,
)

__all__ = [
    "AdamWConfig", "OptState", "adamw_init", "adamw_update", "global_norm",
    "constant_schedule", "cosine_schedule", "linear_schedule",
    "CompressionState", "compress_int8", "decompress_int8",
    "compressed_allreduce", "init_compression",
]
