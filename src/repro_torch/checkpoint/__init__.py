from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    CheckpointMismatchError,
    all_steps,
    latest_step,
    restore_checkpoint,
    restore_masks,
    restore_scales,
    save_checkpoint,
)

__all__ = ["AsyncCheckpointer", "CheckpointMismatchError", "all_steps",
           "latest_step", "restore_checkpoint", "restore_masks",
           "restore_scales", "save_checkpoint"]
