from repro_torch.checkpoint.checkpoint import (
    CheckpointMismatchError,
    all_steps,
    latest_step,
    restore_checkpoint,
    restore_masks,
    restore_scales,
)

__all__ = ["CheckpointMismatchError", "all_steps", "latest_step",
           "restore_checkpoint", "restore_masks", "restore_scales"]
