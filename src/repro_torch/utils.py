"""Small shared utilities (counterpart of ``repro/utils.py``)."""
from __future__ import annotations

import torch


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n``, with a floor of 1."""
    return 1 << max(0, int(n) - 1).bit_length()


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device an entry point runs on.

    A CUDA device is refused when CUDA is missing: entry points never
    carry on on the CPU unless the caller asked for ``"cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch path")
    return dev
