"""Plain PyTorch versions of the pattern-sparse linear layer.

``matmul_compact_ref`` is the function the CUDA kernel computes: a matmul
over the pre-compacted contraction dimension with the shared
``bias_act`` epilogue.  The wrapper runs it for a CPU tensor, and the
kernel is held against it on the card.  ``pattern_matmul_ref`` is the
dense masked oracle (counterpart of ``repro/kernels/pattern_matmul/ref.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sparsity import PatternMask, apply_mask
from repro_torch.kernels.epilogue import bias_act


def matmul_compact_ref(x_c: torch.Tensor, w_c: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       act: Optional[str] = None) -> torch.Tensor:
    """act(x_c @ w_c + bias) on (M, Kc) x_c and (Kc, N) w_c."""
    acc = torch.matmul(x_c.to(torch.float32), w_c.to(torch.float32))
    return bias_act(acc, bias, act, x_c.dtype)


def pattern_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       mask: Optional[PatternMask] = None,
                       bias: Optional[torch.Tensor] = None,
                       act: Optional[str] = None) -> torch.Tensor:
    """y = act((x * mask) @ w + bias) computed densely (no compaction)."""
    xm = apply_mask(x, mask) if mask is not None else x
    acc = torch.matmul(xm.to(torch.float32), w.to(torch.float32))
    return bias_act(acc, bias, act, x.dtype)
