"""Plain PyTorch versions of the pattern-sparse linear layer.

``matmul_compact_ref`` is the function the f32 CUDA kernel computes: a
matmul over the pre-compacted contraction dimension with the shared
``bias_act`` epilogue.  ``matmul_q8_ref`` is the function the int8 kernel
computes: the raw accumulator of int8 codes, exact integers held in f32.
The wrappers run them for a CPU tensor, and the kernels are held against
them on the card.  ``pattern_matmul_ref`` is the dense masked oracle
(counterpart of ``repro/kernels/pattern_matmul/ref.py``).
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


def matmul_q8_ref(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """sum_k x_q[m, k] * w_q[k, n] as f32, on (M, Kc) and (Kc, N) int8.

    The codes are widened to f32 and multiplied in f32, as the reference's
    jnp path does.  Every product is at most 127^2 and every partial sum
    stays below 2^24 while Kc * 127^2 < 2^24, so the result is the exact
    integer whatever order the matmul sums in.
    """
    return torch.matmul(x_q.to(torch.float32), w_q.to(torch.float32))


def pattern_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       mask: Optional[PatternMask] = None,
                       bias: Optional[torch.Tensor] = None,
                       act: Optional[str] = None) -> torch.Tensor:
    """y = act((x * mask) @ w + bias) computed densely (no compaction)."""
    xm = apply_mask(x, mask) if mask is not None else x
    acc = torch.matmul(xm.to(torch.float32), w.to(torch.float32))
    return bias_act(acc, bias, act, x.dtype)
