"""When a kernel wrapper takes its gradient path, and what that path
refuses.

The f32 version-2 KAN kernel and the f32 pattern-matmul kernel carry a
``torch.autograd.Function`` each (``kan_fused/ops.py``,
``pattern_matmul/ops.py``): the forward is the kernel, the gradient is
written out in PyTorch ops, as XLA's autodiff writes out the reference's
(which has no backward kernel).  A wrapper takes that path only when
grad is enabled and an operand requires it, so a forward under
``torch.no_grad`` or ``torch.inference_mode`` launches what it did
before.  The reference trains in f32 only: the bf16, int8 and version-1
kernels refuse a gradient.
"""
from __future__ import annotations

from typing import Optional

import torch


def grad_wanted(*operands: Optional[torch.Tensor]) -> bool:
    """True when autograd records and an operand requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in operands)


def refuse_grad(fn: str, why: str) -> None:
    raise NotImplementedError(
        f"{fn}: no gradient {why}; the reference trains in f32 through the "
        f"version-2 KAN and pattern-matmul kernels only, and a gradient "
        f"through the other kernels is not ported (ROADMAP.md, queue 2)")


def ieee_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in IEEE f32, as the reference's XLA products: refuses a
    CUDA product while TF32 is allowed."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the gradient products must run in IEEE f32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.matmul(a, b)
