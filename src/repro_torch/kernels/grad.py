"""When a kernel wrapper takes its gradient path, and what that path
refuses.

The version-2 KAN kernel (f32, and bf16 with a bf16 output) and the f32
pattern-matmul kernel carry a ``torch.autograd.Function`` each
(``kan_fused/ops.py``, ``pattern_matmul/ops.py``): the forward is the
kernel, the gradient is written out in PyTorch ops, as XLA's autodiff
writes out the reference's (which has no backward kernel).  A wrapper
takes that path only when grad is enabled and an operand requires it,
so a forward under ``torch.no_grad`` or ``torch.inference_mode``
launches what it did before.  The int8 and version-1 kernels, the bf16
matmul and the matmul's gelu epilogue refuse a gradient.
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
        f"{fn}: no gradient {why}; the port trains through the version-2 "
        f"KAN kernel (f32, bf16) and the f32 pattern-matmul kernel only, "
        f"and a gradient through the other kernels is not ported "
        f"(ROADMAP.md, queue 2)")


def ieee_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in IEEE f32, as the reference's XLA products: refuses a
    CUDA product while TF32 is allowed (the gradient products here, the
    transformer models' plain products in ``models/layers.py``)."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "f32 products must run in IEEE f32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.matmul(a, b)
