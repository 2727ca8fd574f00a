"""When a kernel wrapper takes its gradient path, and what that path
refuses.

The version-2 KAN kernel (f32, and bf16 with a bf16 or an f32 output)
and the pattern-matmul kernel (f32, and bf16 with a bf16 or an f32
output, every epilogue) carry a ``torch.autograd.Function`` each
(``kan_fused/ops.py``, ``pattern_matmul/ops.py``): the forward is the
kernel, the gradient follows ``jax.grad`` of the reference's jnp path,
as XLA's autodiff writes it out (the reference has no backward kernel).
A wrapper takes that path only when grad is enabled and an operand
requires it, so a forward under ``torch.no_grad`` or
``torch.inference_mode`` launches what it did before.

Two kernels refuse a gradient, because no entry point of the reference
trains through them: the version-1 KAN kernel (its configs never pass
``kan_version``) and the int8 kernels (serving only: no float operand of
a training path reaches them).
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
        f"KAN kernel and the pattern-matmul kernel (f32, bf16), as the "
        f"reference does, and the version-1 and int8 kernels, which no "
        f"entry point of the reference trains, have no gradient "
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
