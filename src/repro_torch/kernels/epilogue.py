"""The one bias/activation epilogue of the port's plain versions.

Counterpart of ``repro/kernels/epilogue.py``.  ``gelu`` is the tanh form
because ``jax.nn.gelu`` defaults to ``approximate=True``.  The f32 and
bf16 CUDA pattern-matmul kernels apply the same ``act(acc + bias)`` in
the same order (``pattern_matmul/csrc/epilogue.cuh``), bf16 rounding the
result once; ``ACT_CODES`` is the integer the kernels take for each
activation.  ``act_grad`` is the epilogue's derivative, as ``jax.grad``
takes it (the pattern matmul's gradient, ``pattern_matmul/ops.py``).
``resolve_out_dtype`` is the output-dtype rule of the f32 and bf16
layers.  ``scale_bias_act`` is the int8 matmul's epilogue,
applied outside its kernel in both paths.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

ACTS: Dict[Optional[str], Callable[[torch.Tensor], torch.Tensor]] = {
    None: lambda v: v,
    "relu": torch.relu,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "silu": F.silu,
}

# Activation selector passed to the CUDA kernel (``act`` argument).
ACT_CODES: Dict[Optional[str], int] = {None: 0, "relu": 1, "gelu": 2,
                                       "silu": 3}


def bias_act(acc: torch.Tensor, bias: Optional[torch.Tensor],
             act: Optional[str], out_dtype: torch.dtype) -> torch.Tensor:
    """``act(acc + bias)`` on the f32 accumulator, cast to ``out_dtype``.

    ``bias=None`` skips the add entirely.
    """
    y = acc if bias is None else acc + bias.to(torch.float32)
    return ACTS[act](y).to(out_dtype)


def act_grad(g: torch.Tensor, pre: torch.Tensor, act: str) -> torch.Tensor:
    """The cotangent ``g`` of ``act(pre)`` carried back to ``pre``, in f32
    on the f32 pre-activation ``acc + bias``: relu's derivative is 0 at
    0, as ``jax.nn.relu``'s; gelu's is the tanh form's."""
    if act == "relu":
        return torch.where(pre > 0, g, torch.zeros_like(g))
    if act == "gelu":
        return torch.ops.aten.gelu_backward(g, pre, approximate="tanh")
    if act == "silu":
        return torch.ops.aten.silu_backward(g, pre)
    raise ValueError(f"act_grad: unknown act {act!r}")


def resolve_out_dtype(fn: str, x: torch.Tensor,
                      out_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The output dtype of an f32 or bf16 layer: ``out_dtype``, x's dtype
    when None.  The kernels write x's dtype or f32 (a bf16 layer's f32
    accumulator unrounded), nothing else."""
    out = x.dtype if out_dtype is None else out_dtype
    if out not in (x.dtype, torch.float32):
        raise ValueError(f"{fn}: out_dtype must be x's dtype ({x.dtype}) or "
                         f"torch.float32, got {out}")
    return out


def scale_bias_act(acc: torch.Tensor, col_scale: torch.Tensor,
                   bias: Optional[torch.Tensor],
                   act: Optional[str]) -> torch.Tensor:
    """Int8 dequantization epilogue: ``act(acc * s + bias)``, f32 out.

    Applied once, after full accumulation, to the int8 matmul's raw
    integer accumulator (kernel or plain version alike).  The scale
    multiply and the bias add are two separate roundings, never one FMA,
    as in the reference.
    """
    y = acc * col_scale.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return ACTS[act](y).to(torch.float32)
