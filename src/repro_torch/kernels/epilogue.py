"""The one bias/activation epilogue of the port's plain versions.

Counterpart of ``repro/kernels/epilogue.py``.  ``gelu`` is the tanh form
because ``jax.nn.gelu`` defaults to ``approximate=True``.  The CUDA
pattern-matmul kernel applies the same ``act(acc + bias)`` in the same
order (``pattern_matmul/csrc/pattern_matmul.cu``); ``ACT_CODES`` is the
integer the kernel takes for each activation.  ``scale_bias_act`` is the
int8 matmul's epilogue, applied outside its kernel in both paths.
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
