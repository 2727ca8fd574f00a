"""Public entry: pattern-sparse linear layer, dispatched on the device.

Counterpart of ``repro/kernels/pattern_matmul/ops.py``.  The static
m-of-4 compaction happens outside the kernels: ``pattern_linear`` gathers
the kept activation lanes and weight rows, then ``matmul_compact`` runs
the compact matmul with the fused ``act(acc + bias)`` epilogue -- the
plain version (``ref.matmul_compact_ref``) for a CPU tensor, the CUDA
kernel ``csrc/pattern_matmul.cu`` for a CUDA tensor.  The int8 path is
the same with ``matmul_q8`` (``ref.matmul_q8_ref`` or
``csrc/pattern_matmul_q8.cu``), whose raw integer accumulator
``pattern_linear_q8`` scales with the shared ``scale_bias_act``.  There is
no fallback from a kernel to its plain version.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.sparsity import PatternMask
from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import ACT_CODES, scale_bias_act
from repro_torch.kernels.pattern_matmul.ref import (
    matmul_compact_ref,
    matmul_q8_ref,
)

KERNEL = "pattern_matmul"
KERNEL_Q8 = "pattern_matmul_q8"


def _check_operands(fn: str, x_c: torch.Tensor, w_c: torch.Tensor,
                    operands: Sequence[Tuple[str, torch.Tensor]],
                    dtype: torch.dtype, what: str) -> Tuple[int, int, int]:
    """(M, K, N) of ``x_c @ w_c``; raises on a shape, device, dtype or
    layout the kernel does not take."""
    if x_c.dim() != 2 or w_c.dim() != 2 or x_c.shape[1] != w_c.shape[0]:
        raise ValueError(f"{fn}: shapes {tuple(x_c.shape)} @ "
                         f"{tuple(w_c.shape)} do not contract")
    for name, t in operands:
        if t.device != x_c.device:
            raise ValueError(f"{fn}: {name} on {t.device}, x on {x_c.device}")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype} "
                            f"({what})")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    M, K = x_c.shape
    N = w_c.shape[1]
    if M > 65535 * 64:
        raise ValueError(f"{fn}: {M} rows exceed the grid limit")
    return M, K, N


def matmul_compact(x_c: torch.Tensor, w_c: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   act: Optional[str] = None) -> torch.Tensor:
    """act(x_c @ w_c + bias) on (M, Kc) x_c and (Kc, N) w_c."""
    if x_c.device.type == "cpu":
        return matmul_compact_ref(x_c, w_c, bias, act)
    if x_c.device.type != "cuda":
        raise ValueError(f"matmul_compact: no kernel for device {x_c.device}")
    if act not in ACT_CODES:
        raise ValueError(f"matmul_compact: unknown act {act!r}")
    operands = [("x_c", x_c), ("w_c", w_c)]
    if bias is not None:
        if bias.shape != (w_c.shape[-1],):
            raise ValueError(f"matmul_compact: bias has shape "
                             f"{tuple(bias.shape)}, expected "
                             f"({w_c.shape[-1]},)")
        operands.append(("bias", bias))
    M, K, N = _check_operands("matmul_compact", x_c, w_c, operands,
                              torch.float32, "this kernel is f32 only")
    y = torch.empty((M, N), dtype=torch.float32, device=x_c.device)
    if M == 0 or N == 0:
        return y
    _build.launch(
        KERNEL, x_c.data_ptr(), w_c.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), M, K, N,
        ACT_CODES[act], torch.cuda.current_stream(x_c.device).cuda_stream)
    return y


def matmul_q8(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The raw accumulator ``x_q @ w_q`` as f32 on (M, Kc) and (Kc, N)
    int8 codes: exact integers while Kc * 127^2 < 2^24."""
    if x_q.device.type == "cpu":
        return matmul_q8_ref(x_q, w_q)
    if x_q.device.type != "cuda":
        raise ValueError(f"matmul_q8: no kernel for device {x_q.device}")
    M, K, N = _check_operands("matmul_q8", x_q, w_q,
                              [("x_q", x_q), ("w_q", w_q)], torch.int8,
                              "this kernel takes int8 codes")
    y = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    if M == 0 or N == 0:
        return y
    _build.launch(KERNEL_Q8, x_q.data_ptr(), w_q.data_ptr(), y.data_ptr(),
                  M, K, N, torch.cuda.current_stream(x_q.device).cuda_stream)
    return y


def pattern_linear(x: torch.Tensor, w: torch.Tensor,
                   mask: Optional[PatternMask] = None,
                   bias: Optional[torch.Tensor] = None, *,
                   act: Optional[str] = None) -> torch.Tensor:
    """y = act(x[..., keep] @ w[keep, :] + bias); x: (..., K), w: (K, N).

    Functional form of the JAX ``pattern_linear``: compacts the weight on
    every call.  ``models/ffn.PatternLinear`` compacts it once instead.
    """
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    if mask is not None:
        idx = torch.as_tensor(mask.indices(), dtype=torch.long,
                              device=x.device)
        xf = xf.index_select(1, idx)
        w = w.index_select(0, idx.to(w.device))
    y = matmul_compact(xf.contiguous(), w.contiguous(), bias, act=act)
    return y.reshape(*lead, w.shape[-1])


def pattern_linear_q8(x_q: torch.Tensor, w_q: torch.Tensor,
                      col_scale: torch.Tensor,
                      mask: Optional[PatternMask] = None,
                      bias: Optional[torch.Tensor] = None, *,
                      act: Optional[str] = None) -> torch.Tensor:
    """Int8 pattern-sparse linear: act(dq(x_q) @ dq(w_q) + bias), f32 out.

    x_q: (..., K) int8; w_q: (K, N) int8; col_scale: (N,) f32 = s_x * s_w
    per output channel.  Both operands stay int8 through the lane gather;
    the exact integer accumulator is then scaled by the shared epilogue,
    once, after full accumulation -- as in the reference.  Functional
    form: ``core/quant.QuantVikinStack`` compacts the weight once instead.
    """
    lead = x_q.shape[:-1]
    xf = x_q.reshape(-1, x_q.shape[-1])
    if mask is not None:
        idx = torch.as_tensor(mask.indices(), dtype=torch.long,
                              device=x_q.device)
        xf = xf.index_select(1, idx)
        w_q = w_q.index_select(0, idx.to(w_q.device))
    acc = matmul_q8(xf.contiguous(), w_q.contiguous())
    y = scale_bias_act(acc, col_scale, bias, act)
    return y.reshape(*lead, w_q.shape[-1])
