"""Public entry: pattern-sparse linear layer, dispatched on the device.

Counterpart of ``repro/kernels/pattern_matmul/ops.py``.  The static
m-of-4 compaction happens outside the kernel: ``pattern_linear`` gathers
the kept activation lanes and weight rows, then ``matmul_compact`` runs
the compact matmul with the fused ``act(acc + bias)`` epilogue -- the
plain version (``ref.matmul_compact_ref``) for a CPU tensor, the CUDA
kernel ``csrc/pattern_matmul.cu`` for a CUDA tensor.  There is no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sparsity import PatternMask
from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import ACT_CODES
from repro_torch.kernels.pattern_matmul.ref import matmul_compact_ref

KERNEL = "pattern_matmul"


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
    if x_c.dim() != 2 or w_c.dim() != 2 or x_c.shape[1] != w_c.shape[0]:
        raise ValueError(f"matmul_compact: shapes {tuple(x_c.shape)} @ "
                         f"{tuple(w_c.shape)} do not contract")
    M, K = x_c.shape
    N = w_c.shape[1]
    tensors = [("x_c", x_c), ("w_c", w_c)]
    if bias is not None:
        if bias.shape != (N,):
            raise ValueError(f"matmul_compact: bias has shape "
                             f"{tuple(bias.shape)}, expected ({N},)")
        tensors.append(("bias", bias))
    for name, t in tensors:
        if t.device != x_c.device:
            raise ValueError(f"matmul_compact: {name} on {t.device}, x_c on "
                             f"{x_c.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"matmul_compact: {name} must be float32, got "
                            f"{t.dtype} (this kernel is f32 only)")
        if not t.is_contiguous():
            raise ValueError(f"matmul_compact: {name} must be contiguous")
    y = torch.empty((M, N), dtype=torch.float32, device=x_c.device)
    if M == 0 or N == 0:
        return y
    if M > 65535 * 64:
        raise ValueError(f"matmul_compact: {M} rows exceed the grid limit")
    _build.launch(
        KERNEL, x_c.data_ptr(), w_c.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), M, K, N,
        ACT_CODES[act], torch.cuda.current_stream(x_c.device).cuda_stream)
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
