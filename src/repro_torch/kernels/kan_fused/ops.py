"""Public entry for the fused KAN layer, dispatched on the tensor's device.

Counterpart of ``repro/kernels/kan_fused/ops.py`` (version 2 only).  A
CPU tensor runs the plain version (``ref.kan_fused_v2_ref``, or
``ref.kan_fused_v2_q8_ref`` for int8 codes); a CUDA tensor launches the
hand-written kernel ``csrc/kan_fused.cu`` (``csrc/kan_fused_q8.cu``) or
raises.  There is no fallback from a kernel to its plain version.

Weights keep the JAX package's layouts: ``w_b`` (n_in, n_out), ``t``
(n_in, G+K, n_out), ``t_flat`` (n_in*nbk, n_out) feature-major, and the
fused ``wt`` (n_in*(nbk+1), n_out) with the silu row first per feature.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.splines import SplineSpec
from repro_torch.kernels import _build
from repro_torch.kernels.kan_fused.ref import (
    kan_fused_v2_q8_ref,
    kan_fused_v2_ref,
)

KERNEL = "kan_fused_v2"
KERNEL_Q8 = "kan_fused_v2_q8"


def flatten_t(t: torch.Tensor,
              kb: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """(n_in, n_bases, n_out) -> (n_in*nbk, n_out), rows feature-major.

    ``kb`` selects the kept basis indices (stage-2 compaction).
    """
    if kb is not None:
        t = t.index_select(1, torch.as_tensor(kb, dtype=torch.long,
                                              device=t.device))
    n_in, nbk, n_out = t.shape
    return t.reshape(n_in * nbk, n_out)


def fuse_wt(w_b: torch.Tensor, t_flat: torch.Tensor, nbk: int) -> torch.Tensor:
    """Row-interleave [w_b ; t] into the fused layout.

    (n_in, n_out) + (n_in*nbk, n_out) -> (n_in*(nbk+1), n_out): per input
    feature p, row p*(nbk+1) is w_b[p] and rows p*(nbk+1)+1.. its nbk
    kept spline rows.
    """
    n_in, n_out = w_b.shape
    if t_flat.shape != (n_in * nbk, n_out):
        raise ValueError(f"t_flat has shape {tuple(t_flat.shape)}, expected "
                         f"{(n_in * nbk, n_out)}")
    t3 = t_flat.reshape(n_in, nbk, n_out)
    wt = torch.cat([w_b[:, None, :], t3], dim=1)
    return wt.reshape(n_in * (nbk + 1), n_out).contiguous()


def slot_table(kb: Tuple[int, ...], n_bases: int,
               device: torch.device) -> torch.Tensor:
    """(n_bases,) int32: the kept slot of each basis index, -1 if dropped
    (the kernel's counterpart of the TPU kernel's ``kb_arr`` input)."""
    slot = [-1] * n_bases
    for s, i in enumerate(kb):
        slot[i] = s
    return torch.tensor(slot, dtype=torch.int32, device=device)


def _check_operands(fn: str, x: torch.Tensor, wt: torch.Tensor,
                    slot_of: torch.Tensor, spec: SplineSpec, nbk: int,
                    operands: Sequence[Tuple[str, torch.Tensor, torch.dtype]],
                    what: str) -> Tuple[int, int, int]:
    """(B, n_in, n_out) of one layer call; raises on a shape, device,
    dtype or layout the kernel does not take."""
    if x.dim() != 2:
        raise ValueError(f"{fn} takes (B, n_in) x, got {tuple(x.shape)}")
    B, n_in = x.shape
    for name, t, dtype in operands:
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype} "
                            f"({what})")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if wt.dim() != 2 or wt.shape[0] != n_in * (nbk + 1):
        raise ValueError(f"{fn}: wt has shape {tuple(wt.shape)}, "
                         f"expected ({n_in * (nbk + 1)}, n_out)")
    if slot_of.shape != (spec.n_bases,):
        raise ValueError(f"{fn}: slot_of has shape "
                         f"{tuple(slot_of.shape)}, expected ({spec.n_bases},)")
    if B > 65535 * 16:
        raise ValueError(f"{fn}: batch {B} exceeds the grid limit")
    return B, n_in, wt.shape[1]


def kan_fused_v2(x: torch.Tensor, wt: torch.Tensor, spec: SplineSpec,
                 kb: Tuple[int, ...],
                 slot_of: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One KAN layer on (B, n_in) x against the fused ``wt``.

    ``slot_of`` is ``slot_table(kb, ...)`` on the device; layers build it
    once and pass it, else it is built here.
    """
    if x.device.type == "cpu":
        return kan_fused_v2_ref(x, wt, spec, kb)
    if x.device.type != "cuda":
        raise ValueError(f"kan_fused_v2: no kernel for device {x.device}")
    if slot_of is None:
        slot_of = slot_table(kb, spec.n_bases, x.device)
    B, n_in, n_out = _check_operands(
        "kan_fused_v2", x, wt, slot_of, spec, len(kb),
        [("x", x, torch.float32), ("wt", wt, torch.float32),
         ("slot_of", slot_of, torch.int32)], "this kernel is f32 only")
    out = torch.empty((B, n_out), dtype=torch.float32, device=x.device)
    if B == 0 or n_out == 0:
        return out
    _build.launch(
        KERNEL, x.data_ptr(), wt.data_ptr(), slot_of.data_ptr(),
        out.data_ptr(), B, n_in, n_out, len(kb), spec.grid_size, spec.order,
        float(spec.x0), float(spec.clip_hi), float(spec.inv_h),
        torch.cuda.current_stream(x.device).cuda_stream)
    return out


def kan_fused_v2_q8(x_q: torch.Tensor, wt_q: torch.Tensor,
                    slot_scales: torch.Tensor, spec: SplineSpec,
                    kb: Tuple[int, ...], x_scale: float,
                    slot_of: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One int8 KAN layer: (B, n_in) int8 codes ``x_q`` against the int8
    fused ``wt_q``, dequantized on load by the static ``x_scale`` and the
    (nbk+1,) f32 ``slot_scales``; f32 accumulate, f32 out."""
    nbk = len(kb)
    if slot_scales.shape != (nbk + 1,):
        raise ValueError(f"kan_fused_v2_q8: slot_scales has shape "
                         f"{tuple(slot_scales.shape)} for nbk={nbk}")
    if x_q.device.type == "cpu":
        return kan_fused_v2_q8_ref(x_q, wt_q, slot_scales, spec, kb, x_scale)
    if x_q.device.type != "cuda":
        raise ValueError(f"kan_fused_v2_q8: no kernel for device "
                         f"{x_q.device}")
    if slot_of is None:
        slot_of = slot_table(kb, spec.n_bases, x_q.device)
    B, n_in, n_out = _check_operands(
        "kan_fused_v2_q8", x_q, wt_q, slot_of, spec, nbk,
        [("x_q", x_q, torch.int8), ("wt_q", wt_q, torch.int8),
         ("slot_scales", slot_scales, torch.float32),
         ("slot_of", slot_of, torch.int32)], "this kernel takes int8 codes")
    out = torch.empty((B, n_out), dtype=torch.float32, device=x_q.device)
    if B == 0 or n_out == 0:
        return out
    _build.launch(
        KERNEL_Q8, x_q.data_ptr(), wt_q.data_ptr(), slot_scales.data_ptr(),
        slot_of.data_ptr(), out.data_ptr(), B, n_in, n_out, nbk,
        spec.grid_size, spec.order, float(x_scale), float(spec.x0),
        float(spec.clip_hi), float(spec.inv_h),
        torch.cuda.current_stream(x_q.device).cuda_stream)
    return out


def kan_linear(x: torch.Tensor, w_b: torch.Tensor, t_flat: torch.Tensor,
               spec: SplineSpec,
               kb: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """phi(x) per Eq. 3 with two-stage sparsity; batch dims preserved.

    Functional form of the JAX ``kan_linear``: fuses the weights on every
    call.  ``core/kan.KANLayer`` fuses them once instead.
    """
    lead = x.shape[:-1]
    n_in = x.shape[-1]
    kb = tuple(range(spec.n_bases)) if kb is None else tuple(kb)
    wt = fuse_wt(w_b, t_flat, len(kb))
    y = kan_fused_v2(x.reshape(-1, n_in).contiguous(), wt, spec, kb)
    return y.reshape(*lead, w_b.shape[-1])


def kan_linear_q8(x_q: torch.Tensor, wt_q: torch.Tensor,
                  slot_scales: Sequence[float], spec: SplineSpec,
                  kb: Optional[Tuple[int, ...]] = None, *,
                  x_scale: float) -> torch.Tensor:
    """Int8 phi(x) on the fused int8 ``wt_q``: dequantize on load, f32
    accumulate, f32 out; batch dims preserved.

    Functional form of the JAX ``kan_linear_q8``; ``slot_scales`` is the
    (nbk+1,) ``[s_wb, s_t[kb0], ...]`` vector.
    """
    lead = x_q.shape[:-1]
    n_in = x_q.shape[-1]
    kb = tuple(range(spec.n_bases)) if kb is None else tuple(kb)
    ss = torch.as_tensor(np.asarray(slot_scales, np.float32),
                         device=x_q.device)
    y = kan_fused_v2_q8(x_q.reshape(-1, n_in).contiguous(), wt_q, ss, spec,
                        kb, x_scale)
    return y.reshape(*lead, wt_q.shape[-1])
