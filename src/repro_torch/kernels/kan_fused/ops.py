"""Public entry for the fused KAN layer, dispatched on the tensor's device.

Counterpart of ``repro/kernels/kan_fused/ops.py`` (version 2 only).  A
CPU tensor runs the plain version (``ref.kan_fused_v2_ref``); a CUDA
tensor launches the hand-written kernel ``csrc/kan_fused.cu`` or raises.
There is no fallback from the kernel to the plain version.

Weights keep the JAX package's layouts: ``w_b`` (n_in, n_out), ``t``
(n_in, G+K, n_out), ``t_flat`` (n_in*nbk, n_out) feature-major, and the
fused ``wt`` (n_in*(nbk+1), n_out) with the silu row first per feature.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.splines import SplineSpec
from repro_torch.kernels import _build
from repro_torch.kernels.kan_fused.ref import kan_fused_v2_ref

KERNEL = "kan_fused_v2"


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
    nbk = len(kb)
    if x.dim() != 2:
        raise ValueError(f"kan_fused_v2 takes (B, n_in) x, got {tuple(x.shape)}")
    B, n_in = x.shape
    if slot_of is None:
        slot_of = slot_table(kb, spec.n_bases, x.device)
    for name, t, dtype in (("x", x, torch.float32), ("wt", wt, torch.float32),
                           ("slot_of", slot_of, torch.int32)):
        if t.device != x.device:
            raise ValueError(f"kan_fused_v2: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != dtype:
            raise TypeError(f"kan_fused_v2: {name} must be {dtype}, got "
                            f"{t.dtype} (this kernel is f32 only)")
        if not t.is_contiguous():
            raise ValueError(f"kan_fused_v2: {name} must be contiguous")
    if wt.dim() != 2 or wt.shape[0] != n_in * (nbk + 1):
        raise ValueError(f"kan_fused_v2: wt has shape {tuple(wt.shape)}, "
                         f"expected ({n_in * (nbk + 1)}, n_out)")
    if slot_of.shape != (spec.n_bases,):
        raise ValueError(f"kan_fused_v2: slot_of has shape "
                         f"{tuple(slot_of.shape)}, expected ({spec.n_bases},)")
    n_out = wt.shape[1]
    out = torch.empty((B, n_out), dtype=torch.float32, device=x.device)
    if B == 0 or n_out == 0:
        return out
    if B > 65535 * 16:
        raise ValueError(f"kan_fused_v2: batch {B} exceeds the grid limit")
    _build.launch(
        KERNEL, x.data_ptr(), wt.data_ptr(), slot_of.data_ptr(),
        out.data_ptr(), B, n_in, n_out, nbk, spec.grid_size, spec.order,
        float(spec.x0), float(spec.clip_hi), float(spec.inv_h),
        torch.cuda.current_stream(x.device).cuda_stream)
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
