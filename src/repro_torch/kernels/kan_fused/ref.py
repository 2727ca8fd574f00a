"""Plain PyTorch versions of the fused KAN layer.

``kan_fused_v2_ref`` mirrors ``_kan_linear_jnp`` of
``repro/kernels/kan_fused/ops.py`` (version 2): the K+1 local basis
values scattered into the kept-basis columns, ``[silu | bases]`` per input
feature, one contraction against the fused ``[w_b ; t[kb]]`` weights.
``kan_fused_v1_ref`` is version 1 of the same: ``silu(x) @ w_b`` and
``bases @ t_flat`` as two contractions.  On bf16 x the activation is
computed in bf16 as the reference's (silu in f32 rounded once, the de
Boor recursion rounded op by op, ``core/splines``), the products in f32
on the widened operands, and ``out_dtype`` (x's dtype by default, or f32)
rounds the total once.  ``kan_fused_v2_q8_ref`` mirrors
``_kan_linear_q8_jnp``: version 2 on int8 codes, dequantized first
(``dequant_wt`` per weight-row slot).  They are
what the wrappers run for a CPU tensor and what the CUDA kernels are held
against on the card.  The dense Eq. 3 oracle is
``core/kan.kan_reference_dense``.  ``split_bf16_planes`` and
``kan_fused_v2_planes`` model, for the tests, the arithmetic of the mixed
kernel (a bf16 x against f32 fused rows), which contracts the activation
tile with three exact bf16 planes of the rows on tensor cores.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.splines import (
    SplineSpec,
    bases_local,
    scatter_kept,
    silu,
)


def _silu_and_bases(x: torch.Tensor, spec: SplineSpec, kb: Tuple[int, ...]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SIMD + SPU + TSE: silu(x) computed in f32 and cast back, and the
    K+1 local basis values of x clipped to [x0, x1 - eps) scattered into
    the kept-basis columns: (B, n_in) and (B, n_in, nbk)."""
    vals, cell = bases_local(spec.clip(x), spec)            # (B, n_in, K+1)
    kbv = torch.as_tensor(kb, dtype=torch.int32, device=x.device)
    act = scatter_kept(vals, cell, kbv, spec.n_active)      # (B, n_in, nbk)
    return silu(x.to(torch.float32)).to(x.dtype), act


def kan_fused_v2_ref(x: torch.Tensor, wt: torch.Tensor, spec: SplineSpec,
                     kb: Tuple[int, ...],
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, n_in) x, (n_in*(nbk+1), n_out) fused wt -> (B, n_out): the f32
    product of the widened operands, cast to ``out_dtype`` (x's dtype by
    default)."""
    n_in = x.shape[-1]
    nbk = len(kb)
    s, act = _silu_and_bases(x, spec, kb)
    fused = torch.cat([s[..., None], act], dim=-1)
    y = torch.matmul(fused.reshape(x.shape[0], n_in * (nbk + 1)).to(
        torch.float32), wt.to(torch.float32))
    return y.to(out_dtype or x.dtype)


def kan_fused_v1_ref(x: torch.Tensor, w_b: torch.Tensor, t_flat: torch.Tensor,
                     spec: SplineSpec, kb: Tuple[int, ...],
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, n_in) x, (n_in, n_out) w_b, (n_in*nbk, n_out) t_flat -> (B,
    n_out): ``silu(x) @ w_b + scattered_bases @ t_flat``, two f32 products
    added once, as ``_kan_linear_jnp`` does at ``version=1``, cast to
    ``out_dtype`` (x's dtype by default)."""
    n_in = x.shape[-1]
    nbk = len(kb)
    s, act = _silu_and_bases(x, spec, kb)
    y = torch.matmul(s.to(torch.float32), w_b.to(torch.float32))
    y = y + torch.matmul(act.reshape(x.shape[0], n_in * nbk).to(
        torch.float32), t_flat.to(torch.float32))
    return y.to(out_dtype or x.dtype)


def dequant_wt(wt_q: torch.Tensor, slot_scales: torch.Tensor,
               nbk: int) -> torch.Tensor:
    """(n_in*(nbk+1), n_out) int8 fused weights -> f32 under the (nbk+1,)
    per-slot scales: row p*(nbk+1)+s is multiplied by ``slot_scales[s]``."""
    n_rows, n_out = wt_q.shape
    ss = slot_scales.to(torch.float32).reshape(1, nbk + 1, 1)
    wt = wt_q.to(torch.float32).reshape(n_rows // (nbk + 1), nbk + 1, n_out)
    return (wt * ss).reshape(n_rows, n_out)


def kan_fused_v2_q8_ref(x_q: torch.Tensor, wt_q: torch.Tensor,
                        slot_scales: torch.Tensor, spec: SplineSpec,
                        kb: Tuple[int, ...], x_scale: float) -> torch.Tensor:
    """(B, n_in) int8 x_q, (n_in*(nbk+1), n_out) int8 fused wt_q -> (B,
    n_out) f32: the f32 layer on ``x_q * x_scale`` and the dequantized
    weights."""
    n_in = x_q.shape[-1]
    nbk = len(kb)
    x = x_q.to(torch.float32) * float(np.float32(x_scale))
    s, act = _silu_and_bases(x, spec, kb)
    wt = dequant_wt(wt_q, slot_scales, nbk)
    fused = torch.cat([s[..., None], act], dim=-1)
    return torch.matmul(fused.reshape(x_q.shape[0], n_in * (nbk + 1)), wt)


_HIGH16 = -65536                # 0xffff0000 as an int32


def _high16(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` with its low 16 bits cleared: rounded toward zero to a
    bf16 value."""
    return (v.view(torch.int32) & _HIGH16).view(torch.float32)


def split_bf16_planes(w: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three bf16 planes (hi, mid, lo) of f32 ``w``, as the mixed
    kernel splits its f32 rows (``csrc/kan_mma.cuh``): hi is ``w`` with
    its low 16 bits cleared, mid the same of ``w - hi``, lo the same of
    ``w - hi - mid``.  Both subtractions are exact in f32 and ``w - hi -
    mid`` has at most 8 significant bits, so ``hi + mid + lo == w`` for
    every finite ``w`` (rounding toward zero never overflows), save where
    that remainder has bits below bf16's subnormal step 2^-133 (``|w|``
    below about 2^-110), which lo drops: less than 2^-133 a weight."""
    w = w.to(torch.float32).contiguous()
    hi = _high16(w)
    r1 = w - hi
    mid = _high16(r1)
    lo = _high16(r1 - mid)
    return hi.to(torch.bfloat16), mid.to(torch.bfloat16), lo.to(torch.bfloat16)


def kan_fused_v2_planes(x: torch.Tensor, wt: torch.Tensor, spec: SplineSpec,
                        kb: Tuple[int, ...],
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """The mixed kernel's products on the CPU: bf16 ``x``'s activation
    tile (``kan_fused_v2_ref``'s) against each bf16 plane of the f32
    ``wt`` (``split_bf16_planes``) in an f32 product, the three added lo,
    mid, hi, cast to ``out_dtype`` (x's dtype by default).  Each product
    of two bf16 values is exact in f32, so this is ``kan_fused_v2_ref``'s
    function with its f32 sums in another order.  For the tests."""
    n_in = x.shape[-1]
    s, act = _silu_and_bases(x, spec, kb)
    a = torch.cat([s[..., None], act], dim=-1).reshape(
        x.shape[0], n_in * (len(kb) + 1)).to(torch.float32)
    hi, mid, lo = split_bf16_planes(wt)
    y = torch.matmul(a, lo.to(torch.float32))
    y = y + torch.matmul(a, mid.to(torch.float32))
    y = y + torch.matmul(a, hi.to(torch.float32))
    return y.to(out_dtype or x.dtype)
