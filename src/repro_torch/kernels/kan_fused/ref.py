"""Plain PyTorch versions of the fused KAN layer.

``kan_fused_v2_ref`` mirrors ``_kan_linear_jnp`` of
``repro/kernels/kan_fused/ops.py`` (version 2): the K+1 local basis
values scattered into the kept-basis columns, ``[silu | bases]`` per input
feature, one contraction against the fused ``[w_b ; t[kb]]`` weights.
``kan_fused_v2_q8_ref`` mirrors ``_kan_linear_q8_jnp``: the same on int8
codes, dequantized first (``dequant_wt`` per weight-row slot).  They are
what the wrappers run for a CPU tensor and what the CUDA kernels are held
against on the card.  The dense Eq. 3 oracle is
``core/kan.kan_reference_dense``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.splines import (
    SplineSpec,
    bases_local,
    scatter_kept,
    silu,
)


def kan_fused_v2_ref(x: torch.Tensor, wt: torch.Tensor, spec: SplineSpec,
                     kb: Tuple[int, ...]) -> torch.Tensor:
    """(B, n_in) x, (n_in*(nbk+1), n_out) fused wt -> (B, n_out)."""
    n_in = x.shape[-1]
    nbk = len(kb)
    vals, cell = bases_local(spec.clip(x), spec)            # (B, n_in, K+1)
    kbv = torch.as_tensor(kb, dtype=torch.int32, device=x.device)
    act = scatter_kept(vals, cell, kbv, spec.n_active)      # (B, n_in, nbk)
    s = silu(x.to(torch.float32)).to(x.dtype)
    fused = torch.cat([s[..., None], act], dim=-1)
    y = torch.matmul(fused.reshape(-1, n_in * (nbk + 1)).to(torch.float32),
                     wt.to(torch.float32))
    return y.to(x.dtype)


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
    vals, cell = bases_local(spec.clip(x), spec)
    kbv = torch.as_tensor(kb, dtype=torch.int32, device=x.device)
    act = scatter_kept(vals, cell, kbv, spec.n_active)      # (B, n_in, nbk)
    s = silu(x)
    wt = dequant_wt(wt_q, slot_scales, nbk)
    fused = torch.cat([s[..., None], act], dim=-1)
    return torch.matmul(fused.reshape(-1, n_in * (nbk + 1)), wt)
