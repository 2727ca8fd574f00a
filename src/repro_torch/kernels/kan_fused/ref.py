"""Plain PyTorch version of the fused KAN layer.

``kan_fused_v2_ref`` mirrors ``_kan_linear_jnp`` of
``repro/kernels/kan_fused/ops.py`` (version 2): the K+1 local basis
values scattered into the kept-basis columns, ``[silu | bases]`` per input
feature, one contraction against the fused ``[w_b ; t[kb]]`` weights.  It
is what the wrapper runs for a CPU tensor and what the CUDA kernel is
held against on the card.  The dense Eq. 3 oracle is
``core/kan.kan_reference_dense``.
"""
from __future__ import annotations

from typing import Tuple

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
