"""Plain PyTorch versions of the spline-basis kernel.

``spline_basis_plain`` is the function the CUDA kernel computes: the K+1
local de Boor values of each input (no clipping; only the cell is
clamped) scattered into all G+K columns, as the JAX package's
``_spline_basis_jnp`` does.  The wrapper runs it for a CPU tensor, and the
kernel is held against it on the card, bit for bit.  ``spline_basis_ref``
is the dense Cox-de Boor oracle (counterpart of
``repro/kernels/spline_basis/ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.splines import (
    SplineSpec,
    bases_dense,
    bases_local,
    scatter_local,
)


def spline_basis_plain(x: torch.Tensor, spec: SplineSpec) -> torch.Tensor:
    """(n,) inputs -> (n, G+K) basis values by local evaluation + scatter;
    f32, or bf16 with the recursion in bf16 (interval location in f32)."""
    vals, cell = bases_local(x, spec)
    return scatter_local(vals, cell, spec)


def spline_basis_ref(x: torch.Tensor, spec: SplineSpec) -> torch.Tensor:
    """All G+K basis values for a flat batch of inputs: (n,) -> (n, G+K)."""
    return bases_dense(x, spec)
