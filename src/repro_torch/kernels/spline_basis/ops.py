"""Public entry for B-spline basis evaluation, dispatched on the device.

Counterpart of ``repro/kernels/spline_basis/ops.py``.  A CPU tensor runs
the plain version (``ref.spline_basis_plain``, f32 or bf16); a CUDA tensor
launches the hand-written kernel ``csrc/spline_basis.cu`` (f32 only) or
raises.  There is no fallback from the kernel to its plain version.

The kernel's one launch knob, ``block_n`` (inputs, one per thread, a
block takes), resolves: explicit argument > autotune-cache hit for (n
bucket, dtype, card) > a measured search when ``REPRO_TORCH_AUTOTUNE=1``
> ``DEFAULT_BLOCK_N``.  It changes no result.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core.splines import SplineSpec, bases_local
from repro_torch.kernels import _build, autotune
from repro_torch.kernels.spline_basis.ref import spline_basis_plain

KERNEL = "spline_basis"
DEFAULT_BLOCK_N = 256


def resolve_block_n(n: int, n_bases: int, dtype: torch.dtype,
                    block_n: Optional[int] = None,
                    device: torch.device | str = "cuda",
                    tune: Optional[Callable[[], Dict[str, int]]] = None
                    ) -> int:
    """block_n for the kernel: explicit > cached > searched > default.

    ``tune`` runs the search on a cache miss when ``REPRO_TORCH_AUTOTUNE``
    is set; it stores what it finds, so the next call hits the cache.
    """
    if block_n is not None:
        return int(block_n)
    hit = autotune.cached_blocks(KERNEL, (n, n_bases), dtype, device)
    if hit is not None:
        return hit["block_n"]
    if tune is not None and autotune.autotune_enabled():
        return tune()["block_n"]
    return DEFAULT_BLOCK_N


def _launch(x: torch.Tensor, spec: SplineSpec,
            block_n: Optional[int]) -> torch.Tensor:
    """The CUDA kernel on flat contiguous ``x``: (n,) -> (n, G+K)."""
    if x.dtype != torch.float32:
        raise TypeError(f"spline_basis: the CUDA kernel is f32 only, got "
                        f"{x.dtype} (bf16 kernels are ROADMAP item 7)")
    n, nb = x.shape[0], spec.n_bases
    out = torch.empty((n, nb), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    if n > 2**31 - 1 - autotune.MAX_THREADS_PER_BLOCK:
        raise ValueError(f"spline_basis: {n} inputs exceed the grid limit")
    bn = resolve_block_n(n, nb, x.dtype, block_n, x.device,
                         tune=lambda: autotune.tune_spline_basis(x, spec))
    if not 1 <= bn <= autotune.MAX_THREADS_PER_BLOCK:
        raise ValueError(f"spline_basis: block_n {bn} is not in 1.."
                         f"{autotune.MAX_THREADS_PER_BLOCK}")
    _build.launch(KERNEL, x.data_ptr(), out.data_ptr(), n, spec.grid_size,
                  spec.order, float(spec.x0), float(spec.inv_h), bn,
                  torch.cuda.current_stream(x.device).cuda_stream)
    return out


def spline_basis(x: torch.Tensor, spec: SplineSpec, *,
                 block_n: Optional[int] = None) -> torch.Tensor:
    """Dense (..., G+K) basis values of ``x`` (not clipped: inputs outside
    [x0, x1) get their edge cell's extrapolated values)."""
    flat = x.reshape(-1)
    if x.device.type == "cpu":
        out = spline_basis_plain(flat, spec)
    elif x.device.type == "cuda":
        out = _launch(flat.contiguous(), spec, block_n)
    else:
        raise ValueError(f"spline_basis: no kernel for device {x.device}")
    return out.reshape(*x.shape, spec.n_bases)


def spline_basis_local(x: torch.Tensor, spec: SplineSpec):
    """Zero-free form: ((..., K+1) values, (...,) int32 cell offsets)."""
    return bases_local(x, spec)
