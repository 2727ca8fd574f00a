"""Public entry for B-spline basis evaluation, dispatched on the device.

Counterpart of ``repro/kernels/spline_basis/ops.py``.  A CPU tensor runs
the plain version (``ref.spline_basis_plain``, f32 or bf16); a CUDA tensor
launches the hand-written kernel for its dtype, ``csrc/spline_basis.cu``
(f32) or ``csrc/spline_basis_bf16.cu`` (bf16, the output in bf16), or
raises; a meta tensor (the dry run, ``launch/dryrun``) gets the card's
checks and output and no launch, its work counted by ``kernels/work``.
There is no fallback from a kernel to its plain version.

The kernel's one launch knob, ``block_n``, is the number of consecutive
inputs a block takes (the JAX kernel's block): a power of two from 32 to
4096 whose (block_n, G+K) output stretch fits in the block's shared
memory (half as much at bf16); a block has min(block_n, 256) threads
(bf16: min(block_n / 2, 256), each evaluating two inputs at once in
bf16x2).
It resolves: explicit argument > autotune-cache hit for (n bucket, dtype,
card) > a measured search when ``REPRO_TORCH_AUTOTUNE=1`` >
``DEFAULT_BLOCK_N``, and is checked (``check_block_n``) on the CPU too.
It changes no result.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core.splines import SplineSpec, bases_local
from repro_torch.kernels import _build, autotune, work
from repro_torch.kernels.spline_basis.ref import spline_basis_plain

KERNEL = "spline_basis"
KERNEL_BF16 = "spline_basis_bf16"
DTYPES = (torch.float32, torch.bfloat16)
DEFAULT_BLOCK_N = 256
MIN_BLOCK_N = 32
MAX_BLOCK_N = 4096


def kernel_smem(block_n: int, n_bases: int,
                dtype: torch.dtype = torch.float32) -> int:
    """Shared memory, in bytes, a block of the kernel for ``dtype`` uses
    (csrc/spline_basis.cuh's smem_bytes): its output stretch and one
    16-byte store of alignment slack."""
    size = 2 if dtype == torch.bfloat16 else 4
    return size * (block_n * n_bases + 16 // size)


def check_block_n(block_n: int, n_bases: int,
                  dtype: torch.dtype = torch.float32) -> None:
    """Raise ``ValueError`` unless the kernel for ``dtype`` takes
    ``block_n`` at ``n_bases`` basis columns."""
    if not MIN_BLOCK_N <= block_n <= MAX_BLOCK_N or block_n & (block_n - 1):
        raise ValueError(f"spline_basis: block_n {block_n} is not a power "
                         f"of two in {MIN_BLOCK_N}..{MAX_BLOCK_N}")
    smem = kernel_smem(block_n, n_bases, dtype)
    if smem > autotune.MAX_SMEM_BYTES:
        raise ValueError(f"spline_basis: block_n {block_n} needs {smem} "
                         f"bytes of shared memory at {n_bases} bases, more "
                         f"than {autotune.MAX_SMEM_BYTES}")


def resolve_block_n(n: int, n_bases: int, dtype: torch.dtype,
                    block_n: Optional[int] = None,
                    device: torch.device | str = "cuda",
                    tune: Optional[Callable[[], Dict[str, int]]] = None
                    ) -> int:
    """block_n for the kernel: explicit > cached > searched > default,
    checked against what the kernel takes.

    ``tune`` runs the search on a cache miss when ``REPRO_TORCH_AUTOTUNE``
    is set; it stores what it finds, so the next call hits the cache.
    """
    if block_n is None:
        hit = autotune.cached_blocks(KERNEL, (n, n_bases), dtype, device)
        if hit is not None:
            block_n = hit["block_n"]
        elif tune is not None and autotune.autotune_enabled():
            block_n = tune()["block_n"]
        else:
            block_n = DEFAULT_BLOCK_N
    check_block_n(int(block_n), n_bases, dtype)
    return int(block_n)


def _launch(x: torch.Tensor, spec: SplineSpec,
            block_n: Optional[int]) -> torch.Tensor:
    """The CUDA kernel for ``x``'s dtype on flat contiguous ``x``: (n,) ->
    (n, G+K) in that dtype."""
    if x.dtype not in DTYPES:
        raise TypeError(f"spline_basis: the CUDA kernels take f32 or bf16, "
                        f"got {x.dtype}")
    n, nb = x.shape[0], spec.n_bases
    out = torch.empty((n, nb), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    if n > 2**31 - 1 - MAX_BLOCK_N:
        raise ValueError(f"spline_basis: {n} inputs exceed the grid limit")
    if x.is_meta:
        if block_n is not None:
            check_block_n(int(block_n), nb, x.dtype)
        return out
    bn = resolve_block_n(n, nb, x.dtype, block_n, x.device,
                         tune=lambda: autotune.tune_spline_basis(x, spec))
    _build.launch(KERNEL_BF16 if x.dtype == torch.bfloat16 else KERNEL,
                  x.data_ptr(), out.data_ptr(), n, spec.grid_size,
                  spec.order, float(spec.x0), float(spec.inv_h), bn,
                  torch.cuda.current_stream(x.device).cuda_stream)
    return out


def spline_basis(x: torch.Tensor, spec: SplineSpec, *,
                 block_n: Optional[int] = None) -> torch.Tensor:
    """Dense (..., G+K) basis values of ``x`` (not clipped: inputs outside
    [x0, x1) get their edge cell's extrapolated values).  ``block_n``
    (inputs a block) is checked on the CPU too."""
    flat = x.reshape(-1)
    name = KERNEL_BF16 if x.dtype == torch.bfloat16 else KERNEL
    with work.kernel(name, lambda: work.spline_basis(flat.numel(), spec,
                                                     x.dtype)):
        if x.device.type == "cpu":
            if block_n is not None:
                check_block_n(int(block_n), spec.n_bases, x.dtype)
            out = spline_basis_plain(flat, spec)
        elif x.device.type in ("cuda", "meta"):
            out = _launch(flat.contiguous(), spec, block_n)
        else:
            raise ValueError(f"spline_basis: no kernel for device "
                             f"{x.device}")
    return out.reshape(*x.shape, spec.n_bases)


def spline_basis_local(x: torch.Tensor, spec: SplineSpec):
    """Zero-free form: ((..., K+1) values, (...,) int32 cell offsets)."""
    return bases_local(x, spec)
