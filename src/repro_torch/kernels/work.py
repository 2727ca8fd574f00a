"""Each kernel's work from its shapes, and the hook the dry run counts it
through.

The dry run (``launch/dryrun.count``) counts a step's FLOPs and bytes op
by op.  A kernel launch is not an aten op, so each wrapper reports its
kernel's work here instead, from the operands' shapes and dtypes alone,
by one function per kernel: the same count whether the wrapper launched
the kernel (cuda), ran its plain version (cpu) or made only its outputs
(meta).  Inside the wrapper's device branch the aten ops it runs (the
plain version's, the output's allocation, the slot table's copy) are
hidden from the FLOP and byte counters; the live-bytes tracker still sees
the tensors the branch makes.

What a kernel's work counts is what its bound in ``PERF.md`` §6 counts:
the multiply-adds of its contraction as two operations each (the KAN
kernels' dense fused contraction, every kept basis of every row: §6's
kept-basis hits depend on the data, this count does not) plus, for a
kernel that evaluates spline bases, ``spu_op_count(spec) + 4``
operations an input; its bytes are each operand read once and each
output written once.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Optional, Tuple

import torch

from repro_torch.core.splines import SplineSpec, spu_op_count

# the active counts (launch/dryrun.Count), innermost last
COUNTERS: List = []

Work = Tuple[float, float]          # (operations, bytes)


@contextlib.contextmanager
def kernel(name: str, work: Callable[[], Optional[Work]]) -> Iterator[None]:
    """Around one wrapper call's device branch: while a count is active,
    hide the branch's aten ops from its FLOP and byte counters and, when
    the branch returns, add ``work()`` to it as one launch of ``name``
    (None: an empty call, which launches nothing)."""
    if not COUNTERS:
        yield
        return
    counters = list(COUNTERS)
    with hidden():
        yield
    w = work()
    if w is not None:
        for c in counters:
            c.add_kernel(name, *w)


@contextlib.contextmanager
def hidden() -> Iterator[None]:
    """Hide the aten ops inside the block from every active count's FLOP
    and byte counters: a collective's own copies (its bytes are counted
    as the collective's, ``launch/collectives``)."""
    counters = list(COUNTERS)
    for c in counters:
        c.hidden += 1
    try:
        yield
    finally:
        for c in counters:
            c.hidden -= 1


def _spu(n: int, spec: SplineSpec) -> float:
    return float(n) * (spu_op_count(spec) + 4)


def kan_fused(B: int, n_in: int, n_out: int, spec: SplineSpec, nbk: int,
              x_dtype: torch.dtype, wt_dtype: torch.dtype,
              out_dtype: torch.dtype, extra_bytes: int = 0
              ) -> Optional[Work]:
    """A fused-KAN layer (kernels 1, 3 and 6): ``2 B n_in (nbk+1) n_out``
    operations of the contraction and the SPU's on every (row, feature);
    x, the ``n_in (nbk+1)`` weight rows (version 1: ``w_b`` and
    ``t_flat``, as many), the output and the (G+K,) int32 slot table."""
    if B == 0 or n_out == 0:
        return None
    ops = 2.0 * B * n_in * (nbk + 1) * n_out + _spu(B * n_in, spec)
    nbytes = (B * n_in * x_dtype.itemsize
              + n_in * (nbk + 1) * n_out * wt_dtype.itemsize
              + B * n_out * out_dtype.itemsize + 4 * spec.n_bases
              + extra_bytes)
    return ops, float(nbytes)


def kan_fused_q8(B: int, n_in: int, n_out: int, spec: SplineSpec,
                 nbk: int) -> Optional[Work]:
    """The int8 layer (kernel 3): int8 x and rows, the (nbk+1,) f32 slot
    scales, f32 out."""
    return kan_fused(B, n_in, n_out, spec, nbk, torch.int8, torch.int8,
                     torch.float32, extra_bytes=4 * (nbk + 1))


def matmul(M: int, K: int, N: int, dtype: torch.dtype,
           out_dtype: torch.dtype, bias_dtype: Optional[torch.dtype] = None
           ) -> Optional[Work]:
    """A compact matmul (kernels 2 and 4): ``2 M K N`` operations; x_c,
    w_c, the bias when given, the output."""
    if M == 0 or N == 0:
        return None
    nbytes = ((M * K + K * N) * dtype.itemsize + M * N * out_dtype.itemsize
              + (N * bias_dtype.itemsize if bias_dtype is not None else 0))
    return 2.0 * M * K * N, float(nbytes)


def spline_basis(n: int, spec: SplineSpec,
                 dtype: torch.dtype) -> Optional[Work]:
    """The dense basis (kernel 5): the SPU's operations an input; the n
    inputs and the (n, G+K) output."""
    if n == 0:
        return None
    return _spu(n, spec), float(dtype.itemsize * (n + n * spec.n_bases))
