"""Collectives over the axes of a ``launch/mesh.ProcessMesh``.

New in the port, with no counterpart file: the reference's collectives
are ``jax.lax`` primitives (``all_gather``, ``psum``, ``pmax``) that XLA
places inside one program.  Here each rank calls ``torch.distributed``
on the subgroup of the axes it reduces over:

* ``all_gather_shards`` returns every rank's tensor along the axes, in
  row-major order of them; ``gather_cat`` concatenates them on a dim;
* ``reduce_over`` sums floats in rank order -- all-gather, then add in
  a fixed order -- so two runs of a mesh give the same bits, and a run
  over NCCL the bits of the same mesh over gloo;
* ``reduce_scatter_over`` sums, in the same rank order, only this
  rank's chunk of every rank's tensor (an all-to-all, then the adds):
  the bits ``reduce_over`` gives that chunk, for 1/n of the bytes;
* ``psum_int32`` sums int32 with ``all_reduce`` (an integer sum is exact
  in any order) and ``pmax`` takes a maximum (exact too);
* ``enter`` and ``combine`` are the two ``torch.autograd.Function``s of
  expert parallelism (``models/moe``): *enter* is the identity forward
  and sums the cotangent over the axis backward (each expert rank holds
  only its experts' share of it); *combine* sums over the axis forward
  and is the identity backward.

gloo takes host tensors: a card's tensor is copied to pinned host
memory before a gloo collective and back after it, explicitly
(``_host``); NCCL takes it in place.  An all-gather moves bytes (every dtype, bf16 too, on
every backend).  Along axes of one rank every function is
the identity, with no process group needed.  ``SENT`` counts the
collectives a rank takes part in and the bytes it contributes to them
(an all-to-all: the chunks it sends to other ranks; ``reset_sent``
zeroes it).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Axes, ProcessMesh

SENT = {"calls": 0, "bytes": 0}


def reset_sent() -> None:
    SENT.update(calls=0, bytes=0)


def _staged(mesh: ProcessMesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.device.type == "cuda"


def _host(mesh: ProcessMesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous where the backend takes it: a card's tensor in
    pinned host memory for gloo (torch caches the pinned blocks, and a
    copy from pinned memory runs at the link's rate), in place for
    NCCL and on the CPU."""
    if _staged(mesh, x):
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        return buf
    return x.contiguous()


def _like(w: torch.Tensor, staged: bool) -> torch.Tensor:
    """A receive buffer for ``w``: beside it, pinned when staged."""
    return torch.empty(w.shape, dtype=w.dtype, device=w.device,
                       pin_memory=staged)


def all_gather_shards(x: torch.Tensor, mesh: ProcessMesh,
                      axes: str | Sequence[str]) -> List[torch.Tensor]:
    """Every rank's ``x`` along ``axes``, in row-major order of them
    (equal shapes and dtypes on every rank).  The tensors cross as their
    bytes, so every dtype gathers on every backend."""
    ax: Axes = mesh.present(axes)
    if not ax:
        return [x]
    w = _host(mesh, x).reshape(-1).view(torch.uint8)
    SENT["calls"] += 1
    SENT["bytes"] += w.numel()
    parts = [_like(w, _staged(mesh, x)) for _ in range(mesh.axis_size(ax))]
    dist.all_gather(parts, w, group=mesh.group(ax))
    return [p.view(x.dtype).reshape(x.shape).to(x.device) for p in parts]


def gather_cat(x: torch.Tensor, mesh: ProcessMesh,
               axes: str | Sequence[str], dim: int) -> torch.Tensor:
    """The shards of ``x`` along ``axes`` concatenated on ``dim``."""
    parts = all_gather_shards(x, mesh, axes)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def reduce_over(x: torch.Tensor, mesh: ProcessMesh,
                axes: str | Sequence[str],
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, added in rank order in ``dtype``
    (default x's; every rank gets the same bits).  ``x`` crosses in its
    own dtype."""
    parts = all_gather_shards(x, mesh, axes)
    acc = parts[0].to(dtype or x.dtype)
    for p in parts[1:]:
        acc = acc + p.to(acc.dtype)
    return acc


def reduce_scatter_over(chunks: Sequence[torch.Tensor], mesh: ProcessMesh,
                        axes: str | Sequence[str],
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``chunks[j]`` goes to the j-th rank along ``axes`` (row-major);
    returns the sum over the ranks of the chunk each sent this rank,
    added in rank order in ``dtype`` (default the chunks').  Every rank
    passes chunks of one shape and dtype; they cross as their bytes."""
    ax: Axes = mesh.present(axes)
    n = mesh.axis_size(ax)
    if len(chunks) != n:
        raise ValueError(f"{len(chunks)} chunks for {n} ranks along {ax}")
    x = chunks[0]
    if not ax:
        return x.to(dtype or x.dtype)
    # one flat buffer of the chunks' bytes, chunk j at j * nbytes: gloo
    # takes only the single-tensor all-to-all
    staged = _staged(mesh, x)
    nbytes = x.numel() * x.element_size()
    send = torch.empty(n * nbytes, dtype=torch.uint8,
                       device="cpu" if staged else x.device,
                       pin_memory=staged)
    for j, c in enumerate(chunks):
        send[j * nbytes:(j + 1) * nbytes].copy_(
            c.contiguous().reshape(-1).view(torch.uint8))
    SENT["calls"] += 1
    SENT["bytes"] += (n - 1) * nbytes
    recv = _like(send, staged)
    dist.all_to_all_single(recv, send, group=mesh.group(ax))
    acc = None
    for j in range(n):
        p = recv[j * nbytes:(j + 1) * nbytes].view(x.dtype).reshape(
            x.shape).to(x.device)
        acc = p.to(dtype or x.dtype) if acc is None else acc + p.to(acc.dtype)
    return acc


def _all_reduce(x: torch.Tensor, mesh: ProcessMesh,
                axes: str | Sequence[str], op: "dist.ReduceOp") -> torch.Tensor:
    ax = mesh.present(axes)
    if not ax:
        return x
    w = _host(mesh, x)
    w = w if _staged(mesh, x) else w.clone()
    SENT["calls"] += 1
    SENT["bytes"] += w.numel() * w.element_size()
    dist.all_reduce(w, op=op, group=mesh.group(ax))
    return w.to(x.device)


def psum_int32(x: torch.Tensor, mesh: ProcessMesh,
               axes: str | Sequence[str]) -> torch.Tensor:
    """The int32 sum of ``x`` over ``axes`` (exact in any order)."""
    if x.dtype != torch.int32:
        raise TypeError(f"psum_int32 takes int32, got {x.dtype}")
    return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh: ProcessMesh,
         axes: str | Sequence[str]) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``axes``."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MAX)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: ProcessMesh,
                axis: str) -> torch.Tensor:
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return reduce_over(g.contiguous(), ctx.mesh, ctx.axis), None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: ProcessMesh,
                axis: str) -> torch.Tensor:
        return reduce_over(x, mesh, axis)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None, None


def enter(x: torch.Tensor, mesh: ProcessMesh,
          axis: str = "model") -> torch.Tensor:
    """Identity forward; backward sums the cotangent over ``axis`` in
    rank order (a replicated input read by rank-local work)."""
    if not mesh.present(axis):
        return x
    return _Enter.apply(x, mesh, axis)


def combine(x: torch.Tensor, mesh: ProcessMesh,
            axis: str = "model") -> torch.Tensor:
    """Sum over ``axis`` in rank order forward; identity backward (the
    per-token combine of rank-local experts)."""
    if not mesh.present(axis):
        return x
    return _Combine.apply(x, mesh, axis)
