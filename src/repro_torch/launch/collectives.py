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
* ``all_to_all`` sends ``chunks[j]`` to the j-th rank along the axes and
  returns what each rank sent this one, in rank order;
* ``softmax_combine`` merges attention's softmax partials ``(m, l, o)``
  over the axes (a sequence-sharded KV cache), in rank order in f32;
  ``argmax_over`` is the argmax of values split over the axes, the
  lowest global index of a tie (``jnp.argmax``'s rule);
* ``enter`` and ``combine`` are the two ``torch.autograd.Function``s of
  expert and tensor parallelism (``models/moe``, Megatron's f and g):
  *enter* is the identity forward and sums the cotangent over the axis
  backward (each rank's work holds only its share of it); *combine*
  sums over the axis forward and is the identity backward;
* ``gather_seq`` and ``scatter_seq`` are their sequence-parallel
  counterparts over a sequence split in chunks along the axis
  (``seq_bounds``): *gather_seq* all-gathers the chunks forward and
  reduce-scatters the cotangent backward (or, with ``partial=False``,
  keeps its own chunk of a cotangent every rank holds whole);
  *scatter_seq* reduce-scatters forward (or, with ``reduce=False``,
  keeps its chunk of a value every rank holds whole) and all-gathers
  the cotangent backward.  A sequence that does not split evenly is
  zero-padded to whole chunks for the collective and trimmed after, as
  GSPMD pads; the last ranks' chunks are then short or empty;
* ``gather_lanes`` is *gather_seq* over the last dim split over
  ``model`` in equal blocks (tensor parallelism's lanes): the rank's
  block all-gathered in rank order forward, the cotangent summed over
  ``model`` in rank order in f32 and the rank's block kept backward;
* ``gather_blocks`` makes several tensors whole along ``model`` from
  every rank's equal blocks of each (the serve steps' recurrent state),
  in one all-gather of one f32 buffer.

gloo takes host tensors: a card's tensor is copied to pinned host
memory before a gloo collective and back after it, explicitly
(``_host``); NCCL takes it in place.  An all-gather moves bytes (every dtype, bf16 too, on
every backend).  Along axes of one rank every function is
the identity, with no process group needed.  ``SENT`` counts the
collectives a rank takes part in and the bytes it contributes to them
(an all-to-all: the chunks it sends to other ranks), ``GATHERS`` its
all-gathers by the axes they run along (``reset_sent`` zeroes both).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Axes, ProcessMesh

SENT = {"calls": 0, "bytes": 0}
# all-gathers a rank takes part in, by the axes they run along
GATHERS: Dict[Axes, int] = {}


def reset_sent() -> None:
    SENT.update(calls=0, bytes=0)
    GATHERS.clear()


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
    GATHERS[ax] = GATHERS.get(ax, 0) + 1
    parts = [_like(w, _staged(mesh, x)) for _ in range(mesh.axis_size(ax))]
    dist.all_gather(parts, w, group=mesh.group(ax))
    return [p.view(x.dtype).reshape(x.shape).to(x.device) for p in parts]


def gather_cat(x: torch.Tensor, mesh: ProcessMesh,
               axes: str | Sequence[str], dim: int) -> torch.Tensor:
    """The shards of ``x`` along ``axes`` concatenated on ``dim``."""
    parts = all_gather_shards(x, mesh, axes)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def gather_blocks(parts: Dict[str, torch.Tensor], dims: Dict[str, int],
                  mesh: ProcessMesh) -> Dict[str, torch.Tensor]:
    """Each ``parts[k]`` whole from every rank's block of it along
    ``dims[k]``, in rank order over ``model``; each holds the same count
    of units (lanes, heads) along its dim.  One all-gather of one f32
    buffer: a float of f32 or narrower widens and narrows back exactly."""
    if not mesh.present("model"):
        return dict(parts)
    front = {k: parts[k].movedim(d, 0) for k, d in dims.items()}
    n = next(iter(front.values())).shape[0]
    whole = gather_cat(torch.cat([t.reshape(n, -1).to(torch.float32)
                                  for t in front.values()], dim=1),
                       mesh, "model", 0)
    out, c = {}, 0
    for k, t in front.items():
        w = t[0].numel()
        out[k] = (whole[:, c:c + w].reshape(-1, *t.shape[1:]).to(t.dtype)
                  .movedim(0, dims[k]).contiguous())
        c += w
    return out


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
    added in rank order in ``dtype`` (default the chunks'): an
    ``all_to_all``, then the adds."""
    acc = None
    for p in all_to_all(chunks, mesh, axes):
        acc = p.to(dtype or p.dtype) if acc is None else acc + p.to(acc.dtype)
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


def all_to_all(chunks: Sequence[torch.Tensor], mesh: ProcessMesh,
               axes: str | Sequence[str]) -> List[torch.Tensor]:
    """``chunks[j]`` goes to the j-th rank along ``axes`` (row-major);
    returns the chunk each rank sent this one, in rank order.  Every
    rank passes chunks of one shape and dtype; they cross as their bytes
    in one flat buffer (gloo takes only the single-tensor all-to-all)."""
    ax: Axes = mesh.present(axes)
    n = mesh.axis_size(ax)
    if len(chunks) != n:
        raise ValueError(f"{len(chunks)} chunks for {n} ranks along {ax}")
    x = chunks[0]
    if not ax:
        return [x]
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
    return [recv[j * nbytes:(j + 1) * nbytes].view(x.dtype).reshape(
        x.shape).to(x.device) for j in range(n)]


def softmax_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                    mesh: ProcessMesh, axes: str | Sequence[str] = "model"
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax partials over a split key axis merged over ``axes``: each
    rank's running max ``m`` (...), denominator ``l`` (...) and
    unnormalised output ``o`` (..., d), f32, all-gathered in one buffer;
    then ``m = max_r m_r`` and ``l``, ``o`` summed in rank order in f32
    with weights ``exp(m_r - m)``.  Every rank gets the same bits."""
    f32 = torch.float32
    packed = torch.cat([m.to(f32)[..., None], l.to(f32)[..., None],
                        o.to(f32)], dim=-1)
    parts = all_gather_shards(packed, mesh, axes)
    mx = parts[0][..., 0]
    for p in parts[1:]:
        mx = torch.maximum(mx, p[..., 0])
    l_acc = o_acc = None
    for p in parts:
        w = torch.exp(p[..., 0] - mx)
        lw, ow = p[..., 1] * w, p[..., 2:] * w[..., None]
        l_acc = lw if l_acc is None else l_acc + lw
        o_acc = ow if o_acc is None else o_acc + ow
    return mx, l_acc, o_acc


def argmax_over(x: torch.Tensor, mesh: ProcessMesh,
                axes: str | Sequence[str] = "model") -> torch.Tensor:
    """The global index (int64) of the maximum over the last dim of
    values split over ``axes`` in equal blocks (rank j of them holds
    block j): the maximum through ``pmax`` (exact), then the lowest
    global index among the ranks that hold it, as ``jnp.argmax`` breaks
    ties."""
    n = x.shape[-1]
    idx = torch.argmax(x, dim=-1)        # the first index of a local tie
    val = torch.gather(x, -1, idx[..., None])[..., 0]
    top = pmax(val, mesh, axes)
    idx = idx + mesh.index_over(axes) * n
    big = torch.full_like(idx, n * mesh.axis_size(axes))
    return _all_reduce(torch.where(val == top, idx, big), mesh, axes,
                       dist.ReduceOp.MIN)


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


def seq_bounds(n: int, mesh: ProcessMesh,
               axis: str = "model") -> Tuple[int, int, int]:
    """(lo, hi, c): this rank's chunk ``[lo, hi)`` of ``n`` positions
    split over ``axis`` in chunks of ``c = ceil(n / ranks)``."""
    m = mesh.axis_size(axis)
    c = -(-n // m)
    lo = min(mesh.index_over(axis) * c, n)
    return lo, min(lo + c, n), c


def _pad(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` zero-padded on ``dim`` to length ``n``."""
    short = n - x.shape[dim]
    if not short:
        return x.contiguous()
    shape = list(x.shape)
    shape[dim] = short
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _gather_chunks(x: torch.Tensor, mesh: ProcessMesh, axis: str, dim: int,
                   n: int) -> torch.Tensor:
    """Every rank's chunk of ``n`` positions on ``dim``, concatenated."""
    parts = all_gather_shards(_pad(x, dim, seq_bounds(n, mesh, axis)[2]),
                              mesh, axis)
    return torch.cat(parts, dim=dim).narrow(dim, 0, n)


def _scatter_chunks(x: torch.Tensor, mesh: ProcessMesh, axis: str,
                    dim: int, reduce: bool) -> torch.Tensor:
    """This rank's chunk of ``x``'s positions on ``dim``: of the sum over
    ``axis`` (rank order, f32, cast back) when ``reduce``, else of
    ``x`` itself."""
    lo, hi, c = seq_bounds(x.shape[dim], mesh, axis)
    if not reduce:
        return x.narrow(dim, lo, hi - lo).contiguous()
    m = mesh.axis_size(axis)
    x = _pad(x, dim, m * c)
    acc = reduce_scatter_over([x.narrow(dim, j * c, c) for j in range(m)],
                              mesh, axis, torch.float32)
    return acc.narrow(dim, 0, hi - lo).to(x.dtype)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: ProcessMesh, axis: str,
                dim: int, n: int, partial: bool) -> torch.Tensor:
        ctx.args = (mesh, axis, dim, partial)
        return _gather_chunks(x, mesh, axis, dim, n)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        mesh, axis, dim, partial = ctx.args
        return (_scatter_chunks(g, mesh, axis, dim, partial), None, None,
                None, None, None)


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: ProcessMesh, axis: str,
                dim: int, reduce: bool) -> torch.Tensor:
        ctx.args = (mesh, axis, dim, x.shape[dim])
        return _scatter_chunks(x, mesh, axis, dim, reduce)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        mesh, axis, dim, n = ctx.args
        return _gather_chunks(g, mesh, axis, dim, n), None, None, None, None


def gather_seq(x: torch.Tensor, mesh: ProcessMesh, n: int, *,
               axis: str = "model", dim: int = 1,
               partial: bool = True) -> torch.Tensor:
    """The whole sequence of ``n`` positions on ``dim`` from this rank's
    chunk ``x`` (``seq_bounds``).  Backward: the cotangent summed over
    ``axis`` in rank order in f32, this rank's chunk of it (each rank's
    work held only a share of it: tensor parallelism); with
    ``partial=False`` this rank's chunk of a cotangent every rank holds
    whole."""
    if not mesh.present(axis):
        return x
    return _GatherSeq.apply(x, mesh, axis, dim, n, partial)


def scatter_seq(x: torch.Tensor, mesh: ProcessMesh, *, axis: str = "model",
                dim: int = 1, reduce: bool = True) -> torch.Tensor:
    """This rank's chunk (``seq_bounds``) of the sum of ``x`` over
    ``axis``, added in rank order in f32 and cast back to ``x``'s dtype
    (a tensor-parallel partial); with ``reduce=False``, of ``x`` itself
    (a value every rank holds whole).  Backward: the chunks' cotangents
    all-gathered."""
    if not mesh.present(axis):
        return x
    return _ScatterSeq.apply(x, mesh, axis, dim, reduce)


def gather_lanes(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """The whole last dim, split over ``model`` in equal blocks, from this
    rank's block ``x``, in rank order.  Backward: the cotangent summed
    over ``model`` in rank order in f32, this rank's block of it (the
    whole was read by rank-local work)."""
    if not mesh.present("model"):
        return x
    return _GatherSeq.apply(x, mesh, "model", x.dim() - 1,
                            x.shape[-1] * mesh.axis_size("model"), True)
