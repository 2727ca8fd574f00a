"""Public entry for the fused KAN layer, dispatched on the tensor's device.

Counterpart of ``repro/kernels/kan_fused/ops.py``.  A CPU tensor runs
the plain version (``ref.kan_fused_v2_ref``, ``ref.kan_fused_v1_ref`` for
version 1, or ``ref.kan_fused_v2_q8_ref`` for int8 codes); a CUDA tensor
launches the hand-written kernel for its dtype -- f32:
``csrc/kan_fused.cu`` (``csrc/kan_fused_v1.cu`` at version 1); bf16:
``csrc/kan_fused_bf16.cu`` (``csrc/kan_fused_v1_bf16.cu``); int8 codes:
``csrc/kan_fused_q8.cu`` -- or raises.  There is no fallback from a
kernel to its plain version.  f32 and bf16 layers take ``out_dtype``, as
the JAX ``kan_linear`` does: x's dtype (the default) or f32, the bf16
kernels' f32 accumulator unrounded.

Four kernels run one body (``csrc/kan_split.cuh``); the bf16 version-2
kernel runs a tensor-core body (``csrc/kan_mma.cuh``) on the same knob
checks and feature split.  All five take their knobs ``(bm, bi, bn)`` at
launch time: bm rows x bn outputs a block, bi input features a block
walk.  ``resolve_blocks`` picks them as the JAX
one does, at either version: explicit ``blocks=`` > autotune-cache hit
for (kernel ``kan_fused_v{version}``, shape bucket, dtype, card) > a
default by batch bucket; the wrappers never search
(``autotune.tune_kan_fused`` does, and ``launch/serve.py`` runs it under
``REPRO_TORCH_AUTOTUNE=1``).  No knob changes a bit of the output: the
summation order is fixed by the layer alone.  A knob the kernel does not
take raises, on the CPU too.

Weights keep the JAX package's layouts: ``w_b`` (n_in, n_out), ``t``
(n_in, G+K, n_out), ``t_flat`` (n_in*nbk, n_out) feature-major, and the
fused ``wt`` (n_in*(nbk+1), n_out) with the silu row first per feature.

``kan_fused_v2`` has a gradient at f32 (``KanFusedV2``, taken only when
grad is enabled and x or wt requires it; ``kernels/grad.py``): the
forward is the kernel, and the backward rebuilds the fused activations
from the spline-basis kernel at order K and their derivatives from it at
order K - 1.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.splines import SplineSpec, locate_cell
from repro_torch.kernels import _build, autotune
from repro_torch.kernels.epilogue import resolve_out_dtype
from repro_torch.kernels.grad import grad_wanted, ieee_matmul, refuse_grad
from repro_torch.kernels.kan_fused.ref import (
    kan_fused_v1_ref,
    kan_fused_v2_q8_ref,
    kan_fused_v2_ref,
)
from repro_torch.kernels.spline_basis.ops import spline_basis
from repro_torch.utils import next_pow2

KERNEL = "kan_fused_v2"
KERNEL_V1 = "kan_fused_v1"
KERNEL_Q8 = "kan_fused_v2_q8"
# the _build kernel of each (version, x dtype) of the f32 and bf16 layers
KERNELS = {(2, torch.float32): KERNEL, (1, torch.float32): KERNEL_V1,
           (2, torch.bfloat16): "kan_fused_v2_bf16",
           (1, torch.bfloat16): "kan_fused_v1_bf16"}
DEFAULT_VERSION = 2

# The knobs the kernels take (csrc/kan_split.cuh checks the same): bm and
# bn from TILES with bm * bn <= max_tile(version); bi a multiple of PC, or
# >= n_in (every feature in one block).  PC fixes the summation order; no
# knob changes it.
PC = 32
TILES = (8, 16, 32, 64, 128)
MAX_TILE = 8192
MAX_SPLIT = 16                  # blocks a cluster along the features
PORTABLE_SPLIT = 8              # above it, at most half the shared memory
MAX_GRID_Y = 65535              # column tiles; row tiles go on grid.x
_MIN_THREADS = 128
_HDR_WORDS = 64
_ACT_STRIDE = PC * 8 + 4
_SMS = 132                      # the H100's SMs (default_blocks)

Blocks = Dict[str, int]


def max_tile(version: int = DEFAULT_VERSION) -> int:
    """The largest bm * bn: the version-1 kernel's two accumulator chains
    spill at 8 rows a thread, so it stops at 4 (half the tile)."""
    return MAX_TILE // 2 if version == 1 else MAX_TILE


def tile_rows(bm: int, bn: int) -> int:
    """Rows a compute thread owns at a bm x bn block tile."""
    return min(8, max(1, bm * bn // 1024))


def kernel_threads(bm: int, bn: int, dtype: torch.dtype = torch.float32,
                   version: int = DEFAULT_VERSION) -> int:
    """Threads a block: on ``kan_split.cuh``'s body one per TM rows x 4
    columns, at least 128 (the rest only stage); the bf16 version-2
    kernel (``kan_mma.cuh``) 256, or 512 from a 32 x 32 tile on, its SPU
    pass on all of them, its MMAs on at most 8 warps."""
    if dtype == torch.bfloat16 and version == 2:
        return 512 if bm * bn >= 1024 else 256
    return max(_MIN_THREADS, (bm // tile_rows(bm, bn)) * (bn // 4))


def split(n_in: int, bi: int) -> Tuple[int, int, int]:
    """(chunks of PC features, chunks a block walks, blocks a cluster
    along the features) for ``n_in`` features at knob ``bi``."""
    nchunks = -(-n_in // PC)
    cpb = max(1, nchunks) if bi >= n_in else bi // PC
    return nchunks, cpb, -(-nchunks // cpb) if nchunks else 1


def kernel_smem(bm: int, bi: int, bn: int, n_in: int, nbk: int,
                dtype: torch.dtype, version: int = DEFAULT_VERSION) -> int:
    """Dynamic shared memory, in bytes, a block of the kernel for
    ``dtype`` and ``version`` uses: weight and x buffers (two when a block
    walks several chunks), the staged (row, feature) values, a cluster
    member's chunk partials (two sets at version 1: the silu and the
    spline chain), and the raw weight and x elements int8 (a byte each)
    and bf16 (two) stage before they widen.  bf16 at version 1 widens its
    weights into one f32 buffer, its raw buffers taking the copies in
    flight, and reads x raw; bf16 at version 2 (``kan_mma.cuh``) widens
    nothing and writes a bf16 A tile for its MMAs."""
    _, cpb, nsplit = split(n_in, bi)
    rows = PC * (nbk + 1)
    stages = 2 if cpb > 1 else 1
    bf16 = dtype == torch.bfloat16
    if bf16 and version == 2:
        # kan_mma.cuh: the slot table, a cluster member's f32 chunk
        # partials (A-tile rows x bn), and `stages` raw bf16 weight buffers
        # (rows padded to an odd number of 16 B), x buffers (32 + 8 a row)
        # and bf16 A tiles (max(16, bm) rows of 32 * (nbk+1) + 8)
        arows = max(16, bm)
        return (4 * 32 + (4 * cpb * arows * bn if nsplit > 1 else 0)
                + 2 * stages * (rows * (bn + (16 if bn == 8 else 8))
                                + bm * (PC + 8) + arows * (rows + 8)))
    chains = 2 if version == 1 else 1
    words = (_HDR_WORDS + (1 if bf16 else stages) * rows * bn
             + (0 if bf16 else stages) * bm * PC + bm * _ACT_STRIDE
             + (chains * cpb * bm * bn if nsplit > 1 else 0))
    raw = {torch.int8: 1, torch.bfloat16: 2}.get(dtype, 0)
    return 4 * words + raw * stages * (rows * bn + bm * PC)


def check_blocks(blocks: Blocks, n_in: int, n_out: int, nbk: int,
                 dtype: torch.dtype, version: int = DEFAULT_VERSION) -> None:
    """Raise ``ValueError`` unless the kernel for ``dtype`` and
    ``version`` takes ``blocks`` at this layer's widths."""
    bm, bi, bn = (blocks[k] for k in ("bm", "bi", "bn"))
    what = f"kan_fused blocks (bm={bm}, bi={bi}, bn={bn})"
    if min(bm, bi, bn) <= 0:
        raise ValueError(f"{what}: every knob must be positive")
    if bm not in TILES or bn not in TILES:
        raise ValueError(f"{what}: the kernel takes bm and bn in {TILES}")
    if bm * bn > max_tile(version):
        raise ValueError(f"{what}: bm * bn exceeds {max_tile(version)} at "
                         f"version {version}")
    if bi % PC and bi < n_in:
        raise ValueError(f"{what}: bi must be a multiple of {PC} or cover "
                         f"all {n_in} features")
    _, _, nsplit = split(n_in, bi)
    if nsplit > MAX_SPLIT:
        raise ValueError(f"{what}: {nsplit} blocks a cluster exceed "
                         f"{MAX_SPLIT} at n_in={n_in}")
    smem = kernel_smem(bm, bi, bn, n_in, nbk, dtype, version)
    if smem > autotune.MAX_SMEM_BYTES:
        raise ValueError(f"{what}: {smem} bytes of shared memory exceed "
                         f"{autotune.MAX_SMEM_BYTES} at nbk={nbk}")
    if nsplit > PORTABLE_SPLIT and 2 * smem > autotune.MAX_SMEM_BYTES:
        raise ValueError(f"{what}: a cluster of {nsplit} blocks needs two "
                         f"blocks an SM, {smem} bytes each do not fit")
    if -(-n_out // bn) > MAX_GRID_Y:
        raise ValueError(f"{what}: n_out={n_out} needs more than "
                         f"{MAX_GRID_Y} column tiles")


def default_blocks(B: int, n_in: int, n_out: int, nbk: int,
                   dtype: torch.dtype,
                   version: int = DEFAULT_VERSION) -> Blocks:
    """The knobs a launch takes when none is given or cached (the fastest
    candidates at vikin's KAN layers at B = 8 and 8192 on an H100): 8 or
    16 rows x 8 outputs at serving buckets, with the features split over
    a cluster of up to 16 blocks until the grid holds about two blocks an
    SM; 32 x 32 tiles at large batches, where a grid of at least one wave
    walks every feature in one block (a split only adds the combine).
    The bf16 version-2 kernel (tensor cores) evaluates every (row,
    feature) once a column tile, so at large batches its bn covers n_out
    (up to 128) with 32 rows a block, 64 from bn = 64 on (at most B
    rounded up to a power of two), and it splits the features only below
    half a wave of tiles.  bi is a power of two
    (an autotune candidate); the tiles halve where the shared memory
    would not fit."""
    mma = dtype == torch.bfloat16 and version == 2 and B > 16
    bm = 8 if B <= 8 else 16 if B <= 16 else 32
    bn = min(8 if B <= 16 else 32, max(8, next_pow2(n_out)))
    if mma:
        bn = min(128, max(8, next_pow2(n_out)))
        bm = min(32 if bn <= 32 else 64, next_pow2(B))
    wave = _SMS // 2 if mma else _SMS
    nchunks = max(1, -(-n_in // PC))
    while True:
        tiles = -(-B // bm) * -(-n_out // bn)
        want = 1 if tiles >= wave else min(MAX_SPLIT, nchunks,
                                           -(-2 * _SMS // tiles))
        knob = {"bm": bm, "bi": PC * next_pow2(-(-nchunks // want)),
                "bn": bn}
        try:
            check_blocks(knob, n_in, n_out, nbk, dtype, version)
            return knob
        except ValueError:
            if bm == 8 and bn == 8:
                raise
        if bn > 8:
            bn //= 2
        else:
            bm //= 2


def _as_blocks(blocks: Sequence[int]) -> Blocks:
    bm, bi, bn = blocks
    return {"bm": int(bm), "bi": int(bi), "bn": int(bn)}


def resolve_blocks(B: int, n_in: int, n_out: int, nbk: int,
                   dtype: torch.dtype,
                   blocks: Optional[Sequence[int]] = None,
                   version: int = DEFAULT_VERSION,
                   device: torch.device | str = "cuda") -> Blocks:
    """(bm, bi, bn) for the kernel of ``dtype`` and ``version``: explicit >
    cached (kernel ``kan_fused_v{version}``; at version 2 the dtype tells
    f32 from int8) > default by batch bucket, checked against what the
    kernel takes."""
    return dict(zip(("bm", "bi", "bn"), _knobs(B, n_in, n_out, nbk, dtype,
                                               blocks, device, version)))


def _knobs(B: int, n_in: int, n_out: int, nbk: int, dtype: torch.dtype,
           blocks: Optional[Sequence[int]], device: torch.device | str,
           version: int = DEFAULT_VERSION) -> Tuple[int, int, int]:
    """``resolve_blocks`` as a tuple; without ``blocks`` the answer for an
    exact shape is remembered in ``autotune.RESOLVED`` (dropped with the
    cache's other answers on a store, clear or new cache), so a served
    batch pays one dict lookup."""
    if blocks is not None:
        knob = _as_blocks(blocks)
        check_blocks(knob, n_in, n_out, nbk, dtype, version)
        return knob["bm"], knob["bi"], knob["bn"]
    kernel = KERNEL_V1 if version == 1 else KERNEL
    key = autotune.memo_key(kernel, B, n_in, n_out, nbk, dtype, device)
    knobs = autotune.RESOLVED.get(key)
    if knobs is None:
        knob = (autotune.cached_blocks(kernel, (B, n_in, n_out, nbk), dtype,
                                       device)
                or default_blocks(B, n_in, n_out, nbk, dtype, version))
        check_blocks(knob, n_in, n_out, nbk, dtype, version)
        knobs = autotune.RESOLVED[key] = knob["bm"], knob["bi"], knob["bn"]
    return knobs


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


def kernel_dtype(x: torch.Tensor) -> Tuple[torch.dtype, str]:
    """(operand dtype, what) of the f32 or bf16 kernel ``x`` selects: bf16
    for a bf16 x, else f32 (any other dtype is then refused as not f32)."""
    if x.dtype == torch.bfloat16:
        return torch.bfloat16, "this kernel is bf16 only"
    return torch.float32, "this kernel is f32 only"


def _check_operands(fn: str, x: torch.Tensor,
                    weights: Sequence[Tuple[str, torch.Tensor, int]],
                    slot_of: torch.Tensor, spec: SplineSpec,
                    operands: Sequence[Tuple[str, torch.Tensor, torch.dtype]],
                    what: str) -> Tuple[int, int, int]:
    """(B, n_in, n_out) of one layer call; raises on a shape, device,
    dtype or layout the kernel does not take.  ``weights`` holds (name,
    tensor, rows per input feature) of each (rows, n_out) weight array."""
    if x.dim() != 2:
        raise ValueError(f"{fn} takes (B, n_in) x, got {tuple(x.shape)}")
    B, n_in = x.shape
    for name, t, dtype in operands:
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype} "
                            f"({what})")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    n_out = weights[0][1].shape[-1] if weights[0][1].dim() == 2 else -1
    for name, w, per_feature in weights:
        if tuple(w.shape) != (n_in * per_feature, n_out):
            raise ValueError(f"{fn}: {name} has shape {tuple(w.shape)}, "
                             f"expected ({n_in * per_feature}, {n_out})")
    if slot_of.shape != (spec.n_bases,):
        raise ValueError(f"{fn}: slot_of has shape "
                         f"{tuple(slot_of.shape)}, expected ({spec.n_bases},)")
    return B, n_in, n_out


def kan_fused_v2(x: torch.Tensor, wt: torch.Tensor, spec: SplineSpec,
                 kb: Tuple[int, ...],
                 slot_of: Optional[torch.Tensor] = None, *,
                 blocks: Optional[Sequence[int]] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One KAN layer on (B, n_in) x against the fused ``wt``, f32 or bf16
    (both of one dtype), f32 accumulation, ``out_dtype`` out (x's dtype
    by default, or f32).

    ``slot_of`` is ``slot_table(kb, ...)`` on the device; layers build it
    once and pass it, else it is built here.  ``blocks`` overrides the
    kernel's (bm, bi, bn); None consults the autotune cache before the
    defaults.
    """
    dtype, what = kernel_dtype(x)
    out_dtype = resolve_out_dtype("kan_fused_v2", x, out_dtype)
    if grad_wanted(x, wt):
        if dtype != torch.float32 or out_dtype != torch.float32:
            refuse_grad("kan_fused_v2", "at bf16")
        return KanFusedV2.apply(x, wt, spec, tuple(kb), slot_of, blocks)
    if x.device.type == "cpu":
        if blocks is not None:
            check_blocks(_as_blocks(blocks), x.shape[-1], wt.shape[-1],
                         len(kb), dtype)
        return kan_fused_v2_ref(x, wt, spec, kb, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"kan_fused_v2: no kernel for device {x.device}")
    if slot_of is None:
        slot_of = slot_table(kb, spec.n_bases, x.device)
    nbk = len(kb)
    B, n_in, n_out = _check_operands(
        "kan_fused_v2", x, [("wt", wt, nbk + 1)], slot_of, spec,
        [("x", x, dtype), ("wt", wt, dtype),
         ("slot_of", slot_of, torch.int32)], what)
    out = torch.empty((B, n_out), dtype=out_dtype, device=x.device)
    if B == 0 or n_out == 0:
        return out
    bm, bi, bn = _knobs(B, n_in, n_out, nbk, dtype, blocks, x.device)
    # the bf16 kernels also take the output's dtype
    out_f32 = (() if dtype == torch.float32
               else (int(out_dtype == torch.float32),))
    _build.launch(
        KERNELS[2, dtype], x.data_ptr(), wt.data_ptr(), slot_of.data_ptr(),
        out.data_ptr(), B, n_in, n_out, nbk, spec.grid_size, spec.order,
        float(spec.x0), float(spec.clip_hi), float(spec.inv_h), *out_f32, bm,
        bi, bn, torch.cuda.current_stream(x.device).cuda_stream)
    return out


def _kept(v: torch.Tensor, spec: SplineSpec,
          kb: Tuple[int, ...]) -> torch.Tensor:
    """The kept-basis columns ``kb`` of (..., G+K) ``v``."""
    if tuple(kb) == tuple(range(spec.n_bases)):
        return v
    return v.index_select(-1, torch.as_tensor(kb, dtype=torch.long,
                                              device=v.device))


def fused_activations(x: torch.Tensor, spec: SplineSpec,
                      kb: Tuple[int, ...]) -> torch.Tensor:
    """The (B, n_in, nbk+1) ``[silu(x) | kept bases of clip(x)]`` rows
    the version-2 layer contracts against ``wt``, the bases from
    ``spline_basis`` (the kernel on a CUDA tensor)."""
    bases = _kept(spline_basis(spec.clip(x), spec), spec, kb)
    return torch.cat([(x * torch.sigmoid(x))[..., None], bases], dim=-1)


def fused_activation_grads(x: torch.Tensor, spec: SplineSpec,
                           kb: Tuple[int, ...]) -> torch.Tensor:
    """d/dx of ``fused_activations``, (B, n_in, nbk+1).

    On the uniform grid ``B_i' = (Bm_{i-1} - Bm_i) / h``, with ``Bm`` the
    order K - 1 basis (from ``spline_basis``; the cell indicator at K = 1)
    and zero outside its index range.  clip's derivative is 1 inside the
    grid, 0 outside and 1/2 at a bound, where JAX's ``jnp.clip`` splits
    the tie.
    """
    G, K = spec.grid_size, spec.order
    xc = spec.clip(x)
    if K > 1:
        lower = spline_basis(xc, SplineSpec(G, K - 1, spec.x0, spec.x1))
    else:
        cell = locate_cell(xc, spec)[0].long()
        lower = torch.nn.functional.one_hot(cell, G).to(x.dtype)
    lower = torch.nn.functional.pad(lower, (1, 1))          # Bm_{i-1} at i
    dbases = _kept((lower[..., :-1] - lower[..., 1:]) * spec.inv_h, spec, kb)
    inside = (x > spec.x0) & (x < spec.clip_hi)
    at_bound = (x == spec.x0) | (x == spec.clip_hi)
    dclip = inside.to(x.dtype) + 0.5 * at_bound.to(x.dtype)
    sig = torch.sigmoid(x)
    dsilu = sig + x * (sig * (1 - sig))
    return torch.cat([dsilu[..., None], dbases * dclip[..., None]], dim=-1)


class KanFusedV2(torch.autograd.Function):
    """The f32 version-2 layer with its gradient with respect to x and
    the fused ``wt``; ``fuse_wt`` is plain torch ops, so autograd carries
    ``d wt`` back to ``w_b`` and ``t``.

    ``d wt = A^T g`` over the (B, n_in*(nbk+1)) activations A
    (``fused_activations``, the order-K basis), and ``dx_p = sum_s
    dA_{p,s} (g wt^T)_{p,s}`` (``fused_activation_grads``, the order K - 1
    basis), each basis computed only when its gradient is asked for; the
    products in IEEE f32.  The backward runs no part of the plain version.
    """

    @staticmethod
    def forward(ctx, x, wt, spec, kb, slot_of, blocks):  # noqa: D102
        ctx.spec, ctx.kb = spec, kb
        ctx.save_for_backward(x, wt)
        return kan_fused_v2(x, wt, spec, kb, slot_of, blocks=blocks)

    @staticmethod
    def backward(ctx, g):  # noqa: D102
        x, wt = ctx.saved_tensors
        B, n_in = x.shape
        g = g.contiguous()
        dx = dwt = None
        if ctx.needs_input_grad[1]:
            a = fused_activations(x, ctx.spec, ctx.kb)
            dwt = ieee_matmul(a.reshape(B, -1).t(), g)
        if ctx.needs_input_grad[0]:
            gw = ieee_matmul(g, wt.t()).reshape(B, n_in, -1)
            dx = (fused_activation_grads(x, ctx.spec, ctx.kb) * gw).sum(-1)
        return dx, dwt, None, None, None, None


def kan_fused_v1(x: torch.Tensor, w_b: torch.Tensor, t_flat: torch.Tensor,
                 spec: SplineSpec, kb: Tuple[int, ...],
                 slot_of: Optional[torch.Tensor] = None, *,
                 blocks: Optional[Sequence[int]] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One KAN layer, version 1: (B, n_in) x against the unfused ``w_b``
    (n_in, n_out) and ``t_flat`` (n_in*nbk, n_out), all f32 or all bf16,
    the silu and spline branches summed apart and added once, ``out_dtype``
    out (x's dtype by default, or f32).  ``blocks`` overrides the kernel's
    (bm, bi, bn); None consults the autotune cache (kernel
    ``kan_fused_v1``) before the defaults."""
    dtype, what = kernel_dtype(x)
    out_dtype = resolve_out_dtype("kan_fused_v1", x, out_dtype)
    if grad_wanted(x, w_b, t_flat):
        refuse_grad("kan_fused_v1", "through the version-1 kernel")
    if x.device.type == "cpu":
        if blocks is not None:
            check_blocks(_as_blocks(blocks), x.shape[-1], w_b.shape[-1],
                         len(kb), dtype, version=1)
        return kan_fused_v1_ref(x, w_b, t_flat, spec, kb, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"kan_fused_v1: no kernel for device {x.device}")
    if slot_of is None:
        slot_of = slot_table(kb, spec.n_bases, x.device)
    nbk = len(kb)
    B, n_in, n_out = _check_operands(
        "kan_fused_v1", x, [("w_b", w_b, 1), ("t_flat", t_flat, nbk)],
        slot_of, spec,
        [("x", x, dtype), ("w_b", w_b, dtype), ("t_flat", t_flat, dtype),
         ("slot_of", slot_of, torch.int32)], what)
    out = torch.empty((B, n_out), dtype=out_dtype, device=x.device)
    if B == 0 or n_out == 0:
        return out
    bm, bi, bn = _knobs(B, n_in, n_out, nbk, dtype, blocks, x.device,
                        version=1)
    # the bf16 kernels also take the output's dtype
    out_f32 = (() if dtype == torch.float32
               else (int(out_dtype == torch.float32),))
    _build.launch(
        KERNELS[1, dtype], x.data_ptr(), w_b.data_ptr(), t_flat.data_ptr(),
        slot_of.data_ptr(), out.data_ptr(), B, n_in, n_out, nbk,
        spec.grid_size, spec.order, float(spec.x0), float(spec.clip_hi),
        float(spec.inv_h), *out_f32, bm, bi, bn,
        torch.cuda.current_stream(x.device).cuda_stream)
    return out


def kan_fused_v2_q8(x_q: torch.Tensor, wt_q: torch.Tensor,
                    slot_scales: torch.Tensor, spec: SplineSpec,
                    kb: Tuple[int, ...], x_scale: float,
                    slot_of: Optional[torch.Tensor] = None, *,
                    blocks: Optional[Sequence[int]] = None) -> torch.Tensor:
    """One int8 KAN layer: (B, n_in) int8 codes ``x_q`` against the int8
    fused ``wt_q``, dequantized on load by the static ``x_scale`` and the
    (nbk+1,) f32 ``slot_scales``; f32 accumulate, f32 out.  ``blocks``
    overrides the kernel's (bm, bi, bn)."""
    nbk = len(kb)
    if grad_wanted(slot_scales):
        refuse_grad("kan_fused_v2_q8", "through the int8 kernel")
    if slot_scales.shape != (nbk + 1,):
        raise ValueError(f"kan_fused_v2_q8: slot_scales has shape "
                         f"{tuple(slot_scales.shape)} for nbk={nbk}")
    if x_q.device.type == "cpu":
        if blocks is not None:
            check_blocks(_as_blocks(blocks), x_q.shape[-1], wt_q.shape[-1],
                         nbk, torch.int8)
        return kan_fused_v2_q8_ref(x_q, wt_q, slot_scales, spec, kb, x_scale)
    if x_q.device.type != "cuda":
        raise ValueError(f"kan_fused_v2_q8: no kernel for device "
                         f"{x_q.device}")
    if slot_of is None:
        slot_of = slot_table(kb, spec.n_bases, x_q.device)
    B, n_in, n_out = _check_operands(
        "kan_fused_v2_q8", x_q, [("wt_q", wt_q, nbk + 1)], slot_of, spec,
        [("x_q", x_q, torch.int8), ("wt_q", wt_q, torch.int8),
         ("slot_scales", slot_scales, torch.float32),
         ("slot_of", slot_of, torch.int32)], "this kernel takes int8 codes")
    out = torch.empty((B, n_out), dtype=torch.float32, device=x_q.device)
    if B == 0 or n_out == 0:
        return out
    bm, bi, bn = _knobs(B, n_in, n_out, nbk, torch.int8, blocks, x_q.device)
    _build.launch(
        KERNEL_Q8, x_q.data_ptr(), wt_q.data_ptr(), slot_scales.data_ptr(),
        slot_of.data_ptr(), out.data_ptr(), B, n_in, n_out, nbk,
        spec.grid_size, spec.order, float(x_scale), float(spec.x0),
        float(spec.clip_hi), float(spec.inv_h), bm, bi, bn,
        torch.cuda.current_stream(x_q.device).cuda_stream)
    return out


def kan_linear(x: torch.Tensor, w_b: torch.Tensor, t_flat: torch.Tensor,
               spec: SplineSpec, kb: Optional[Tuple[int, ...]] = None, *,
               version: int = DEFAULT_VERSION,
               blocks: Optional[Sequence[int]] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """phi(x) per Eq. 3 with two-stage sparsity; batch dims preserved.

    ``version`` selects the kernel generation: 2, one pass against the
    fused ``[w_b ; t]`` rows, or 1, the silu and spline branches against
    ``w_b`` and ``t_flat`` apart.  Functional form of the JAX
    ``kan_linear``: at version 2 it fuses the weights on every call;
    ``core/kan.KANLayer`` does so once instead.  ``blocks`` overrides the
    kernel's (bm, bi, bn) at either version; ``out_dtype`` (x's dtype by
    default, or f32) emits the f32 accumulator unrounded for bf16 x.
    """
    if version not in (1, 2):
        raise ValueError(f"kan_linear: version must be 1 or 2, got "
                         f"{version!r}")
    lead = x.shape[:-1]
    n_in = x.shape[-1]
    xf = x.reshape(-1, n_in).contiguous()
    kb = tuple(range(spec.n_bases)) if kb is None else tuple(kb)
    if version == 2:
        wt = fuse_wt(w_b, t_flat, len(kb))
        y = kan_fused_v2(xf, wt, spec, kb, blocks=blocks,
                         out_dtype=out_dtype)
    else:
        y = kan_fused_v1(xf, w_b.contiguous(), t_flat.contiguous(), spec, kb,
                         blocks=blocks, out_dtype=out_dtype)
    return y.reshape(*lead, w_b.shape[-1])


def kan_linear_q8(x_q: torch.Tensor, wt_q: torch.Tensor,
                  slot_scales: Sequence[float], spec: SplineSpec,
                  kb: Optional[Tuple[int, ...]] = None, *,
                  x_scale: float,
                  blocks: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Int8 phi(x) on the fused int8 ``wt_q``: dequantize on load, f32
    accumulate, f32 out; batch dims preserved.

    Functional form of the JAX ``kan_linear_q8``; ``slot_scales`` is the
    (nbk+1,) ``[s_wb, s_t[kb0], ...]`` vector; ``blocks`` overrides the
    kernel's (bm, bi, bn).
    """
    lead = x_q.shape[:-1]
    n_in = x_q.shape[-1]
    kb = tuple(range(spec.n_bases)) if kb is None else tuple(kb)
    ss = torch.as_tensor(np.asarray(slot_scales, np.float32),
                         device=x_q.device)
    y = kan_fused_v2_q8(x_q.reshape(-1, n_in).contiguous(), wt_q, ss, spec,
                        kb, x_scale, blocks=blocks)
    return y.reshape(*lead, wt_q.shape[-1])
