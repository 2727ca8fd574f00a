"""Public entry for the fused KAN layer, dispatched on the tensor's device.

Counterpart of ``repro/kernels/kan_fused/ops.py``.  A CPU tensor runs
the plain version (``ref.kan_fused_v2_ref``, ``ref.kan_fused_v1_ref`` for
version 1, or ``ref.kan_fused_v2_q8_ref`` for int8 codes); a CUDA tensor
launches the hand-written kernel for its operands' dtypes -- f32:
``csrc/kan_fused.cu`` (``csrc/kan_fused_v1.cu`` at version 1); bf16:
``csrc/kan_fused_bf16.cu`` (``csrc/kan_fused_v1_bf16.cu``); a bf16 x
against f32 fused weights (a bf16 model's, whose spline coefficients
``t`` are f32 as the reference's are): ``csrc/kan_fused_mixed.cu``;
int8 codes: ``csrc/kan_fused_q8.cu`` -- or raises.  A meta tensor (the
dry run, ``launch/dryrun``) gets the card's checks and tensors and no
launch; each call's work goes to the dry run's counts
(``kernels/work``).  There is no cast and no fallback from a kernel to
its plain version.  f32 and bf16 layers
take ``out_dtype``, as the JAX ``kan_linear`` does: x's dtype (the
default) or f32, the bf16 kernels' f32 accumulator unrounded.

Three kernels run one CUDA-core body (``csrc/kan_split.cuh``: v2 f32 and
int8, v1 f32); the three with a bf16 x -- bf16 rows of both versions,
and the mixed kernel's f32 rows, split into three exact bf16 planes --
run a tensor-core body (``csrc/kan_mma.cuh``) on the same knob checks and
feature split.  All six take their knobs ``(bm, bi, bn)`` at launch
time: bm rows x bn outputs a block, bi input features a block walk.
``resolve_blocks`` picks them as the JAX one does, at either version:
explicit ``blocks=`` > autotune-cache hit for (kernel
``kan_fused_v{version}``, or ``kan_fused_v2_mixed``, shape bucket,
dtype, card) > a default by batch bucket; the wrappers never search
(``autotune.tune_kan_fused`` does, and ``launch/serve.py`` runs it under
``REPRO_TORCH_AUTOTUNE=1``).  No knob changes a bit of the output: the
summation order is fixed by the layer alone.  A knob the kernel does not
take raises, on the CPU too.

Weights keep the JAX package's layouts: ``w_b`` (n_in, n_out), ``t``
(n_in, G+K, n_out), ``t_flat`` (n_in*nbk, n_out) feature-major, and the
fused ``wt`` (n_in*(nbk+1), n_out) with the silu row first per feature.

``kan_fused_v2`` has a gradient at f32 and at bf16 with a bf16 output
(``KanFusedV2``, taken only when grad is enabled and x or wt requires
it; ``kernels/grad.py``): the forward is the kernel, and the backward
rebuilds the fused activations from the spline-basis kernel at order K.
At f32 the derivatives come from that kernel at order K - 1 (B_i' =
(Bm_{i-1} - Bm_i) / h).  At bf16 the backward rounds where ``jax.grad``
of the reference's jnp layer rounds: the products' f32 results to bf16,
the silu branch's f32 cotangent once, the spline branch's cotangent op
by op back through the de Boor recursion, again after the 1/h scale,
and the two branches' sum -- the bits of the reference's gradient on
the CPU.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.splines import INV_LUT, SplineSpec, locate_cell, silu
from repro_torch.kernels import _build, autotune, work
from repro_torch.kernels.epilogue import resolve_out_dtype
from repro_torch.kernels.grad import grad_wanted, ieee_matmul, refuse_grad
from repro_torch.kernels.kan_fused.ref import (
    kan_fused_v1_ref,
    kan_fused_v2_q8_ref,
    kan_fused_v2_ref,
)
from repro_torch.kernels.spline_basis.ops import spline_basis
from repro_torch.utils import next_pow2, one_hot

KERNEL = "kan_fused_v2"
KERNEL_V1 = "kan_fused_v1"
KERNEL_Q8 = "kan_fused_v2_q8"
KERNEL_MIXED = "kan_fused_v2_mixed"
# the _build kernel of each (version, x dtype, weight dtype) of the f32,
# bf16 and mixed layers; no other pair has a kernel
KERNELS = {(2, torch.float32, torch.float32): KERNEL,
           (1, torch.float32, torch.float32): KERNEL_V1,
           (2, torch.bfloat16, torch.bfloat16): "kan_fused_v2_bf16",
           (1, torch.bfloat16, torch.bfloat16): "kan_fused_v1_bf16",
           (2, torch.bfloat16, torch.float32): KERNEL_MIXED}
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


def _mma(dtype: torch.dtype) -> bool:
    """Whether x of ``dtype`` runs the tensor-core body: a bf16 x, against
    bf16 rows (either version) or f32 rows (``_planes``)."""
    return dtype == torch.bfloat16


def _planes(dtype: torch.dtype, wt_dtype: Optional[torch.dtype]) -> bool:
    """Whether x of ``dtype`` against weights of ``wt_dtype`` (None: the
    same) is the mixed kernel's: a bf16 x, f32 rows split into planes."""
    return dtype == torch.bfloat16 and wt_dtype == torch.float32


def max_tile(version: int = DEFAULT_VERSION,
             dtype: torch.dtype = torch.float32) -> int:
    """The largest bm * bn: the f32 version-1 kernel's two accumulator
    chains spill at 8 rows a thread on the CUDA-core body, so it stops at
    4 (half the tile); the bf16 version-1 kernel (tensor cores) takes the
    whole tile."""
    return (MAX_TILE // 2 if version == 1 and dtype != torch.bfloat16
            else MAX_TILE)


def tile_rows(bm: int, bn: int) -> int:
    """Rows a compute thread owns at a bm x bn block tile."""
    return min(8, max(1, bm * bn // 1024))


def kernel_threads(bm: int, bn: int, dtype: torch.dtype = torch.float32,
                   version: int = DEFAULT_VERSION,
                   wt_dtype: Optional[torch.dtype] = None) -> int:
    """Threads a block: on ``kan_split.cuh``'s body one per TM rows x 4
    columns, at least 128 (the rest only stage); the bf16-x kernels
    (``kan_mma.cuh``) 256, or 512 from a 32 x 32 tile on, their SPU pass
    on all of them, their MMAs on at most 8 warps -- except version 1 and
    the mixed kernel at a full 8192 tile, 256: at 8 n8 tiles a warp the
    two chains' accumulators, or the three planes' fragments beside one,
    need more registers than 512 threads leave."""
    if _mma(dtype):
        if ((version == 1 or _planes(dtype, wt_dtype))
                and max(16, bm) * bn >= MAX_TILE):
            return 256
        return 512 if bm * bn >= 1024 else 256
    return max(_MIN_THREADS, (bm // tile_rows(bm, bn)) * (bn // 4))


def split(n_in: int, bi: int) -> Tuple[int, int, int]:
    """(chunks of PC features, chunks a block walks, blocks a cluster
    along the features) for ``n_in`` features at knob ``bi``."""
    nchunks = -(-n_in // PC)
    cpb = max(1, nchunks) if bi >= n_in else bi // PC
    return nchunks, cpb, -(-nchunks // cpb) if nchunks else 1


def kernel_smem(bm: int, bi: int, bn: int, n_in: int, nbk: int,
                dtype: torch.dtype, version: int = DEFAULT_VERSION,
                wt_dtype: Optional[torch.dtype] = None) -> int:
    """Dynamic shared memory, in bytes, a block of the kernel for x of
    ``dtype`` against weights of ``wt_dtype`` (None: the same) at
    ``version`` uses.  On ``kan_split.cuh``'s body: f32 weight buffers
    (two when a block walks several chunks) and as many f32 x buffers,
    the staged (row, feature) values, a cluster member's chunk partials
    (two sets at version 1: the silu and the spline chain), and the raw
    int8 weights and x (a byte each) staged before they widen.  The
    bf16-x kernels (``kan_mma.cuh``) write a bf16 A tile for their MMAs;
    the mixed kernel stages its f32 rows and splits them into a bf16
    plane tile."""
    _, cpb, nsplit = split(n_in, bi)
    rows = PC * (nbk + 1)
    stages = 2 if cpb > 1 else 1
    chains = 2 if version == 1 else 1
    if _mma(dtype):
        # kan_mma.cuh: the slot table, a cluster member's f32 chunk
        # partials (A-tile rows x bn, a set a chain), `stages` x buffers
        # (32 + 8 a row), bf16 A tiles (max(16, bm) rows of 32 * (nbk+1)
        # + 8) and B tiles: for bf16 rows `stages` of each, the raw rows
        # padded to an odd number of 16 B; for f32 rows `stages` f32 row
        # buffers and one A tile and one plane tile, whose rows hold hi,
        # mid and lo (3 bn, padded by 8 save at bn = 8)
        arows = max(16, bm)
        x_tile, a_tile = 2 * bm * (PC + 8), 2 * arows * (rows + 8)
        if _planes(dtype, wt_dtype):
            tiles = (stages * (4 * rows * bn + x_tile) + a_tile
                     + 2 * rows * (3 * bn + (0 if bn == 8 else 8)))
        else:
            tiles = stages * (2 * rows * (bn + (16 if bn == 8 else 8))
                              + x_tile + a_tile)
        return (4 * 32 + (4 * chains * cpb * arows * bn if nsplit > 1 else 0)
                + tiles)
    raw = 1 if dtype == torch.int8 else 0
    words = (_HDR_WORDS + stages * rows * bn + stages * bm * PC
             + bm * _ACT_STRIDE
             + (chains * cpb * bm * bn if nsplit > 1 else 0))
    return 4 * words + stages * raw * (rows * bn + bm * PC)


def check_blocks(blocks: Blocks, n_in: int, n_out: int, nbk: int,
                 dtype: torch.dtype, version: int = DEFAULT_VERSION,
                 wt_dtype: Optional[torch.dtype] = None) -> None:
    """Raise ``ValueError`` unless the kernel for x of ``dtype`` against
    weights of ``wt_dtype`` (None: the same) at ``version`` takes
    ``blocks`` at this layer's widths."""
    bm, bi, bn = (blocks[k] for k in ("bm", "bi", "bn"))
    what = f"kan_fused blocks (bm={bm}, bi={bi}, bn={bn})"
    if min(bm, bi, bn) <= 0:
        raise ValueError(f"{what}: every knob must be positive")
    if bm not in TILES or bn not in TILES:
        raise ValueError(f"{what}: the kernel takes bm and bn in {TILES}")
    if bm * bn > max_tile(version, dtype):
        raise ValueError(f"{what}: bm * bn exceeds "
                         f"{max_tile(version, dtype)} at version {version}")
    if bi % PC and bi < n_in:
        raise ValueError(f"{what}: bi must be a multiple of {PC} or cover "
                         f"all {n_in} features")
    _, _, nsplit = split(n_in, bi)
    if nsplit > MAX_SPLIT:
        raise ValueError(f"{what}: {nsplit} blocks a cluster exceed "
                         f"{MAX_SPLIT} at n_in={n_in}")
    smem = kernel_smem(bm, bi, bn, n_in, nbk, dtype, version, wt_dtype)
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
                   version: int = DEFAULT_VERSION,
                   wt_dtype: Optional[torch.dtype] = None) -> Blocks:
    """The knobs a launch takes when none is given or cached (the fastest
    candidates at vikin's KAN layers at B = 8 and 8192 on an H100): 8 or
    16 rows x 8 outputs at serving buckets, with the features split over
    a cluster of up to 16 blocks until the grid holds about two blocks an
    SM; 32 x 32 tiles at large batches, where a grid of at least one wave
    walks every feature in one block (a split only adds the combine).
    The bf16-x kernels (tensor cores, the mixed one's f32 rows too)
    evaluate every (row, feature) once a column tile, so at large batches
    their bn covers n_out (up to 128) with 32 rows a block, 64 from bn =
    64 on and for the mixed kernel (at most B rounded up to a power of
    two), and it splits the features only below half a wave of tiles.  bi is a power of two (an
    autotune candidate); the tiles halve, bn first, where the shared
    memory would not fit (the mixed kernel's f32 rows and planes: 64 x 64
    at nbk = 5)."""
    mma = _mma(dtype) and B > 16
    bm = 8 if B <= 8 else 16 if B <= 16 else 32
    bn = min(8 if B <= 16 else 32, max(8, next_pow2(n_out)))
    if mma:
        bn = min(128, max(8, next_pow2(n_out)))
        # the mixed kernel splits a block's f32 rows once for all its rows
        bm = min(32 if bn <= 32 and not _planes(dtype, wt_dtype) else 64,
                 next_pow2(B))
    wave = _SMS // 2 if mma else _SMS
    nchunks = max(1, -(-n_in // PC))
    while True:
        tiles = -(-B // bm) * -(-n_out // bn)
        want = 1 if tiles >= wave else min(MAX_SPLIT, nchunks,
                                           -(-2 * _SMS // tiles))
        knob = {"bm": bm, "bi": PC * next_pow2(-(-nchunks // want)),
                "bn": bn}
        try:
            check_blocks(knob, n_in, n_out, nbk, dtype, version,
                         wt_dtype=wt_dtype)
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
                   device: torch.device | str = "cuda",
                   wt_dtype: Optional[torch.dtype] = None) -> Blocks:
    """(bm, bi, bn) for the kernel of x ``dtype``, weights ``wt_dtype``
    (None: the same) and ``version``: explicit > cached (kernel
    ``kan_fused_v{version}``, at version 2 the dtype telling f32, bf16
    and int8 apart; ``kan_fused_v2_mixed`` for a bf16 x against f32
    weights) > default by batch bucket, checked against what the kernel
    takes."""
    return dict(zip(("bm", "bi", "bn"), _knobs(B, n_in, n_out, nbk, dtype,
                                               blocks, device, version,
                                               wt_dtype)))


def cache_kernel(version: int, dtype: torch.dtype,
                 wt_dtype: Optional[torch.dtype] = None) -> str:
    """The autotune-cache kernel name of a layer's knobs."""
    if version == 1:
        return KERNEL_V1
    return KERNEL if wt_dtype in (None, dtype) else KERNEL_MIXED


def _knobs(B: int, n_in: int, n_out: int, nbk: int, dtype: torch.dtype,
           blocks: Optional[Sequence[int]], device: torch.device | str,
           version: int = DEFAULT_VERSION,
           wt_dtype: Optional[torch.dtype] = None) -> Tuple[int, int, int]:
    """``resolve_blocks`` as a tuple; without ``blocks`` the answer for an
    exact shape is remembered in ``autotune.RESOLVED`` (dropped with the
    cache's other answers on a store, clear or new cache), so a served
    batch pays one dict lookup."""
    if blocks is not None:
        knob = _as_blocks(blocks)
        check_blocks(knob, n_in, n_out, nbk, dtype, version,
                     wt_dtype=wt_dtype)
        return knob["bm"], knob["bi"], knob["bn"]
    kernel = cache_kernel(version, dtype, wt_dtype)
    key = autotune.memo_key(kernel, B, n_in, n_out, nbk, dtype, device)
    knobs = autotune.RESOLVED.get(key)
    if knobs is None:
        knob = autotune.cached_blocks(kernel, (B, n_in, n_out, nbk), dtype,
                                      device)
        if kernel == KERNEL_MIXED and knob is not None:
            # a mixed entry may come from the CUDA-core body this kernel
            # ran before its f32 rows were split into bf16 planes: one the
            # tensor-core body refuses is a miss, never launched, until
            # autotune.tune_kan_fused searches the shape again
            try:
                check_blocks(knob, n_in, n_out, nbk, dtype, version,
                             wt_dtype=wt_dtype)
            except ValueError:
                knob = None
        knob = knob or default_blocks(B, n_in, n_out, nbk, dtype, version,
                                      wt_dtype=wt_dtype)
        check_blocks(knob, n_in, n_out, nbk, dtype, version,
                     wt_dtype=wt_dtype)
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
    """One KAN layer on (B, n_in) x against the fused ``wt``, f32
    accumulation, ``out_dtype`` out (x's dtype by default, or f32).  On
    the card the pair (x, wt) picks the kernel: f32/f32, bf16/bf16, or a
    bf16 x against an f32 ``wt`` (a bf16 model's f32 spline rows, as
    ``fuse_wt`` promotes them); any other pair raises.

    ``slot_of`` is ``slot_table(kb, ...)`` on the device; layers build it
    once and pass it, else it is built here.  ``blocks`` overrides the
    kernel's (bm, bi, bn); None consults the autotune cache before the
    defaults.
    """
    dtype, what = kernel_dtype(x)
    out_dtype = resolve_out_dtype("kan_fused_v2", x, out_dtype)
    if grad_wanted(x, wt):
        return KanFusedV2.apply(x, wt, spec, tuple(kb), slot_of, blocks,
                                out_dtype)
    wt_dtype = (torch.float32 if dtype == torch.bfloat16
                and wt.dtype == torch.float32 else dtype)
    with work.kernel(KERNELS.get((2, dtype, wt_dtype), KERNEL),
                     lambda: work.kan_fused(
                         x.shape[0], x.shape[-1], wt.shape[-1], spec,
                         len(kb), x.dtype, wt.dtype, out_dtype)):
        return _kan_fused_v2(x, wt, spec, kb, slot_of, blocks, out_dtype,
                             dtype, wt_dtype, what)


def _kan_fused_v2(x: torch.Tensor, wt: torch.Tensor, spec: SplineSpec,
                  kb: Tuple[int, ...], slot_of: Optional[torch.Tensor],
                  blocks: Optional[Sequence[int]], out_dtype: torch.dtype,
                  dtype: torch.dtype, wt_dtype: torch.dtype,
                  what: str) -> torch.Tensor:
    """``kan_fused_v2``'s device branch: the plain version on the CPU,
    the kernel on the card, on meta the card's checks and tensors and no
    launch (``kernels/work``: the dry run)."""
    if x.device.type == "cpu":
        if blocks is not None:
            check_blocks(_as_blocks(blocks), x.shape[-1], wt.shape[-1],
                         len(kb), dtype, wt_dtype=wt_dtype)
        return kan_fused_v2_ref(x, wt, spec, kb, out_dtype)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"kan_fused_v2: no kernel for device {x.device}")
    if slot_of is None:
        slot_of = slot_table(kb, spec.n_bases, x.device)
    nbk = len(kb)
    if wt_dtype != dtype:
        what = "a bf16 x takes a bf16 or an f32 wt"
    B, n_in, n_out = _check_operands(
        "kan_fused_v2", x, [("wt", wt, nbk + 1)], slot_of, spec,
        [("x", x, dtype), ("wt", wt, wt_dtype),
         ("slot_of", slot_of, torch.int32)], what)
    out = torch.empty((B, n_out), dtype=out_dtype, device=x.device)
    if x.is_meta:
        if blocks is not None:
            check_blocks(_as_blocks(blocks), n_in, n_out, nbk, dtype,
                         wt_dtype=wt_dtype)
        return out
    if B == 0 or n_out == 0:
        return out
    bm, bi, bn = _knobs(B, n_in, n_out, nbk, dtype, blocks, x.device,
                        wt_dtype=wt_dtype)
    # the bf16-x kernels also take the output's dtype
    out_f32 = (() if dtype == torch.float32
               else (int(out_dtype == torch.float32),))
    _build.launch(
        KERNELS[2, dtype, wt_dtype], x.data_ptr(), wt.data_ptr(),
        slot_of.data_ptr(),
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
    s = silu(x.to(torch.float32)).to(x.dtype)       # f32 at bf16, as forward
    return torch.cat([s[..., None], bases], dim=-1)


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
        lower = one_hot(cell, G, x.dtype)
    lower = torch.nn.functional.pad(lower, (1, 1))          # Bm_{i-1} at i
    dbases = _kept((lower[..., :-1] - lower[..., 1:]) * spec.inv_h, spec, kb)
    sig = torch.sigmoid(x)
    dsilu = sig + x * (sig * (1 - sig))
    return torch.cat([dsilu[..., None], dbases * _clip_slope(x, spec)[..., None]],
                     dim=-1)


def _clip_slope(x: torch.Tensor, spec: SplineSpec) -> torch.Tensor:
    """d clip(x) / dx in x's dtype: 1 inside the bounds, 0 outside, 1/2 at
    a bound (JAX's ``jnp.clip`` splits the tie), the bounds rounded to
    x's dtype as the reference's are."""
    lo = torch.tensor(spec.x0, dtype=x.dtype, device=x.device)
    hi = torch.tensor(spec.clip_hi, dtype=x.dtype, device=x.device)
    inside = (x > lo) & (x < hi)
    at_bound = (x == lo) | (x == hi)
    return inside.to(x.dtype) + 0.5 * at_bound.to(x.dtype)


def _recursion_vjp_r(r: torch.Tensor, ct_vals: Sequence[torch.Tensor],
                     order: int) -> torch.Tensor:
    """The cotangent of r (the position in the cell, x's dtype) given the
    cotangents ``ct_vals`` of the K+1 local de Boor values: reverse mode
    through ``core/splines.bases_local``'s recursion, op by op in r's
    dtype, in the order ``jax.grad`` of the reference takes it (each
    level from the last, each iteration from the last; a knot
    difference's cotangents summed in the order they arrive, then the
    K left ones minus the K right ones)."""
    K = order
    d = [torch.tensor(float(i), dtype=r.dtype, device=r.device)
         for i in range(K)]
    right = [(d[i] + 1.0) - r for i in range(K)]
    left = [r + d[i] for i in range(K)]
    vals = [torch.ones_like(r)] + [torch.zeros_like(r) for _ in range(K)]
    temps = {}
    for j in range(1, K + 1):
        inv = torch.tensor(INV_LUT[j], dtype=r.dtype, device=r.device)
        saved = torch.zeros_like(r)
        for rr in range(j):
            temps[j, rr] = temp = vals[rr] * inv
            vals[rr] = saved + right[rr] * temp
            saved = left[j - rr - 1] * temp
        vals[j] = saved
    ct = list(ct_vals)
    ct_right: List[List[torch.Tensor]] = [[] for _ in range(K)]
    ct_left: List[List[torch.Tensor]] = [[] for _ in range(K)]
    for j in range(K, 0, -1):
        inv = torch.tensor(INV_LUT[j], dtype=r.dtype, device=r.device)
        ct_saved = ct[j]
        for rr in range(j - 1, -1, -1):
            temp = temps[j, rr]
            ct_left[j - rr - 1].append(ct_saved * temp)
            ct_right[rr].append(ct[rr] * temp)
            ct_temp = ct[rr] * right[rr] + ct_saved * left[j - rr - 1]
            ct_saved = ct[rr]
            ct[rr] = ct_temp * inv

    def total(terms: Sequence[torch.Tensor]) -> torch.Tensor:
        out = terms[0]
        for t in terms[1:]:
            out = out + t
        return out

    return (total([total(c) for c in ct_left])
            + -total([total(c) for c in ct_right]))


def _bf16_grads(x: torch.Tensor, wt: torch.Tensor, g: torch.Tensor,
                spec: SplineSpec, kb: Tuple[int, ...], need_x: bool,
                need_wt: bool) -> Tuple[Optional[torch.Tensor],
                                        Optional[torch.Tensor]]:
    """(dx, d wt) of the bf16 layer, in x's and wt's dtypes, as
    ``jax.grad`` of the reference's jnp layer takes them (bitwise on the
    CPU): f32 products of the widened operands rounded to the operand's
    dtype (``d wt`` against the activations of the spline-basis kernel;
    an f32 wt, which the plain version takes beside a bf16 x, keeps its
    f32 gradient, as the reference's promoted product does); the silu
    branch's cotangent
    in f32 from the rounded ``g wt^T``, rounded once; the spline
    branch's from the kept columns of ``g wt^T`` back through the de Boor
    recursion in bf16 (``_recursion_vjp_r``), widened, scaled by 1/h and
    rounded, times clip's slope; the two branches added in bf16."""
    B, n_in = x.shape
    bf16, f32 = torch.bfloat16, torch.float32
    gf = g.to(f32)
    dx = dwt = None
    if need_wt:
        a = fused_activations(x, spec, kb).reshape(B, -1).to(f32)
        dwt = ieee_matmul(a.t(), gf).to(wt.dtype)
    if need_x:
        gw = ieee_matmul(gf, wt.to(f32).t()).to(bf16).reshape(B, n_in, -1)
        xf = x.to(f32)
        sig = torch.sigmoid(xf)
        cs = gw[..., 0].to(f32)
        d_silu = (cs * sig + (xf * cs) * (sig * (1 - sig))).to(bf16)
        cell, r = locate_cell(spec.clip(x), spec)
        delta = (torch.as_tensor(kb, dtype=torch.int32, device=x.device)
                 - cell[..., None])
        zero = torch.zeros((), dtype=bf16, device=x.device)
        # the kept column holding local value j (at most one), else 0
        ct_vals = [torch.where(delta == j, gw[..., 1:], zero).sum(-1)
                   for j in range(spec.n_active)]
        dr = _recursion_vjp_r(r, ct_vals, spec.order)
        d_spline = (dr.to(f32) * spec.inv_h).to(bf16)
        dx = d_silu + d_spline * _clip_slope(x, spec)
    return dx, dwt


class KanFusedV2(torch.autograd.Function):
    """The version-2 layer (f32, or bf16 with a bf16 or an f32 output --
    a tensor-parallel partial, whose f32 cotangent holds the bf16
    output's values; bf16: ``_bf16_grads``) with its gradient with
    respect to x and the fused ``wt``; ``fuse_wt`` is plain torch ops, so autograd carries
    ``d wt`` back to ``w_b`` and ``t``.

    ``d wt = A^T g`` over the (B, n_in*(nbk+1)) activations A
    (``fused_activations``, the order-K basis), and ``dx_p = sum_s
    dA_{p,s} (g wt^T)_{p,s}`` (``fused_activation_grads``, the order K - 1
    basis), each basis computed only when its gradient is asked for; the
    products in IEEE f32.  The backward runs no part of the plain version.
    """

    @staticmethod
    def forward(ctx, x, wt, spec, kb, slot_of, blocks,
                out_dtype):  # noqa: D102
        ctx.spec, ctx.kb = spec, kb
        ctx.save_for_backward(x, wt)
        return kan_fused_v2(x, wt, spec, kb, slot_of, blocks=blocks,
                            out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):  # noqa: D102
        x, wt = ctx.saved_tensors
        B, n_in = x.shape
        g = g.contiguous()
        if x.dtype == torch.bfloat16:
            dx, dwt = _bf16_grads(x, wt, g, ctx.spec, ctx.kb,
                                  ctx.needs_input_grad[0],
                                  ctx.needs_input_grad[1])
            return dx, dwt, None, None, None, None, None
        dx = dwt = None
        if ctx.needs_input_grad[1]:
            a = fused_activations(x, ctx.spec, ctx.kb)
            dwt = ieee_matmul(a.reshape(B, -1).t(), g)
        if ctx.needs_input_grad[0]:
            gw = ieee_matmul(g, wt.t()).reshape(B, n_in, -1)
            dx = (fused_activation_grads(x, ctx.spec, ctx.kb) * gw).sum(-1)
        return dx, dwt, None, None, None, None, None


def kan_fused_v1(x: torch.Tensor, w_b: torch.Tensor, t_flat: torch.Tensor,
                 spec: SplineSpec, kb: Tuple[int, ...],
                 slot_of: Optional[torch.Tensor] = None, *,
                 blocks: Optional[Sequence[int]] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One KAN layer, version 1: (B, n_in) x against the unfused ``w_b``
    (n_in, n_out) and ``t_flat`` (n_in*nbk, n_out), all f32 or all bf16
    on the card (the plain version also takes the reference's f32
    ``t_flat`` beside a bf16 x), the silu and spline branches summed
    apart and added once, ``out_dtype`` out (x's dtype by default, or
    f32).  ``blocks`` overrides the kernel's (bm, bi, bn); None consults
    the autotune cache (kernel ``kan_fused_v1``) before the defaults."""
    dtype, what = kernel_dtype(x)
    out_dtype = resolve_out_dtype("kan_fused_v1", x, out_dtype)
    if grad_wanted(x, w_b, t_flat):
        refuse_grad("kan_fused_v1", "through the version-1 kernel")
    with work.kernel(KERNELS.get((1, dtype, dtype), KERNEL_V1),
                     lambda: work.kan_fused(
                         x.shape[0], x.shape[-1], w_b.shape[-1], spec,
                         len(kb), x.dtype, w_b.dtype, out_dtype)):
        return _kan_fused_v1(x, w_b, t_flat, spec, kb, slot_of, blocks,
                             out_dtype, dtype, what)


def _kan_fused_v1(x: torch.Tensor, w_b: torch.Tensor, t_flat: torch.Tensor,
                  spec: SplineSpec, kb: Tuple[int, ...],
                  slot_of: Optional[torch.Tensor],
                  blocks: Optional[Sequence[int]], out_dtype: torch.dtype,
                  dtype: torch.dtype, what: str) -> torch.Tensor:
    """``kan_fused_v1``'s device branch (``_kan_fused_v2``'s rules)."""
    if x.device.type == "cpu":
        if blocks is not None:
            check_blocks(_as_blocks(blocks), x.shape[-1], w_b.shape[-1],
                         len(kb), dtype, version=1)
        return kan_fused_v1_ref(x, w_b, t_flat, spec, kb, out_dtype)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"kan_fused_v1: no kernel for device {x.device}")
    if x.dtype == torch.bfloat16 and torch.float32 in (w_b.dtype,
                                                        t_flat.dtype):
        raise TypeError("kan_fused_v1: no version-1 kernel takes a bf16 x "
                        "against f32 weights (ROADMAP.md, queue 3); run "
                        "version 2, whose mixed kernel does")
    if slot_of is None:
        slot_of = slot_table(kb, spec.n_bases, x.device)
    nbk = len(kb)
    B, n_in, n_out = _check_operands(
        "kan_fused_v1", x, [("w_b", w_b, 1), ("t_flat", t_flat, nbk)],
        slot_of, spec,
        [("x", x, dtype), ("w_b", w_b, dtype), ("t_flat", t_flat, dtype),
         ("slot_of", slot_of, torch.int32)], what)
    out = torch.empty((B, n_out), dtype=out_dtype, device=x.device)
    if x.is_meta:
        if blocks is not None:
            check_blocks(_as_blocks(blocks), n_in, n_out, nbk, dtype,
                         version=1)
        return out
    if B == 0 or n_out == 0:
        return out
    bm, bi, bn = _knobs(B, n_in, n_out, nbk, dtype, blocks, x.device,
                        version=1)
    # the bf16 kernels also take the output's dtype
    out_f32 = (() if dtype == torch.float32
               else (int(out_dtype == torch.float32),))
    _build.launch(
        KERNELS[1, dtype, dtype], x.data_ptr(), w_b.data_ptr(),
        t_flat.data_ptr(),
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
    with work.kernel(KERNEL_Q8, lambda: work.kan_fused_q8(
            x_q.shape[0], x_q.shape[-1], wt_q.shape[-1], spec, nbk)):
        return _kan_fused_v2_q8(x_q, wt_q, slot_scales, spec, kb, x_scale,
                                slot_of, blocks)


def _kan_fused_v2_q8(x_q: torch.Tensor, wt_q: torch.Tensor,
                     slot_scales: torch.Tensor, spec: SplineSpec,
                     kb: Tuple[int, ...], x_scale: float,
                     slot_of: Optional[torch.Tensor],
                     blocks: Optional[Sequence[int]]) -> torch.Tensor:
    """``kan_fused_v2_q8``'s device branch (``_kan_fused_v2``'s rules)."""
    nbk = len(kb)
    if x_q.device.type == "cpu":
        if blocks is not None:
            check_blocks(_as_blocks(blocks), x_q.shape[-1], wt_q.shape[-1],
                         nbk, torch.int8)
        return kan_fused_v2_q8_ref(x_q, wt_q, slot_scales, spec, kb, x_scale)
    if x_q.device.type not in ("cuda", "meta"):
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
    if x_q.is_meta:
        if blocks is not None:
            check_blocks(_as_blocks(blocks), n_in, n_out, nbk, torch.int8)
        return out
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
