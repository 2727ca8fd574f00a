"""Public entry: pattern-sparse linear layer, dispatched on the device.

Counterpart of ``repro/kernels/pattern_matmul/ops.py``.  The static
m-of-4 compaction happens outside the kernels: ``pattern_linear`` gathers
the kept activation lanes and weight rows, then ``matmul_compact`` runs
the compact matmul with the fused ``act(acc + bias)`` epilogue -- the
plain version (``ref.matmul_compact_ref``) for a CPU tensor, the CUDA
kernel for its dtype for a CUDA tensor: ``csrc/pattern_matmul.cu`` (f32,
CUDA cores) or ``csrc/pattern_matmul_bf16.cu`` (bf16 tensor cores, f32
accumulation, bf16 or f32 out by ``out_dtype``); a meta tensor (the dry
run, ``launch/dryrun``) gets the card's checks and output and no launch,
its work counted by ``kernels/work``.  The int8 path is the
same with ``matmul_q8`` (``ref.matmul_q8_ref`` or
``csrc/pattern_matmul_q8.cu``), whose raw integer accumulator
``pattern_linear_q8`` scales with the shared ``scale_bias_act``.  There is
no fallback from a kernel to its plain version.

All three kernels take their tiles ``(bm, bk, bn)`` at launch time.
``resolve_blocks`` picks them as the JAX one does: explicit ``blocks=`` >
autotune-cache hit for (shape bucket, dtype, card) > a default by M
bucket; the wrappers never search (``autotune.tune_pattern_matmul``
does, and ``launch/serve.py`` runs it under ``REPRO_TORCH_AUTOTUNE=1``).
No knob changes a bit of the output (the kernels' notes say why).  A
knob the kernel does not take raises, on the CPU too.

``matmul_compact`` has a gradient at f32 with the ``relu`` and ``None``
epilogues (``MatmulCompact``, taken only when grad is enabled and an
operand requires it; ``kernels/grad.py``): the forward is the kernel,
the backward three IEEE f32 products in PyTorch ops.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.sparsity import PatternMask
from repro_torch.kernels import _build, autotune, work
from repro_torch.kernels.epilogue import (
    ACT_CODES,
    resolve_out_dtype,
    scale_bias_act,
)
from repro_torch.kernels.grad import grad_wanted, ieee_matmul, refuse_grad
from repro_torch.kernels.pattern_matmul.ref import (
    matmul_compact_ref,
    matmul_q8_ref,
)

KERNEL = "pattern_matmul"
KERNEL_Q8 = "pattern_matmul_q8"
KERNEL_BF16 = "pattern_matmul_bf16"

# The tiles each kernel takes (csrc/*.cu check the same), and the bk grid
# the autotune search walks.
F32_BM = (8, 16, 32, 64, 128)
F32_BN = (8, 16, 32, 64, 128)
Q8_BM = (16, 32, 64, 128)
Q8_BN = (32, 64, 128)
BF16_BM = (16, 32, 64, 128)
BF16_BN = (8, 16, 32, 64, 128)
F32_BK = (8, 16, 32, 64)          # any multiple of 4 is taken
Q8_BK = (32, 64, 128, 256, 512)   # any multiple of 32 is taken
BF16_BK = (16, 32, 64, 128, 256)  # any multiple of 16 is taken
MAX_GRID_Y = 65535                # N tiles; M tiles go on grid.x

# The f32 kernel's ring of bk-deep slabs and its least threads a block
# (pattern_matmul.cu).
_MIN_THREADS = 128
_MAX_STAGES = 16
_STAGE_BUDGET = 32 * 1024
# The bf16 kernel's ring of x slabs, the bytes after each staged output
# row, and the shared memory its w_c column tile stays resident within
# (pattern_matmul_bf16.cu, staging.cuh's MAX_SMEM).
_BF16_STAGES = 2
_BF16_OPAD = 16
_BF16_SMEM = 232448
_SM_SMEM = 233472                 # shared memory an SM, sm_90

Blocks = Dict[str, int]


def tile_rules(dtype: torch.dtype) -> Tuple[Tuple[int, ...],
                                            Tuple[int, ...], int]:
    """(bm values, bn values, bk step) the kernel for ``dtype`` takes."""
    if dtype == torch.int8:
        return Q8_BM, Q8_BN, 32
    if dtype == torch.bfloat16:
        return BF16_BM, BF16_BN, 16
    return F32_BM, F32_BN, 4


def kernel_threads(bm: int, bn: int, dtype: torch.dtype) -> int:
    """Threads a block of the kernel for ``dtype`` at tiles ``bm x bn``
    (its register tile, or warp tile for int8 and bf16, follows the block
    tile)."""
    if dtype == torch.int8:
        mt, nt = (1, 2) if bm == 16 else (2, 4)
        return (bm // (16 * mt)) * (bn // (8 * nt)) * 32
    if dtype == torch.bfloat16:
        mt, nt = 1 if bm == 16 else 2, min(4, bn // 8)
        return max(_MIN_THREADS, (bm // (16 * mt)) * (bn // (8 * nt)) * 32)
    tm = 8 if bm >= 64 else bm // 8
    tn = 8 if bn >= 64 else 4
    return max(_MIN_THREADS, (bm // tm) * (bn // tn))


def kernel_smem(bm: int, bk: int, bn: int, K: int,
                dtype: torch.dtype) -> int:
    """Dynamic shared memory, in bytes, a block of the kernel uses (bf16:
    the persistent kernel's, which sets what the kernel takes; where M
    is one row tile, its first-design kernel runs on one x and one w_c
    slab)."""
    if dtype == torch.int8:
        return max((bm + bn) * (bk + 16), 4 * bm * (bn + 8))
    if dtype == torch.bfloat16:
        # the output tile (sized for f32 out), its bias (f32), w_c's
        # column tile -- all of K rounded up to 16 where that fits, else a
        # bk slab a stage -- and the x slabs; x rows padded by 8 elements,
        # w_c rows to an odd number of 16 B
        fixed = (bm * (4 * bn + _BF16_OPAD) + 4 * bn
                 + 2 * _BF16_STAGES * bm * (bk + 8))
        ldb = bn + (16 if bn == 8 else 8)
        resident = fixed + 2 * 16 * -(-K // 16) * ldb
        if resident <= _BF16_SMEM:
            return resident
        return fixed + 2 * _BF16_STAGES * bk * ldb
    slab = 4 * (bm * (bk + 4) + bk * bn)
    nslabs = -(-K // bk)
    stages = min(max(nslabs, 1), _MAX_STAGES, max(2, _STAGE_BUDGET // slab))
    return stages * slab


def bf16_grid(M: int, K: int, N: int, blocks: Blocks,
              sms: int) -> Tuple[int, int]:
    """(grid.x, grid.y) of the bf16 kernel's persistent grid on a card of
    ``sms`` SMs (pattern_matmul_bf16.cu computes the same): grid.y the
    column tiles, grid.x about two blocks an SM between them -- as many as
    the SM's shared memory, threads and registers (128 a thread) hold at
    once -- at least one and at most the row tiles, each block walking
    row tiles grid.x apart."""
    bm, bk, bn = (blocks[k] for k in ("bm", "bk", "bn"))
    threads = kernel_threads(bm, bn, torch.bfloat16)
    smem = kernel_smem(bm, bk, bn, K, torch.bfloat16)
    per_sm = max(1, min(2, _SM_SMEM // (smem + 1024), 2048 // threads,
                        65536 // (threads * 128)))
    gy = -(-N // bn)
    return max(1, min(-(-M // bm), per_sm * sms // gy)), gy


def check_blocks(blocks: Blocks, K: int, N: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` unless the kernel for ``dtype`` takes
    ``blocks`` at contraction depth K and width N."""
    bm, bk, bn = (blocks[k] for k in ("bm", "bk", "bn"))
    what = f"pattern_matmul blocks (bm={bm}, bk={bk}, bn={bn})"
    if min(bm, bk, bn) <= 0:
        raise ValueError(f"{what}: every tile must be positive")
    bms, bns, step = tile_rules(dtype)
    if bm not in bms or bn not in bns:
        raise ValueError(f"{what}: the {dtype} kernel takes bm in {bms} "
                         f"and bn in {bns}")
    if bk % step:
        raise ValueError(f"{what}: bk must be a multiple of {step} for "
                         f"{dtype}")
    threads = kernel_threads(bm, bn, dtype)
    if threads > autotune.MAX_THREADS_PER_BLOCK:
        raise ValueError(f"{what}: {threads} threads a block exceed "
                         f"{autotune.MAX_THREADS_PER_BLOCK}")
    smem = kernel_smem(bm, bk, bn, K, dtype)
    if smem > autotune.MAX_SMEM_BYTES:
        raise ValueError(f"{what}: {smem} bytes of shared memory exceed "
                         f"{autotune.MAX_SMEM_BYTES} at K={K}")
    if -(-N // bn) > MAX_GRID_Y:
        raise ValueError(f"{what}: N={N} needs more than {MAX_GRID_Y} "
                         f"column tiles")


def default_blocks(M: int, K: int, dtype: torch.dtype) -> Blocks:
    """The tiles a launch takes when none is given or cached, by M bucket
    (among the fastest candidates at vikin's matmul shapes at M = 8 and
    8192 on an H100): at serving buckets narrow tiles put more blocks on
    the card, and slabs deep enough that Kc <= 304 is one wait; at large
    M 128-row tiles, with deeper slabs for a deep Kc.  int8's bk covers
    all of K up to 512, bf16's up to 256 (its m16 tiles at bm >= 16), 128
    from M = 257 on, where two 128-row x slabs share the block's shared
    memory with w_c's column tile and the staged output tile."""
    if dtype == torch.bfloat16:
        k16 = 16 * max(1, -(-K // 16))
        if M <= 16:
            return {"bm": 16, "bk": min(256, k16), "bn": 8}
        if M <= 64:
            return {"bm": 32, "bk": min(256, k16), "bn": 32}
        if M <= 256:
            return {"bm": 64, "bk": min(256, k16), "bn": 64}
        return {"bm": 128, "bk": min(128, k16), "bn": 64}
    if dtype == torch.int8:
        bm = 16 if M <= 16 else 32 if M <= 32 else 64 if M <= 256 else 128
        return {"bm": bm, "bk": min(512, 32 * max(1, -(-K // 32))),
                "bn": 32 if M <= 64 else 64}
    if M <= 16:
        return {"bm": 8 if M <= 8 else 16,
                "bk": min(64, 4 * max(1, -(-K // 4))), "bn": 8}
    bm = 32 if M <= 64 else 64 if M <= 256 else 128
    return {"bm": bm, "bk": 16 if K <= 128 else 64, "bn": 32}


def _as_blocks(blocks: Sequence[int]) -> Blocks:
    bm, bk, bn = blocks
    return {"bm": int(bm), "bk": int(bk), "bn": int(bn)}


def resolve_blocks(M: int, K: int, N: int, dtype: torch.dtype,
                   blocks: Optional[Sequence[int]] = None,
                   device: torch.device | str = "cuda") -> Blocks:
    """(bm, bk, bn) for the compact matmul: explicit > cached > default
    by M bucket, checked against what the kernel takes."""
    return dict(zip(("bm", "bk", "bn"),
                    _tiles(M, K, N, dtype, blocks, device)))


def _tiles(M: int, K: int, N: int, dtype: torch.dtype,
           blocks: Optional[Sequence[int]],
           device: torch.device | str) -> Tuple[int, int, int]:
    """``resolve_blocks`` as a tuple.  Without ``blocks`` the answer for
    an exact shape is remembered in ``autotune.RESOLVED`` (dropped with
    the cache's other answers on a store, clear or new cache), so a
    served batch pays one dict lookup; the cache itself is read once per
    shape bucket (``autotune.cached_blocks``)."""
    if blocks is not None:
        knob = _as_blocks(blocks)
        check_blocks(knob, K, N, dtype)
        return knob["bm"], knob["bk"], knob["bn"]
    tiles = autotune.RESOLVED.get(autotune.memo_key(KERNEL, M, K, N, dtype,
                                                    device))
    if tiles is None:
        knob = (autotune.cached_blocks(KERNEL, (M, K, N), dtype, device)
                or default_blocks(M, K, dtype))
        check_blocks(knob, K, N, dtype)
        tiles = knob["bm"], knob["bk"], knob["bn"]
        autotune.RESOLVED[autotune.memo_key(KERNEL, M, K, N, dtype,
                                            device)] = tiles
    return tiles


def _check_operands(fn: str, x_c: torch.Tensor, w_c: torch.Tensor,
                    operands: Sequence[Tuple[str, torch.Tensor]],
                    dtype: torch.dtype, what: str) -> Tuple[int, int, int]:
    """(M, K, N) of ``x_c @ w_c``; raises on a shape, device, dtype or
    layout the kernel does not take."""
    if x_c.dim() != 2 or w_c.dim() != 2 or x_c.shape[1] != w_c.shape[0]:
        raise ValueError(f"{fn}: shapes {tuple(x_c.shape)} @ "
                         f"{tuple(w_c.shape)} do not contract")
    for name, t in operands:
        if t.device != x_c.device:
            raise ValueError(f"{fn}: {name} on {t.device}, x on {x_c.device}")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype} "
                            f"({what})")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    M, K = x_c.shape
    return M, K, w_c.shape[1]


def matmul_compact(x_c: torch.Tensor, w_c: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   act: Optional[str] = None, *,
                   blocks: Optional[Sequence[int]] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """act(x_c @ w_c + bias) on (M, Kc) x_c and (Kc, N) w_c, all f32 or all
    bf16, f32 accumulation, ``out_dtype`` out (x's dtype by default, or
    f32); ``blocks`` overrides the kernel's (bm, bk, bn) tiles."""
    bf16 = x_c.dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32
    out_dtype = resolve_out_dtype("matmul_compact", x_c, out_dtype)
    if grad_wanted(x_c, w_c, bias):
        if bf16 or out_dtype != torch.float32:
            refuse_grad("matmul_compact", "at bf16")
        if act not in (None, "relu"):
            refuse_grad("matmul_compact", f"through the {act} epilogue")
        return MatmulCompact.apply(x_c, w_c, bias, act, blocks)
    with work.kernel(KERNEL_BF16 if bf16 else KERNEL, lambda: work.matmul(
            x_c.shape[0], x_c.shape[-1], w_c.shape[-1], x_c.dtype,
            out_dtype, None if bias is None else bias.dtype)):
        return _matmul_compact(x_c, w_c, bias, act, blocks, out_dtype,
                               dtype)


def _matmul_compact(x_c: torch.Tensor, w_c: torch.Tensor,
                    bias: Optional[torch.Tensor], act: Optional[str],
                    blocks: Optional[Sequence[int]], out_dtype: torch.dtype,
                    dtype: torch.dtype) -> torch.Tensor:
    """``matmul_compact``'s device branch: the plain version on the CPU,
    the kernel on the card, on meta the card's checks and output and no
    launch (``kernels/work``: the dry run)."""
    bf16 = dtype == torch.bfloat16
    if x_c.device.type == "cpu":
        if blocks is not None:
            check_blocks(_as_blocks(blocks), x_c.shape[-1], w_c.shape[-1],
                         dtype)
        return matmul_compact_ref(x_c, w_c, bias, act, out_dtype)
    if x_c.device.type not in ("cuda", "meta"):
        raise ValueError(f"matmul_compact: no kernel for device {x_c.device}")
    if act not in ACT_CODES:
        raise ValueError(f"matmul_compact: unknown act {act!r}")
    operands = [("x_c", x_c), ("w_c", w_c)]
    if bias is not None:
        if bias.shape != (w_c.shape[-1],):
            raise ValueError(f"matmul_compact: bias has shape "
                             f"{tuple(bias.shape)}, expected "
                             f"({w_c.shape[-1]},)")
        operands.append(("bias", bias))
    M, K, N = _check_operands(
        "matmul_compact", x_c, w_c, operands, dtype,
        "this kernel is bf16 only" if bf16 else "this kernel is f32 only")
    y = torch.empty((M, N), dtype=out_dtype, device=x_c.device)
    if x_c.is_meta:
        if blocks is not None:
            check_blocks(_as_blocks(blocks), K, N, dtype)
        return y
    if M == 0 or N == 0:
        return y
    bm, bk, bn = _tiles(M, K, N, dtype, blocks, x_c.device)
    # the bf16 kernel also takes the output's dtype
    out_f32 = (int(out_dtype == torch.float32),) if bf16 else ()
    _build.launch(
        KERNEL_BF16 if bf16 else KERNEL, x_c.data_ptr(), w_c.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), M, K, N,
        ACT_CODES[act], *out_f32, bm, bk, bn,
        torch.cuda.current_stream(x_c.device).cuda_stream)
    return y


class MatmulCompact(torch.autograd.Function):
    """The f32 ``act(x_c @ w_c + bias)`` (act None or relu) with its
    gradient: ``g' = g * (y > 0)`` at relu (0 at 0, as ``jax.nn.relu``),
    ``dx_c = g' w_c^T``, ``dw_c = x_c^T g'``, ``dbias = sum_rows g'``."""

    @staticmethod
    def forward(ctx, x_c, w_c, bias, act, blocks):  # noqa: D102
        y = matmul_compact(x_c, w_c, bias, act, blocks=blocks)
        ctx.save_for_backward(x_c, w_c, y if act == "relu" else None)
        return y

    @staticmethod
    def backward(ctx, g):  # noqa: D102
        x_c, w_c, y = ctx.saved_tensors
        if y is not None:
            g = torch.where(y > 0, g, torch.zeros_like(g))
        need = ctx.needs_input_grad
        dx = ieee_matmul(g, w_c.t()) if need[0] else None
        dw = ieee_matmul(x_c.t(), g) if need[1] else None
        db = g.sum(0) if need[2] else None
        return dx, dw, db, None, None


def matmul_q8(x_q: torch.Tensor, w_q: torch.Tensor, *,
              blocks: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The raw accumulator ``x_q @ w_q`` as f32 on (M, Kc) and (Kc, N)
    int8 codes: exact integers while Kc * 127^2 < 2^24.  ``blocks``
    overrides the kernel's (bm, bk, bn) tiles."""
    with work.kernel(KERNEL_Q8, lambda: work.matmul(
            x_q.shape[0], x_q.shape[-1], w_q.shape[-1], torch.int8,
            torch.float32)):
        return _matmul_q8(x_q, w_q, blocks)


def _matmul_q8(x_q: torch.Tensor, w_q: torch.Tensor,
               blocks: Optional[Sequence[int]]) -> torch.Tensor:
    """``matmul_q8``'s device branch (``_matmul_compact``'s rules)."""
    if x_q.device.type == "cpu":
        if blocks is not None:
            check_blocks(_as_blocks(blocks), x_q.shape[-1], w_q.shape[-1],
                         torch.int8)
        return matmul_q8_ref(x_q, w_q)
    if x_q.device.type not in ("cuda", "meta"):
        raise ValueError(f"matmul_q8: no kernel for device {x_q.device}")
    M, K, N = _check_operands("matmul_q8", x_q, w_q,
                              [("x_q", x_q), ("w_q", w_q)], torch.int8,
                              "this kernel takes int8 codes")
    y = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    if x_q.is_meta:
        if blocks is not None:
            check_blocks(_as_blocks(blocks), K, N, torch.int8)
        return y
    if M == 0 or N == 0:
        return y
    bm, bk, bn = _tiles(M, K, N, torch.int8, blocks, x_q.device)
    _build.launch(KERNEL_Q8, x_q.data_ptr(), w_q.data_ptr(), y.data_ptr(),
                  M, K, N, bm, bk, bn,
                  torch.cuda.current_stream(x_q.device).cuda_stream)
    return y


def pattern_linear(x: torch.Tensor, w: torch.Tensor,
                   mask: Optional[PatternMask] = None,
                   bias: Optional[torch.Tensor] = None, *,
                   act: Optional[str] = None,
                   blocks: Optional[Sequence[int]] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = act(x[..., keep] @ w[keep, :] + bias); x: (..., K), w: (K, N).

    Functional form of the JAX ``pattern_linear``: compacts the weight on
    every call.  ``models/ffn.PatternLinear`` compacts it once instead.
    ``blocks`` overrides the (bm, bk, bn) tiles; None consults the
    autotune cache before the defaults.  f32 or bf16 (the gather is
    exact); ``out_dtype`` x's dtype by default, or f32.
    """
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    if mask is not None:
        idx = torch.as_tensor(mask.indices(), dtype=torch.long,
                              device=x.device)
        xf = xf.index_select(1, idx)
        w = w.index_select(0, idx.to(w.device))
    y = matmul_compact(xf.contiguous(), w.contiguous(), bias, act=act,
                       blocks=blocks, out_dtype=out_dtype)
    return y.reshape(*lead, w.shape[-1])


def pattern_linear_q8(x_q: torch.Tensor, w_q: torch.Tensor,
                      col_scale: torch.Tensor,
                      mask: Optional[PatternMask] = None,
                      bias: Optional[torch.Tensor] = None, *,
                      act: Optional[str] = None,
                      blocks: Optional[Sequence[int]] = None
                      ) -> torch.Tensor:
    """Int8 pattern-sparse linear: act(dq(x_q) @ dq(w_q) + bias), f32 out.

    x_q: (..., K) int8; w_q: (K, N) int8; col_scale: (N,) f32 = s_x * s_w
    per output channel.  Both operands stay int8 through the lane gather;
    the exact integer accumulator is then scaled by the shared epilogue,
    once, after full accumulation -- as in the reference.  Functional
    form: ``core/quant.QuantVikinStack`` compacts the weight once instead.
    ``blocks`` overrides the int8 kernel's (bm, bk, bn) tiles.
    """
    lead = x_q.shape[:-1]
    xf = x_q.reshape(-1, x_q.shape[-1])
    if mask is not None:
        idx = torch.as_tensor(mask.indices(), dtype=torch.long,
                              device=x_q.device)
        xf = xf.index_select(1, idx)
        w_q = w_q.index_select(0, idx.to(w_q.device))
    acc = matmul_q8(xf.contiguous(), w_q.contiguous(), blocks=blocks)
    y = scale_bias_act(acc, col_scale, bias, act)
    return y.reshape(*lead, w_q.shape[-1])
