"""Launch-knob autotuning for the port's CUDA kernels.

Counterpart of ``repro/kernels/autotune.py``:

* a persistent JSON cache keyed by ``kernel|shape bucket|dtype|device``,
  where the device is the card's name (``torch.cuda.get_device_name``), or
  ``cpu`` for timings of the plain versions, so a CPU timing is never
  served to a card and one card's timing never to another;
* a measured search over a candidate grid (``tune_*``), timed on the
  card with CUDA events around a CUDA graph of the calls (device time);
* ``cached_blocks``, which the kernel wrappers consult, so a shape tuned
  once is launched with its tuned knob ever after, across processes.  It
  resolves each (kernel, shape bucket, dtype, device) once per process
  and keeps the answer, hit or miss, until the cache is stored to or
  cleared: a served batch asks no card name and builds no key string.

Shapes are bucketed to the next power of two per dimension.  The cache
file is ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_torch/autotune.json`` -- not the JAX package's file, so
neither package ever reads the other's timings.  Search on a cache miss is
opt-in (``REPRO_TORCH_AUTOTUNE=1``): a silent search in the middle of a
serving step is worse than a default knob.  The spline-basis wrapper
searches on a miss; the pattern-matmul and KAN wrappers, like the JAX
``pattern_linear``, never search: ``launch/serve.py`` tunes the matmul
and KAN layers it serves before the first request instead.

Unlike the JAX ``search``, which skips candidates that fail to compile,
this one lets every failure raise: the candidates are pruned up front to
what the card takes (threads a block, shared memory a block), so a launch
that fails is a fault to see, not a candidate to skip.

Knobs: ``block_n`` of the two spline-basis kernels (inputs a block, as in
the JAX package), ``(bm, bk, bn)`` of the three pattern-matmul kernels,
f32, bf16 and int8 alike under kernel ``pattern_matmul``, ``(bm, bi,
bn)`` of the three version-2 KAN kernels under kernel ``kan_fused_v2``
(the dtype tells f32, bf16 and int8 apart, as in the JAX
``resolve_blocks``), of the mixed one (bf16 x, f32 weights) under
``kan_fused_v2_mixed``, and of the two version-1 KAN kernels under
``kan_fused_v1``.  The mixed kernel moved from the CUDA-core body to the
tensor-core one, whose shared memory differs, with this file's schema
unchanged: a ``kan_fused_v2_mixed`` entry its body refuses is a miss
(``kan_fused/ops``) until ``tune_kan_fused`` searches the shape again;
any other kernel's refused entry raises.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.utils import next_pow2

CACHE_SCHEMA_VERSION = 1

# The card's limits a block; candidates never exceed them.
MAX_THREADS_PER_BLOCK = 1024
MAX_SMEM_BYTES = 232448          # 227 KB of shared memory on sm_90

# (kernel, key, blocks, source) of every cache hit and search result, so
# tests (and people) can see which knob a launch was served.
DISPATCH_LOG: List[Tuple[str, str, Dict[str, int], str]] = []
_DISPATCH_LOG_MAX = 256


def note_dispatch(kernel: str, key: str, blocks: Dict[str, int],
                  source: str) -> None:
    DISPATCH_LOG.append((kernel, key, dict(blocks), source))
    if len(DISPATCH_LOG) > _DISPATCH_LOG_MAX:
        del DISPATCH_LOG[: len(DISPATCH_LOG) - _DISPATCH_LOG_MAX]


def default_cache_path() -> str:
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE", "")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


def device_tag(device: torch.device | str) -> str:
    """The device part of a cache key: the card's name, or ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    raise ValueError(f"autotune: no kernels for device {dev}")


def shape_bucket(dims: Sequence[int]) -> Tuple[int, ...]:
    """Round every dim up to the next power of two (>= 1)."""
    return tuple(next_pow2(max(1, int(d))) for d in dims)


def cache_key(kernel: str, dims: Sequence[int], dtype: torch.dtype,
              device: torch.device | str) -> str:
    bucket = "x".join(str(d) for d in shape_bucket(dims))
    dtype_name = str(dtype).removeprefix("torch.")
    return f"{kernel}|{bucket}|{dtype_name}|{device_tag(device)}"


class AutotuneCache:
    """Persistent {cache_key: {"blocks": {...}, "us": float}} JSON store."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_cache_path()
        self._data: Optional[Dict[str, Dict]] = None
        self._discard_disk = False      # set by clear(): next save resets

    def _read_disk(self) -> Dict[str, Dict]:
        try:
            with open(self.path) as f:
                raw = json.load(f)
            if raw.get("schema") == CACHE_SCHEMA_VERSION:
                return dict(raw.get("entries", {}))
        except (OSError, ValueError, AttributeError):
            pass
        return {}

    def _load(self) -> Dict[str, Dict]:
        if self._data is None:
            self._data = self._read_disk()
        return self._data

    def save(self) -> None:
        """Write atomically (temporary file + rename), merged with what is
        on disk now: another process may have stored other keys since this
        one loaded, and rewriting only this view would drop them.  This
        process's entries win on the same key."""
        data = self._load()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        disk = {} if self._discard_disk else self._read_disk()
        merged = {**disk, **data}
        self._data, self._discard_disk = merged, False
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"schema": CACHE_SCHEMA_VERSION, "entries": merged},
                      f, indent=1, sort_keys=True, allow_nan=False)
        os.replace(tmp, self.path)

    def lookup(self, key: str) -> Optional[Dict[str, int]]:
        ent = self._load().get(key)
        if ent is None:
            return None
        return {k: int(v) for k, v in ent["blocks"].items()}

    def store(self, key: str, blocks: Dict[str, int],
              us: Optional[float] = None) -> None:
        self._load()[key] = {"blocks": {k: int(v) for k, v in blocks.items()},
                             "us": None if us is None else float(us)}
        self.save()
        RESOLVED.clear()

    def clear(self) -> None:
        """Reset to empty: the next save() overwrites rather than merges."""
        self._data = {}
        self._discard_disk = True
        RESOLVED.clear()


# The process's cache (key "cache"), in a module-level dict like the
# port's other process state (kernels/_build.LAUNCHES, DISPATCH_LOG);
# ``reset_cache`` empties it.
_PROCESS: Dict[str, AutotuneCache] = {}

# Answers derived from the process's cache, under ``memo_key``: (kernel,
# shape bucket, dtype, device) -> its entry (None for a miss), and what a
# kernel wrapper derives from those (pattern_matmul/ops.py: the checked
# tiles of an exact shape).  Emptied by every store, clear and new cache.
RESOLVED: Dict[Tuple, object] = {}


def get_cache() -> AutotuneCache:
    """The process's cache at ``default_cache_path()`` (re-made when the
    environment variable changes)."""
    cache = _PROCESS.get("cache")
    if cache is None or cache.path != default_cache_path():
        cache = _PROCESS["cache"] = AutotuneCache()
        RESOLVED.clear()
    return cache


def reset_cache() -> None:
    """Forget the process's cache and every answer derived from it: the
    next ``get_cache`` reads the file ``default_cache_path()`` names now
    (for a caller that changed the environment variables)."""
    _PROCESS.clear()
    RESOLVED.clear()


def lookup_blocks(kernel: str, dims: Sequence[int], dtype: torch.dtype,
                  device: torch.device | str,
                  cache: Optional[AutotuneCache] = None,
                  ) -> Optional[Dict[str, int]]:
    """Cached knobs for a shape on ``device``, or None; logs a hit."""
    cache = cache or get_cache()
    key = cache_key(kernel, dims, dtype, device)
    blocks = cache.lookup(key)
    if blocks is not None:
        note_dispatch(kernel, key, blocks, "cache")
    return blocks


def memo_key(*parts: object) -> Tuple:
    """A ``RESOLVED`` key: ``parts`` under the process's current cache
    object.  A new cache (``get_cache`` after the cache file's variable
    changed, or ``reset_cache``) starts over, and so do a store and a
    clear; the environment is read on a miss only, never on a remembered
    answer."""
    return (id(_PROCESS.get("cache")),) + parts


def cached_blocks(kernel: str, dims: Sequence[int], dtype: torch.dtype,
                  device: torch.device | str) -> Optional[Dict[str, int]]:
    """``lookup_blocks`` on the process's cache, asked once per (kernel,
    shape bucket, dtype, device) and remembered, hit or miss, until the
    cache is stored to, cleared or replaced; a hit is logged the first
    time only.  A remembered answer costs a dict lookup: no card name, no
    key string, no file, no environment."""
    bucket = shape_bucket(dims)
    try:
        hit = RESOLVED[memo_key(kernel, bucket, dtype, device)]
    except KeyError:
        hit = lookup_blocks(kernel, dims, dtype, device, get_cache())
        RESOLVED[memo_key(kernel, bucket, dtype, device)] = hit
    return None if hit is None else dict(hit)


def autotune_enabled() -> bool:
    return os.environ.get("REPRO_TORCH_AUTOTUNE", "0") not in (
        "", "0", "false")


def _time_us(fn: Callable[[], object], reps: int,
             device: torch.device) -> float:
    """Mean microseconds of one of ``reps`` calls, after one warm-up call.

    On the card, device time alone: the ``reps`` calls are captured in one
    CUDA graph and its replay is timed with CUDA events.  Back-to-back
    calls of a small kernel are paced by the host's launch overhead, which
    is the same for every candidate and would decide the search.  On the
    CPU, the host clock.
    """
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def search(kernel: str, dims: Sequence[int], dtype: torch.dtype,
           run_fn: Callable[..., object],
           candidates: Iterable[Dict[str, int]], *,
           device: torch.device | str, reps: int = 10,
           cache: Optional[AutotuneCache] = None) -> Dict[str, int]:
    """Time ``run_fn(**cand)`` per candidate on ``device``, cache and
    return the fastest.  Any failure raises."""
    dev = torch.device(device)
    cache = cache or get_cache()
    key = cache_key(kernel, dims, dtype, dev)
    best: Optional[Tuple[float, Dict[str, int]]] = None
    for cand in candidates:
        us = _time_us(lambda: run_fn(**cand), reps, dev)
        if best is None or us < best[0]:
            best = (us, dict(cand))
    if best is None:
        raise ValueError(f"autotune: no candidates for {key}")
    cache.store(key, best[1], us=best[0])
    note_dispatch(kernel, key, best[1], "search")
    return best[1]


def candidates_spline_basis(n: int, n_bases: int,
                            dtype: torch.dtype = torch.float32
                            ) -> List[Dict[str, int]]:
    """``block_n`` (inputs a block, the JAX package's grid): 256..4096,
    none above ``n``'s power-of-two bucket (floor 256), pruned to what the
    kernel for ``dtype`` takes (``ops.check_block_n``: the block's
    (block_n, n_bases) output stretch in shared memory)."""
    from repro_torch.kernels.spline_basis import ops

    out = []
    for b in (256, 512, 1024, 2048, 4096):
        if b > next_pow2(max(256, n)):
            continue
        try:
            ops.check_block_n(b, n_bases, dtype)
        except ValueError:
            continue
        out.append({"block_n": b})
    return out


def tune_spline_basis(x: torch.Tensor, spec, *, reps: int = 10,
                      cache: Optional[AutotuneCache] = None
                      ) -> Dict[str, int]:
    """Search ``block_n`` for the spline-basis kernel on ``x``'s device
    (on the CPU this times the plain version, stored under ``cpu``)."""
    from repro_torch.kernels.spline_basis.ops import spline_basis

    flat = x.reshape(-1)
    n = flat.shape[0]
    return search("spline_basis", (n, spec.n_bases), flat.dtype,
                  lambda block_n: spline_basis(flat, spec, block_n=block_n),
                  candidates_spline_basis(n, spec.n_bases, flat.dtype),
                  device=flat.device, reps=reps, cache=cache)


def candidates_pattern_matmul(M: int, K: int, N: int, dtype: torch.dtype
                              ) -> List[Dict[str, int]]:
    """``(bm, bk, bn)`` grid of the f32, bf16 or int8 pattern-matmul
    kernel: the tiles it takes, with ``bm`` at most ``max(16,
    next_pow2(M))``, ``bn`` at most ``max(32, next_pow2(N))`` and ``bk`` at
    most K's bucket (floor: the smallest ``bk``), pruned to the card's
    thread and shared-memory limits a block."""
    from repro_torch.kernels.pattern_matmul import ops

    bms, bns, _ = ops.tile_rules(dtype)
    bks = {torch.int8: ops.Q8_BK,
           torch.bfloat16: ops.BF16_BK}.get(dtype, ops.F32_BK)
    cap_m = max(16, next_pow2(M))
    cap_n = max(32, next_pow2(N))
    cap_k = max(bks[0], next_pow2(K))
    out = []
    for bm in bms:
        for bn in bns:
            for bk in bks:
                if bm > cap_m or bn > cap_n or bk > cap_k:
                    continue
                if (ops.kernel_threads(bm, bn, dtype) <= MAX_THREADS_PER_BLOCK
                        and ops.kernel_smem(bm, bk, bn, K, dtype)
                        <= MAX_SMEM_BYTES):
                    out.append({"bm": bm, "bk": bk, "bn": bn})
    return out


def tune_pattern_matmul(x_c: torch.Tensor, w_c: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, *,
                        act: Optional[str] = None, reps: int = 10,
                        cache: Optional[AutotuneCache] = None
                        ) -> Dict[str, int]:
    """Search ``(bm, bk, bn)`` for the compact matmul on ``x_c``'s device
    (on the CPU this times the plain version, stored under ``cpu``).
    bf16 operands tune the bf16 kernel, int8 codes the int8 kernel (raw
    accumulator: no bias, no act), each stored under the same kernel name
    with its dtype."""
    from repro_torch.kernels.pattern_matmul.ops import (
        matmul_compact,
        matmul_q8,
    )

    M, K = x_c.shape
    N = w_c.shape[1]
    if x_c.dtype == torch.int8:
        if bias is not None or act is not None:
            raise ValueError("tune_pattern_matmul: the int8 kernel writes "
                             "the raw accumulator; bias and act apply after")

        def run(bm: int, bk: int, bn: int) -> torch.Tensor:
            return matmul_q8(x_c, w_c, blocks=(bm, bk, bn))
    else:
        def run(bm: int, bk: int, bn: int) -> torch.Tensor:
            return matmul_compact(x_c, w_c, bias, act, blocks=(bm, bk, bn))
    return search("pattern_matmul", (M, K, N), x_c.dtype, run,
                  candidates_pattern_matmul(M, K, N, x_c.dtype),
                  device=x_c.device, reps=reps, cache=cache)


def candidates_kan_fused(B: int, n_in: int, n_out: int, nbk: int,
                         dtype: torch.dtype, version: int = 2,
                         wt_dtype: Optional[torch.dtype] = None
                         ) -> List[Dict[str, int]]:
    """``(bm, bi, bn)`` grid of the f32, bf16, mixed (bf16 x, ``wt_dtype``
    f32) or int8 version-2 KAN kernel, or of the f32 or bf16 version-1
    kernel: bm at most ``max(8,
    next_pow2(B))``, bn at most ``max(8, next_pow2(n_out))``, bi a power
    of two from 32 up to the first that covers ``n_in``, pruned to what
    the kernel takes on the card (``ops.check_blocks``: tile, shared
    memory a block, blocks a cluster; bm * bn <= 8192 keeps a block at 256
    threads)."""
    from repro_torch.kernels.kan_fused import ops

    cap_m = max(8, next_pow2(B))
    cap_n = max(8, next_pow2(n_out))
    bis = [ops.PC]
    while bis[-1] < n_in:
        bis.append(2 * bis[-1])
    out = []
    for bm in ops.TILES:
        for bn in ops.TILES:
            if bm > cap_m or bn > cap_n:
                continue
            for bi in bis:
                cand = {"bm": bm, "bi": bi, "bn": bn}
                try:
                    ops.check_blocks(cand, n_in, n_out, nbk, dtype, version,
                                     wt_dtype)
                except ValueError:
                    continue
                out.append(cand)
    return out


def tune_kan_fused(x: torch.Tensor, wt: torch.Tensor, spec,
                   kb: Optional[Sequence[int]] = None, *,
                   version: int = 2,
                   t_flat: Optional[torch.Tensor] = None,
                   slot_scales: Optional[torch.Tensor] = None,
                   x_scale: Optional[float] = None, reps: int = 10,
                   cache: Optional[AutotuneCache] = None
                   ) -> Dict[str, int]:
    """Search ``(bm, bi, bn)`` for a KAN kernel on ``x``'s device (on the
    CPU this times the plain version, stored under ``cpu``).  At version
    2, against the fused ``wt`` (``ops.fuse_wt``): bf16 operands tune the
    bf16 kernel, int8 codes the int8 kernel, which needs ``slot_scales``
    and ``x_scale``; all are stored under kernel ``kan_fused_v2`` with
    their dtype, a bf16 x against an f32 ``wt`` (the mixed kernel) under
    ``kan_fused_v2_mixed``.  At version 1, ``wt``
    is ``w_b`` and ``t_flat`` the kept-basis rows, stored under kernel
    ``kan_fused_v1``, as the JAX ``tune_kan_fused(..., version=1)``
    does."""
    from repro_torch.kernels.kan_fused.ops import (
        cache_kernel,
        kan_fused_v1,
        kan_fused_v2,
        kan_fused_v2_q8,
        slot_table,
    )

    if version not in (1, 2):
        raise ValueError(f"tune_kan_fused: version must be 1 or 2, got "
                         f"{version!r}")
    if (version == 1) != (t_flat is not None):
        raise ValueError("tune_kan_fused: version 1 takes w_b and t_flat; "
                         "version 2 the fused wt alone")
    B, n_in = x.shape
    n_out = wt.shape[1]
    kb = tuple(range(spec.n_bases)) if kb is None else tuple(kb)
    nbk = len(kb)
    slot_of = slot_table(kb, spec.n_bases, x.device)
    if version == 1:
        def run(bm: int, bi: int, bn: int) -> torch.Tensor:
            return kan_fused_v1(x, wt, t_flat, spec, kb, slot_of,
                                blocks=(bm, bi, bn))
    elif x.dtype == torch.int8:
        if slot_scales is None or x_scale is None:
            raise ValueError("tune_kan_fused: int8 codes need slot_scales "
                             "and x_scale")

        def run(bm: int, bi: int, bn: int) -> torch.Tensor:
            return kan_fused_v2_q8(x, wt, slot_scales, spec, kb, x_scale,
                                   slot_of, blocks=(bm, bi, bn))
    else:
        def run(bm: int, bi: int, bn: int) -> torch.Tensor:
            return kan_fused_v2(x, wt, spec, kb, slot_of,
                                blocks=(bm, bi, bn))
    wt_dtype = wt.dtype if version == 2 else None
    return search(cache_kernel(version, x.dtype, wt_dtype),
                  (B, n_in, n_out, nbk), x.dtype, run,
                  candidates_kan_fused(B, n_in, n_out, nbk, x.dtype,
                                       version, wt_dtype),
                  device=x.device, reps=reps, cache=cache)
