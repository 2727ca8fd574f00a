"""Launch-knob autotuning for the port's CUDA kernels.

Counterpart of ``repro/kernels/autotune.py``:

* a persistent JSON cache keyed by ``kernel|shape bucket|dtype|device``,
  where the device is the card's name (``torch.cuda.get_device_name``), or
  ``cpu`` for timings of the plain versions, so a CPU timing is never
  served to a card and one card's timing never to another;
* a measured search over a candidate grid (``tune_*``), timed on the
  card with CUDA events around a CUDA graph of the calls (device time);
* ``lookup_blocks``, which the kernel wrappers consult, so a shape tuned
  once is launched with its tuned knob ever after, across processes.

Shapes are bucketed to the next power of two per dimension.  The cache
file is ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_torch/autotune.json`` -- not the JAX package's file, so
neither package ever reads the other's timings.  Search on a cache miss is
opt-in (``REPRO_TORCH_AUTOTUNE=1``): a silent search in the middle of a
serving step is worse than a default knob.

Unlike the JAX ``search``, which skips candidates that fail to compile,
this one lets every failure raise: the candidates are pruned up front to
what the card takes (at most 1024 threads a block), so a launch that
fails is a fault to see, not a candidate to skip.

Only the spline-basis kernel has a launch-time knob (``block_n``).  The
KAN and matmul kernels' tiles are compile-time constants
(``kan_fused.cuh``, ``pattern_matmul.cu``), so ``tune_kan_fused``,
``tune_pattern_matmul`` and ``KANConfig.blocks`` wait for the kernels'
redesign to give them launch-time knobs (ROADMAP).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.utils import next_pow2

CACHE_SCHEMA_VERSION = 1

# The card's limit on threads a block; candidates never exceed it.
MAX_THREADS_PER_BLOCK = 1024

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

    def clear(self) -> None:
        """Reset to empty: the next save() overwrites rather than merges."""
        self._data = {}
        self._discard_disk = True


_GLOBAL_CACHE: Optional[AutotuneCache] = None


def get_cache() -> AutotuneCache:
    """The process's cache at ``default_cache_path()`` (re-resolved when
    the environment variable changes)."""
    global _GLOBAL_CACHE
    if _GLOBAL_CACHE is None or _GLOBAL_CACHE.path != default_cache_path():
        _GLOBAL_CACHE = AutotuneCache()
    return _GLOBAL_CACHE


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


def candidates_spline_basis(n: int) -> List[Dict[str, int]]:
    """``block_n`` (threads a block, one input each): 64..1024, and none
    above ``n``'s power-of-two bucket (floor 64)."""
    cap = min(next_pow2(max(64, n)), MAX_THREADS_PER_BLOCK)
    return [{"block_n": b} for b in (64, 128, 256, 512, 1024) if b <= cap]


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
                  candidates_spline_basis(n), device=flat.device, reps=reps,
                  cache=cache)
