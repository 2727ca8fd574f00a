"""LM token pipeline: synthetic + file-backed sources, sharded host loading.

Counterpart of ``repro/data/lm.py``, numpy only: every ``batch_at(step)``
array is byte-equal to the reference's for any seed, step, ``n_shards``
and ``shard_id``.  Each data-parallel replica gets a disjoint,
deterministic stream keyed by (step, shard), so a restart resumes
exactly, and no host holds the global batch:

  * SyntheticLM  -- deterministic zipf-ish token stream from a counter-based
    PRNG on (seed, step, shard); no disk, infinitely long.
  * FileLM       -- memory-mapped token file (np.uint32), sharded by range.
  * Prefetcher   -- double-buffered background prefetch.

Both sources emit {"tokens": (B, S+1) int32} so the train step derives
inputs and labels by shifting (``launch/steps._split_batch``), the
convention ``launch/specs.input_specs`` mirrors.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1            # data-parallel host shards
    shard_id: int = 0

    @property
    def shard_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0, (
            "global batch must divide across data shards")
        return self.global_batch // self.n_shards


class SyntheticLM:
    """Deterministic synthetic token stream (zipf-like unigram mixture).

    Tokens are produced by a counter-based generator keyed on
    (seed, step, shard, position), so shard streams are disjoint and
    resuming at step k reproduces exactly the batch a failed worker saw.
    """

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        # Zipf-ish unigram distribution over a capped alphabet for cheap
        # sampling: P(rank r) ~ 1/(r+10).
        v = cfg.vocab_size
        ranks = np.arange(v, dtype=np.float64)
        p = 1.0 / (ranks + 10.0)
        self._cdf = np.cumsum(p / p.sum())

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.shard_id]))
        u = rng.random((c.shard_batch, c.seq_len + 1))
        tokens = np.searchsorted(self._cdf, u).astype(np.int32)
        return {"tokens": np.clip(tokens, 0, c.vocab_size - 1)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class FileLM:
    """Token file source: flat np.uint32 binary, range-sharded, wrapping."""

    def __init__(self, cfg: LMDataConfig, path: str):
        self.cfg = cfg
        self._data = np.memmap(path, dtype=np.uint32, mode="r")
        n = len(self._data)
        per = n // cfg.n_shards
        self._lo, self._hi = cfg.shard_id * per, (cfg.shard_id + 1) * per
        assert self._hi - self._lo > cfg.seq_len + 1, "shard too small"

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        span = self._hi - self._lo
        need = c.seq_len + 1
        out = np.empty((c.shard_batch, need), np.int32)
        for b in range(c.shard_batch):
            # deterministic wrapping offsets
            off = (step * c.shard_batch + b) * need % (span - need)
            out[b] = self._data[self._lo + off: self._lo + off + need]
        return {"tokens": np.clip(out, 0, c.vocab_size - 1)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Double-buffered background prefetch (keeps the device queue full)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def make_source(cfg: LMDataConfig, path: Optional[str] = None):
    return FileLM(cfg, path) if path else SyntheticLM(cfg)
