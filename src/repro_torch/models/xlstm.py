"""xLSTM blocks (mLSTM + sLSTM): their config alone, so far.

Counterpart of the ``XLSTMConfig`` of ``repro/models/xlstm.py``, copied
exactly, so that ``configs/base.ArchConfig.xlstm_cfg`` and the arch
registry are whole.  The cells (``mlstm_*``, ``slstm_*``) are not ported
yet (``ROADMAP.md``, queue 1, item 2); ``models/transformer`` refuses
``"mlstm"`` and ``"slstm"`` blocks.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int
    proj_factor: float = 2.0       # mLSTM up-projection
    conv_kernel: int = 4
    chunk: int = 128               # chunkwise-parallel chunk length
    slstm_proj_factor: float = 4.0 / 3.0

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)

    @property
    def head_dim(self) -> int:
        assert self.d_inner % self.n_heads == 0
        return self.d_inner // self.n_heads
