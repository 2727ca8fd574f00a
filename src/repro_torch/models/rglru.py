"""RG-LRU recurrent block (RecurrentGemma / Griffin): its config alone,
so far.

Counterpart of the ``RGLRUConfig`` of ``repro/models/rglru.py``, copied
exactly, so that ``configs/base.ArchConfig.rglru_cfg`` and the arch
registry are whole.  The recurrence (``rglru_init``, ``rglru_apply``,
``rglru_decode_step``) is not ported yet (``ROADMAP.md``, queue 1,
item 2); ``models/transformer`` refuses a ``"rec"`` block.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    lru_width: Optional[int] = None     # defaults to d_model
    conv_kernel: int = 4

    @property
    def width(self) -> int:
        return self.lru_width or self.d_model
