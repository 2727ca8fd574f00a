"""Mixture-of-Experts: its config alone, so far.

Counterpart of the ``MoEConfig`` of ``repro/models/moe.py``, copied
exactly, so that ``configs/base.ArchConfig.moe_cfg`` and the arch
registry are whole.  The capacity-bounded dispatch (``moe_init``,
``moe_apply``, ``moe_init_with_shared``) is not ported yet
(``ROADMAP.md``, queue 1, item 2); ``models/transformer`` refuses an
FFN of kind ``"moe"``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                    # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4: one always-on shared expert
    router_jitter: float = 0.0
    ffn_kind: str = "swiglu"     # swiglu | kan
    kan_grid: int = 4
    kan_order: int = 3

    def capacity(self, n_tokens: int) -> int:
        c = int(self.capacity_factor * self.top_k * n_tokens
                / self.n_experts) + 1
        return max(self.top_k, min(c, n_tokens))
