"""LR schedules as step -> f32 tensor functions.

Counterpart of ``repro/optim/schedules.py``: the same f32 arithmetic in
the same order.  ``step`` may be a Python number or a tensor on any
device; the result is a 0-d f32 tensor (on ``step``'s device).
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

Step = Union[int, float, torch.Tensor]
Schedule = Callable[[Step], torch.Tensor]


def _f32(step: Step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(lr: float) -> Schedule:
    def f(step: Step) -> torch.Tensor:
        return torch.tensor(lr, dtype=torch.float32)
    return f


def _warm_frac(step: torch.Tensor, total_steps: int, warmup: int):
    warm = (torch.clamp(step / warmup, max=1.0) if warmup > 0 else 1.0)
    frac = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0, 1)
    return warm, frac


def linear_schedule(lr: float, total_steps: int, warmup: int = 0,
                    final_frac: float = 0.0) -> Schedule:
    def f(step: Step) -> torch.Tensor:
        warm, frac = _warm_frac(_f32(step), total_steps, warmup)
        decay = 1.0 - (1.0 - final_frac) * frac
        return lr * warm * decay
    return f


def cosine_schedule(lr: float, total_steps: int, warmup: int = 0,
                    final_frac: float = 0.1) -> Schedule:
    def f(step: Step) -> torch.Tensor:
        warm, frac = _warm_frac(_f32(step), total_steps, warmup)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return lr * warm * (final_frac + (1 - final_frac) * cos)
    return f
