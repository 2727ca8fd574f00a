"""Stage-2 pattern sparsity: static m-of-4 masks (paper Sec. IV-C).

Counterpart of ``repro/core/sparsity.py``.  Masks are host numpy: they
are fixed at training time and compacted into the weights once, when a
layer is built, so the contraction dimension shrinks by keep/4.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

GROUP = 4  # the TSE filters elements in batches of four (paper Sec. IV-C)


@dataclasses.dataclass(frozen=True)
class PatternMask:
    """A static m-of-4 sparsity mask over one tensor dimension.

    ``keep`` is a bool np.ndarray.  ``n`` may not be divisible by 4; a
    tiled mask keeps the trailing partial group whole.
    """

    keep: np.ndarray  # (n,) bool

    def __post_init__(self) -> None:
        if self.keep.dtype != np.bool_ or self.keep.ndim != 1:
            raise ValueError(
                f"PatternMask.keep must be a 1-D bool array, got "
                f"{self.keep.dtype} with shape {self.keep.shape}")

    @property
    def n(self) -> int:
        return int(self.keep.shape[0])

    @property
    def n_keep(self) -> int:
        return int(self.keep.sum())

    @property
    def sparsity(self) -> float:
        return 1.0 - self.n_keep / self.n

    def indices(self) -> np.ndarray:
        """Static gather indices of kept positions (host numpy)."""
        return np.nonzero(self.keep)[0].astype(np.int32)


def tiled_mask(n: int, pattern: Tuple[int, ...]) -> PatternMask:
    """Tile one 4-bit pattern (e.g. (1,0,1,0)) across an n-wide dimension."""
    if len(pattern) != GROUP:
        raise ValueError(f"pattern must have {GROUP} entries, got {pattern}")
    reps = -(-n // GROUP)
    keep = np.tile(np.asarray(pattern, bool), reps)[:n].copy()
    keep[(n // GROUP) * GROUP:] = True  # partial trailing group fully kept
    return PatternMask(keep)


def sparsity_to_pattern(rate: float) -> Tuple[int, ...]:
    """Paper sweep points: 0/25/50/75% -> 4/3/2/1-of-4 patterns."""
    table = {0.0: (1, 1, 1, 1), 0.25: (1, 1, 1, 0), 0.5: (1, 0, 1, 0),
             0.75: (1, 0, 0, 0)}
    if rate not in table:
        raise ValueError(f"pattern sparsity rate must be in {sorted(table)}")
    return table[rate]


def apply_mask(x: torch.Tensor, mask: PatternMask) -> torch.Tensor:
    """Multiplicative form (semantics oracle): zero masked-out lanes."""
    keep = torch.as_tensor(mask.keep.astype(np.float32), device=x.device)
    return x * keep.to(x.dtype)
