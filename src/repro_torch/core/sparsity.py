"""Stage-2 pattern sparsity: static m-of-4 masks (paper Sec. IV-C).

Counterpart of ``repro/core/sparsity.py``.  Masks are host numpy: they
are fixed at training time and compacted into the weights once, when a
layer is built, so the contraction dimension shrinks by keep/4.  The
sparsity statistics at the bottom give the cycle model measured rates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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

    def is_tiled(self) -> Optional[np.ndarray]:
        """The 4-bit pattern if this mask is one pattern tiled, else None."""
        full = (self.n // GROUP) * GROUP
        if full == 0:
            return None
        g = self.keep[:full].reshape(-1, GROUP)
        if (g == g[0]).all() and self.keep[full:].all():
            return g[0].copy()
        return None


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


def magnitude_mask(saliency: np.ndarray, keep_per_group: int) -> PatternMask:
    """m-of-4 mask keeping the highest-saliency entries per group ([23,24]).

    ``saliency`` is any per-node importance score, e.g. sum|W| over the
    fan-out (Wanda-style) -- computed offline from trained weights.
    """
    n = saliency.shape[0]
    keep = np.ones(n, bool)
    full = (n // GROUP) * GROUP
    g = saliency[:full].reshape(-1, GROUP)
    order = np.argsort(-g, axis=1)  # descending
    gkeep = np.zeros_like(g, dtype=bool)
    np.put_along_axis(gkeep, order[:, :keep_per_group], True, axis=1)
    keep[:full] = gkeep.reshape(-1)
    return PatternMask(keep)


def weight_saliency(w: np.ndarray, axis_out: int = -1) -> np.ndarray:
    """Fan-out L1 saliency of each input node of a weight matrix."""
    return np.abs(w).sum(axis=axis_out)


def _kept_index(x: torch.Tensor, mask: PatternMask) -> torch.Tensor:
    return torch.as_tensor(mask.indices(), dtype=torch.long, device=x.device)


def compact_rows(w: torch.Tensor, mask: PatternMask) -> torch.Tensor:
    """Drop weight rows (contraction-dim entries) that the mask removes."""
    return w.index_select(0, _kept_index(w, mask))


def compact_cols_activation(x: torch.Tensor,
                            mask: PatternMask) -> torch.Tensor:
    """Gather the kept activation lanes (the last dimension)."""
    return x.index_select(-1, _kept_index(x, mask))


def apply_mask(x: torch.Tensor, mask: PatternMask) -> torch.Tensor:
    """Multiplicative form (semantics oracle): zero masked-out lanes."""
    keep = torch.as_tensor(mask.keep.astype(np.float32), device=x.device)
    return x * keep.to(x.dtype)


# Sparsity statistics (measured rates for the VIKIN cycle model).

def activation_nnz_rate(x: torch.Tensor, atol: float = 0.0) -> float:
    """Fraction of non-zero activations (ReLU streams etc.)."""
    return float(torch.mean((torch.abs(x) > atol).to(torch.float32)))


def spline_nnz_rate(grid_size: int, order: int) -> float:
    """Structural non-zero fraction of a B-spline basis vector: (K+1)/(G+K)."""
    return (order + 1) / (grid_size + order)


def combined_keep_rate(structural: float, pattern: float) -> float:
    """Expected node keep-rate after both stages (independent filters)."""
    return structural * (1.0 - pattern)
