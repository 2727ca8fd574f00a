"""B-spline machinery for KANs (paper Eq. 4-5), in PyTorch.

Counterpart of ``repro/core/splines.py``.  G is restricted to {2,4,8,16}
and K to {1,2,3,4}; on the uniform grid the de Boor denominators are the
integers 1..K, so the recursion multiplies by ``INV_LUT`` and never
divides.

* ``bases_dense`` -- textbook Cox-de Boor over all G+K bases (the oracle).
* ``bases_local`` -- the SPU path: locate the knot cell with one
  multiply + floor, then run the recursion over the K+1 structurally
  non-zero bases only, with the knot differences formed once (the stage
  buffer).

Every function applies the same f32 operations in the same order as the
JAX reference, one op per torch call, so the results are bitwise equal
on the CPU (pinned by ``tests/test_torch_splines.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

VALID_G = (2, 4, 8, 16)
VALID_K = (1, 2, 3, 4)

# Reciprocal LUT replacing FP division in the de Boor recursion.  Index j
# holds 1/j.
INV_LUT = (0.0, 1.0, 0.5, 1.0 / 3.0, 0.25)


@dataclasses.dataclass(frozen=True)
class SplineSpec:
    """Static configuration of a B-spline basis set (one KAN layer)."""

    grid_size: int = 4          # G: knot intervals inside [x0, x1]
    order: int = 3              # K: spline order (degree)
    x0: float = -1.0
    x1: float = 1.0

    def __post_init__(self) -> None:
        if self.grid_size not in VALID_G:
            raise ValueError(f"G must be one of {VALID_G}, got {self.grid_size}")
        if self.order not in VALID_K:
            raise ValueError(f"K must be one of {VALID_K}, got {self.order}")
        if not self.x1 > self.x0:
            raise ValueError("x1 must exceed x0")

    @property
    def n_bases(self) -> int:
        """Number of basis functions B_i(x): G + K."""
        return self.grid_size + self.order

    @property
    def n_active(self) -> int:
        """Bases with non-zero value at any x: K + 1 (local support)."""
        return self.order + 1

    @property
    def h(self) -> float:
        """Knot spacing."""
        return (self.x1 - self.x0) / self.grid_size

    @property
    def inv_h(self) -> float:
        return self.grid_size / (self.x1 - self.x0)

    @property
    def clip_hi(self) -> float:
        """Upper clip bound ``x1 - eps`` with ``eps = 1e-6 * (x1 - x0)``."""
        return self.x1 - 1e-6 * (self.x1 - self.x0)

    def knots(self) -> np.ndarray:
        """Extended uniform knot vector: G + 2K + 1 knots,
        t_j = x0 + (j - K) * h for j = 0 .. G+2K."""
        j = np.arange(self.grid_size + 2 * self.order + 1)
        return self.x0 + (j - self.order) * self.h

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        """Clip inputs into the grid's supported range [x0, x1)."""
        return torch.clamp(x, self.x0, self.clip_hi)


def silu(x: torch.Tensor) -> torch.Tensor:
    """silu(x) = x * sigmoid(x) (paper Eq. 2)."""
    return x * torch.sigmoid(x)


def bases_dense(x: torch.Tensor, spec: SplineSpec) -> torch.Tensor:
    """All G+K basis values at x.  Shape: x.shape + (G+K,)."""
    t = torch.as_tensor(spec.knots(), dtype=x.dtype, device=x.device)
    xe = x[..., None]
    b = ((xe >= t[:-1]) & (xe < t[1:])).to(x.dtype)
    for k in range(1, spec.order + 1):
        left = (xe - t[: -(k + 1)]) / (t[k:-1] - t[: -(k + 1)])
        right = (t[k + 1:] - xe) / (t[k + 1:] - t[1:-k])
        b = left * b[..., :-1] + right * b[..., 1:]
    return b


def locate_cell(x: torch.Tensor,
                spec: SplineSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knot-interval location by multiply + floor (no division, no search).

    Returns (cell, r): cell in [0, G-1] (int32), r in [0, 1) the position
    of x inside that cell in knot units.  Runs in f32 whatever x's dtype.
    """
    xf = x.to(torch.float32)
    u = (xf - spec.x0) * torch.tensor(spec.inv_h, dtype=torch.float32,
                                      device=x.device)
    cell = torch.clamp(torch.floor(u), 0, spec.grid_size - 1)
    r = (u - cell).to(x.dtype)
    return cell.to(torch.int32), r


def bases_local(x: torch.Tensor,
                spec: SplineSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K+1 structurally non-zero basis values at x, plus their offset.

    Returns (vals, cell): vals has shape x.shape + (K+1,) and
    vals[..., j] == bases_dense(x)[..., cell + j] for in-range x.
    """
    K = spec.order
    cell, r = locate_cell(x, spec)
    d = torch.arange(K, dtype=x.dtype, device=x.device)
    right = (d + 1.0) - r[..., None]          # stage buffer, x.shape + (K,)
    left = r[..., None] + d

    vals = [torch.ones_like(r)] + [torch.zeros_like(r) for _ in range(K)]
    for j in range(1, K + 1):
        inv = torch.tensor(INV_LUT[j], dtype=x.dtype, device=x.device)
        saved = torch.zeros_like(r)
        for rr in range(j):
            temp = vals[rr] * inv
            vals[rr] = saved + right[..., rr] * temp
            saved = left[..., j - rr - 1] * temp
        vals[j] = saved
    return torch.stack(vals, dim=-1), cell


def scatter_local(vals: torch.Tensor, cell: torch.Tensor,
                  spec: SplineSpec) -> torch.Tensor:
    """Place the K+1 local values into the dense G+K vector."""
    kbv = torch.arange(spec.n_bases, dtype=torch.int32, device=vals.device)
    return scatter_kept(vals, cell, kbv, spec.n_active)


def scatter_kept(vals: torch.Tensor, cell: torch.Tensor, kbv: torch.Tensor,
                 n_active: int) -> torch.Tensor:
    """Scatter the K+1 local values into the kept-basis columns ``kbv``.

    One delta tensor ``kbv - cell`` and exactly ``n_active`` selects,
    independent of how many basis columns are kept.
    """
    delta = kbv.to(torch.int32) - cell[..., None]
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    out = torch.zeros(delta.shape, dtype=vals.dtype, device=vals.device)
    for j in range(n_active):
        out = out + torch.where(delta == j, vals[..., j:j + 1], zero)
    return out


def gather_local(dense: torch.Tensor, cell: torch.Tensor,
                 spec: SplineSpec) -> torch.Tensor:
    """Inverse of ``scatter_local``: the K+1 values at ``cell..cell+K``."""
    idx = torch.arange(spec.n_bases, dtype=torch.int32, device=dense.device)
    out = []
    for j in range(spec.n_active):
        sel = (idx == cell[..., None] + j).to(dense.dtype)
        out.append(torch.sum(dense * sel, dim=-1))
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# Operation counting (feeds the VIKIN cycle model).
# ---------------------------------------------------------------------------

def spu_op_count(spec: SplineSpec, stage_buffer: bool = True) -> int:
    """Scalar-op count to evaluate the basis set for ONE input.

    ``stage_buffer=False`` recomputes the knot differences at every order;
    ``True`` forms them once and reuses them (the paper's -21%).
    """
    K = spec.order
    ops = 4                 # cell location: sub + mul + floor + sub
    if stage_buffer:
        ops += 2 * K        # stage buffer fill: K rights + K lefts
    for j in range(1, K + 1):
        for _ in range(j):
            ops += 5        # temp = N*inv; N = saved + right*temp; saved = ...
            if not stage_buffer:
                ops += 2    # recompute the two knot differences
    return ops


def dense_eval_op_count(spec: SplineSpec) -> int:
    """Ops to evaluate ALL G+K bases by the dense recursion."""
    G, K = spec.grid_size, spec.order
    ops = G + 2 * K         # order-0 indicators
    n = G + 2 * K
    for _ in range(1, K + 1):
        n -= 1
        ops += n * 6
    return ops
