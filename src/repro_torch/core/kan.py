"""KAN layers (paper Eq. 1-3) in PyTorch.

Counterpart of ``repro/core/kan.py``.  A KAN layer phi: R^n_in -> R^n_out
is

    phi(x)_q = sum_p  w_b[p,q] silu(x_p)  +  sum_p sum_i  t[p,i,q] B_i(x_p)

with t_i = w_s * c_i pre-folded (Eq. 3).  Stage-2 pattern sparsity over
the basis dimension is a static mask carried in the config.
``KANLayer`` compacts and fuses its weights once, when it is built;
``kan_apply`` is the functional form that does so on every call.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.sparsity import PatternMask, tiled_mask
from repro_torch.core.splines import SplineSpec, bases_dense, silu
from repro_torch.kernels.kan_fused.ops import (
    flatten_t,
    fuse_wt,
    kan_fused_v2,
    kan_linear,
    slot_table,
)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class KANConfig:
    n_in: int
    n_out: int
    spec: SplineSpec = SplineSpec(4, 3)          # paper default: G=4, K=3
    pattern: Optional[Tuple[int, ...]] = None    # tiled 4-bit stage-2 mask
    # explicit kept basis indices (calibrated mask); wins over ``pattern``
    basis_keep: Optional[Tuple[int, ...]] = None

    @property
    def basis_mask(self) -> Optional[PatternMask]:
        if self.basis_keep is not None:
            keep = np.zeros(self.spec.n_bases, bool)
            keep[list(self.basis_keep)] = True
            return PatternMask(keep)
        if self.pattern is None:
            return None
        return tiled_mask(self.spec.n_bases, self.pattern)

    @property
    def kb(self) -> Optional[Tuple[int, ...]]:
        """Kept basis indices (static) under the stage-2 mask."""
        m = self.basis_mask
        return None if m is None else tuple(int(i) for i in m.indices())

    @property
    def n_bases_kept(self) -> int:
        kb = self.kb
        return self.spec.n_bases if kb is None else len(kb)


def kan_init(cfg: KANConfig, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32) -> Params:
    """KAN-paper style init on the CPU: w_b ~ U(-1/sqrt(n_in), 1/sqrt(n_in)),
    spline coefficients 0.1/sqrt(n_in) * N(0, 1).  Same shapes and
    distributions as the JAX ``kan_init``; the draws differ."""
    scale_b = 1.0 / np.sqrt(cfg.n_in)
    w_b = (torch.rand((cfg.n_in, cfg.n_out), generator=generator,
                      dtype=dtype) * 2.0 - 1.0) * scale_b
    t = 0.1 * scale_b * torch.randn(
        (cfg.n_in, cfg.spec.n_bases, cfg.n_out), generator=generator,
        dtype=dtype)
    return {"w_b": w_b, "t": t}


def kan_apply(params: Params, x: torch.Tensor, cfg: KANConfig) -> torch.Tensor:
    """Apply the layer functionally; leading batch dims arbitrary."""
    t_flat = flatten_t(params["t"], cfg.kb)
    return kan_linear(x, params["w_b"], t_flat, cfg.spec, cfg.kb)


class KANLayer(nn.Module):
    """One KAN layer holding its fused ``[w_b ; t[kb]]`` weights.

    The kept-basis compaction, the fused layout and the kernel's slot
    table are built once here, as JAX folds them at trace time.
    """

    def __init__(self, cfg: KANConfig, params: Params) -> None:
        super().__init__()
        self.cfg = cfg
        self.kb = (tuple(range(cfg.spec.n_bases)) if cfg.kb is None
                   else cfg.kb)
        w_b, t = params["w_b"], params["t"]
        if tuple(w_b.shape) != (cfg.n_in, cfg.n_out) or tuple(t.shape) != (
                cfg.n_in, cfg.spec.n_bases, cfg.n_out):
            raise ValueError(
                f"KANLayer {cfg.n_in}->{cfg.n_out}: got w_b "
                f"{tuple(w_b.shape)} and t {tuple(t.shape)}")
        self.register_buffer("w_b", w_b)
        self.register_buffer("t", t)
        self.register_buffer(
            "wt", fuse_wt(w_b, flatten_t(t, cfg.kb), len(self.kb)),
            persistent=False)
        self.register_buffer(
            "slot_of", slot_table(self.kb, cfg.spec.n_bases, w_b.device),
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = kan_fused_v2(x.reshape(-1, self.cfg.n_in).contiguous(), self.wt,
                         self.cfg.spec, self.kb, self.slot_of)
        return y.reshape(*lead, self.cfg.n_out)


def kan_reference_dense(params: Params, x: torch.Tensor,
                        cfg: KANConfig) -> torch.Tensor:
    """Slow dense-oracle apply (tests); honors the stage-2 mask."""
    xf = x.reshape(-1, cfg.n_in).to(torch.float32)
    b = bases_dense(cfg.spec.clip(xf), cfg.spec)
    m = cfg.basis_mask
    if m is not None:
        b = b * torch.as_tensor(m.keep.astype(np.float32), device=x.device)
    y = silu(xf) @ params["w_b"].to(torch.float32)
    y = y + torch.einsum("bpi,pio->bo", b, params["t"].to(torch.float32))
    return y.reshape(*x.shape[:-1], cfg.n_out).to(x.dtype)
