"""KAN layers (paper Eq. 1-3) in PyTorch.

Counterpart of ``repro/core/kan.py``.  A KAN layer phi: R^n_in -> R^n_out
is

    phi(x)_q = sum_p  w_b[p,q] silu(x_p)  +  sum_p sum_i  t[p,i,q] B_i(x_p)

with t_i = w_s * c_i pre-folded (Eq. 3).  Stage-2 pattern sparsity over
the basis dimension is a static mask carried in the config, and
``KANConfig.version`` picks the kernel generation (2: one pass against
the fused ``[w_b ; t]`` rows; 1: the silu and spline branches apart),
and ``KANConfig.blocks`` the kernel's launch knobs, at either version.
``KANLayer`` compacts (and at version 2 fuses) its weights once, when it
is built; ``kan_apply`` is the functional form that does so on every
call.  The device of the input picks kernel or plain version.

Accuracy scaling: ``extend_grid`` refits the spline coefficients onto a
finer grid (larger G) by least squares (paper Sec. II-B, Fig. 8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.core.sparsity import PatternMask, tiled_mask
from repro_torch.core.splines import (
    SplineSpec,
    bases_dense,
    dense_eval_op_count,
    silu,
    spu_op_count,
)
from repro_torch.kernels.kan_fused.ops import (
    DEFAULT_VERSION,
    flatten_t,
    fuse_wt,
    kan_fused_v1,
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
    version: int = DEFAULT_VERSION               # fused-kernel generation
    # (bm, bi, bn) of the kernel of this version; None -> autotune cache,
    # then the kernel's defaults
    blocks: Optional[Tuple[int, int, int]] = None

    def __post_init__(self) -> None:
        if self.version not in (1, 2):
            raise ValueError(f"KANConfig.version must be 1 or 2, got "
                             f"{self.version!r}")

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

    def param_count(self) -> int:
        return self.n_in * self.n_out * (1 + self.spec.n_bases)


def kan_init(cfg: KANConfig, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32) -> Params:
    """KAN-paper style init on the generator's device (the CPU for None):
    w_b ~ U(-1/sqrt(n_in), 1/sqrt(n_in)) in ``dtype``, spline coefficients
    ``t`` ~ 0.1/sqrt(n_in) * N(0, 1) in ``promote_types(dtype, f32)``.
    Same shapes, distributions and dtypes as the JAX ``kan_init``; the
    draws differ.

    ``t`` is f32 in a bf16 model because it is in the reference: its
    scale ``0.1 * scale_b`` is a numpy float64, a strongly typed scalar
    that JAX (without x64) takes as f32, so the product promotes the
    bf16 draw to f32.  A bf16 model's fused ``[w_b ; t]`` rows are then
    f32, and its layers run the bf16-x / f32-weight kernel
    (``kan_fused_v2``)."""
    scale_b = 1.0 / np.sqrt(cfg.n_in)
    device = torch.device("cpu") if generator is None else generator.device
    w_b = (torch.rand((cfg.n_in, cfg.n_out), generator=generator,
                      dtype=dtype, device=device) * 2.0 - 1.0) * scale_b
    t = 0.1 * scale_b * torch.randn(
        (cfg.n_in, cfg.spec.n_bases, cfg.n_out), generator=generator,
        dtype=torch.promote_types(dtype, torch.float32), device=device)
    return {"w_b": w_b, "t": t}


def kan_apply(params: Params, x: torch.Tensor, cfg: KANConfig) -> torch.Tensor:
    """Apply the layer functionally; leading batch dims arbitrary."""
    t_flat = flatten_t(params["t"], cfg.kb)
    return kan_linear(x, params["w_b"], t_flat, cfg.spec, cfg.kb,
                      version=cfg.version, blocks=cfg.blocks)


class KANLayer(nn.Module):
    """One KAN layer holding its compacted weights: the fused ``[w_b ;
    t[kb]]`` rows ``wt`` at version 2, ``w_b`` and the kept-basis rows
    ``t_flat`` at version 1, in the params' dtype (f32, or bf16 for the
    bf16 kernels, which then take bf16 x).

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
        self.register_buffer("w_b", w_b.contiguous())
        self.register_buffer("t", t)
        t_flat = flatten_t(t, cfg.kb).contiguous()
        if cfg.version == 2:
            self.register_buffer("wt", fuse_wt(w_b, t_flat, len(self.kb)),
                                 persistent=False)
        else:
            self.register_buffer("t_flat", t_flat, persistent=False)
        self.register_buffer(
            "slot_of", slot_table(self.kb, cfg.spec.n_bases, w_b.device),
            persistent=False)

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """x's dtype out, or ``out_dtype`` (f32: a bf16 layer's
        tensor-parallel partial)."""
        lead = x.shape[:-1]
        xf = x.reshape(-1, self.cfg.n_in).contiguous()
        if self.cfg.version == 2:
            y = kan_fused_v2(xf, self.wt, self.cfg.spec, self.kb,
                             self.slot_of, blocks=self.cfg.blocks,
                             out_dtype=out_dtype)
        else:
            y = kan_fused_v1(xf, self.w_b, self.t_flat, self.cfg.spec,
                             self.kb, self.slot_of, blocks=self.cfg.blocks,
                             out_dtype=out_dtype)
        return y.reshape(*lead, self.cfg.n_out)


def kan_stack_apply(
    params_list: Sequence[Params], x: torch.Tensor,
    cfgs: Sequence[KANConfig], return_hidden: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, List[torch.Tensor]]]:
    """Compose L KAN layers: KAN(x) = phi_{L-1} o ... o phi_0 (Eq. 1)."""
    hidden = []
    for p, c in zip(params_list, cfgs):
        x = kan_apply(p, x, c)
        hidden.append(x)
    return (x, hidden) if return_hidden else x


def extend_grid(params: Params, cfg: KANConfig, new_grid_size: int,
                n_samples: int = 512) -> Tuple[Params, KANConfig]:
    """Refit the spline coefficients on a finer grid, the function kept up
    to least-squares error.

    Solves min_t' || A_new t' - A_old t ||^2 on a dense x sample, per
    (input feature, output) pair, sharing one pseudo-inverse.
    """
    old = cfg.spec
    new = dataclasses.replace(old, grid_size=new_grid_size)
    t = params["t"]
    xs = torch.linspace(old.x0, old.x1 - 1e-5, n_samples,
                        dtype=torch.float32, device=t.device)
    a_old = bases_dense(xs, old)                      # (S, nb_old)
    a_new = bases_dense(xs, new)                      # (S, nb_new)
    pinv = torch.linalg.pinv(a_new)                   # (nb_new, S)
    y = torch.einsum("si,pio->spo", a_old, t.to(torch.float32))
    t_new = torch.einsum("ns,spo->pno", pinv, y).to(t.dtype)
    return ({"w_b": params["w_b"], "t": t_new},
            dataclasses.replace(cfg, spec=new))


def kan_op_counts(cfg: KANConfig, batch: int = 1) -> Dict[str, float]:
    """Theoretical op counts for one layer application.

    "dense" -- all G+K bases evaluated and multiply-added (Fig. 8's "ops"
    axis; grows with G); "vikin" -- stage-1 zero-free: K+1 basis
    evaluations (SPU) and K+1 multiply-adds per (input, output), silu
    branch unchanged; "vikin_pattern" -- also drops the masked bases from
    the multiply-adds.
    """
    s = cfg.spec
    n_in, n_out = cfg.n_in, cfg.n_out
    silu_ops = 6 * n_in                       # sigmoid approx + mul
    dense_mac = 2 * n_in * n_out * (s.n_bases + 1)
    dense_eval = n_in * dense_eval_op_count(s)
    spu_eval = n_in * spu_op_count(s)
    nnz = s.n_active
    vikin_mac = 2 * n_in * n_out * (nnz + 1)
    # kept bases inside the K+1 window: nnz * kept / n_bases expected for
    # a tiled mask
    kept_nnz = nnz * cfg.n_bases_kept / s.n_bases
    pattern_mac = 2 * n_in * n_out * (kept_nnz + 1)
    return {
        "dense": batch * (silu_ops + dense_eval + dense_mac),
        "vikin": batch * (silu_ops + spu_eval + vikin_mac),
        "vikin_pattern": batch * (silu_ops + spu_eval + pattern_mac),
        "dense_mac": batch * dense_mac,
        "vikin_mac": batch * vikin_mac,
        "pattern_mac": batch * pattern_mac,
        "spu_eval": batch * spu_eval,
        "silu": batch * silu_ops,
    }


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
