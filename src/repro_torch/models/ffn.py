"""Stacked KAN/MLP feed-forward workloads (the VIKIN serving path).

Counterpart of the stack half of ``repro/models/ffn.py``.  A ``model`` is
any config with ``.sizes``, ``.layer_kinds``, ``.spec`` and
``.pattern_rate`` (configs/vikin_models.PaperModelConfig).  Contract:

* "kan" layers run the fused KAN kernel (core/kan.KANLayer) with the
  stage-2 basis mask; inputs are clipped into the spline domain by the
  kernel itself.
* "mlp" layers run the pattern-sparse linear (``PatternLinear``) with a
  fused ReLU epilogue on every non-final layer; the m-of-4 mask applies
  to HIDDEN inputs only (layer i > 0) -- raw request features are never
  masked.

Parameters keep the JAX package's layout: one dict per layer, kan
``{"w_b": (n_in, n_out), "t": (n_in, G+K, n_out)}``, mlp
``{"w": (n_in, n_out), "b": (n_out,)}``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.kan import KANConfig, KANLayer, kan_init
from repro_torch.core.sparsity import (
    PatternMask,
    sparsity_to_pattern,
    tiled_mask,
)
from repro_torch.kernels.pattern_matmul.ops import matmul_compact

Params = Dict[str, torch.Tensor]


def stack_layer_cfgs(model: Any,
                     masks: Optional[Sequence[Optional[PatternMask]]] = None,
                     ) -> List[Tuple[str, Any]]:
    """Per-layer lowering descriptors: ("kan", KANConfig) or ("mlp", dict).

    ``masks`` (one Optional[PatternMask] per layer) overrides the tiled
    masks derived from ``model.pattern_rate``: KAN layers take it over the
    basis dimension, MLP layers over their input dimension.  A None entry
    leaves that layer dense.
    """
    spec = model.spec
    pat = (sparsity_to_pattern(model.pattern_rate)
           if model.pattern_rate > 0 else None)
    if masks is not None and len(masks) != len(model.sizes) - 1:
        raise ValueError(
            f"masks has {len(masks)} entries for "
            f"{len(model.sizes) - 1} layers")
    out: List[Tuple[str, Any]] = []
    for i, (kind, a, b) in enumerate(
            zip(model.layer_kinds, model.sizes, model.sizes[1:])):
        last = i == len(model.sizes) - 2
        override = masks[i] if masks is not None else None
        if kind == "kan":
            if masks is not None:
                kb = (None if override is None
                      else tuple(int(j) for j in override.indices()))
                out.append(("kan", KANConfig(a, b, spec, basis_keep=kb)))
            else:
                out.append(("kan", KANConfig(a, b, spec, pattern=pat)))
        elif kind == "mlp":
            if masks is not None:
                mask = override
            else:
                mask = (tiled_mask(a, pat) if pat is not None and i > 0
                        else None)
            out.append(("mlp", {"n_in": a, "n_out": b, "mask": mask,
                                "act": None if last else "relu"}))
        else:
            raise ValueError(f"unknown stack layer kind {kind!r}")
    return out


def vikin_stack_init(model: Any, generator: Optional[torch.Generator] = None,
                     dtype: torch.dtype = torch.float32) -> List[Params]:
    """He-init MLP layers / KAN-paper init for KAN layers, on the CPU.

    Same shapes and distributions as the JAX ``vikin_stack_init``; the
    draws differ (``tests`` carry weights across with ``convert.py``).
    """
    params: List[Params] = []
    for kind, cfg in stack_layer_cfgs(model):
        if kind == "kan":
            params.append(kan_init(cfg, generator, dtype))
        else:
            a, b = cfg["n_in"], cfg["n_out"]
            params.append({
                "w": torch.randn((a, b), generator=generator, dtype=dtype)
                * float(np.sqrt(2.0 / a)),
                "b": torch.zeros((b,), dtype=dtype),
            })
    return params


class PatternLinear(nn.Module):
    """One MLP layer: ``act(x[..., keep] @ w[keep, :] + b)``.

    The weight rows the mask drops are removed once, here; per call only
    the kept activation lanes are gathered, outside the kernel.
    """

    def __init__(self, cfg: Dict[str, Any], params: Params) -> None:
        super().__init__()
        self.n_in, self.n_out = cfg["n_in"], cfg["n_out"]
        self.act = cfg["act"]
        self.mask: Optional[PatternMask] = cfg["mask"]
        w, b = params["w"], params["b"]
        if tuple(w.shape) != (self.n_in, self.n_out) or tuple(b.shape) != (
                self.n_out,):
            raise ValueError(
                f"PatternLinear {self.n_in}->{self.n_out}: got w "
                f"{tuple(w.shape)} and b {tuple(b.shape)}")
        self.register_buffer("w", w)
        self.register_buffer("b", b)
        idx = None
        w_c = w
        if self.mask is not None:
            idx = torch.as_tensor(self.mask.indices(), dtype=torch.long,
                                  device=w.device)
            w_c = w.index_select(0, idx)
        self.register_buffer("idx", idx, persistent=False)
        self.register_buffer("w_c", w_c.contiguous(), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        xf = x.reshape(-1, self.n_in)
        if self.idx is not None:
            xf = xf.index_select(1, self.idx)
        y = matmul_compact(xf.contiguous(), self.w_c, self.b, act=self.act)
        return y.reshape(*lead, self.n_out)


class VikinStack(nn.Module):
    """A whole KAN/MLP stack, its weights compacted and fused once, in the
    params' dtype: f32 params take f32 x, bf16 params (the reference's
    bf16 serving) bf16 x, every layer emitting its input's dtype."""

    def __init__(self, model: Any, params: Sequence[Params],
                 masks: Optional[Sequence[Optional[PatternMask]]] = None,
                 layer_range: Optional[Tuple[int, int]] = None) -> None:
        super().__init__()
        cfgs = stack_layer_cfgs(model, masks)
        if layer_range is not None:
            lo, hi = layer_range
            if not 0 <= lo < hi <= len(cfgs):
                raise ValueError(
                    f"layer_range {layer_range!r} out of bounds for a "
                    f"{len(cfgs)}-layer stack")
            cfgs = cfgs[lo:hi]
            # accept the full param list (slice it) or a pre-sliced one
            if len(params) != len(cfgs):
                params = params[lo:hi]
        if len(params) != len(cfgs):
            raise ValueError(f"{len(params)} param dicts for a "
                             f"{len(cfgs)}-layer stack")
        self.model = model
        self.kinds = [kind for kind, _ in cfgs]
        self.layers = nn.ModuleList(
            KANLayer(cfg, p) if kind == "kan" else PatternLinear(cfg, p)
            for p, (kind, cfg) in zip(params, cfgs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


def vikin_stack_apply(params: Sequence[Params], x: torch.Tensor, model: Any,
                      *, masks: Optional[Sequence[Optional[PatternMask]]] = None,
                      layer_range: Optional[Tuple[int, int]] = None,
                      ) -> torch.Tensor:
    """Run the stack (or layers ``lo..hi-1`` of it) functionally.

    ``layer_range=(lo, hi)`` runs only those layers against the full or a
    matching pre-sliced ``params``; ``x`` is then layer ``lo``'s input.
    Builds the layers on every call; serving holds a ``VikinStack``.
    Differentiable with respect to the param tensors (and ``x``): the
    weight fusion and compaction are torch ops, and at f32 the KAN and
    matmul kernels carry their gradients (``kernels/grad.py``).
    """
    moved = [{k: v.to(x.device) for k, v in p.items()} for p in params]
    return VikinStack(model, moved, masks, layer_range)(x)
