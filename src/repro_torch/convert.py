"""Carry weights, masks and int8 scales between the JAX package and the port.

``jax.random`` draws cannot be reproduced with ``torch.Generator``s, so
parity tests and served checkpoints move weights across instead of
re-initialising them.  The port keeps the JAX layouts -- no transposes --
so both packages contract like with like:

* kan layer: ``{"w_b": (n_in, n_out), "t": (n_in, G+K, n_out)}``
* mlp layer: ``{"w": (n_in, n_out), "b": (n_out,)}``

``stack_params_to_numpy`` is the reverse direction: the port's params
(trained on any device) as numpy arrays in that layout, which the
reference's functions take as they are.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.kan import KANConfig
from repro_torch.core.quant import LayerScales, StackScales
from repro_torch.core.sparsity import PatternMask
from repro_torch.models.ffn import stack_layer_cfgs
from repro_torch.utils import host_f32


def _layer_from_jax(p: Mapping[str, Any], want: Mapping[str, tuple],
                    what: str) -> Dict[str, torch.Tensor]:
    """f32 CPU tensors of one layer's arrays; raises naming ``what`` if a
    key or shape differs from ``want``."""
    if set(p) != set(want):
        raise ValueError(f"{what}: keys {sorted(p)}, expected "
                         f"{sorted(want)}")
    layer = {}
    for k, shape in want.items():
        a = np.asarray(p[k], np.float32)
        if a.shape != shape:
            raise ValueError(f"{what} {k}: shape {a.shape}, expected {shape}")
        layer[k] = torch.from_numpy(a.copy())
    return layer


def _kan_shapes(cfg: KANConfig) -> Dict[str, tuple]:
    return {"w_b": (cfg.n_in, cfg.n_out),
            "t": (cfg.n_in, cfg.spec.n_bases, cfg.n_out)}


def kan_params_from_jax(p: Mapping[str, Any],
                        cfg: KANConfig) -> Dict[str, torch.Tensor]:
    """One lone KAN layer's ``{"w_b", "t"}`` (numpy arrays, e.g.
    ``np.asarray`` of each JAX leaf) as f32 CPU tensors; raises if a key
    or shape does not match ``cfg``."""
    return _layer_from_jax(p, _kan_shapes(cfg),
                           f"KAN layer {cfg.n_in}->{cfg.n_out}")


def stack_params_from_jax(params: Sequence[Mapping[str, Any]],
                          model: Any) -> List[Dict[str, torch.Tensor]]:
    """One dict of f32 CPU tensors per layer from the JAX stack params
    (a list of dicts of numpy arrays, e.g. ``np.asarray`` of each leaf);
    raises if a key or shape does not match ``model``."""
    cfgs = stack_layer_cfgs(model)
    if len(params) != len(cfgs):
        raise ValueError(f"{len(params)} layer dicts for the "
                         f"{len(cfgs)}-layer stack {model.name!r}")
    out = []
    for i, (p, (kind, cfg)) in enumerate(zip(params, cfgs)):
        if kind == "kan":
            want = _kan_shapes(cfg)
        else:
            want = {"w": (cfg["n_in"], cfg["n_out"]), "b": (cfg["n_out"],)}
        out.append(_layer_from_jax(p, want, f"layer {i} ({kind})"))
    return out


def masks_from_keep(keeps: Sequence[Optional[Any]]
                    ) -> List[Optional[PatternMask]]:
    """Per-layer optional ``keep`` arrays (e.g. the JAX masks'
    ``.keep``) -> the port's PatternMasks; None stays None."""
    return [None if k is None else PatternMask(np.asarray(k, bool).copy())
            for k in keeps]


def scales_from_jax(scales: Any) -> StackScales:
    """The JAX ``StackScales`` (read through its fields as plain floats and
    numpy arrays) -> the port's, value for value."""
    out = []
    for ls in scales.scales:
        if ls.kind == "mlp":
            out.append(LayerScales(kind="mlp", x=float(ls.x),
                                   w=np.array(ls.w, np.float32)))
        else:
            out.append(LayerScales(kind="kan", x=float(ls.x),
                                   w_b=float(ls.w_b),
                                   t=np.array(ls.t, np.float32)))
    return StackScales(tuple(out))


def stack_params_to_numpy(params: Sequence[Mapping[str, Any]]
                          ) -> List[Dict[str, np.ndarray]]:
    """The port's stack params (one dict of tensors per layer, on any
    device) as f32 numpy arrays in the same layout, one dict per layer."""
    return [{k: host_f32(v).copy() for k, v in p.items()} for p in params]
