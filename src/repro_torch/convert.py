"""Carry the JAX package's stack weights and masks into the port.

``jax.random`` draws cannot be reproduced with ``torch.Generator``s, so
parity tests and served checkpoints move weights across instead of
re-initialising them.  The port keeps the JAX layouts -- no transposes --
so both packages contract like with like:

* kan layer: ``{"w_b": (n_in, n_out), "t": (n_in, G+K, n_out)}``
* mlp layer: ``{"w": (n_in, n_out), "b": (n_out,)}``
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.sparsity import PatternMask
from repro_torch.models.ffn import stack_layer_cfgs


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
            want = {"w_b": (cfg.n_in, cfg.n_out),
                    "t": (cfg.n_in, cfg.spec.n_bases, cfg.n_out)}
        else:
            want = {"w": (cfg["n_in"], cfg["n_out"]), "b": (cfg["n_out"],)}
        if set(p) != set(want):
            raise ValueError(f"layer {i} ({kind}): keys {sorted(p)}, "
                             f"expected {sorted(want)}")
        layer = {}
        for k, shape in want.items():
            a = np.asarray(p[k], np.float32)
            if a.shape != shape:
                raise ValueError(f"layer {i} ({kind}) {k}: shape {a.shape}, "
                                 f"expected {shape}")
            layer[k] = torch.from_numpy(a.copy())
        out.append(layer)
    return out


def masks_from_keep(keeps: Sequence[Optional[Any]]
                    ) -> List[Optional[PatternMask]]:
    """Per-layer optional ``keep`` arrays (e.g. the JAX masks'
    ``.keep``) -> the port's PatternMasks; None stays None."""
    return [None if k is None else PatternMask(np.asarray(k, bool).copy())
            for k in keeps]
