"""Meta-device stand-ins for every model input: shapes and dtypes, with
nothing allocated.

Counterpart of ``repro/launch/specs.py`` (its ``ShapeDtypeStruct``s are
tensors on the meta device here).  ``input_specs(cfg, shape)`` mirrors
what the data pipeline or a serving frontend feeds:

  train   : {"tokens": (B, S+1) int32}  (+ frames/patches stubs)
  prefill : {"tokens": (B, S) int32}    (+ frames/patches stubs)
  decode  : {"token": (B, 1) int32, "caches": the whole cache tree}

``param_specs(cfg)`` is the params' tree (``models/transformer.
param_shapes``) and ``state_specs(cfg)`` the training state's
(``{"params", "opt", "step"}``, the reference's ``jax.eval_shape(
adamw_init, ...)``): they let ``launch/sharding``'s rules run on a
full-size arch without its bytes.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

META = torch.device("meta")


def _spec(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def frontend_specs(cfg: ArchConfig, batch: int) -> Dict[str, torch.Tensor]:
    """The modality stub a batch carries: ``patches`` (vision) or
    ``frames`` (audio), (batch, n_frontend_tokens, d_model) in the
    params' dtype."""
    shape = (batch, cfg.n_frontend_tokens, cfg.d_model)
    if cfg.frontend == "vision":
        return {"patches": _spec(shape, cfg.param_dtype)}
    if cfg.frontend == "audio":
        return {"frames": _spec(shape, cfg.param_dtype)}
    return {}


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": _spec((B, S + 1), torch.int32),
                **frontend_specs(cfg, B)}
    if shape.kind == "prefill":
        return {"tokens": _spec((B, S), torch.int32),
                **frontend_specs(cfg, B)}
    if shape.kind == "decode":
        return {"token": _spec((B, 1), torch.int32),
                "caches": T.init_caches(cfg, B, S + cfg.decode_margin,
                                        META)}
    raise ValueError(shape.kind)



def param_specs(cfg: ArchConfig) -> Any:
    return T.param_shapes(cfg)


def state_specs(cfg: ArchConfig) -> Dict[str, Any]:
    params = T.param_shapes(cfg)
    return {"params": params, "opt": adamw_init(params),
            "step": _spec((), torch.int32)}
