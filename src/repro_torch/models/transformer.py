"""Decoder-only transformer assembly: init, forward, prefill and decode.

Counterpart of ``repro/models/transformer.py`` for ``"attn"`` blocks:
one ``ArchConfig`` drives init and every pass.  Params and caches are
nested dicts and lists of tensors in the reference's layout, so
``convert.transformer_params_from_jax`` carries the reference's weights
across leaf for leaf:

  * archs with ``scan_layers`` keep their layers stacked per pattern unit
    under ``"units"`` (a leading ``(n_units,)`` axis); the port walks that
    axis in a Python loop where the reference scans it.  Remainder layers
    sit under ``"extra"``.
  * KAN-FFN hybrids (``ffn_kinds`` set) have per-layer param shapes and
    keep every layer under ``"extra"``; each ``"kan"`` layer's FFN is
    ``models/ffn.kan_ffn_apply``: one fused KAN launch (the up-projection)
    and one pattern-matmul launch (the down-projection) on a CUDA tensor.

``ffns`` (``ffn_modules``) lets a server hold each KAN-FFN layer with its
weights fused and compacted once; without it the functional form
rebuilds them per call.  Either gives the same bits.

Not ported yet (``ROADMAP.md``, queue 1, item 2), each refused with
``NotImplementedError``: ``"rec"``, ``"mlstm"`` and ``"slstm"`` blocks,
FFNs of kind ``"moe"``, the encoder-decoder path (``encode``,
cross-attention blocks) and modality frontends.  ``lm_loss`` and
``param_shapes`` wait for LM training (item 5).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models.layers import (
    dense_init,
    embed,
    embed_init,
    f32_matmul,
    layernorm,
    layernorm_init,
    rmsnorm,
    rmsnorm_init,
    unembed,
)
from repro_torch.utils import leaf_paths, tree_map

Params = Dict[str, Any]
_WAITS = "is not ported yet (ROADMAP.md, queue 1, item 2)"
_BLOCK_MODULE = {"rec": "models/rglru.py", "mlstm": "models/xlstm.py",
                 "slstm": "models/xlstm.py"}


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for an arch that needs a part of the
    reference the port does not have yet."""
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder path (encode, cross-attention "
            f"blocks) {_WAITS}")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend {_WAITS}")
    for kind in cfg.pattern:
        _check_block(cfg, kind)
    if any(cfg.layer_ffn_kind(i) == "moe" for i in range(cfg.n_layers)):
        raise NotImplementedError(
            f"{cfg.name}: FFN kind 'moe' (models/moe.py) {_WAITS}")


def _check_block(cfg: ArchConfig, kind: str) -> None:
    if kind in _BLOCK_MODULE:
        raise NotImplementedError(
            f"{cfg.name}: {kind!r} blocks ({_BLOCK_MODULE[kind]}) {_WAITS}")
    if kind != "attn":
        raise ValueError(kind)


def _stack(trees: Sequence[Any]) -> Any:
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _n_stacked(tree: Any) -> int:
    """Length of the leading (unit) axis of a stacked tree."""
    return int(leaf_paths(tree)[0][1].shape[0])


def _take(tree: Any, i: int) -> Any:
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# Norm helpers (rms vs ln, gemma offset)
# ---------------------------------------------------------------------------

def _norm_init(cfg: ArchConfig, dtype: torch.dtype) -> Params:
    return (rmsnorm_init(cfg.d_model, dtype) if cfg.norm == "rms"
            else layernorm_init(cfg.d_model, dtype))


def _norm(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rms":
        return rmsnorm(p, x, offset=cfg.norm_offset)
    return layernorm(p, x)


# ---------------------------------------------------------------------------
# Single block: init / forward / prefill / decode
# ---------------------------------------------------------------------------

def block_init(generator: Optional[torch.Generator], cfg: ArchConfig,
               kind: str, *, layer: int = 0) -> Params:
    _check_block(cfg, kind)
    dtype = cfg.param_dtype
    p = {"attn_norm": _norm_init(cfg, dtype),
         "attn": A.attn_init(generator, cfg.attn_cfg(), dtype)}
    fk = cfg.layer_ffn_kind(layer)
    if fk == "moe":
        raise NotImplementedError(
            f"{cfg.name}: FFN kind 'moe' (models/moe.py) {_WAITS}")
    if fk != "none" and cfg.d_ff > 0:
        p["ffn_norm"] = _norm_init(cfg, dtype)
        p["ffn"] = F.ffn_init(generator, cfg.ffn_cfg(layer), dtype)
    return p


def _apply_ffn_part(p: Params, x: torch.Tensor, cfg: ArchConfig,
                    layer: int = 0,
                    taps: Optional[Dict[int, torch.Tensor]] = None,
                    ffn: Optional[torch.nn.Module] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in p:
        xn = _norm(cfg, p["ffn_norm"], x)
        if taps is not None:
            # calibration hook: the normed FFN INPUT of this layer (what
            # the saliencies of core/calibrate score against)
            taps[layer] = xn
        y = ffn(xn) if ffn is not None else F.ffn_apply(
            p["ffn"], xn, cfg.ffn_cfg(layer))
        x = x + y
    return x, aux


def block_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str, *,
                layer: int = 0,
                taps: Optional[Dict[int, torch.Tensor]] = None,
                ffn: Optional[torch.nn.Module] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence path (no cache).  Returns (x, aux_loss)."""
    _check_block(cfg, kind)
    x = x + A.attention(p["attn"], _norm(cfg, p["attn_norm"], x),
                        cfg.attn_cfg())
    return _apply_ffn_part(p, x, cfg, layer, taps, ffn)


def block_init_cache(batch: int, max_len: int, cfg: ArchConfig, kind: str,
                     device: torch.device | str = "cpu") -> Params:
    _check_block(cfg, kind)
    acfg = cfg.attn_cfg()
    size = min(max_len, acfg.window) if acfg.window else max_len
    return A.init_cache(batch, size, acfg, cfg.param_dtype, device)


def block_prefill(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str,
                  max_len: int, *, layer: int = 0,
                  ffn: Optional[torch.nn.Module] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence pass that also returns the decode cache."""
    _check_block(cfg, kind)
    acfg = cfg.attn_cfg()
    xn = _norm(cfg, p["attn_norm"], x)
    size = min(max_len, acfg.window) if acfg.window else max_len
    # prefill_cache handles the ring layout when S > window
    y, cache = A.prefill_cache(p["attn"], xn, acfg, size,
                               dtype=cfg.param_dtype)
    x, _ = _apply_ffn_part(p, x + y, cfg, layer, ffn=ffn)
    return x, cache


def block_decode(p: Params, x1: torch.Tensor, cfg: ArchConfig, kind: str,
                 cache: Params, *, layer: int = 0,
                 ffn: Optional[torch.nn.Module] = None
                 ) -> Tuple[torch.Tensor, Params]:
    """One-token step.  Returns (x1, new_cache)."""
    _check_block(cfg, kind)
    y, cache = A.decode_step(p["attn"], _norm(cfg, p["attn_norm"], x1),
                             cfg.attn_cfg(), cache)
    x1, _ = _apply_ffn_part(p, x1 + y, cfg, layer, ffn=ffn)
    return x1, cache


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def _unit_counts(cfg: ArchConfig) -> Tuple[int, int]:
    if cfg.ffn_kinds is not None:
        # per-layer FFN variants have per-layer param SHAPES: nothing to
        # stack into units, so every layer sits under "extra"
        # (ArchConfig validation pins scan_layers=False)
        return 0, cfg.n_layers
    u = len(cfg.pattern)
    return cfg.n_layers // u, cfg.n_layers % u


def _block_kind(cfg: ArchConfig, i: int) -> str:
    """Block kind of absolute layer ``i`` (pattern tiles past one unit)."""
    return cfg.pattern[i % len(cfg.pattern)]


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device: torch.device | str = "cpu") -> Params:
    """Random params of ``cfg`` in ``cfg.param_dtype`` on ``device``, drawn
    on the CPU from ``generator`` (the reference's shapes and
    distributions; ``jax.random``'s draws cannot be reproduced)."""
    check_supported(cfg)
    dtype = cfg.param_dtype
    p: Params = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                                     dtype)}
    n_units, rem = _unit_counts(cfg)
    units = [{f"slot{i}": block_init(generator, cfg, kind)
              for i, kind in enumerate(cfg.pattern)}
             for _ in range(n_units)]
    if units:
        p["units"] = _stack(units)
    off = n_units * len(cfg.pattern)
    p["extra"] = [block_init(generator, cfg, _block_kind(cfg, off + i),
                             layer=off + i) for i in range(rem)]
    p["final_norm"] = _norm_init(cfg, dtype)
    if not cfg.tied_embeddings:
        p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                  dtype=dtype)
    return tree_map(lambda a: a.to(device), p)


def ffn_modules(params: Params, cfg: ArchConfig
                ) -> List[Optional[torch.nn.Module]]:
    """One entry per ``params["extra"]`` layer: a ``models/ffn.KanFFN``
    (weights fused and compacted once) for a ``"kan"`` FFN, else None."""
    n_units, _ = _unit_counts(cfg)
    off = n_units * len(cfg.pattern)
    return [F.KanFFN(cfg.ffn_cfg(off + i), bp["ffn"])
            if "ffn" in bp and cfg.layer_ffn_kind(off + i) == "kan" else None
            for i, bp in enumerate(params["extra"])]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed_in(params: Params, cfg: ArchConfig,
              tokens: torch.Tensor) -> torch.Tensor:
    x = embed(params["embed"], tokens)
    if cfg.embed_scale:
        # a 0-dim host tensor: no copy to the device (CUDA-graph safe)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x.to(cfg.param_dtype)


def _ffn_of(ffns: Optional[Sequence[Optional[torch.nn.Module]]],
            i: int) -> Optional[torch.nn.Module]:
    return None if ffns is None else ffns[i]


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            ffn_taps: Optional[Dict[int, torch.Tensor]] = None,
            ffns: Optional[Sequence[Optional[torch.nn.Module]]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden (B, S, d), aux_loss).  ``ffn_taps`` collects
    each ``"extra"`` layer's normed FFN input by absolute layer index."""
    check_supported(cfg)
    x = _embed_in(params, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "units" in params:
        for u in range(_n_stacked(params["units"])):
            up = _take(params["units"], u)
            for i, kind in enumerate(cfg.pattern):
                x, a = block_apply(up[f"slot{i}"], x, cfg, kind)
                aux = aux + a
    n_units, _ = _unit_counts(cfg)
    off = n_units * len(cfg.pattern)
    for i, bp in enumerate(params["extra"]):
        x, a = block_apply(bp, x, cfg, _block_kind(cfg, off + i),
                           layer=off + i, taps=ffn_taps,
                           ffn=_ffn_of(ffns, i))
        aux = aux + a
    return _norm(cfg, params["final_norm"], x), aux


def _logits(params: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.tied_embeddings:
        return unembed(params["embed"], h)
    return f32_matmul(h, params["lm_head"]["kernel"])


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device: torch.device | str = "cpu") -> Params:
    check_supported(cfg)
    n_units, rem = _unit_counts(cfg)
    caches: Params = {}
    if n_units:
        caches["units"] = _stack([
            {f"slot{i}": block_init_cache(batch, max_len, cfg, kind, device)
             for i, kind in enumerate(cfg.pattern)}
            for _ in range(n_units)])
    off = n_units * len(cfg.pattern)
    caches["extra"] = [
        block_init_cache(batch, max_len, cfg, _block_kind(cfg, off + i),
                         device) for i in range(rem)]
    return caches


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            max_len: Optional[int] = None,
            ffns: Optional[Sequence[Optional[torch.nn.Module]]] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Full forward + cache build.  Returns (last-position logits, caches)."""
    check_supported(cfg)
    x = _embed_in(params, cfg, tokens)
    total = x.shape[1]
    # the cache covers the prompt + margin
    max_len = max(max_len or 0, total + cfg.decode_margin)
    caches: Params = {}
    if "units" in params:
        per_unit = []
        for u in range(_n_stacked(params["units"])):
            up = _take(params["units"], u)
            uc = {}
            for i, kind in enumerate(cfg.pattern):
                x, uc[f"slot{i}"] = block_prefill(up[f"slot{i}"], x, cfg,
                                                  kind, max_len)
            per_unit.append(uc)
        caches["units"] = _stack(per_unit)
    caches["extra"] = []
    n_units, _ = _unit_counts(cfg)
    off = n_units * len(cfg.pattern)
    for i, bp in enumerate(params["extra"]):
        x, c = block_prefill(bp, x, cfg, _block_kind(cfg, off + i), max_len,
                             layer=off + i, ffn=_ffn_of(ffns, i))
        caches["extra"].append(c)
    h = _norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, h[:, -1:]), caches


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                caches: Params, *,
                ffns: Optional[Sequence[Optional[torch.nn.Module]]] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One token for the whole stack.  Returns (logits (B,1,V), caches);
    the input caches are left as they were."""
    check_supported(cfg)
    x = _embed_in(params, cfg, token)
    new_caches: Params = {}
    if "units" in params:
        per_unit = []
        for u in range(_n_stacked(params["units"])):
            up, uc = _take(params["units"], u), _take(caches["units"], u)
            nc = {}
            for i, kind in enumerate(cfg.pattern):
                x, nc[f"slot{i}"] = block_decode(up[f"slot{i}"], x, cfg,
                                                 kind, uc[f"slot{i}"])
            per_unit.append(nc)
        new_caches["units"] = _stack(per_unit)
    new_caches["extra"] = []
    n_units, _ = _unit_counts(cfg)
    off = n_units * len(cfg.pattern)
    for i, bp in enumerate(params["extra"]):
        x, c = block_decode(bp, x, cfg, _block_kind(cfg, off + i),
                            caches["extra"][i], layer=off + i,
                            ffn=_ffn_of(ffns, i))
        new_caches["extra"].append(c)
    h = _norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, h), new_caches


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1) int32 argmax of the last position (the first index of a
    tie, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
