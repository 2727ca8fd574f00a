"""Decoder-only model assembly: init, forward, prefill and decode.

Counterpart of ``repro/models/transformer.py`` for decoder-only archs:
one ``ArchConfig`` drives init and every pass.  Block kinds: ``"attn"``
(GQA + FFN or MoE), ``"rec"`` (RG-LRU + FFN, ``models/rglru``),
``"mlstm"``/``"slstm"`` (xLSTM, self-contained, ``models/xlstm``);
``cfg.pattern`` tiles them.  Params and caches are nested dicts and
lists of tensors in the reference's layout, so
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
  * MoE layers (``"moe"`` FFNs) route through ``models/moe.moe_apply``
    and add its aux loss; with ``ffn_kind="kan"`` every expert is two
    fused-KAN launches on a CUDA tensor.

``ffns`` (``ffn_modules``, one entry per layer by absolute index) lets a
server hold each KAN-FFN layer with its weights fused and compacted
once, and each KAN-expert MoE layer's experts fused once
(``models/moe.KanExperts``); without it the functional forms rebuild
them per call.  Either gives the same bits.

Not ported yet (``ROADMAP.md``, queue 1, item 2), each refused with
``NotImplementedError``: the encoder-decoder path (``encode``,
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
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import xlstm as X
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
BLOCK_KINDS = ("attn", "rec", "mlstm", "slstm")
Ffns = Optional[Sequence[Optional[Any]]]


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
        _check_block(kind)


def _check_block(kind: str) -> None:
    if kind not in BLOCK_KINDS:
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
    _check_block(kind)
    dtype = cfg.param_dtype
    if kind == "attn":
        p = {"attn_norm": _norm_init(cfg, dtype),
             "attn": A.attn_init(generator, cfg.attn_cfg(), dtype)}
        fk = cfg.layer_ffn_kind(layer)
        if fk == "moe":
            p["moe_norm"] = _norm_init(cfg, dtype)
            p["moe"] = M.moe_init_with_shared(generator, cfg.moe_cfg(), dtype)
        elif fk != "none" and cfg.d_ff > 0:
            p["ffn_norm"] = _norm_init(cfg, dtype)
            p["ffn"] = F.ffn_init(generator, cfg.ffn_cfg(layer), dtype)
        return p
    if kind == "rec":
        p = {"rec_norm": _norm_init(cfg, dtype),
             "rec": R.rglru_init(generator, cfg.rglru_cfg(), dtype)}
        if cfg.d_ff > 0:
            p["ffn_norm"] = _norm_init(cfg, dtype)
            p["ffn"] = F.ffn_init(generator, cfg.ffn_cfg(layer), dtype)
        return p
    if kind == "mlstm":
        return {"mlstm": X.mlstm_init(generator, cfg.xlstm_cfg(), dtype)}
    return {"slstm": X.slstm_init(generator, cfg.xlstm_cfg(), dtype)}


def _apply_ffn_part(p: Params, x: torch.Tensor, cfg: ArchConfig,
                    layer: int = 0,
                    taps: Optional[Dict[int, torch.Tensor]] = None,
                    ffn: Optional[Any] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        r = M.moe_apply(p["moe"], _norm(cfg, p["moe_norm"], x),
                        cfg.moe_cfg(), experts=ffn)
        x = x + r["out"]
        aux = r["aux_loss"]
    elif "ffn" in p:
        xn = _norm(cfg, p["ffn_norm"], x)
        if taps is not None:
            # calibration hook: the normed FFN INPUT of this layer (what
            # the saliencies of core/calibrate score against)
            taps[layer] = xn
        y = ffn(xn) if ffn is not None else F.ffn_apply(
            p["ffn"], xn, cfg.ffn_cfg(layer))
        x = x + y
    return x, aux


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def block_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str, *,
                layer: int = 0,
                taps: Optional[Dict[int, torch.Tensor]] = None,
                ffn: Optional[Any] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence path (no cache).  Returns (x, aux_loss)."""
    _check_block(kind)
    if kind == "attn":
        x = x + A.attention(p["attn"], _norm(cfg, p["attn_norm"], x),
                            cfg.attn_cfg())
        return _apply_ffn_part(p, x, cfg, layer, taps, ffn)
    if kind == "rec":
        y, _ = R.rglru_apply(p["rec"], _norm(cfg, p["rec_norm"], x),
                             cfg.rglru_cfg())
        return _apply_ffn_part(p, x + y, cfg, layer, taps, ffn)
    if kind == "mlstm":
        y, _ = X.mlstm_apply(p["mlstm"], x, cfg.xlstm_cfg())
        return y, _no_aux(x)
    y, _ = X.slstm_apply(p["slstm"], x, cfg.xlstm_cfg())
    return y, _no_aux(x)


def block_init_cache(batch: int, max_len: int, cfg: ArchConfig, kind: str,
                     device: torch.device | str = "cpu") -> Params:
    _check_block(kind)
    dtype = cfg.param_dtype
    if kind == "attn":
        acfg = cfg.attn_cfg()
        size = min(max_len, acfg.window) if acfg.window else max_len
        return A.init_cache(batch, size, acfg, dtype, device)
    if kind == "rec":
        return R.rglru_init_state(batch, cfg.rglru_cfg(), dtype, device)
    if kind == "mlstm":
        return X.mlstm_init_state(batch, cfg.xlstm_cfg(), dtype, device)
    return X.slstm_init_state(batch, cfg.xlstm_cfg(), device)


def block_prefill(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str,
                  max_len: int, *, layer: int = 0,
                  ffn: Optional[Any] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence pass that also returns the decode cache."""
    _check_block(kind)
    if kind == "attn":
        acfg = cfg.attn_cfg()
        xn = _norm(cfg, p["attn_norm"], x)
        size = min(max_len, acfg.window) if acfg.window else max_len
        # prefill_cache handles the ring layout when S > window
        y, cache = A.prefill_cache(p["attn"], xn, acfg, size,
                                   dtype=cfg.param_dtype)
        x, _ = _apply_ffn_part(p, x + y, cfg, layer, ffn=ffn)
        return x, cache
    if kind == "rec":
        y, st = R.rglru_apply(p["rec"], _norm(cfg, p["rec_norm"], x),
                              cfg.rglru_cfg())
        x, _ = _apply_ffn_part(p, x + y, cfg, layer, ffn=ffn)
        return x, st
    if kind == "mlstm":
        return X.mlstm_apply(p["mlstm"], x, cfg.xlstm_cfg())
    return X.slstm_apply(p["slstm"], x, cfg.xlstm_cfg())


def block_decode(p: Params, x1: torch.Tensor, cfg: ArchConfig, kind: str,
                 cache: Params, *, layer: int = 0,
                 ffn: Optional[Any] = None
                 ) -> Tuple[torch.Tensor, Params]:
    """One-token step.  Returns (x1, new_cache)."""
    _check_block(kind)
    if kind == "attn":
        y, cache = A.decode_step(p["attn"], _norm(cfg, p["attn_norm"], x1),
                                 cfg.attn_cfg(), cache)
        x1, _ = _apply_ffn_part(p, x1 + y, cfg, layer, ffn=ffn)
        return x1, cache
    if kind == "rec":
        y, st = R.rglru_decode_step(
            p["rec"], _norm(cfg, p["rec_norm"], x1), cfg.rglru_cfg(), cache)
        x1, _ = _apply_ffn_part(p, x1 + y, cfg, layer, ffn=ffn)
        return x1, st
    if kind == "mlstm":
        return X.mlstm_apply(p["mlstm"], x1, cfg.xlstm_cfg(), cache)
    return X.slstm_apply(p["slstm"], x1, cfg.xlstm_cfg(), cache)


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
    from ``generator`` on the generator's own device (the CPU for None;
    a generator on the card draws there, which a full-width MoE needs):
    the reference's shapes and distributions (``jax.random``'s draws
    cannot be reproduced)."""
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
        del units
    off = n_units * len(cfg.pattern)
    p["extra"] = [block_init(generator, cfg, _block_kind(cfg, off + i),
                             layer=off + i) for i in range(rem)]
    p["final_norm"] = _norm_init(cfg, dtype)
    if not cfg.tied_embeddings:
        p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                  dtype=dtype)
    return tree_map(lambda a: a.to(device), p)


def _layers(params: Params, cfg: ArchConfig
            ) -> List[Tuple[int, str, Params, Optional[int]]]:
    """(absolute layer, block kind, block params, unit or None) of every
    layer in order: the stacked units' slots, then ``"extra"``."""
    out = []
    n_units, _ = _unit_counts(cfg)
    u_len = len(cfg.pattern)
    if "units" in params:
        for u in range(_n_stacked(params["units"])):
            up = _take(params["units"], u)
            out += [(u * u_len + i, kind, up[f"slot{i}"], u)
                    for i, kind in enumerate(cfg.pattern)]
    off = n_units * u_len
    out += [(off + i, _block_kind(cfg, off + i), bp, None)
            for i, bp in enumerate(params["extra"])]
    return out


def ffn_modules(params: Params, cfg: ArchConfig) -> List[Optional[Any]]:
    """One entry per layer, by absolute index: a ``models/ffn.KanFFN``
    (weights fused and compacted once) for a ``"kan"`` FFN, a
    ``models/moe.KanExperts`` (every expert's weights fused once) for a
    MoE layer of KAN experts, else None."""
    mods: List[Optional[Any]] = []
    for layer, _, bp, _ in _layers(params, cfg):
        if "moe" in bp and cfg.moe_cfg().ffn_kind == "kan":
            mods.append(M.KanExperts(cfg.moe_cfg(), bp["moe"]["experts"]))
        elif "ffn" in bp and cfg.layer_ffn_kind(layer) == "kan":
            mods.append(F.KanFFN(cfg.ffn_cfg(layer), bp["ffn"]))
        else:
            mods.append(None)
    return mods


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


def _ffn_of(ffns: Ffns, layer: int) -> Optional[Any]:
    return None if ffns is None else ffns[layer]


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            ffn_taps: Optional[Dict[int, torch.Tensor]] = None,
            ffns: Ffns = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden (B, S, d), aux_loss).  ``ffn_taps`` collects
    each ``"extra"`` layer's normed FFN input by absolute layer index."""
    check_supported(cfg)
    x = _embed_in(params, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, kind, bp, unit in _layers(params, cfg):
        # stacked units run as the reference's scan body: layer 0's FFN
        # config, no taps
        extra = unit is None
        x, a = block_apply(bp, x, cfg, kind, layer=layer if extra else 0,
                           taps=ffn_taps if extra else None,
                           ffn=_ffn_of(ffns, layer))
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


def _regroup(cfg: ArchConfig, layers: list, new: List[Params]) -> Params:
    """Per-layer caches (in ``_layers`` order) as the caches tree:
    stacked per unit under ``"units"``, a list under ``"extra"``."""
    caches: Params = {}
    units: Dict[int, Dict[str, Params]] = {}
    extra = []
    for (layer, _, _, unit), c in zip(layers, new):
        if unit is None:
            extra.append(c)
        else:
            units.setdefault(unit, {})[f"slot{layer % len(cfg.pattern)}"] = c
    if units:
        caches["units"] = _stack([units[u] for u in sorted(units)])
    caches["extra"] = extra
    return caches


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, ffns: Ffns = None
            ) -> Tuple[torch.Tensor, Params]:
    """Full forward + cache build.  Returns (last-position logits, caches)."""
    check_supported(cfg)
    x = _embed_in(params, cfg, tokens)
    total = x.shape[1]
    # the cache covers the prompt + margin
    max_len = max(max_len or 0, total + cfg.decode_margin)
    layers = _layers(params, cfg)
    new = []
    for layer, kind, bp, unit in layers:
        x, c = block_prefill(bp, x, cfg, kind, max_len,
                             layer=layer if unit is None else 0,
                             ffn=_ffn_of(ffns, layer))
        new.append(c)
    h = _norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, h[:, -1:]), _regroup(cfg, layers, new)


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                caches: Params, *, ffns: Ffns = None
                ) -> Tuple[torch.Tensor, Params]:
    """One token for the whole stack.  Returns (logits (B,1,V), caches);
    the input caches are left as they were."""
    check_supported(cfg)
    x = _embed_in(params, cfg, token)
    layers = _layers(params, cfg)
    n_units, _ = _unit_counts(cfg)
    off = n_units * len(cfg.pattern)
    new = []
    for layer, kind, bp, unit in layers:
        if unit is None:
            cache = caches["extra"][layer - off]
        else:
            cache = _take(caches["units"],
                          unit)[f"slot{layer % len(cfg.pattern)}"]
        x, c = block_decode(bp, x, cfg, kind, cache,
                            layer=layer if unit is None else 0,
                            ffn=_ffn_of(ffns, layer))
        new.append(c)
    h = _norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, h), _regroup(cfg, layers, new)


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1) int32 argmax of the last position (the first index of a
    tie, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
