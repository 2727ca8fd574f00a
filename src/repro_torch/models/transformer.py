"""Model assembly for every arch of the zoo: init, forward, loss,
prefill and decode.

Counterpart of ``repro/models/transformer.py``: one ``ArchConfig``
drives init and every pass.  Block kinds: ``"attn"`` (GQA + FFN or
MoE), ``"rec"`` (RG-LRU + FFN, ``models/rglru``), ``"mlstm"``/
``"slstm"`` (xLSTM, self-contained, ``models/xlstm``); ``cfg.pattern``
tiles them.  ``enc_dec`` adds a bidirectional encoder (``encode``) and
cross-attention in every decoder block (whisper); ``prefix_lm`` with a
vision frontend makes the prefix-VLM (paligemma).  Frontends are stubs,
as in the reference: the caller gives precomputed frame or patch
embeddings and the learnable ``frontend_proj`` maps them into the
residual stream.  Params and caches are nested dicts and lists of
tensors in the reference's layout, so
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
  * ``ffn_kind="kan"`` (the reference's KAN drop-in) makes every FFN,
    the encoder's too, two fused-KAN launches on a CUDA tensor.
  * the encoder's layers are stacked under ``params["encoder"]["units"]``
    whatever ``scan_layers`` says, and run with layer 0's FFN config, as
    the reference's scan does.

``ffns`` (``ffn_modules``, one entry per decoder layer by absolute
index) and ``enc_ffns`` (``encoder_ffn_modules``, one per encoder layer)
let a caller hold each KAN FFN with its weights fused and compacted
once, and each KAN-expert MoE layer's experts fused once
(``models/moe.KanExperts``); without them the functional forms rebuild
them per call.  Either gives the same bits.

Activation checkpointing (``layers.remat``, the reference's
``jax.checkpoint``): when ``cfg.remat``, ``forward`` checkpoints each
stacked unit (all of ``cfg.pattern``'s blocks, the carry ``(x, aux)``)
and ``encode`` each encoder layer; ``"extra"`` layers never are.
``lm_loss`` checkpoints each chunk's cross-entropy always.  Under
``no_grad`` (the serve paths) nothing is checkpointed.

``prefill`` is causal over a prefix-LM's image tokens, as the
reference's is (its ``block_prefill`` passes no ``prefix_len``);
``forward`` attends to them bidirectionally.

Under an active mesh with more than one ``model`` rank
(``launch/mesh.set_mesh``; the mesh train step), ``forward`` and
``lm_loss`` read its ``MeshContext``.  A sub-layer whose leaves are in
its tensor-parallel set (``launch/sharding.tp_unit``) runs over this
rank's shards (``layers.Shard``): a decoder or encoder block's attention
and FFN, cross-attention, the RG-LRU (its lanes), the mLSTM (its heads)
and the shared expert (its hidden lanes); ``collectives.enter`` after
the norm, the partial output summed by ``combine`` at the exit.  The
embedding and the cross-entropy are vocab-parallel when the table (or
``lm_head``) is: the loss takes the max over ``model`` (``pmax``), the
sums of exps and the gold logit summed over ``model`` in rank order in
f32.  Under ``activation_mode="sp"`` the decoder's residual stream
between sub-layers is this rank's chunk of the sequence
(``collectives.seq_bounds``): the norms run on the chunk, their weights'
cotangents summed over ``model``; a tensor-parallel sub-layer gathers
the normed chunks at its entry (``gather_seq``) and reduce-scatters its
partial output (``scatter_seq``); any other sub-layer -- a gathered one,
a MoE (its shared expert's partial summed whole), the xLSTM blocks (the
mLSTM's partial summed whole) -- runs on the gathered sequence and keeps
the rank's chunk, its backward whole on every rank; the final norm's
chunks are gathered for the loss.  The encoder runs tensor-parallel with
its activations replicated under either mode (the reference's ``sp``
constrains only the decoder's final hidden state); ``frontend_proj`` is
gathered (``tp_unit`` says why).

``prefill`` and ``decode_step`` read the context too (the serve steps,
``launch/steps.serve_mesh``): the same sub-layers run over the rank's
shards, the logits are the rank's vocab columns and
``greedy_token(logits, cfg)`` takes the argmax over ``model``; the
caches are the rank's pieces in the layout of ``MeshContext.caches`` (a
sequence-sharded cache holds the rank's slots of every kv head,
``ck``/``cv`` the rank's frames of every kv head).  Recurrent and mLSTM
state is replicated over ``model``: a rank reads its lanes or heads of
it and the new values are all-gathered along ``model`` after the block
(``_whole_state``: one ``collectives.gather_blocks``), so every rank
holds the same whole state.  ``init_caches(mesh=)`` makes a rank's empty
pieces.  The sLSTM runs whole.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import collectives as COLL
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import (
    MeshContext,
    ProcessMesh,
    current_context,
    set_mesh,
)
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import xlstm as X
from repro_torch.models.layers import (
    Shard,
    dense,
    dense_init,
    embed,
    embed_init,
    f32_matmul,
    layernorm,
    layernorm_init,
    remat,
    rmsnorm,
    rmsnorm_init,
    unembed,
)
from repro_torch.utils import leaf_paths, tree_map

Params = Dict[str, Any]
BLOCK_KINDS = ("attn", "rec", "mlstm", "slstm")
# the encoder's stacked blocks' params prefix, as utils.leaf_paths writes it
ENCODER = "['encoder']['units']"
Ffns = Optional[Sequence[Optional[Any]]]


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
               kind: str, *, cross: bool = False, causal: bool = True,
               layer: int = 0) -> Params:
    """One block's params; ``cross`` adds a decoder block's
    cross-attention, ``causal=False`` makes an encoder block."""
    _check_block(kind)
    dtype = cfg.param_dtype
    if kind == "attn":
        acfg = cfg.attn_cfg() if causal else cfg.enc_attn_cfg()
        p = {"attn_norm": _norm_init(cfg, dtype),
             "attn": A.attn_init(generator, acfg, dtype)}
        if cross:
            p["cross_norm"] = _norm_init(cfg, dtype)
            p["cross"] = A.cross_attn_init(generator, cfg.attn_cfg(), dtype)
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


def _mesh_ctx() -> Optional[MeshContext]:
    """The active mesh's context when it has more than one ``model``
    rank (tensor and sequence parallelism apply), else None."""
    ctx = current_context()
    return ctx if ctx is not None and ctx.mesh.axis_size("model") > 1 \
        else None


def _tp_shard(ctx: Optional[MeshContext], path: str) -> Optional[Shard]:
    """The ``Shard`` of a sub-layer whose leaf at ``path`` is computed
    from this rank's shard, else None."""
    if ctx is None or path not in ctx.tp:
        return None
    return Shard(ctx.mesh, ctx.sp)


def _whole_shard(ctx: Optional[MeshContext], path: str) -> Optional[Shard]:
    """``_tp_shard`` of a sub-layer whose output every rank holds whole
    (a block that runs on the gathered sequence under sp): its partial
    summed over ``model`` whole."""
    shard = _tp_shard(ctx, path)
    return None if shard is None else Shard(shard.mesh)


@contextlib.contextmanager
def _replicated(ctx: Optional[MeshContext]) -> Iterator[None]:
    """``ctx`` with a replicated residual stream inside the block (the
    encoder under ``activation_mode="sp"``)."""
    if ctx is None or not ctx.sp:
        yield
        return
    with set_mesh(ctx.mesh, tp=ctx.tp, caches=ctx.caches):
        yield


def _layer_path(cfg: ArchConfig, layer: int, unit: Optional[int]) -> str:
    """A decoder layer's params prefix in the tree (a stacked unit's slot
    or an ``"extra"`` entry), as ``utils.leaf_paths`` writes it."""
    u = len(cfg.pattern)
    if unit is not None:
        return f"['units']['slot{layer % u}']"
    return f"['extra'][{layer - _unit_counts(cfg)[0] * u}]"


def _ffn_shard(ctx: Optional[MeshContext], path: str) -> Optional[Shard]:
    """The ``Shard`` of the tensor-parallel FFN of the block at ``path``,
    else None."""
    return (_tp_shard(ctx, path + "['ffn']['up']['kernel']")
            or _tp_shard(ctx, path + "['ffn']['kan_up']['w_b']"))


def _seq_mesh(ctx: Optional[MeshContext], path: str,
              key: str) -> Optional[ProcessMesh]:
    """The mesh whose ``model`` axis splits the sequence of the cache
    entry ``key`` of the block at ``path`` (``MeshContext.caches``), else
    None.  A serve step on more than one ``model`` rank carries its
    caches' specs; without them it raises rather than guess."""
    if ctx is None:
        return None
    if ctx.caches is None:
        raise ValueError("prefill and decode on more than one model rank "
                         "need the caches' specs (launch/steps."
                         "cache_layout, through the serve steps)")
    spec = ctx.caches.get(path + f"[{key!r}]")
    return ctx.mesh if spec is not None and "model" in spec.axes() else None


def _sublayer(cfg: ArchConfig, ctx: Optional[MeshContext], norm_p: Params,
              x: torch.Tensor, n: int, fn: Any,
              shard: Optional[Shard]) -> torch.Tensor:
    """The update of the residual ``x`` (this rank's chunk of ``n``
    positions under sequence parallelism) by ``fn(normed input, shard)``
    in x's layout (module docstring).  With ``shard``, ``fn`` computes
    from this rank's shards and leaves through ``shard.out``."""
    if ctx is None:
        return fn(_norm(cfg, norm_p, x), None)
    mesh = ctx.mesh
    if not ctx.sp:
        xn = _norm(cfg, norm_p, x)
        return fn(xn if shard is None else COLL.enter(xn, mesh), shard)
    norm_p = tree_map(lambda a: COLL.enter(a, mesh), norm_p)
    xn = COLL.gather_seq(_norm(cfg, norm_p, x), mesh, n,
                         partial=shard is not None)
    y = fn(xn, shard)
    return y if shard is not None else COLL.scatter_seq(y, mesh,
                                                        reduce=False)


def _whole(ctx: Optional[MeshContext], x: torch.Tensor, n: int,
           fn: Any) -> torch.Tensor:
    """``fn`` of the whole sequence of a self-contained block (the
    xLSTM blocks) in x's layout: under sequence parallelism the chunks
    gathered, and this rank's chunk kept."""
    if ctx is None or not ctx.sp:
        return fn(x)
    y = fn(COLL.gather_seq(x, ctx.mesh, n, partial=False))
    return COLL.scatter_seq(y, ctx.mesh, reduce=False)


def _apply_ffn_part(p: Params, x: torch.Tensor, cfg: ArchConfig,
                    layer: int = 0,
                    taps: Optional[Dict[int, torch.Tensor]] = None,
                    ffn: Optional[Any] = None, *,
                    path: Optional[str] = None,
                    n: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN or MoE sub-layer; ``path``/``n`` as ``block_apply``'s."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ctx = _mesh_ctx() if path is not None else None
    if "moe" in p:
        auxes = []

        shared = None if ctx is None else _whole_shard(
            ctx, path + "['moe']['shared']['up']['kernel']")

        def moe(h: torch.Tensor, _: Optional[Shard]) -> torch.Tensor:
            r = M.moe_apply(p["moe"], h, cfg.moe_cfg(), experts=ffn,
                            shared=shared)
            auxes.append(r["aux_loss"])
            return r["out"]

        x = x + _sublayer(cfg, ctx, p["moe_norm"], x, n, moe, None)
        aux = auxes[0]
    elif "ffn" in p:
        fcfg = cfg.ffn_cfg(layer)
        shard = None if ctx is None else _ffn_shard(ctx, path)
        if (shard is not None and ffn is not None
                and getattr(ffn, "shard", None) is None):
            raise ValueError("a held FFN module of whole leaves on a "
                             "tensor-parallel path: build it from the "
                             "rank's shards under the step's mesh "
                             "(ffn_modules)")

        def run(xn: torch.Tensor, sh: Optional[Shard]) -> torch.Tensor:
            if taps is not None:
                # calibration hook: the normed FFN INPUT of this layer
                # (what the saliencies of core/calibrate score against)
                taps[layer] = xn
            if ffn is not None:
                return ffn(xn)
            return F.ffn_apply(p["ffn"], xn, fcfg, sh)

        x = x + _sublayer(cfg, ctx, p["ffn_norm"], x, n, run, shard)
    return x, aux


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def block_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str, *,
                causal: bool = True, prefix_len: Optional[int] = None,
                memory: Optional[torch.Tensor] = None, layer: int = 0,
                taps: Optional[Dict[int, torch.Tensor]] = None,
                ffn: Optional[Any] = None, path: Optional[str] = None,
                n: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence path (no cache).  Returns (x, aux_loss).  ``path``
    (the block's params prefix, ``_layer_path`` or ``ENCODER``) puts the
    block under the active mesh's tensor and sequence parallelism, ``n``
    being the sequence's whole length; None computes it whole and
    replicated."""
    _check_block(kind)
    ctx = _mesh_ctx() if path is not None else None
    if kind == "attn":
        acfg = cfg.attn_cfg() if causal else cfg.enc_attn_cfg()
        shard = None if ctx is None else _tp_shard(
            ctx, path + "['attn']['wq']['kernel']")
        x = x + _sublayer(cfg, ctx, p["attn_norm"], x, n, lambda h, sh:
                          A.attention(p["attn"], h, acfg,
                                      prefix_len=prefix_len, shard=sh),
                          shard)
        if "cross" in p and memory is not None:
            shard = None if ctx is None else _tp_shard(
                ctx, path + "['cross']['wq']['kernel']")
            x = x + _sublayer(cfg, ctx, p["cross_norm"], x, n, lambda h, sh:
                              A.cross_attention(p["cross"], h, memory,
                                                cfg.attn_cfg(), shard=sh),
                              shard)
        return _apply_ffn_part(p, x, cfg, layer, taps, ffn, path=path, n=n)
    if kind == "rec":
        shard = None if ctx is None else _tp_shard(
            ctx, path + "['rec']['lambda']")
        y = _sublayer(cfg, ctx, p["rec_norm"], x, n, lambda h, sh:
                      R.rglru_apply(p["rec"], h, cfg.rglru_cfg(),
                                    shard=sh)[0], shard)
        return _apply_ffn_part(p, x + y, cfg, layer, taps, ffn, path=path,
                               n=n)
    if kind == "mlstm":
        shard = None if ctx is None else _whole_shard(
            ctx, path + "['mlstm']['wq']['kernel']")
        y = _whole(ctx, x, n, lambda h: X.mlstm_apply(
            p["mlstm"], h, cfg.xlstm_cfg(), shard=shard)[0])
        return y, _no_aux(x)
    y = _whole(ctx, x, n, lambda h: X.slstm_apply(p["slstm"], h,
                                                  cfg.xlstm_cfg())[0])
    return y, _no_aux(x)


def block_init_cache(batch: int, max_len: int, cfg: ArchConfig, kind: str,
                     device: torch.device | str = "cpu", *,
                     cross_len: int = 0) -> Params:
    """A block's empty decode cache; ``cross_len`` adds zero cross-
    attention keys and values (``ck``, ``cv``) of that many frames."""
    _check_block(kind)
    dtype = cfg.param_dtype
    if kind == "attn":
        acfg = cfg.attn_cfg()
        size = min(max_len, acfg.window) if acfg.window else max_len
        c = A.init_cache(batch, size, acfg, dtype, device)
        if cross_len:
            shape = (batch, cross_len, acfg.n_kv_heads, acfg.hd)
            c["ck"] = torch.zeros(shape, dtype=dtype, device=device)
            c["cv"] = torch.zeros(shape, dtype=dtype, device=device)
        return c
    if kind == "rec":
        return R.rglru_init_state(batch, cfg.rglru_cfg(), dtype, device)
    if kind == "mlstm":
        return X.mlstm_init_state(batch, cfg.xlstm_cfg(), dtype, device)
    return X.slstm_init_state(batch, cfg.xlstm_cfg(), device)


def block_prefill(p: Params, x: torch.Tensor, cfg: ArchConfig, kind: str,
                  max_len: int, *, memory: Optional[torch.Tensor] = None,
                  layer: int = 0, ffn: Optional[Any] = None,
                  path: Optional[str] = None) -> Tuple[torch.Tensor, Params]:
    """Full-sequence pass that also returns the decode cache.  Causal
    over every position, a prefix-LM's prefix too (the reference's
    ``block_prefill`` passes no ``prefix_len``); with ``memory`` the
    cache also holds the cross-attention keys and values of it.
    ``path`` puts the block under the active mesh as ``block_apply``'s:
    its attention and FFN tensor-parallel where their leaves are, its
    caches in the layout of ``MeshContext.caches``."""
    _check_block(kind)
    ctx = _mesh_ctx() if path is not None else None
    if kind == "attn":
        acfg = cfg.attn_cfg()
        xn = _norm(cfg, p["attn_norm"], x)
        size = min(max_len, acfg.window) if acfg.window else max_len
        # prefill_cache handles the ring layout when S > window
        y, cache = A.prefill_cache(
            p["attn"], xn, acfg, size, dtype=cfg.param_dtype,
            shard=_tp_shard(ctx, f"{path}['attn']['wq']['kernel']"),
            seq=_seq_mesh(ctx, path, "k"))
        x = x + y
        if "cross" in p and memory is not None:
            # the memory's keys and values, once: attended now and cached
            # (every kv head; the rank's frames of a sequence-sharded
            # cache)
            shard = _tp_shard(ctx, f"{path}['cross']['wq']['kernel']")
            kv, (cache["ck"], cache["cv"]) = A.cross_prefill(
                p["cross"], memory, acfg, shard=shard,
                seq=_seq_mesh(ctx, path, "ck"))
            x = x + A.cross_attention(
                p["cross"], _norm(cfg, p["cross_norm"], x), memory, acfg,
                kv=kv, shard=shard)
        x, _ = _apply_ffn_part(p, x, cfg, layer, ffn=ffn, path=path)
        return x, cache
    if kind == "rec":
        shard = _tp_shard(ctx, f"{path}['rec']['lambda']")
        y, st = R.rglru_apply(p["rec"], _norm(cfg, p["rec_norm"], x),
                              cfg.rglru_cfg(), shard=shard)
        x, _ = _apply_ffn_part(p, x + y, cfg, layer, ffn=ffn, path=path)
        return x, _whole_state(st, shard, R.STATE_LANES)
    if kind == "mlstm":
        shard = _whole_shard(ctx, f"{path}['mlstm']['wq']['kernel']")
        y, st = X.mlstm_apply(p["mlstm"], x, cfg.xlstm_cfg(), shard=shard)
        return y, _whole_state(st, shard, X.MLSTM_STATE_HEADS)
    return X.slstm_apply(p["slstm"], x, cfg.xlstm_cfg())


def _whole_state(state: Params, shard: Optional[Shard],
                 dims: Dict[str, int]) -> Params:
    """``state`` with each entry of ``dims`` (a rank's lanes or heads of
    it) all-gathered along ``model``, so every ``model`` rank holds the
    same whole state (``collectives.gather_blocks``); without ``shard``,
    ``state``."""
    if shard is None:
        return state
    return {**state, **COLL.gather_blocks({k: state[k] for k in dims},
                                          dims, shard.mesh)}


def block_decode(p: Params, x1: torch.Tensor, cfg: ArchConfig, kind: str,
                 cache: Params, *, layer: int = 0,
                 ffn: Optional[Any] = None, path: Optional[str] = None
                 ) -> Tuple[torch.Tensor, Params]:
    """One-token step.  Returns (x1, new_cache); ``ck``/``cv`` ride
    through unchanged.  ``path`` as ``block_prefill``'s."""
    _check_block(kind)
    ctx = _mesh_ctx() if path is not None else None
    if kind == "attn":
        acfg = cfg.attn_cfg()
        # decode_step reads and returns the self-attention entries only
        y, sub = A.decode_step(
            p["attn"], _norm(cfg, p["attn_norm"], x1), acfg, cache,
            shard=_tp_shard(ctx, f"{path}['attn']['wq']['kernel']"),
            seq=_seq_mesh(ctx, path, "k"))
        x1 = x1 + y
        new_cache = {**cache, **sub}
        if "cross" in p and "ck" in cache:
            x1 = x1 + A.cross_decode(
                p["cross"], _norm(cfg, p["cross_norm"], x1), cache, acfg,
                shard=_tp_shard(ctx, f"{path}['cross']['wq']['kernel']"),
                seq=_seq_mesh(ctx, path, "ck"))
        x1, _ = _apply_ffn_part(p, x1, cfg, layer, ffn=ffn, path=path)
        return x1, new_cache
    if kind == "rec":
        shard = _tp_shard(ctx, f"{path}['rec']['lambda']")
        y, st = R.rglru_apply(p["rec"], _norm(cfg, p["rec_norm"], x1),
                              cfg.rglru_cfg(), cache, shard)
        x1, _ = _apply_ffn_part(p, x1 + y, cfg, layer, ffn=ffn, path=path)
        return x1, _whole_state(st, shard, R.STATE_LANES)
    if kind == "mlstm":
        shard = _whole_shard(ctx, f"{path}['mlstm']['wq']['kernel']")
        y, st = X.mlstm_apply(p["mlstm"], x1, cfg.xlstm_cfg(), cache,
                              shard=shard)
        return y, _whole_state(st, shard, X.MLSTM_STATE_HEADS)
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
    dtype = cfg.param_dtype
    cross = cfg.enc_dec
    p: Params = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                                     dtype)}
    n_units, rem = _unit_counts(cfg)
    units = [{f"slot{i}": block_init(generator, cfg, kind, cross=cross)
              for i, kind in enumerate(cfg.pattern)}
             for _ in range(n_units)]
    if units:
        p["units"] = _stack(units)
        del units
    off = n_units * len(cfg.pattern)
    p["extra"] = [block_init(generator, cfg, _block_kind(cfg, off + i),
                             cross=cross, layer=off + i)
                  for i in range(rem)]
    p["final_norm"] = _norm_init(cfg, dtype)
    if not cfg.tied_embeddings:
        p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                  dtype=dtype)
    if cfg.enc_dec:
        p["encoder"] = {
            "units": _stack([block_init(generator, cfg, "attn", causal=False)
                             for _ in range(cfg.n_enc_layers)]),
            "final_norm": _norm_init(cfg, dtype),
        }
    if cfg.frontend is not None:
        p["frontend_proj"] = dense_init(generator, cfg.d_model, cfg.d_model,
                                        dtype=dtype)
    return tree_map(lambda a: a.to(device), p)


def param_shapes(cfg: ArchConfig) -> Params:
    """The params' tree as tensors on the meta device, shapes and dtypes
    only: nothing is allocated or drawn (a 235 B-param arch too)."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = init_params(cfg)
    return tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                          device="meta"), fake)


def _layers(params: Params, cfg: ArchConfig
            ) -> List[Tuple[int, str, Params, Optional[int]]]:
    """(absolute layer, block kind, block params, unit or None) of every
    decoder layer in order: the stacked units' slots, then ``"extra"``."""
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


def _encoder_layers(params: Params) -> List[Params]:
    units = params["encoder"]["units"]
    return [_take(units, i) for i in range(_n_stacked(units))]


def _held_ffn(fcfg: F.FFNConfig, p: Params,
              shard: Optional[Shard] = None) -> Optional[Any]:
    if fcfg.kind == "kanffn":
        return F.KanFFN(fcfg, p, shard)
    if fcfg.kind == "kan":
        return F.KanPairFFN(fcfg, p, shard)
    return None


def ffn_modules(params: Params, cfg: ArchConfig) -> List[Optional[Any]]:
    """One entry per decoder layer, by absolute index: a ``models/ffn.
    KanFFN`` (weights fused and compacted once) for a ``"kanffn"`` FFN,
    a ``models/ffn.KanPairFFN`` (both KAN layers fused once) for a
    ``"kan"`` FFN, a ``models/moe.KanExperts`` (every expert's weights
    fused once) for a MoE layer of KAN experts, else None.  Under a mesh
    whose FFN leaves are tensor-parallel (``launch/steps.serve_mesh``),
    from the rank's shards: each FFN holds its ``Shard``."""
    mods: List[Optional[Any]] = []
    ctx = _mesh_ctx()
    for layer, _, bp, unit in _layers(params, cfg):
        if "moe" in bp and cfg.moe_cfg().ffn_kind == "kan":
            mods.append(M.KanExperts(cfg.moe_cfg(), bp["moe"]["experts"]))
        elif "ffn" in bp:
            # stacked units run with layer 0's FFN config
            mods.append(_held_ffn(cfg.ffn_cfg(layer if unit is None else 0),
                                  bp["ffn"], _ffn_shard(
                                      ctx, _layer_path(cfg, layer, unit))))
        else:
            mods.append(None)
    return mods


def encoder_ffn_modules(params: Params,
                        cfg: ArchConfig) -> List[Optional[Any]]:
    """``ffn_modules`` of the encoder's layers, one entry per layer (all
    with layer 0's FFN config, as ``encode`` runs them); from the rank's
    shards where the encoder's FFN leaves are tensor-parallel."""
    shard = _ffn_shard(_mesh_ctx(), ENCODER)
    return [_held_ffn(cfg.ffn_cfg(0), bp["ffn"], shard) if "ffn" in bp
            else None for bp in _encoder_layers(params)]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed_in(params: Params, cfg: ArchConfig,
              tokens: torch.Tensor) -> torch.Tensor:
    x = embed(params["embed"], tokens,
              _tp_shard(_mesh_ctx(), "['embed']['table']"))
    if cfg.embed_scale:
        # a 0-dim host tensor: no copy to the device (CUDA-graph safe)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x.to(cfg.param_dtype)


def _ffn_of(ffns: Ffns, layer: int) -> Optional[Any]:
    return None if ffns is None else ffns[layer]


def encode(params: Params, cfg: ArchConfig, frames: torch.Tensor, *,
           ffns: Ffns = None) -> torch.Tensor:
    """The encoder over stub frames (B, T_audio, d): ``frontend_proj``,
    bidirectional blocks, the final norm.  ``ffns``: one per encoder
    layer (``encoder_ffn_modules``).  Under a mesh its blocks are
    tensor-parallel where their leaves are, their activations
    replicated."""
    x = dense(params["frontend_proj"], frames)

    def layer(x: torch.Tensor, bp: Params, ffn: Optional[Any]
              ) -> torch.Tensor:
        return block_apply(bp, x, cfg, "attn", causal=False, ffn=ffn,
                           path=ENCODER, n=x.shape[1])[0]

    with _replicated(_mesh_ctx()):
        for i, bp in enumerate(_encoder_layers(params)):
            body = functools.partial(layer, bp=bp, ffn=_ffn_of(ffns, i))
            # each layer one checkpoint under cfg.remat, as the reference
            x = remat(body, x) if cfg.remat else body(x)
    return _norm(cfg, params["encoder"]["final_norm"], x)


def _front(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
           frames: Optional[torch.Tensor], patches: Optional[torch.Tensor],
           enc_ffns: Ffns
           ) -> Tuple[torch.Tensor, Optional[int], Optional[torch.Tensor]]:
    """(the decoder's input: patches through ``frontend_proj`` before the
    embedded text, prefix length under ``prefix_lm``, encoder memory)."""
    x = _embed_in(params, cfg, tokens)
    prefix_len = None
    if patches is not None:
        img = dense(params["frontend_proj"], patches).to(x.dtype)
        x = torch.cat([img, x], dim=1)
        if cfg.prefix_lm:
            prefix_len = patches.shape[1]
    memory = (encode(params, cfg, frames, ffns=enc_ffns)
              if frames is not None else None)
    return x, prefix_len, memory


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            ffn_taps: Optional[Dict[int, torch.Tensor]] = None,
            ffns: Ffns = None, enc_ffns: Ffns = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden (B, S_total, d), aux_loss): ``frames`` (B,
    T_audio, d) feed the encoder, ``patches`` (B, n_img, d) come before
    the text.  ``ffn_taps`` collects each ``"extra"`` layer's normed FFN
    input by absolute layer index."""
    x, prefix_len, memory = _front(params, cfg, tokens, frames, patches,
                                   enc_ffns)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n = x.shape[1]
    ctx = _mesh_ctx()
    if ctx is not None and ctx.sp:
        x = COLL.scatter_seq(x, ctx.mesh, reduce=False)

    def run(x: torch.Tensor, aux: torch.Tensor, group: list
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        for layer, kind, bp, unit in group:
            # stacked units run as the reference's scan body: layer 0's
            # FFN config, no taps
            extra = unit is None
            x, a = block_apply(bp, x, cfg, kind, prefix_len=prefix_len,
                               memory=memory, layer=layer if extra else 0,
                               taps=ffn_taps if extra else None,
                               ffn=_ffn_of(ffns, layer),
                               path=_layer_path(cfg, layer, unit), n=n)
            aux = aux + a
        return x, aux

    for unit, group in itertools.groupby(_layers(params, cfg),
                                         key=lambda t: t[3]):
        body = functools.partial(run, group=list(group))
        # a stacked unit is one checkpoint under cfg.remat, its carry
        # (x, aux) -- under sp x is the rank's sequence chunk, the
        # reference's remat residual; "extra" layers never are
        if cfg.remat and unit is not None:
            x, aux = remat(body, x, aux)
        else:
            x, aux = body(x, aux)
    if ctx is None or not ctx.sp:
        return _norm(cfg, params["final_norm"], x), aux
    # the chunks of the final norm gathered for the loss: its cotangent
    # is each rank's share when the loss is vocab-parallel, else whole
    norm_p = tree_map(lambda a: COLL.enter(a, ctx.mesh), params["final_norm"])
    h = COLL.gather_seq(_norm(cfg, norm_p, x), ctx.mesh, n,
                        partial=_vocab_shard(cfg) is not None)
    return h, aux


def _logits(params: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """f32 logits of ``h`` (a rank's vocab columns of a vocab-parallel
    table or head)."""
    if cfg.tied_embeddings:
        return unembed(params["embed"], h)
    return f32_matmul(h, params["lm_head"]["kernel"])


def _vocab_shard(cfg: ArchConfig) -> Optional[Shard]:
    """The ``Shard`` of a vocab-parallel LM head (the tied table or
    ``lm_head``) under the active mesh, else None."""
    return _tp_shard(_mesh_ctx(), "['embed']['table']" if cfg.tied_embeddings
                     else "['lm_head']['kernel']")


def _vocab_parallel_ce(lg: torch.Tensor, labels: torch.Tensor,
                       shard: Shard) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-partition, gold logit) of a rank's f32 vocab columns ``lg``:
    the max over ``model`` (exact), the sums of exps and the gold logit
    (from the rank that holds it, zeros elsewhere) summed over ``model``
    in rank order in f32."""
    n, mesh = lg.shape[-1], shard.mesh
    mx = COLL.pmax(torch.amax(lg, dim=-1).detach(), mesh, "model")
    se = COLL.combine(torch.sum(torch.exp(lg - mx[..., None]), dim=-1), mesh)
    ids = labels.long() - shard.index * n
    inside = (ids >= 0) & (ids < n)
    g = torch.gather(lg, -1, torch.clamp(ids, 0, n - 1)[..., None])[..., 0]
    gold = COLL.combine(torch.where(inside, g, torch.zeros((), device=g.device,
                                                           dtype=g.dtype)),
                        mesh)
    return mx + torch.log(se), gold


def lm_loss(params: Params, cfg: ArchConfig, hidden: torch.Tensor,
            labels: torch.Tensor, mask: Optional[torch.Tensor] = None,
            z_loss: float = 1e-4) -> torch.Tensor:
    """Stable cross-entropy (plus ``z_loss`` times the squared log-
    partition) over ``cfg.loss_chunks`` chunks of the positions, never
    the whole (B, S, V) logits at once; ``hidden`` (B, S, d) aligned with
    ``labels`` (B, S), the mean over ``mask``'s positions.  Vocab-parallel
    under a mesh whose LM head is tensor-parallel (module docstring)."""
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    n_chunks = max(1, min(cfg.loss_chunks, S))
    if S % n_chunks:
        raise ValueError(f"lm_loss: {S} positions do not split into "
                         f"{n_chunks} chunks")
    L = S // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    shard = _vocab_shard(cfg)
    if shard is not None and not shard.sp:
        # under sp forward's gather_seq already sums hidden's cotangent
        hidden = shard.enter(hidden)

    def chunk_ce(h_c: torch.Tensor, lab_c: torch.Tensor,
                 m: torch.Tensor) -> torch.Tensor:
        lg = _logits(params, cfg, h_c).to(torch.float32)
        if shard is None:
            lse = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, lab_c[..., None].long())[..., 0]
        else:
            lse, gold = _vocab_parallel_ce(lg, lab_c, shard)
        out = torch.sum((lse - gold) * m)
        if z_loss:
            out = out + z_loss * torch.sum(torch.square(lse) * m)
        return out

    for c in range(n_chunks):
        sl = slice(c * L, (c + 1) * L)
        # always checkpointed: the backward recomputes a chunk's logits
        # instead of keeping n_chunks (B, L, V) of them alive
        total = total + remat(chunk_ce, hidden[:, sl], labels[:, sl],
                              mask[:, sl])
    return total / denom


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device: torch.device | str = "cpu",
                mesh: Optional[ProcessMesh] = None) -> Params:
    """Empty decode caches; an ``enc_dec`` arch's attention blocks also
    hold zero cross-attention keys and values of its frames.  With
    ``mesh``, this rank's pieces of them (``launch/sharding.
    cache_shardings``)."""
    if mesh is not None:
        whole = init_caches(cfg, batch, max_len, "meta")
        return tree_map(lambda a, spec: torch.zeros(
            SH.local_shape(a.shape, spec, mesh), dtype=a.dtype,
            device=device), whole, SH.cache_shardings(whole, mesh))
    n_units, rem = _unit_counts(cfg)
    cross_len = cfg.n_frontend_tokens if cfg.enc_dec else 0
    caches: Params = {}
    if n_units:
        caches["units"] = _stack([
            {f"slot{i}": block_init_cache(batch, max_len, cfg, kind, device,
                                          cross_len=cross_len)
             for i, kind in enumerate(cfg.pattern)}
            for _ in range(n_units)])
    off = n_units * len(cfg.pattern)
    caches["extra"] = [
        block_init_cache(batch, max_len, cfg, _block_kind(cfg, off + i),
                         device, cross_len=cross_len) for i in range(rem)]
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
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None, ffns: Ffns = None,
            enc_ffns: Ffns = None) -> Tuple[torch.Tensor, Params]:
    """Full forward + cache build.  Returns (last-position logits, caches).
    Causal over a prefix-LM's patches too, as the reference's prefill."""
    x, _, memory = _front(params, cfg, tokens, frames, patches, enc_ffns)
    total = x.shape[1]
    # the cache covers the full prefix (modality tokens too) + margin
    max_len = max(max_len or 0, total + cfg.decode_margin)
    layers = _layers(params, cfg)
    new = []
    for layer, kind, bp, unit in layers:
        x, c = block_prefill(bp, x, cfg, kind, max_len, memory=memory,
                             layer=layer if unit is None else 0,
                             ffn=_ffn_of(ffns, layer),
                             path=_layer_path(cfg, layer, unit))
        new.append(c)
    h = _norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, h[:, -1:]), _regroup(cfg, layers, new)


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                caches: Params, *, ffns: Ffns = None
                ) -> Tuple[torch.Tensor, Params]:
    """One token for the whole stack.  Returns (logits (B,1,V), caches);
    the input caches are left as they were."""
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
                            ffn=_ffn_of(ffns, layer),
                            path=_layer_path(cfg, layer, unit))
        new.append(c)
    h = _norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, h), _regroup(cfg, layers, new)


def greedy_token(logits: torch.Tensor,
                 cfg: Optional[ArchConfig] = None) -> torch.Tensor:
    """(B, 1) int32 argmax of the last position (the first index of a
    tie, as ``jnp.argmax``).  With ``cfg``, under a mesh whose LM head is
    vocab-parallel, ``logits`` are this rank's vocab columns and the
    argmax runs over ``model`` (``collectives.argmax_over``)."""
    shard = None if cfg is None else _vocab_shard(cfg)
    if shard is None:
        return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(
            torch.int32)
    return COLL.argmax_over(logits[:, -1, :], shard.mesh)[:, None].to(
        torch.int32)
