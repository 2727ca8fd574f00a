"""GQA attention: full-sequence (direct or chunked), prefill, cached decode.

Counterpart of ``repro/models/attention.py``, plain PyTorch in the
reference's numerics: scores, softmax and the value contraction in f32;
the chunked (flash-style) path for S > ``chunk_threshold`` keeps its
blocks in the compute dtype and accumulates in f32, with an online
softmax (running max, denominator, accumulator) over KV blocks inside a
loop over Q blocks.  Masks (causal / sliding-window / prefix-LM) come
from positions.  The reference computes attention outside any Pallas
kernel, so no kernel of the port runs here.

Under tensor parallelism (``attention(..., shard=)``) a rank computes
its ``n_heads / model`` heads: its columns of ``wq`` (and bias), of
``wk``/``wv`` when the kv heads split whole, else the columns of the kv
heads its q heads use (head h uses kv head ``h // q_groups``) from the
gathered ``wk``/``wv``, its rows of ``wo`` without the bias; the f32
partial is summed over ``model`` and the bias added once
(``layers.Shard.out``).  RoPE, qk-norm and the masks are per head.

Decode attends one new token per row against a KV cache; each row sits
at its own position ``len[b]`` (slot-based serving), and with a sliding
window the cache is a ring buffer.  ``kv_quant`` stores the cache as
int8 with per-(token, head) f16 scales.  Caches are dicts of tensors,
updated functionally: ``decode_step`` returns new tensors and leaves its
inputs as they were.

On a mesh (``prefill_cache`` / ``decode_step`` with ``shard=`` and
``seq=``) a cache always holds every kv head: replicated over ``model``,
or sequence-sharded (the rank's slots of it), and then the softmax over
the slots is merged over ``model`` from each rank's partials
(``collectives.softmax_combine``).  The int8 quantization is per (slot,
head), so it splits exactly.

Cross-attention (whisper's decoder) splits the same way
(``cross_attention``, ``cross_prefill``, ``cross_decode`` with
``shard=``, ``seq=``): a rank's q heads over every frame of its kv
heads; ``ck``/``cv`` hold every kv head, of every frame or of the rank's
frames.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.launch import collectives as COLL
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.launch.sharding import cache_slots
from repro_torch.models.layers import (
    Shard,
    apply_rope,
    dense,
    dense_init,
    rmsnorm,
    f32_matmul,
    remat,
    rmsnorm_init,
    softcap,
)

NEG_INF = -2.0e38
Params = Dict[str, torch.Tensor]
KV = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: Optional[int] = None        # defaults to d_model // n_heads
    qkv_bias: bool = False                # qwen-style
    rope_base: float = 10000.0
    window: Optional[int] = None          # sliding-window (recurrentgemma)
    logit_softcap: Optional[float] = None
    qk_norm: bool = False                 # qwen3-style per-head RMS on q,k
    causal: bool = True                   # False for encoders
    # int8 KV cache: per-(token, head) symmetric scales
    kv_quant: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_groups(self) -> int:
        assert self.n_heads % self.n_kv_heads == 0
        return self.n_heads // self.n_kv_heads


def attn_init(generator: Optional[torch.Generator], cfg: AttnConfig,
              dtype: torch.dtype = torch.float32) -> Dict:
    hd = cfg.hd
    p = {
        "wq": dense_init(generator, cfg.d_model, cfg.n_heads * hd,
                         bias=cfg.qkv_bias, dtype=dtype),
        "wk": dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd,
                         bias=cfg.qkv_bias, dtype=dtype),
        "wv": dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd,
                         bias=cfg.qkv_bias, dtype=dtype),
        "wo": dense_init(generator, cfg.n_heads * hd, cfg.d_model,
                         dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype)
        p["k_norm"] = rmsnorm_init(hd, dtype)
    return p


def _project_kv(params: Dict, x: torch.Tensor, cfg: AttnConfig,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    k = dense(params["wk"], x).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = dense(params["wv"], x).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = rmsnorm(params["k_norm"], k)
    return apply_rope(k, positions, cfg.rope_base), v


def _project_qkv(params: Dict, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q = dense(params["wq"], x).reshape(B, S, cfg.n_heads, cfg.hd)
    k, v = _project_kv(params, x, cfg, positions)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
    return apply_rope(q, positions, cfg.rope_base), k, v


def _mask_block(q_pos: torch.Tensor, k_pos: torch.Tensor, cfg: AttnConfig,
                prefix_len: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) bool mask: True = attend."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if cfg.causal:
        m = dk <= dq
        if prefix_len is not None:      # prefix-LM: bidirectional prefix
            m = m | (dk < prefix_len)
    if cfg.window is not None:
        m = m & (dq - dk < cfg.window)
    return m


def _direct_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg: AttnConfig, q_pos: torch.Tensor,
                      k_pos: torch.Tensor,
                      prefix_len: Optional[int]) -> torch.Tensor:
    """Materialized-score path for short sequences."""
    B, Sq, H, hd = q.shape
    G = cfg.q_groups
    qf = q.to(torch.float32) / math.sqrt(hd)
    qf = qf.reshape(B, Sq, cfg.n_kv_heads, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.to(torch.float32))
    s = softcap(s, cfg.logit_softcap)
    mask = _mask_block(q_pos, k_pos, cfg, prefix_len)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cfg: AttnConfig, q_pos: torch.Tensor,
                       k_pos: torch.Tensor, prefix_len: Optional[int],
                       q_block: int, k_block: int) -> torch.Tensor:
    """Flash-style: a loop over Q blocks, an inner loop over KV blocks
    with an online softmax (running max m, denominator l, accumulator).
    Each Q block and, inside it, each KV step is checkpointed
    (``layers.remat``), as the reference's: otherwise the backward keeps
    every block's (q_block, k_block) scores, O(S^2), and the chunking
    saves nothing; with it the backward recomputes one block at a
    time."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    G = cfg.q_groups
    KV = cfg.n_kv_heads
    assert Sq % q_block == 0 and Sk % k_block == 0, (Sq, q_block, Sk, k_block)
    nq, nk = Sq // q_block, Sk // k_block
    # blocks stay in the compute dtype; the products accumulate in f32
    qf = (q / torch.tensor(math.sqrt(hd), dtype=q.dtype)).reshape(
        B, nq, q_block, KV, G, hd).permute(1, 0, 3, 4, 2, 5)
    kf = k.reshape(B, nk, k_block, KV, hd).permute(1, 0, 3, 2, 4)
    vf = v.reshape(B, nk, k_block, KV, hd).permute(1, 0, 3, 2, 4)
    qp = q_pos.reshape(nq, q_block)
    kp = k_pos.reshape(nk, k_block)

    def kv_step(acc, m, l, qblk, kblk, vblk, qpos, kpos):
        s = torch.einsum("bkgqh,bksh->bkgqs", qblk, kblk.to(torch.float32))
        s = softcap(s, cfg.logit_softcap)
        mask = _mask_block(qpos, kpos, cfg, prefix_len)
        s = torch.where(mask[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bksh->bkgqh", p.to(vblk.dtype).to(torch.float32),
            vblk.to(torch.float32))
        return acc, m_new, l

    def q_step(qb, qpos):
        qblk = qb.to(torch.float32)                     # (B,KV,G,qb,hd)
        acc = torch.zeros((B, KV, G, q_block, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, KV, G, q_block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, q_block), dtype=torch.float32,
                        device=q.device)
        for j in range(nk):
            acc, m, l = remat(kv_step, acc, m, l, qblk, kf[j], vf[j], qpos,
                              kp[j])
        out = acc / torch.clamp(l[..., None], min=1e-30)
        return out.to(q.dtype)

    outs = [remat(q_step, qf[i], qp[i]) for i in range(nq)]
    o = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, hd)
    return o.to(q.dtype)


def _pick_block(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (block sizes must tile S)."""
    for b in range(min(target, s), 0, -1):
        if s % b == 0:
            return b
    return 1


def _self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: AttnConfig, pos1d: torch.Tensor,
                    prefix_len: Optional[int], chunk_threshold: int,
                    q_block: int, k_block: int) -> torch.Tensor:
    S = q.shape[1]
    if S <= chunk_threshold:
        return _direct_attention(q, k, v, cfg, pos1d, pos1d, prefix_len)
    # prefixes make S non-power-of-two: pick dividing blocks
    return _chunked_attention(q, k, v, cfg, pos1d, pos1d, prefix_len,
                              _pick_block(S, q_block),
                              _pick_block(S, k_block))


def _kv_ids(cfg: AttnConfig, h0: int, H: int) -> List[int]:
    """The kv heads that q heads ``[h0, h0 + H)`` use, in the order of
    ``local_heads``' config: each once when each is used by as many of
    them, else one a q head."""
    ids = [h // cfg.q_groups for h in range(h0, h0 + H)]
    kv = sorted(set(ids))
    return kv if ids == [k for k in kv for _ in range(H // len(kv))] else ids


def local_heads(params: Dict, cfg: AttnConfig,
                shard: Shard) -> Tuple[Dict, AttnConfig]:
    """(params, config) of this rank's heads: ``wq`` (+ bias) are its
    shards; ``wk``/``wv`` its shards when the kv heads split whole, else
    whole, and then cut to the kv heads its q heads use (their cotangents
    summed over ``model``), as are the per-head norms' weights.  Local kv
    heads keep their q groups when each is used by as many local q heads,
    else each q head gets its own copy."""
    hd = cfg.hd
    H = params["wq"]["kernel"].shape[-1] // hd
    h0 = shard.local(H, cfg.n_heads, "wq")
    p = {"wq": params["wq"]}
    for name in ("q_norm", "k_norm"):
        if name in params:
            p[name] = {k: shard.enter(v) for k, v in params[name].items()}
    cols = params["wk"]["kernel"].shape[-1]
    if cols * shard.m == cfg.n_kv_heads * hd:
        p["wk"], p["wv"] = params["wk"], params["wv"]
        return p, dataclasses.replace(cfg, n_heads=H, head_dim=hd,
                                      n_kv_heads=cols // hd)
    if cols != cfg.n_kv_heads * hd:
        raise ValueError(f"wk: {cols} columns, expected {cfg.n_kv_heads} "
                         f"kv heads of {hd} whole or split over {shard.m}")
    kv = _kv_ids(cfg, h0, H)
    idx = torch.tensor([k * hd + j for k in kv for j in range(hd)],
                       device=params["wk"]["kernel"].device)
    for name in ("wk", "wv"):
        p[name] = {k: shard.enter(v).index_select(-1, idx)
                   for k, v in params[name].items()}
    return p, dataclasses.replace(cfg, n_heads=H, head_dim=hd,
                                  n_kv_heads=len(kv))


def attention(params: Dict, x: torch.Tensor, cfg: AttnConfig, *,
              positions: Optional[torch.Tensor] = None,
              prefix_len: Optional[int] = None,
              chunk_threshold: int = 2048, q_block: int = 512,
              k_block: int = 512,
              shard: Optional[Shard] = None) -> torch.Tensor:
    """Self-attention over a full sequence (training / prefill); with
    ``shard``, over this rank's heads (module docstring)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    pos1d = positions[0] if positions.dim() == 2 else positions
    p, hcfg = (params, cfg) if shard is None else local_heads(params, cfg,
                                                              shard)
    q, k, v = _project_qkv(p, x, hcfg, positions)
    o = _self_attention(q, k, v, hcfg, pos1d, prefix_len, chunk_threshold,
                        q_block, k_block).reshape(B, S, -1)
    if shard is None:
        return dense(params["wo"], o)
    wo = params["wo"]
    shard.local(wo["kernel"].shape[0], cfg.n_heads * cfg.hd, "wo")
    return shard.out(f32_matmul(o, wo["kernel"]), x.dtype, wo.get("bias"))


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def _kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 values + a per-(...) f16 scale over the hd axis."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0].to(torch.float16)


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32)
            * scale[..., None].to(torch.float32)).to(dtype)


def init_cache(batch: int, max_len: int, cfg: AttnConfig,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cpu") -> Params:
    """``len`` is PER ROW: the serving layer batches requests at different
    positions in one decode step (slot-based continuous batching)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.float16,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.float16,
                                       device=device),
                "len": length}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": length}


def _ring_payload(k: torch.Tensor, max_len: int, cfg: AttnConfig,
                  dim: int = 1) -> torch.Tensor:
    """The keys or values (S positions on ``dim``) a cache of ``max_len``
    slots holds after a prefill of S tokens: all of them, or with a
    sliding window (max_len == window < S) the trailing ``window``,
    rotated so token j sits at slot j % window -- the invariant decode
    relies on."""
    S = k.shape[dim]
    if S <= max_len:
        return k
    assert cfg.window is not None and max_len == min(cfg.window, max_len)
    return torch.roll(k.narrow(dim, S - max_len, max_len),
                      (S - max_len) % max_len, dims=dim)


def _write_payload(cache: Params, k_in: torch.Tensor, v_in: torch.Tensor,
                   cfg: AttnConfig, dtype: torch.dtype) -> None:
    """The cache's first ``k_in.shape[1]`` slots set to the payload (int8
    with per-(slot, head) scales under ``kv_quant``)."""
    n = k_in.shape[1]
    if cfg.kv_quant:
        kq, ks = _kv_quant(k_in)
        vq, vs = _kv_quant(v_in)
        cache["k"][:, :n] = kq
        cache["v"][:, :n] = vq
        cache["k_scale"][:, :n] = ks
        cache["v_scale"][:, :n] = vs
    else:
        cache["k"][:, :n] = k_in.to(dtype)
        cache["v"][:, :n] = v_in.to(dtype)


def _every_kv_head(params: Dict, x: torch.Tensor, cfg: AttnConfig,
                   positions: torch.Tensor, shard: Optional[Shard],
                   k: torch.Tensor, v: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every kv head's keys and values from a rank's (``k``, ``v`` of its
    heads): themselves without a shard; all-gathered along ``model`` in
    rank order when the kv heads split whole; else projected from the
    whole ``wk``/``wv`` the rank holds."""
    if shard is None:
        return k, v
    if _kv_split(params, cfg):             # one all-gather of both
        kv = COLL.gather_cat(torch.stack([k, v]), shard.mesh, "model", 3)
        return kv[0], kv[1]
    return _project_kv(params, x, cfg, positions)


def _kv_split(params: Dict, cfg: AttnConfig) -> bool:
    """Whether ``wk``/``wv`` are a rank's shards (whole kv heads)."""
    return params["wk"]["kernel"].shape[-1] != cfg.n_kv_heads * cfg.hd


def _out_proj(params: Dict, o: torch.Tensor, cfg: AttnConfig,
              shard: Optional[Shard], dtype: torch.dtype) -> torch.Tensor:
    """``wo`` of the heads' outputs ``o`` (B, S, heads * hd): whole, or a
    rank's rows and the f32 partial summed over ``model``."""
    if shard is None:
        return dense(params["wo"], o)
    wo = params["wo"]
    shard.local(wo["kernel"].shape[0], cfg.n_heads * cfg.hd, "wo")
    return shard.out(f32_matmul(o, wo["kernel"]), dtype, wo.get("bias"))


def prefill_cache(params: Dict, x: torch.Tensor, cfg: AttnConfig,
                  max_len: int, dtype: Optional[torch.dtype] = None, *,
                  shard: Optional[Shard] = None,
                  seq: Optional[ProcessMesh] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """Run full attention AND return the populated cache.

    With a sliding window (max_len == window < S), only the trailing
    ``window`` tokens enter the ring, rotated so token j sits at slot
    j % window -- the invariant decode_step relies on.

    ``shard``: attention over this rank's heads (``attention``'s).
    ``seq``: the cache is sequence-sharded over ``seq``'s ``model`` axis,
    and the rank builds its chunk, every kv head at its slots
    (``launch/sharding.cache_slots``): with kv heads split over
    ``model``, each rank's slot chunks of its heads cross in one
    all-to-all.  A cache that is not sequence-sharded holds every kv head
    at every slot on every rank.
    """
    B, S, _ = x.shape
    dtype = dtype or x.dtype
    positions = torch.arange(S, device=x.device)[None, :]
    p, hcfg = (params, cfg) if shard is None else local_heads(params, cfg,
                                                              shard)
    q, k, v = _project_qkv(p, x, hcfg, positions)
    if seq is None:
        k_in, v_in = _every_kv_head(params, x, cfg, positions, shard, k, v)
        cache = init_cache(B, max_len, cfg, dtype, x.device)
        # the cache payload (attention below uses the FULL k, v)
        _write_payload(cache, _ring_payload(k_in, max_len, cfg),
                       _ring_payload(v_in, max_len, cfg), cfg, dtype)
    else:
        lo, hi = cache_slots(max_len, seq)
        n = min(S, max_len)
        cache = init_cache(B, hi - lo, cfg, dtype, x.device)
        if shard is None or not _kv_split(params, cfg):
            # every kv head here: the rank's slots of them
            chunk = [_ring_payload(a, max_len, cfg)[:, lo:hi] for a in
                     _every_kv_head(params, x, cfg, positions, shard, k, v)]
        else:
            # the rank's kv heads: their slot chunks to the slots' ranks,
            # keys and values in one all-to-all
            m = seq.axis_size("model")
            w = max_len // m
            a = _ring_payload(torch.stack([k, v]), max_len, cfg, dim=2)
            a = torch.cat([a, a.new_zeros(a.shape[:2] + (max_len - n,)
                                          + a.shape[3:])], dim=2)
            got = COLL.all_to_all([a[:, :, j * w:(j + 1) * w]
                                   for j in range(m)], seq, "model")
            chunk = list(torch.cat(got, dim=3))
        n_loc = min(max(n - lo, 0), hi - lo)
        _write_payload(cache, chunk[0][:, :n_loc], chunk[1][:, :n_loc],
                       cfg, dtype)
    cache["len"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    o = _self_attention(q, k, v, hcfg, positions[0], None, 2048, 512, 512)
    return _out_proj(params, o.reshape(B, S, -1), cfg, shard, x.dtype), cache


def _attend(qf: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
            cfg: AttnConfig, valid: torch.Tensor,
            scales: Dict[str, torch.Tensor],
            seq: Optional[ProcessMesh]) -> torch.Tensor:
    """One query a row (qf (B, kv, G, hd), f32, scaled) against cached keys
    and values (B, slots, kv, hd) where ``valid`` (B, slots): the
    softmax over the slots, in f32.  ``seq``: the slots are this rank's
    chunk of a sequence-sharded cache, and the softmax partials are
    merged over ``model`` (``collectives.softmax_combine``)."""
    # int8 cache: the scales factor out of the hd contraction
    s = torch.einsum("bkgh,bskh->bkgs", qf, kc.to(torch.float32))
    if cfg.kv_quant:
        s = s * scales["k_scale"].to(torch.float32).permute(
            0, 2, 1)[:, :, None, :]
    s = softcap(s, cfg.logit_softcap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    if seq is None:
        p = torch.softmax(s, dim=-1)
    else:
        mx = torch.amax(s, dim=-1)
        p = torch.where(valid[:, None, None, :], torch.exp(s - mx[..., None]),
                        torch.zeros((), dtype=s.dtype, device=s.device))
        l = torch.sum(p, dim=-1)
    if cfg.kv_quant:
        p = p * scales["v_scale"].to(torch.float32).permute(
            0, 2, 1)[:, :, None, :]
    o = torch.einsum("bkgs,bskh->bkgh", p, vc.to(torch.float32))
    if seq is None:
        return o
    _, l, o = COLL.softmax_combine(mx, l, o, seq)
    return o / l[..., None]


def decode_step(params: Dict, x1: torch.Tensor, cfg: AttnConfig,
                cache: Params, *, shard: Optional[Shard] = None,
                seq: Optional[ProcessMesh] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One-token decode: x1 (B, 1, d) against the cache (functional update).

    Each batch row sits at its own position ``len[b]`` (slot-based serving).
    With a sliding window the cache is a ring buffer of size window (the
    RecurrentGemma local-attention layout); otherwise it is append-only.

    ``shard``: the q heads and ``wo`` rows of this rank, every kv head's
    new key and value written (the cache holds all of them).  ``seq``: the
    cache is this rank's chunk of a sequence-sharded one
    (``prefill_cache``'s): only the rank that owns a row's slot writes its
    new entry; every q head (all-gathered along ``model`` under
    ``shard``) attends over the rank's slots, masked by their global
    indices, and the softmax partials are merged over ``model``.
    """
    B = x1.shape[0]
    t = cache["len"]                              # (B,)
    positions = t[:, None]
    p, hcfg = (params, cfg) if shard is None else local_heads(params, cfg,
                                                              shard)
    q, k, v = _project_qkv(p, x1, hcfg, positions)
    if seq is not None and shard is not None and _kv_split(params, cfg):
        # every q head and every kv head's new key and value: one
        # all-gather of the rank's
        H, K = hcfg.n_heads, hcfg.n_kv_heads
        parts = COLL.all_gather_shards(torch.cat([q, k, v], dim=2),
                                       shard.mesh, "model")
        q, k, v = (torch.cat([a[:, :, lo:hi] for a in parts], dim=2)
                   for lo, hi in ((0, H), (H, H + K), (H + K, H + 2 * K)))
    else:
        k, v = _every_kv_head(params, x1, cfg, positions, shard, k, v)
        if seq is not None and shard is not None:
            q = COLL.gather_cat(q, seq, "model", 2)

    n_loc = cache["k"].shape[1]
    lo, max_len = 0, n_loc
    if seq is not None:
        max_len = n_loc * seq.axis_size("model")
        lo, _ = cache_slots(max_len, seq)
    t64 = t.long()
    slot = (t64 % max_len) if cfg.window is not None else torch.clamp(
        t64, max=max_len - 1)
    idx = lo + torch.arange(n_loc, device=x1.device)
    rows = torch.arange(B, device=x1.device)
    # the rows whose new entry lies in this rank's slots
    mine = (slot >= lo) & (slot < lo + n_loc)
    at = torch.clamp(slot - lo, 0, n_loc - 1)

    def write(c: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        # per-row cache write: O(B) entries of a copy of the cache
        out = c.clone()
        if seq is None:
            out[rows, at] = new
        else:
            keep = mine.reshape((B,) + (1,) * (new.dim() - 1))
            out[rows, at] = torch.where(keep, new, out[rows, at])
        return out

    new_scales = {}
    if cfg.kv_quant:
        kq, ksc = _kv_quant(k)
        vq, vsc = _kv_quant(v)
        kc = write(cache["k"], kq[:, 0])
        vc = write(cache["v"], vq[:, 0])
        new_scales["k_scale"] = write(cache["k_scale"], ksc[:, 0])
        new_scales["v_scale"] = write(cache["v_scale"], vsc[:, 0])
    else:
        kc = write(cache["k"], k[:, 0].to(cache["k"].dtype))
        vc = write(cache["v"], v[:, 0].to(cache["v"].dtype))

    # valid = slots holding tokens visible to this row's position
    if cfg.window is not None:
        # ring buffer: every slot written within the last W tokens is live
        written = torch.clamp(t64 + 1, max=max_len)            # (B,)
        order = (slot[:, None] - idx[None, :]) % max_len       # 0 = newest
        valid = order < written[:, None]
    else:
        valid = idx[None, :] <= t64[:, None]
    hd = cfg.hd
    acfg, kv, sc = hcfg, (kc, vc), new_scales
    if seq is not None:             # every q head against the rank's slots
        acfg = cfg
    elif shard is not None:         # the rank's q heads, their kv heads
        ids = torch.tensor(_kv_ids(cfg, shard.index * hcfg.n_heads,
                                   hcfg.n_heads), device=x1.device)
        kv = tuple(a.index_select(2, ids) for a in kv)
        sc = {k_: a.index_select(2, ids) for k_, a in sc.items()}
    qf = (q.to(torch.float32) / math.sqrt(hd)).reshape(
        B, acfg.n_kv_heads, acfg.q_groups, hd)
    o = _attend(qf, kv[0], kv[1], acfg, valid, sc, seq)
    o = o.reshape(B, 1, acfg.n_heads * hd)
    if seq is not None and shard is not None:    # the rank's heads' rows
        h0 = shard.index * hcfg.n_heads * hd
        o = o[..., h0:h0 + hcfg.n_heads * hd]
    out = _out_proj(params, o.to(x1.dtype), cfg, shard, x1.dtype)
    return out, {"k": kc, "v": vc, "len": t + 1, **new_scales}


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_attn_init(generator: Optional[torch.Generator], cfg: AttnConfig,
                    dtype: torch.dtype = torch.float32) -> Dict:
    return attn_init(generator, dataclasses.replace(cfg, qk_norm=False),
                     dtype)


def cross_kv(params: Dict, memory: torch.Tensor, cfg: AttnConfig) -> KV:
    """The keys and values (B, Sk, n_kv_heads, hd) of encoder states
    memory (B, Sk, d)."""
    B, Sk, _ = memory.shape
    shape = (B, Sk, cfg.n_kv_heads, cfg.hd)
    return (dense(params["wk"], memory).reshape(shape),
            dense(params["wv"], memory).reshape(shape))


def cross_attention(params: Dict, x: torch.Tensor, memory: torch.Tensor,
                    cfg: AttnConfig, *,
                    kv: Optional[KV] = None,
                    shard: Optional[Shard] = None) -> torch.Tensor:
    """x: (B, Sq, d) queries; memory: (B, Sk, d) encoder states (no rope);
    ``kv``: their ``cross_kv``, where the caller has them already (with
    ``shard``, those of the rank's kv heads, ``cross_prefill``'s).  With
    ``shard``, over this rank's heads, as ``attention``: the memory, read
    whole by every rank, enters through ``Shard.enter``."""
    B, Sq, _ = x.shape
    hd = cfg.hd
    p, hcfg = (params, cfg) if shard is None else local_heads(params, cfg,
                                                              shard)
    q = dense(p["wq"], x).reshape(B, Sq, hcfg.n_heads, hd)
    if kv is None:
        kv = cross_kv(p, memory if shard is None else shard.enter(memory),
                      hcfg)
    k, v = kv
    qf = (q.to(torch.float32) / math.sqrt(hd)).reshape(
        B, Sq, hcfg.n_kv_heads, hcfg.q_groups, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.to(torch.float32))
    p_ = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p_, v.to(torch.float32))
    o = o.reshape(B, Sq, hcfg.n_heads * hd).to(x.dtype)
    return _out_proj(params, o, cfg, shard, x.dtype)


def cross_prefill(params: Dict, memory: torch.Tensor, cfg: AttnConfig, *,
                  shard: Optional[Shard] = None,
                  seq: Optional[ProcessMesh] = None
                  ) -> Tuple[KV, KV]:
    """(the keys and values ``cross_attention`` reads, the ``ck``/``cv``
    the cache holds) of encoder states ``memory``.  With ``shard``, the
    former are those of the kv heads the rank's q heads use
    (``local_heads``'; cut from every kv head's where they do not split
    over ``model``).  The cache holds
    every kv head: of every frame, or with ``seq`` the rank's frames
    (``launch/sharding.cache_slots``); with kv heads split over
    ``model``, all-gathered along it in rank order, or under ``seq`` each
    rank's frame chunks of its heads sent to the chunks' ranks in one
    all-to-all, as ``prefill_cache``'s."""
    if shard is None:
        kv = every = cross_kv(params, memory, cfg)
    elif not _kv_split(params, cfg):
        # every kv head once; the rank's are those its q heads use
        every = cross_kv(params, memory, cfg)
        H = params["wq"]["kernel"].shape[-1] // cfg.hd
        ids = torch.tensor(_kv_ids(cfg, shard.local(H, cfg.n_heads, "wq"),
                                   H), device=memory.device)
        kv = (every[0].index_select(2, ids), every[1].index_select(2, ids))
    else:
        p, hcfg = local_heads(params, cfg, shard)
        kv = cross_kv(p, memory, hcfg)
        if seq is None:
            both = COLL.gather_cat(torch.stack(kv), shard.mesh, "model", 3)
            every = (both[0], both[1])
        else:
            m = seq.axis_size("model")
            a = torch.stack(kv)                  # (2, B, Sk, K / m, hd)
            w = a.shape[2] // m
            got = COLL.all_to_all([a[:, :, j * w:(j + 1) * w]
                                   for j in range(m)], seq, "model")
            return kv, tuple(torch.cat(got, dim=3).contiguous())
    if seq is None:
        return kv, every
    lo, hi = cache_slots(every[0].shape[1], seq)
    return kv, tuple(a[:, lo:hi].contiguous() for a in every)


def cross_decode(params: Dict, x1: torch.Tensor, cache: Params,
                 cfg: AttnConfig, *, shard: Optional[Shard] = None,
                 seq: Optional[ProcessMesh] = None) -> torch.Tensor:
    """One token's cross-attention over every cached frame: f32 softmax,
    no mask, no RoPE.  ``seq``: ``ck``/``cv`` hold this rank's frames of
    a sequence-sharded cache, and the softmax partials are merged over
    ``model`` (``collectives.softmax_combine``).  ``shard``: this rank's
    q heads and ``wo`` rows, as ``decode_step``'s: under ``seq`` every q
    head all-gathered against the rank's frames, the rank's heads' output
    kept; else the rank's q heads against their kv heads."""
    B = x1.shape[0]
    hd = cfg.hd
    p, hcfg = (params, cfg) if shard is None else local_heads(params, cfg,
                                                              shard)
    q = dense(p["wq"], x1).reshape(B, hcfg.n_heads, hd)
    acfg, ck, cv = hcfg, cache["ck"], cache["cv"]
    if seq is not None and shard is not None:
        q = COLL.gather_cat(q, seq, "model", 1)
        acfg = cfg
    elif shard is not None:
        ids = torch.tensor(_kv_ids(cfg, shard.index * hcfg.n_heads,
                                   hcfg.n_heads), device=x1.device)
        ck, cv = ck.index_select(2, ids), cv.index_select(2, ids)
    q = q.reshape(B, acfg.n_kv_heads, acfg.q_groups, hd)
    qf = q.to(torch.float32) / math.sqrt(hd)
    s = torch.einsum("bkgh,bskh->bkgs", qf, ck.to(torch.float32))
    cv = cv.to(torch.float32)
    if seq is None:
        o = torch.einsum("bkgs,bskh->bkgh", torch.softmax(s, dim=-1), cv)
    else:
        mx = torch.amax(s, dim=-1)
        e = torch.exp(s - mx[..., None])
        _, l, o = COLL.softmax_combine(
            mx, torch.sum(e, dim=-1), torch.einsum("bkgs,bskh->bkgh", e, cv),
            seq)
        o = o / l[..., None]
    o = o.reshape(B, 1, acfg.n_heads * hd)
    if seq is not None and shard is not None:    # the rank's heads' rows
        h0 = shard.index * hcfg.n_heads * hd
        o = o[..., h0:h0 + hcfg.n_heads * hd]
    return _out_proj(params, o.to(x1.dtype), cfg, shard, x1.dtype)
