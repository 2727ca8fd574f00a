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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import (
    Shard,
    apply_rope,
    dense,
    dense_init,
    rmsnorm,
    f32_matmul,
    rmsnorm_init,
    softcap,
)

NEG_INF = -2.0e38
Params = Dict[str, torch.Tensor]


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


def _project_qkv(params: Dict, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    hd = cfg.hd
    q = dense(params["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = dense(params["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(params["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_base)
    k = apply_rope(k, positions, cfg.rope_base)
    return q, k, v


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
    with an online softmax (running max m, denominator l, accumulator)."""
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
    outs = []
    for i in range(nq):
        qblk = qf[i].to(torch.float32)                  # (B,KV,G,qb,hd)
        acc = torch.zeros((B, KV, G, q_block, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, KV, G, q_block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, q_block), dtype=torch.float32,
                        device=q.device)
        for j in range(nk):
            s = torch.einsum("bkgqh,bksh->bkgqs", qblk,
                             kf[j].to(torch.float32))
            s = softcap(s, cfg.logit_softcap)
            mask = _mask_block(qp[i], kp[j], cfg, prefix_len)
            s = torch.where(mask[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bksh->bkgqh", p.to(vf.dtype).to(torch.float32),
                vf[j].to(torch.float32))
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.to(q.dtype))
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
    ids = [h // cfg.q_groups for h in range(h0, h0 + H)]
    kv = sorted(set(ids))
    if ids != [k for k in kv for _ in range(H // len(kv))]:
        kv = ids
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


def prefill_cache(params: Dict, x: torch.Tensor, cfg: AttnConfig,
                  max_len: int, dtype: Optional[torch.dtype] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """Run full attention AND return the populated cache.

    With a sliding window (max_len == window < S), only the trailing
    ``window`` tokens enter the ring, rotated so token j sits at slot
    j % window -- the invariant decode_step relies on.
    """
    B, S, _ = x.shape
    dtype = dtype or x.dtype
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    cache = init_cache(B, max_len, cfg, dtype, x.device)
    k_in, v_in = k, v            # the cache payload (attention below uses
    if S > max_len:              # the FULL k, v)
        # ring: keep the last window only, rotated so token j -> slot j % W
        assert cfg.window is not None and max_len == min(cfg.window, max_len)
        shift = (S - max_len) % max_len
        k_in = torch.roll(k[:, -max_len:], shift, dims=1)
        v_in = torch.roll(v[:, -max_len:], shift, dims=1)
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
    cache["len"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    pos1d = positions[0]
    o = _self_attention(q, k, v, cfg, pos1d, None, 2048, 512, 512)
    return dense(params["wo"], o.reshape(B, S, -1)), cache


def decode_step(params: Dict, x1: torch.Tensor, cfg: AttnConfig,
                cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-token decode: x1 (B, 1, d) against the cache (functional update).

    Each batch row sits at its own position ``len[b]`` (slot-based serving).
    With a sliding window the cache is a ring buffer of size window (the
    RecurrentGemma local-attention layout); otherwise it is append-only.
    """
    B = x1.shape[0]
    t = cache["len"]                              # (B,)
    positions = t[:, None]
    q, k, v = _project_qkv(params, x1, cfg, positions)

    max_len = cache["k"].shape[1]
    t64 = t.long()
    slot = (t64 % max_len) if cfg.window is not None else torch.clamp(
        t64, max=max_len - 1)
    idx = torch.arange(max_len, device=x1.device)
    rows = torch.arange(B, device=x1.device)

    def write(c: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        # per-row cache write: O(B) entries of a copy of the cache
        out = c.clone()
        out[rows, slot] = new
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

    hd = cfg.hd
    qf = (q.to(torch.float32) / math.sqrt(hd)).reshape(
        B, cfg.n_kv_heads, cfg.q_groups, hd)
    # int8 cache: the scales factor out of the hd contraction
    s = torch.einsum("bkgh,bskh->bkgs", qf, kc.to(torch.float32))
    if cfg.kv_quant:
        s = s * new_scales["k_scale"].to(torch.float32).permute(
            0, 2, 1)[:, :, None, :]
    s = softcap(s, cfg.logit_softcap)
    # valid = slots holding tokens visible to this row's position
    if cfg.window is not None:
        # ring buffer: every slot written within the last W tokens is live
        written = torch.clamp(t64 + 1, max=max_len)            # (B,)
        order = (slot[:, None] - idx[None, :]) % max_len       # 0 = newest
        valid = order < written[:, None]
    else:
        valid = idx[None, :] <= t64[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if cfg.kv_quant:
        p = p * new_scales["v_scale"].to(torch.float32).permute(
            0, 2, 1)[:, :, None, :]
    o = torch.einsum("bkgs,bskh->bkgh", p, vc.to(torch.float32))
    o = o.reshape(B, 1, cfg.n_heads * hd).to(x1.dtype)
    out = dense(params["wo"], o)
    return out, {"k": kc, "v": vc, "len": t + 1, **new_scales}


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_attn_init(generator: Optional[torch.Generator], cfg: AttnConfig,
                    dtype: torch.dtype = torch.float32) -> Dict:
    return attn_init(generator, dataclasses.replace(cfg, qk_norm=False),
                     dtype)


def cross_kv(params: Dict, memory: torch.Tensor, cfg: AttnConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The keys and values (B, Sk, n_kv_heads, hd) of encoder states
    memory (B, Sk, d)."""
    B, Sk, _ = memory.shape
    shape = (B, Sk, cfg.n_kv_heads, cfg.hd)
    return (dense(params["wk"], memory).reshape(shape),
            dense(params["wv"], memory).reshape(shape))


def cross_attention(params: Dict, x: torch.Tensor, memory: torch.Tensor,
                    cfg: AttnConfig, *,
                    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """x: (B, Sq, d) queries; memory: (B, Sk, d) encoder states (no rope);
    ``kv``: their ``cross_kv``, where the caller has them already."""
    B, Sq, _ = x.shape
    hd = cfg.hd
    q = dense(params["wq"], x).reshape(B, Sq, cfg.n_heads, hd)
    k, v = cross_kv(params, memory, cfg) if kv is None else kv
    qf = (q.to(torch.float32) / math.sqrt(hd)).reshape(
        B, Sq, cfg.n_kv_heads, cfg.q_groups, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.to(torch.float32))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    o = o.reshape(B, Sq, cfg.n_heads * hd).to(x.dtype)
    return dense(params["wo"], o)
