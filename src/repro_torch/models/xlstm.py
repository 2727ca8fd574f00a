"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) + sLSTM (scalar).

Counterpart of ``repro/models/xlstm.py``.  xlstm-125m has no FFN
(d_ff=0): the blocks themselves carry the projections.

* mLSTM runs the chunkwise-parallel form: the sequence is processed in
  chunks of ``L = min(cfg.chunk, S)`` (the reference's boundaries, which
  fix the rounding); within a chunk the stabilised quadratic form
  (log-space gates, running max stabiliser m), across chunks the exact
  (C, n, m) state.  The reference unrolls up to ``UNROLL_MAX_CHUNKS``
  chunks and scans past that; the port loops in Python either way and
  keeps the scan branch's ``S % L == 0`` assert, so a prompt the
  reference refuses is refused here too.  A decode step is a chunk of
  length 1.
* sLSTM is sequential (exponential gating with a normaliser and per-head
  recurrent matrices): a Python loop over time where the reference
  scans.

Every product of the cells is f32 and, on the card, IEEE f32 with no
TF32 (``kernels/grad.ieee_matmul``).  The chunk's inclusive scan of the
log forget gates (the reference's ``jnp.cumsum``) is the product with an
upper-triangular ones matrix in f64, rounded once to f32
(``inclusive_scan``): the running sum to within one f32 rounding, and
deterministic on the card, where torch's deterministic mode refuses a
float ``cumsum``.  ``slstm_scan_flops`` and
``mlstm_chunk_flops`` are the reference's analytic FLOP counts, value
for value.  Initialisers draw from an explicit ``torch.Generator`` on
its device (the reference's shapes and distributions, not its draws;
sLSTM's orthogonal ``r`` comes from a QR of a normal draw).

Tensor parallelism (``mlstm_apply(..., shard=)``): a rank holds its
``model`` shard of ``wq``/``wk``/``wv`` (whole heads' columns) and of
``down`` (those heads' rows), and every other leaf whole.  It computes
z, the conv, ``zc`` and the gate whole, as every rank does, then q, k, v
and the chunk scan over its heads, their input and forget gates from
their columns of the whole ``wif``, and its heads' lanes of the output;
z, ``zc`` and the gate enter the rank's work through ``layers.Shard.
enter`` (their cotangents summed over ``model``), as does ``wif``.
``out_norm`` normalises over the whole inner width: its mean of squares
is each rank's f32 sum of squares summed over ``model`` in rank order
(not bitwise the one-device norm), its scale the rank's lanes; ``down``'s
f32 partial leaves through ``Shard.out``.  The rank reads its heads of a
whole state and returns its heads of the new (C, n, m) with the whole
conv state (``MLSTM_STATE_HEADS``: the dim of each entry that holds
them); the serve steps all-gather the heads along ``model``
(``collectives.gather_blocks``).  The sLSTM
block's ``wx`` columns are (4 gates, heads, head dim) and its ``up``
``[a | b]``, so no shard of them is a whole unit: it runs whole.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.grad import ieee_matmul
from repro_torch.launch import collectives as COLL
from repro_torch.models.layers import (
    Shard,
    dense,
    dense_init,
    f32_matmul,
    gelu,
    randn,
    rmsnorm,
    rmsnorm_init,
)

Params = Dict[str, torch.Tensor]
LOG_EPS = -30.0
# the dim of each mLSTM state entry that holds a rank's heads (its conv
# state is whole)
MLSTM_STATE_HEADS = {"C": 1, "n": 1, "m": 1}
# the reference's mLSTM chunk loops longer than this run as lax.scan
UNROLL_MAX_CHUNKS = 8


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int
    proj_factor: float = 2.0       # mLSTM up-projection
    conv_kernel: int = 4
    chunk: int = 128               # chunkwise-parallel chunk length
    slstm_proj_factor: float = 4.0 / 3.0

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)

    @property
    def head_dim(self) -> int:
        assert self.d_inner % self.n_heads == 0
        return self.d_inner // self.n_heads


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def mlstm_init(generator: Optional[torch.Generator], cfg: XLSTMConfig,
               dtype: torch.dtype = torch.float32) -> Params:
    d, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    return {
        "norm": rmsnorm_init(d, dtype),
        "up": dense_init(generator, d, 2 * di, dtype=dtype),
        "conv": (randn(generator, (cfg.conv_kernel, di)) * 0.1).to(dtype),
        "wq": dense_init(generator, di, di, dtype=dtype),
        "wk": dense_init(generator, di, di, dtype=dtype),
        "wv": dense_init(generator, di, di, dtype=dtype),
        "wif": dense_init(generator, di, 2 * H, bias=True, dtype=dtype),
        "out_norm": rmsnorm_init(di, dtype),
        "down": dense_init(generator, di, d, dtype=dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x (B,S,D), w (K,D).  Returns (y, new_state)
    where state holds the trailing K-1 inputs (decode carry)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    y = xp[:, 0:x.shape[1], :] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + x.shape[1], :] * w[i]
    return y, xp[:, -(K - 1):, :]


def inclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """The inclusive running sum of f32 ``x`` over its last dim: the f64
    product with an upper-triangular ones matrix (deterministic on the
    card, where a float ``torch.cumsum`` is refused under deterministic
    algorithms), rounded once to f32."""
    L = x.shape[-1]
    upper = torch.triu(torch.ones((L, L), dtype=torch.float64,
                                  device=x.device))
    return torch.matmul(x.to(torch.float64), upper).to(x.dtype)


def _mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 li: torch.Tensor, lf: torch.Tensor,
                 state: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Stabilised chunkwise mLSTM.  q,k,v: (B,H,L,hd); li,lf: (B,H,L) log
    gates; state = (C (B,H,hd,hd), n (B,H,hd), m (B,H))."""
    f32 = torch.float32
    B, H, L, hd = q.shape
    C_in, n_in, m_in = state
    q = q.to(f32) / np.float32(np.sqrt(hd))
    k = k.to(f32)
    v = v.to(f32)

    Fc = inclusive_scan(lf)                             # (B,H,L) inclusive
    # intra-chunk exponents a[t,j] = F_t - F_j + li_j  (j <= t)
    a = Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    a = torch.where(tri, a, torch.tensor(LOG_EPS, dtype=f32,
                                         device=q.device))
    b = Fc + m_in[..., None]                            # inter exponent
    m_loc = torch.maximum(torch.amax(a, dim=-1), b)     # (B,H,L)
    m_t = torch.maximum(m_loc, -m_loc * 0 + LOG_EPS)

    D = torch.exp(a - m_t[..., None])                   # (B,H,L,L)
    S = ieee_matmul(q, k.transpose(-1, -2)) * D
    h_intra = ieee_matmul(S, v)
    inter_w = torch.exp(b - m_t)                        # (B,H,L)
    h_inter = ieee_matmul(q, C_in) * inter_w[..., None]
    num = h_intra + h_inter

    denom_vec = ieee_matmul(D, k) + n_in[..., None, :] * inter_w[..., None]
    denom = torch.sum(q * denom_vec, dim=-1)
    denom = torch.maximum(torch.abs(denom), torch.exp(-m_t))
    h = num / denom[..., None]                          # (B,H,L,hd)

    # end-of-chunk state
    m_out = m_t[..., -1]
    wF = torch.exp(Fc[..., -1:] - Fc + li - m_out[..., None])   # (B,H,L)
    decay = torch.exp(Fc[..., -1] + m_in - m_out)
    wk = wF[..., None] * k
    C_out = decay[..., None, None] * C_in + ieee_matmul(
        wk.transpose(-1, -2), v)
    n_out = decay[..., None] * n_in + torch.sum(wk, dim=-2)
    return h, (C_out, n_out, m_out)


def _rmsnorm_lanes(params: Params, x: torch.Tensor, width: int,
                   lanes: slice, shard: Shard) -> torch.Tensor:
    """``rmsnorm`` over ``width`` lanes split over ``model``, of this
    rank's ``lanes`` ``x``: the mean of squares from each rank's f32 sum
    of squares summed over ``model`` in rank order (backward: the
    cotangent, each rank's share, summed too)."""
    xf = x.to(torch.float32)
    ss = torch.sum(torch.square(xf), dim=-1, keepdim=True)
    ss = COLL.enter(COLL.combine(ss, shard.mesh), shard.mesh)
    y = xf * torch.rsqrt(ss / width + 1e-6)       # rmsnorm's eps
    scale = shard.enter(params["scale"])[lanes]
    return (y * scale.to(torch.float32)).to(x.dtype)


def mlstm_apply(params: Params, x: torch.Tensor, cfg: XLSTMConfig,
                state: Optional[Dict[str, torch.Tensor]] = None,
                shard: Optional[Shard] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,S,d).  state carries (conv, C, n, m) for decode.  With
    ``shard`` the rank's heads (module docstring): ``state`` whole, the
    new (C, n, m) the rank's heads of it; the output whole."""
    f32 = torch.float32
    B, S, d = x.shape
    H, hd, di = cfg.n_heads, cfg.head_dim, cfg.d_inner
    h = rmsnorm(params["norm"], x)
    up = dense(params["up"], h)
    z, gate = torch.chunk(up, 2, dim=-1)                # (B,S,di) each
    conv_state = None if state is None else state.get("conv")
    zc, conv_state = _causal_conv(z, params["conv"], conv_state)
    zc = F.silu(zc.to(f32)).to(x.dtype)
    wif, Hl, hs_ = params["wif"], H, slice(None)
    if shard is not None:
        Hl = params["wq"]["kernel"].shape[-1] // hd
        h0 = shard.local(Hl, H, "mlstm heads")
        hs_, lanes = slice(h0, h0 + Hl), slice(h0 * hd, (h0 + Hl) * hd)
        z, zc, gate = shard.enter(torch.stack([z, zc, gate])).unbind(0)
        gate = gate[..., lanes]
        # the rank's heads' input and forget gate columns
        idx = torch.tensor([g * H + h0 + j for g in range(2)
                            for j in range(Hl)], device=x.device)
        wif = {k: shard.enter(v).index_select(-1, idx)
               for k, v in wif.items()}

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(B, S, Hl, hd).permute(0, 2, 1, 3)

    q = heads(dense(params["wq"], zc))
    k = heads(dense(params["wk"], zc))
    v = heads(dense(params["wv"], z))
    gif = dense(wif, zc).to(f32)
    g = gif.reshape(B, S, 2, Hl).permute(0, 3, 1, 2)    # (B,H,S,2)
    li = g[..., 0]                                      # (B,H,S) log input
    # log forget, of a contiguous copy: log_sigmoid's output keeps a
    # strided input's layout on meta and the card, not on the CPU, and
    # the layout picks the scan's product (mm or bmm; launch/dryrun)
    lf = F.logsigmoid(g[..., 1].contiguous())

    if state is None:
        st = (torch.zeros((B, Hl, hd, hd), dtype=f32, device=x.device),
              torch.zeros((B, Hl, hd), dtype=f32, device=x.device),
              torch.zeros((B, Hl), dtype=f32, device=x.device))
    else:
        st = (state["C"][:, hs_], state["n"][:, hs_], state["m"][:, hs_])

    L = min(cfg.chunk, S)
    n_chunks = -(-S // L)
    if n_chunks > UNROLL_MAX_CHUNKS:
        # the reference scans these chunks, which needs whole ones
        assert S % L == 0, (S, L)
    outs = []
    for s0 in range(0, S, L):
        sl = slice(s0, s0 + L)
        hh, st = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                              li[:, :, sl], lf[:, :, sl], st)
        outs.append(hh)
    hs = torch.cat(outs, dim=2)                         # (B,H,S,hd)
    hs = hs.permute(0, 2, 1, 3).reshape(B, S, Hl * hd).to(x.dtype)
    if shard is None:
        hs = rmsnorm(params["out_norm"], hs)
    else:
        hs = _rmsnorm_lanes(params["out_norm"], hs, di, lanes, shard)
    hs = hs * F.silu(gate.to(f32)).to(x.dtype)
    if shard is None:
        y = x + dense(params["down"], hs)
    else:
        y = x + shard.out(f32_matmul(hs, params["down"]["kernel"]),
                          x.dtype, params["down"].get("bias"))
    new_state = {"conv": conv_state, "C": st[0], "n": st[1], "m": st[2]}
    return y, new_state


def mlstm_init_state(batch: int, cfg: XLSTMConfig,
                     dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cpu"
                     ) -> Dict[str, torch.Tensor]:
    H, hd, di = cfg.n_heads, cfg.head_dim, cfg.d_inner
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, di), dtype=dtype,
                            device=device),
        "C": torch.zeros((batch, H, hd, hd), dtype=f32, device=device),
        "n": torch.zeros((batch, H, hd), dtype=f32, device=device),
        "m": torch.zeros((batch, H), dtype=f32, device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def _orthogonal(generator: Optional[torch.Generator],
                shape: Tuple[int, ...]) -> torch.Tensor:
    """An f32 tensor whose (prod(shape[:-1]), shape[-1]) matrix has
    orthonormal columns (rows, if fewer), as ``jax.nn.initializers.
    orthogonal`` shapes it; from the QR of a normal draw."""
    n_cols = shape[-1]
    n_rows = int(np.prod(shape[:-1]))
    a = randn(generator, (max(n_rows, n_cols), min(n_rows, n_cols)))
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.t()
    return q.reshape(shape)


def slstm_init(generator: Optional[torch.Generator], cfg: XLSTMConfig,
               dtype: torch.dtype = torch.float32) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    return {
        "norm": rmsnorm_init(d, dtype),
        "wx": dense_init(generator, d, 4 * d, bias=True, dtype=dtype),
        # per-head recurrent block-diagonal matrices for the 4 gates
        "r": (_orthogonal(generator, (4, H, hd, hd)) * 0.6).to(dtype),
        "out_norm": rmsnorm_init(d, dtype),
        "up": dense_init(generator, d, int(cfg.slstm_proj_factor * d) * 2,
                         dtype=dtype),
        "down": dense_init(generator, int(cfg.slstm_proj_factor * d), d,
                           dtype=dtype),
    }


def _slstm_cell(carry: Tuple[torch.Tensor, ...], inp: torch.Tensor,
                r: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...],
                                          torch.Tensor]:
    """One sLSTM step.  carry = (h, c, n, m) each (B,H,hd); inp = projected
    gate pre-activations (B, 4, H, hd); r = (4,H,hd,hd) recurrent weights."""
    f32 = torch.float32
    h, c, n, m = carry
    # (B,1,H,1,hd) @ (4,H,hd,hd) -> (B,4,H,1,hd)
    rec = ieee_matmul(h[:, None, :, None, :], r.to(f32))[..., 0, :]
    zt, it, ft, ot = [inp[:, g].to(f32) + rec[:, g] for g in range(4)]
    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(lf + m - m_new)
    c_new = f_ * c + i_ * torch.tanh(zt)
    n_new = f_ * n + i_
    h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1.0)
    return (h_new, c_new, n_new, m_new), h_new


def slstm_apply(params: Params, x: torch.Tensor, cfg: XLSTMConfig,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    f32 = torch.float32
    B, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    xn = rmsnorm(params["norm"], x)
    pre = dense(params["wx"], xn).reshape(B, S, 4, H, hd)

    if state is None:
        zeros = torch.zeros((B, H, hd), dtype=f32, device=x.device)
        carry = (zeros, zeros, zeros, zeros - 10.0)
    else:
        carry = (state["h"], state["c"], state["n"], state["m"])

    hs = []
    for t in range(S):
        carry, h_t = _slstm_cell(carry, pre[:, t], params["r"])
        hs.append(h_t)
    hs = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    hs = rmsnorm(params["out_norm"], hs)
    up = dense(params["up"], hs)
    a, b = torch.chunk(up, 2, dim=-1)
    y = x + dense(params["down"], a * gelu(b.to(f32)).to(x.dtype))
    new_state = {"h": carry[0], "c": carry[1], "n": carry[2], "m": carry[3]}
    return y, new_state


def slstm_init_state(batch: int, cfg: XLSTMConfig,
                     device: torch.device | str = "cpu"
                     ) -> Dict[str, torch.Tensor]:
    H = cfg.n_heads
    hd = cfg.d_model // H
    z = torch.zeros((batch, H, hd), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(), "m": z - 10.0}


def slstm_scan_flops(cfg: XLSTMConfig, batch: int, seq: int) -> float:
    """Analytic FLOPs of the recurrent matmuls inside the time loop (the
    reference's roofline adds them back to its scanned HLO's count)."""
    hd = cfg.d_model // cfg.n_heads
    per_step = 2 * 4 * cfg.n_heads * hd * hd
    return float(batch * seq * per_step)


def mlstm_chunk_flops(cfg: XLSTMConfig, batch: int, seq: int) -> float:
    """Analytic FLOPs of ONE mLSTM layer's chunkwise pass (the reference's
    roofline reads it when the chunk loop runs as a scan)."""
    L, H, hd = cfg.chunk, cfg.n_heads, cfg.head_dim
    n_chunks = seq // L
    per_chunk = (
        2 * L * L * hd      # q k^T
        + 2 * L * L * hd    # S v
        + 2 * L * L * hd    # D k (denominator)
        + 2 * L * hd * hd   # q C_in
        + 2 * 2 * L * hd * hd  # C_out outer products + n_out
    )
    return float(batch * H * n_chunks * per_chunk)
