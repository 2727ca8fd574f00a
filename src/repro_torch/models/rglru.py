"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro/models/rglru.py``.  The Real-Gated Linear
Recurrent Unit is a diagonal linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    log a_t = -c * softplus(Lambda) * r_t,          c = 8

with input/recurrence gates r_t, i_t = sigmoid(linear(x_t)), decoded in
O(1) state.  The reference runs the recurrence as
``jax.lax.associative_scan``; the port runs it as a loop over time,
which rounds differently (a few f32 ulps; the parity tests state the
tolerance).  ``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus``
(``F.softplus`` turns into the identity above its threshold).
``lambda`` is f32 at init; a bf16 server casts it with every other
floating leaf, as the reference's does.  The state ``h`` is f32, ``conv``
has x's dtype.

Tensor parallelism (``rglru_apply(..., shard=)``): a rank holds its
``model`` shard of ``in_x``/``in_gate``/``wa``/``wx`` (columns),
``conv``/``lambda`` (lanes) and ``out`` (rows), and computes its lanes
of ``xb``, of the depthwise conv, of the gate and of the scan, which is
elementwise over lanes.  ``wa``/``wx`` read every lane of the conv's
output, so it is all-gathered along ``model`` before them
(``collectives.gather_lanes``: exact; backward, the cotangent summed in
rank order and the rank's lanes kept); ``out``'s f32 partial leaves
through ``layers.Shard.out``.  The rank reads its lanes of a whole state
and returns its lanes of the new one (``STATE_LANES``: the dim of each
entry that holds them); the serve steps all-gather them along ``model``
(``collectives.gather_blocks``), so every ``model`` rank holds the same
whole state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.launch import collectives as COLL
from repro_torch.models.layers import (
    Shard,
    dense,
    dense_init,
    f32_matmul,
    gelu,
    gen_device,
)
from repro_torch.models.xlstm import _causal_conv

Params = Dict[str, torch.Tensor]
# the dim of each state entry that holds a rank's lanes
STATE_LANES = {"conv": 2, "h": 1}
C_FACTOR = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    lru_width: Optional[int] = None     # defaults to d_model
    conv_kernel: int = 4

    @property
    def width(self) -> int:
        return self.lru_width or self.d_model


def rglru_init(generator: Optional[torch.Generator], cfg: RGLRUConfig,
               dtype: torch.dtype = torch.float32) -> Params:
    d, w = cfg.d_model, cfg.width
    dev = gen_device(generator)
    # Lambda init so a^c spans ~[0.9, 0.999] (paper appendix)
    u = torch.empty((w,), dtype=torch.float32, device=dev).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=generator)
    lam = torch.log(torch.exp(-torch.log(u) / (2 * C_FACTOR)) - 1.0)
    conv = torch.randn((cfg.conv_kernel, w), generator=generator, device=dev)
    return {
        "in_x": dense_init(generator, d, w, dtype=dtype),
        "in_gate": dense_init(generator, d, w, dtype=dtype),
        "conv": (conv * 0.1).to(dtype),
        "wa": dense_init(generator, w, w, bias=True, dtype=dtype),
        "wx": dense_init(generator, w, w, bias=True, dtype=dtype),
        "lambda": lam,                      # (w,) f32
        "out": dense_init(generator, w, d, dtype=dtype),
    }


def _lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 (h_0 = b_0)."""
    hs = [b[:, 0]]
    for t in range(1, a.shape[1]):
        hs.append(a[:, t] * hs[-1] + b[:, t])
    return torch.stack(hs, dim=1)


def rglru_apply(params: Params, x: torch.Tensor, cfg: RGLRUConfig,
                state: Optional[Dict[str, torch.Tensor]] = None,
                shard: Optional[Shard] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,S,d) -> (y, state); state = {conv, h} for O(1) decode.  With
    ``shard`` the rank's lanes (module docstring): ``state`` whole, the
    new state the rank's lanes of it."""
    f32 = torch.float32
    lanes = slice(None)
    if shard is not None:
        n = params["lambda"].shape[-1]
        lo = shard.local(n, cfg.width, "rglru lanes")
        lanes = slice(lo, lo + n)
    gate = gelu(dense(params["in_gate"], x).to(f32))
    xb = dense(params["in_x"], x)
    conv_state = None if state is None else state.get("conv")
    if conv_state is not None:
        conv_state = conv_state[..., lanes]
    xc, conv_state = _causal_conv(xb, params["conv"], conv_state)
    # wa / wx read every lane
    xw = xc if shard is None else COLL.gather_lanes(xc, shard.mesh)

    xf = xc.to(f32)
    r = torch.sigmoid(dense(params["wa"], xw).to(f32))
    i = torch.sigmoid(dense(params["wx"], xw).to(f32))
    lam = params["lambda"]
    softplus = torch.logaddexp(lam, torch.zeros((), dtype=lam.dtype,
                                                device=lam.device))
    log_a = -C_FACTOR * softplus * r                    # (B,S,w)
    a = torch.exp(log_a)
    # sqrt(1 - a^2) in log space for stability near a ~ 1
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * (i * xf)

    if state is not None and "h" in state:
        # prepend carry-in: h_0 contributes a_1 * h_in
        b = torch.cat([(b[:, 0] + a[:, 0] * state["h"][:, lanes])[:, None],
                       b[:, 1:]], dim=1)
    h = _lru_scan(a, b)                                 # (B,S,w)
    hg = (h * gate).to(x.dtype)
    if shard is None:
        y = dense(params["out"], hg)
    else:
        y = shard.out(f32_matmul(hg, params["out"]["kernel"]), x.dtype,
                      params["out"].get("bias"))
    new_state = {"conv": conv_state, "h": h[:, -1, :]}
    return y, new_state


def rglru_init_state(batch: int, cfg: RGLRUConfig,
                     dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cpu"
                     ) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.width),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.width), dtype=torch.float32,
                         device=device),
    }


def rglru_decode_step(params: Params, x1: torch.Tensor, cfg: RGLRUConfig,
                      state: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent update (the server's decode step)."""
    return rglru_apply(params, x1, cfg, state)
