"""Mixture-of-Experts with capacity-bounded dispatch.

Counterpart of ``repro/models/moe.py`` on one device.  Each token picks
its top-k experts from the router's softmax; a token's position inside
its expert is the exclusive cumsum of the flattened (T*K, E) one-hot in
token-major order, and tokens beyond an expert's capacity C are dropped
(their combine weight is 0).  Dispatch scatters each kept (token, pick)
into an (E, C + 1, d) buffer whose slot C is a trash row, cut off before
the experts run; the combine gathers each pick back and sums over k in
x's dtype.  The two paths keep the reference's two capacity formulas
and routers:

* swiglu experts (``_moe_local``): f32 router logits, ``C = ceil(int(cf
  * T * K) / E)`` rounded up to a multiple of 8 (at least 8);
* KAN experts (``_moe_local_kan``): the router through ``dense`` (x's
  dtype, then f32: a bf16 router ties), ``C = cfg.capacity(T)``.  Every
  expert runs on every call, as the reference's ``jax.vmap`` over all E
  does: two KAN layers, each one fused-KAN launch on a CUDA tensor (2 E
  launches a call).  ``KanExperts`` holds each expert's fused ``[w_b ;
  t]`` once; the functional form fuses them per call.

``jax.lax.top_k`` puts the lower index first on a tie; a stable
descending sort does the same here.  The Switch-style aux loss is over
the whole router distribution, in f32.  ``shared_expert`` adds
llama4-scout's always-on SwiGLU expert.

The expert products are plain f32-accumulated products.  bf16 expert
weights are widened a group of experts at a time
(``WIDEN_BYTES``), never a layer's whole (E, d, f) stack at once: a
product of two bf16 values is exact in f32, so only the summation order
can differ from the reference's.  On the card every f32 product refuses
TF32.

Expert parallelism (the reference's ``shard_map`` branch of
``moe_apply``): under an active ``launch/mesh.ProcessMesh``
(``launch/mesh.set_mesh``) whose ``model`` axis has more than one rank,
with SwiGLU experts, each ``model`` rank holds ``E / m`` experts (``e0 =
model rank * E_loc``) and runs ``_moe_local(..., e0, E_loc)`` over the
tokens of its ``data`` shard: capacity from that local T with the global
E, the picks of other ranks' experts masked out (``in_range``).  Its
combine sums the picks of its experts in f32 and ``launch/collectives.
combine`` sums that over ``model`` in rank order, cast to x's dtype
once (the reference psums its x-dtype partials; summing in f32 keeps the
1-device answer's single rounding).  ``collectives.enter`` on the tokens
and on the normalised gates sums their cotangents over ``model`` in the
backward: each rank's share covers only its experts, and the router's
gradient and x's come out whole.  ``moe_apply`` takes the layer's whole
experts (and slices them) or the rank's ``E_loc`` already (the train and
serve steps store only those); the steps gather the experts' FSDP
shards over ``data`` before the call.  The aux loss is this ``data``
shard's; the train step averages it over the ``data`` ranks, as the
reference's body does.  KAN experts stay on the local path, gathered, as
in the reference.

The shared expert is tensor-parallel over ``model`` (``moe_apply(...,
shared=)``, a ``layers.Shard``): a rank holds its columns of ``up`` and
rows of ``down`` and computes its hidden lanes, slicing its columns of
the replicated ``gate`` (which the reference's rules do not shard); the
tokens and the whole ``gate`` enter through ``Shard.enter`` and the f32
partial leaves through ``Shard.out``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.kan import KANConfig, kan_init
from repro_torch.core.splines import SplineSpec
from repro_torch.kernels.grad import ieee_matmul
from repro_torch.kernels.kan_fused.ops import kan_fused_v2, slot_table
from repro_torch.launch import collectives as COLL
from repro_torch.launch.mesh import ProcessMesh, current_mesh
from repro_torch.models.ffn import FFNConfig, ffn_apply, ffn_init
from repro_torch.models.layers import Shard, dense, dense_init, randn

Params = Dict[str, torch.Tensor]
# the f32 copy of bf16 expert weights one product widens at a time
WIDEN_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                    # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4: one always-on shared expert
    router_jitter: float = 0.0
    ffn_kind: str = "swiglu"     # swiglu | kan
    kan_grid: int = 4
    kan_order: int = 3

    def capacity(self, n_tokens: int) -> int:
        c = int(self.capacity_factor * self.top_k * n_tokens
                / self.n_experts) + 1
        return max(self.top_k, min(c, n_tokens))

    def kan_cfgs(self) -> Tuple[KANConfig, KANConfig]:
        """Each KAN expert's (up, down) layers: d -> h -> d, h as the
        reference sizes it."""
        spec = SplineSpec(self.kan_grid, self.kan_order)
        h = max(8, self.d_ff // (spec.n_bases + 1))
        return KANConfig(self.d_model, h, spec), KANConfig(h, self.d_model,
                                                           spec)


def _stack(layers: List[Params]) -> Params:
    return {k: torch.stack([p[k] for p in layers]) for k in layers[0]}


def moe_init(generator: Optional[torch.Generator], cfg: MoEConfig,
             dtype: torch.dtype = torch.float32) -> Dict:
    """Router and stacked experts drawn from ``generator`` on its device
    (the reference's shapes and distributions, not its draws)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p: Dict = {"router": dense_init(generator, d, E, dtype=dtype)}
    if cfg.ffn_kind == "swiglu":
        std = float(d ** -0.5)
        p["experts"] = {
            name: (randn(generator, shape) * std).to(dtype)
            for name, shape in (("gate", (E, d, f)), ("up", (E, d, f)),
                                ("down", (E, f, d)))}
    elif cfg.ffn_kind == "kan":
        up_cfg, down_cfg = cfg.kan_cfgs()
        p["experts"] = {
            "up": _stack([kan_init(up_cfg, generator, dtype)
                          for _ in range(E)]),
            "down": _stack([kan_init(down_cfg, generator, dtype)
                            for _ in range(E)])}
    else:
        raise ValueError(cfg.ffn_kind)
    return p


def _expert_matmul(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 (E, C, n) = h (E, C, m) @ w (E, m, n), operands widened to f32
    a group of experts at a time."""
    E = w.shape[0]
    if w.dtype == torch.float32 and h.dtype == torch.float32:
        return ieee_matmul(h, w)
    per = max(1, WIDEN_BYTES // (4 * w[0].numel()))
    return torch.cat([
        ieee_matmul(h[e:e + per].to(torch.float32),
                    w[e:e + per].to(torch.float32))
        for e in range(0, E, per)])


def _swiglu_experts(h: torch.Tensor, gate_w: torch.Tensor,
                    up_w: torch.Tensor, down_w: torch.Tensor) -> torch.Tensor:
    """h: (E, C, d) -> (E, C, d) in h's dtype."""
    g = _expert_matmul(h, gate_w)
    u = _expert_matmul(h, up_w)
    z = (F.silu(g) * u).to(h.dtype)
    return _expert_matmul(z, down_w).to(h.dtype)


class KanExperts(nn.Module):
    """E KAN experts (two KAN layers each) holding every expert's fused
    ``[w_b ; t]`` rows once, in the params' promoted dtype: ``forward`` maps
    (E, C, d) to (E, C, d), one fused-KAN launch a layer an expert on a
    CUDA tensor."""

    def __init__(self, cfg: MoEConfig, experts: Dict[str, Params]) -> None:
        super().__init__()
        if cfg.ffn_kind != "kan":
            raise ValueError(f"KanExperts needs ffn_kind='kan', got "
                             f"{cfg.ffn_kind!r}")
        self.cfgs = cfg.kan_cfgs()
        self.spec = self.cfgs[0].spec
        self.kb = tuple(range(self.spec.n_bases))
        for name, kcfg in zip(("up", "down"), self.cfgs):
            w_b, t = experts[name]["w_b"], experts[name]["t"]
            E = w_b.shape[0]
            want = ((E, kcfg.n_in, kcfg.n_out),
                    (E, kcfg.n_in, self.spec.n_bases, kcfg.n_out))
            if (tuple(w_b.shape), tuple(t.shape)) != want:
                raise ValueError(
                    f"KanExperts {name}: got w_b {tuple(w_b.shape)} and t "
                    f"{tuple(t.shape)}, expected {want}")
            self.register_buffer(f"wt_{name}", _fuse_stack(w_b, t),
                                 persistent=False)
        self.register_buffer(
            "slot_of", slot_table(self.kb, self.spec.n_bases, w_b.device),
            persistent=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        outs = []
        for e in range(h.shape[0]):
            mid = kan_fused_v2(h[e].contiguous(), self.wt_up[e], self.spec,
                               self.kb, self.slot_of)
            outs.append(kan_fused_v2(mid, self.wt_down[e], self.spec,
                                     self.kb, self.slot_of))
        return torch.stack(outs)


def _fuse_stack(w_b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(E, n_in*(nb+1), n_out): each expert's fused ``[w_b ; t]`` rows
    (``kan_fused.ops.fuse_wt``'s layout), in w_b's and t's promoted dtype:
    f32 in a bf16 model, whose t is f32 (the reference's ``kan_init``),
    as the reference's expert layer promotes its product."""
    E, n_in, n_out = w_b.shape
    return torch.cat([w_b[:, :, None], t], dim=2).reshape(
        E, -1, n_out)


def _route(probs: torch.Tensor, K: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top_p normalised, top_e) of (T, E) probs; the lower expert first
    on a tie, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = vals[:, :K], idx[:, :K]
    return top_p / torch.sum(top_p, dim=-1, keepdim=True), top_e


def _dispatch(xt: torch.Tensor, top_e: torch.Tensor, top_p: torch.Tensor,
              E: int, C: int, e0: int = 0, local: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """(buf (E, C, d), flat_e, flat_pos, gate): each kept pick at its
    position in its expert's slots, dropped picks at the trash slot C
    (cut off) with gate 0.  ``local`` dispatches the experts ``e0 .. e0
    + E - 1`` of all the picks only: other picks are masked out (the
    reference's ``in_range``)."""
    T, d = xt.shape
    K = top_e.shape[1]
    if local:
        le = top_e - e0                                         # local ids
        in_range = (le >= 0) & (le < E)
        top_e = torch.clamp(le, 0, E - 1)
    onehot = F.one_hot(top_e, E).to(torch.int32)                # (T, K, E)
    if local:
        onehot = onehot * in_range[..., None].to(torch.int32)
    flat = onehot.reshape(T * K, E)
    rank = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat  # exclusive
    pos = torch.sum(rank * flat, dim=-1).reshape(T, K)
    keep = pos < C
    if local:
        keep = in_range & keep
    gate = torch.where(keep, top_p, torch.zeros((), dtype=top_p.dtype,
                                                device=top_p.device))
    flat_e = top_e.reshape(-1)
    flat_pos = torch.where(keep.reshape(-1), pos.reshape(-1),
                           torch.full((), C, dtype=pos.dtype,
                                      device=pos.device)).long()
    buf = torch.zeros((E, C + 1, d), dtype=xt.dtype, device=xt.device)
    tok_idx = torch.arange(T, device=xt.device).repeat_interleave(K)
    buf.index_put_((flat_e, flat_pos), xt[tok_idx], accumulate=True)
    return buf[:, :C], flat_e, flat_pos, gate


def _combine(hidden: torch.Tensor, flat_e: torch.Tensor,
             flat_pos: torch.Tensor, gate: torch.Tensor,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(T, d): each token's picks weighted by their gates, summed over k
    in hidden's dtype (in ``dtype`` when given)."""
    T, K = gate.shape
    E, _, d = hidden.shape
    padded = torch.cat([hidden, torch.zeros((E, 1, d), dtype=hidden.dtype,
                                            device=hidden.device)], dim=1)
    picked = padded[flat_e, flat_pos].reshape(T, K, d)
    return torch.sum(picked * gate[..., None].to(picked.dtype), dim=1,
                     dtype=dtype)


def _aux_loss(probs: torch.Tensor, top_e: torch.Tensor,
              E: int) -> torch.Tensor:
    """Switch-style load balance, over the full router distribution."""
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(top_e[:, 0], E).to(torch.float32), dim=0)
    return E * torch.sum(me * ce)


def _moe_local(xt: torch.Tensor, router_k: torch.Tensor,
               gate_w: torch.Tensor, up_w: torch.Tensor,
               down_w: torch.Tensor, cfg: MoEConfig, e0: int = 0,
               E_loc: Optional[int] = None,
               mesh: Optional[ProcessMesh] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SwiGLU experts: routing + expert FFN + combine over the ``E_loc``
    local experts from ``e0`` (all E by default: the 1-device path).
    With ``mesh`` (expert parallelism over its ``model`` axis) the
    combine is summed over ``model``; see the module docstring."""
    T, d = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    E_loc = E if E_loc is None else E_loc
    logits = ieee_matmul(xt.to(torch.float32),
                         router_k.to(torch.float32))            # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _route(probs, K)
    # capacity per local expert, from the local T and the global E,
    # padded to keep shapes friendly
    C = -(-int(cfg.capacity_factor * T * K) // E)   # ceil
    C = max(8, -(-C // 8) * 8)
    if mesh is not None:
        xt, top_p = COLL.enter(xt, mesh), COLL.enter(top_p, mesh)
    buf, flat_e, flat_pos, gate = _dispatch(
        xt, top_e, top_p, E_loc, C, e0, mesh is not None or E_loc != E)
    hidden = _swiglu_experts(buf, gate_w, up_w, down_w)
    if mesh is None:
        out = _combine(hidden, flat_e, flat_pos, gate)
    else:
        part = _combine(hidden, flat_e, flat_pos, gate, torch.float32)
        out = COLL.combine(part, mesh).to(hidden.dtype)
    return out, _aux_loss(probs, top_e, E)


def _moe_local_kan(params: Dict, xt: torch.Tensor, cfg: MoEConfig,
                   experts: Optional[KanExperts] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KAN experts: dispatch like ``_moe_local``, every expert's two KAN
    layers through the fused-KAN kernel."""
    T, d = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = dense(params["router"], xt).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _route(probs, K)
    C = cfg.capacity(T)
    buf, flat_e, flat_pos, gate = _dispatch(xt, top_e, top_p, E, C)
    if experts is None:
        experts = KanExperts(cfg, params["experts"])
    hidden = experts(buf)
    out = _combine(hidden, flat_e, flat_pos, gate)
    return out, _aux_loss(probs, top_e, E)


def _expert_parallel(mesh: Optional[ProcessMesh], cfg: MoEConfig) -> bool:
    return (mesh is not None and mesh.axis_size("model") > 1
            and cfg.ffn_kind == "swiglu")


def local_experts(cfg: MoEConfig, mesh: ProcessMesh) -> Tuple[int, int]:
    """(e0, E_loc): the experts this ``model`` rank holds."""
    m = mesh.axis_size("model")
    E_loc = cfg.n_experts // m
    if E_loc * m != cfg.n_experts:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"{m} model ranks")
    return mesh.index_over("model") * E_loc, E_loc


def moe_apply(params: Dict, x: torch.Tensor, cfg: MoEConfig,
              experts: Optional[KanExperts] = None,
              shared: Optional[Shard] = None) -> Dict:
    """x: (B, S, d) -> {"out": (B, S, d), "aux_loss": f32 scalar}.

    ``experts`` (KAN experts only) is the layer's ``KanExperts``, or any
    callable on (E, C, d); without it the fused weights are built per
    call.  Under an active mesh with ``model`` > 1 and SwiGLU experts,
    the expert-parallel path; ``shared``: the shared expert's leaves are
    the rank's shards (module docstring)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    e = params["experts"]
    mesh = current_mesh()
    if _expert_parallel(mesh, cfg):
        e0, E_loc = local_experts(cfg, mesh)
        gw, uw, dw = e["gate"], e["up"], e["down"]
        if gw.shape[0] == cfg.n_experts:         # the whole layer given
            gw, uw, dw = (w[e0:e0 + E_loc] for w in (gw, uw, dw))
        elif gw.shape[0] != E_loc:
            raise ValueError(f"experts of {gw.shape[0]} on a model rank: "
                             f"expected {cfg.n_experts} or {E_loc}")
        out, aux = _moe_local(xt, params["router"]["kernel"], gw, uw, dw,
                              cfg, e0, E_loc, mesh)
    elif cfg.ffn_kind == "swiglu":
        out, aux = _moe_local(xt, params["router"]["kernel"], e["gate"],
                              e["up"], e["down"], cfg)
    else:
        out, aux = _moe_local_kan(params, xt, cfg, experts)
    if cfg.shared_expert and "shared" in params:
        fcfg, sp = FFNConfig(cfg.d_model, cfg.d_ff, kind="swiglu"), \
            params["shared"]
        if shared is None:
            sh = ffn_apply(sp, xt, fcfg)
        else:
            n = sp["up"]["kernel"].shape[-1]
            lo = shared.local(n, cfg.d_ff, "shared expert")
            gate = {k: shared.enter(v)[..., lo:lo + n]
                    for k, v in sp["gate"].items()}
            sh = ffn_apply({**sp, "gate": gate}, shared.enter(xt), fcfg,
                           shared)
        out = out + sh
    return {"out": out.reshape(B, S, d).to(x.dtype), "aux_loss": aux}


def moe_init_with_shared(generator: Optional[torch.Generator],
                         cfg: MoEConfig,
                         dtype: torch.dtype = torch.float32) -> Dict:
    p = moe_init(generator, cfg, dtype)
    if cfg.shared_expert:
        p["shared"] = ffn_init(
            generator, FFNConfig(cfg.d_model, cfg.d_ff, kind="swiglu"),
            dtype)
    return p
