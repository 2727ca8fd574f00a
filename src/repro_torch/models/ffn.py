"""FFN family: dense MLP / SwiGLU / GeGLU / KAN / **KAN-FFN**, and the
stacked KAN/MLP feed-forward workloads of the VIKIN serving path.

Counterpart of ``repro/models/ffn.py``.  Every transformer block selects
its feed-forward through ``FFNConfig.kind``: ``mlp``, ``swiglu`` and
``geglu`` are plain f32-accumulated products (``torch.matmul`` of the
widened operands), optionally with a static m-of-4 mask over the hidden
dimension; ``kan`` is two KAN layers (``KanPairFFN``: two
``core/kan.KANLayer``s, one fused-KAN launch each on a CUDA tensor);
``kanffn`` (``kan_ffn_apply``, ``KanFFN``) is the paper's technique at
LM scale: a KAN up-projection through the fused KAN kernel (stage-1
basis mask) and a linear down-projection through the pattern-matmul
kernel (stage-2 hidden mask).  ``kan_impl`` is kept for the reference's
field set and takes only ``"auto"``: the tensor's device picks kernel or
plain version.  The reference's interpret-mode single-k-tile rule has no
counterpart (there is no TPU interpreter here).

The stack half (``stack_layer_cfgs`` .. ``vikin_stack_apply``) serves
the paper's models.  A ``model`` is any config with ``.sizes``,
``.layer_kinds``, ``.spec`` and ``.pattern_rate``
(configs/vikin_models.PaperModelConfig).  Contract:

* "kan" layers run the fused KAN kernel (core/kan.KANLayer) with the
  stage-2 basis mask; inputs are clipped into the spline domain by the
  kernel itself.
* "mlp" layers run the pattern-sparse linear (``PatternLinear``) with a
  fused ReLU epilogue on every non-final layer; the m-of-4 mask applies
  to HIDDEN inputs only (layer i > 0) -- raw request features are never
  masked.

Parameters keep the JAX package's layout: one dict per layer, kan
``{"w_b": (n_in, n_out), "t": (n_in, G+K, n_out)}``, mlp
``{"w": (n_in, n_out), "b": (n_out,)}``; a kanffn FFN
``{"kan_up": {"w_b", "t"}, "w": (h, d_model), "b": (d_model,)}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.kan import KANConfig, KANLayer, kan_init
from repro_torch.core.sparsity import (
    PatternMask,
    sparsity_to_pattern,
    tiled_mask,
)
from repro_torch.core.splines import SplineSpec
from repro_torch.kernels.pattern_matmul.ops import matmul_compact
from repro_torch.models.layers import (
    ACT_FNS,
    Shard,
    dense,
    dense_init,
    f32_matmul,
    gen_device,
    randn,
)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FFNConfig:
    d_model: int
    d_ff: int
    kind: str = "swiglu"            # mlp | swiglu | geglu | kan | kanffn
    act: str = "gelu"               # for kind == "mlp"
    bias: bool = False
    # stage-2 pattern sparsity over the hidden dim (MLP) / bases (KAN)
    pattern_rate: float = 0.0
    # KAN-FFN options
    kan_grid: int = 4
    kan_order: int = 3
    kan_hidden: Optional[int] = None    # default: param-matched
    kan_impl: str = "auto"              # "auto" only: the device picks
    kan_version: int = 2                # fused-kernel generation (2 = v2)
    # (bm, bi, bn) knob override for the fused KAN kernels; None defers
    # to the autotune cache, then the kernel's defaults
    kan_blocks: Optional[Tuple[int, int, int]] = None
    # kind == "kanffn": calibrated two-stage masks.  Stage 1 keeps these
    # basis indices of the KAN up-projection (None = a tiled mask from
    # pattern_rate, or dense when that is 0); stage 2 keeps these hidden
    # lanes into the down-projection.
    basis_keep: Optional[Tuple[int, ...]] = None
    hidden_keep: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        if self.kan_impl != "auto":
            raise ValueError(
                f"FFNConfig.kan_impl={self.kan_impl!r}: the port has no "
                f"impl switch (a CUDA tensor launches the kernels, a CPU "
                f"tensor runs their plain versions); pass 'auto'")

    @property
    def hidden_mask(self) -> Optional[PatternMask]:
        if self.pattern_rate <= 0.0 or self.kind in ("kan", "kanffn"):
            return None
        return tiled_mask(self.d_ff, sparsity_to_pattern(self.pattern_rate))

    def kan_cfgs(self) -> Tuple[KANConfig, KANConfig]:
        spec = SplineSpec(self.kan_grid, self.kan_order)
        h = self.kan_hidden or max(8, self.d_ff // (spec.n_bases + 1))
        pat = (sparsity_to_pattern(self.pattern_rate)
               if self.pattern_rate > 0 else None)
        up = KANConfig(self.d_model, h, spec, pattern=pat,
                       version=self.kan_version, blocks=self.kan_blocks)
        down = KANConfig(h, self.d_model, spec, pattern=pat,
                         version=self.kan_version, blocks=self.kan_blocks)
        return up, down

    # -------------------------------------------------- kind == "kanffn"
    @property
    def kanffn_hidden(self) -> int:
        """Param-matched hidden width for the kan-up + linear-down FFN.

        Up carries h*d_model*(n_bases+1) params, down h*d_model, so
        h = 2*d_ff/(n_bases+2) matches the dense MLP's 2*d_model*d_ff.
        """
        spec = SplineSpec(self.kan_grid, self.kan_order)
        return self.kan_hidden or max(8, 2 * self.d_ff // (spec.n_bases + 2))

    def kanffn_up_cfg(self) -> KANConfig:
        spec = SplineSpec(self.kan_grid, self.kan_order)
        pat = (sparsity_to_pattern(self.pattern_rate)
               if self.basis_keep is None and self.pattern_rate > 0
               else None)
        return KANConfig(self.d_model, self.kanffn_hidden, spec,
                         pattern=pat, basis_keep=self.basis_keep,
                         version=self.kan_version, blocks=self.kan_blocks)

    def kanffn_hidden_mask(self) -> Optional[PatternMask]:
        """Stage-2 mask over the hidden lanes feeding the down-projection."""
        h = self.kanffn_hidden
        if self.hidden_keep is not None:
            keep = np.zeros(h, bool)
            keep[np.asarray(self.hidden_keep, np.int64)] = True
            return PatternMask(keep)
        if self.pattern_rate > 0:
            return tiled_mask(h, sparsity_to_pattern(self.pattern_rate))
        return None


def ffn_init(generator: Optional[torch.Generator], cfg: FFNConfig,
             dtype: torch.dtype = torch.float32) -> Dict:
    """The FFN's params drawn from ``generator`` on its device: the
    reference's shapes and distributions, not its draws."""
    if cfg.kind == "mlp":
        return {
            "up": dense_init(generator, cfg.d_model, cfg.d_ff, bias=cfg.bias,
                             dtype=dtype),
            "down": dense_init(generator, cfg.d_ff, cfg.d_model,
                               bias=cfg.bias, dtype=dtype),
        }
    if cfg.kind in ("swiglu", "geglu"):
        return {
            "gate": dense_init(generator, cfg.d_model, cfg.d_ff, dtype=dtype),
            "up": dense_init(generator, cfg.d_model, cfg.d_ff, dtype=dtype),
            "down": dense_init(generator, cfg.d_ff, cfg.d_model, dtype=dtype),
        }
    if cfg.kind == "kan":
        up_cfg, down_cfg = cfg.kan_cfgs()
        return {"kan_up": kan_init(up_cfg, generator, dtype),
                "kan_down": kan_init(down_cfg, generator, dtype)}
    if cfg.kind == "kanffn":
        # KAN up-projection + plain linear down-projection; init against
        # the DENSE up config: masks are serving-time overlays, params do
        # not change shape when calibration lands a mask
        h = cfg.kanffn_hidden
        up_cfg = dataclasses.replace(cfg.kanffn_up_cfg(), pattern=None,
                                     basis_keep=None)
        return {
            "kan_up": kan_init(up_cfg, generator, dtype),
            "w": (randn(generator, (h, cfg.d_model))
                  * float(np.sqrt(2.0 / h))).to(dtype),
            "b": torch.zeros((cfg.d_model,), dtype=dtype,
                             device=gen_device(generator)),
        }
    raise ValueError(f"unknown ffn kind {cfg.kind!r}")


def _compact(kernel: torch.Tensor, mask: PatternMask,
             axis: int) -> torch.Tensor:
    """Static m-of-4 weight compaction: the kept rows (axis 0) or
    columns (axis 1) of a weight."""
    idx = torch.as_tensor(mask.indices(), dtype=torch.long,
                          device=kernel.device)
    return kernel.index_select(axis, idx)


def ffn_apply(params: Dict, x: torch.Tensor, cfg: FFNConfig,
              shard: Optional[Shard] = None) -> torch.Tensor:
    """The FFN of ``cfg.kind`` on x; with ``shard`` (tensor parallelism)
    the leaves are this rank's ``model`` shards: ``gate``/``up`` its
    hidden columns (its lanes of the hidden mask), ``down`` its rows, and
    the f32 partial summed over ``model`` before ``down``'s bias
    (``layers.Shard.out``); the KAN kinds as ``KanPairFFN`` and
    ``KanFFN`` take it."""
    if cfg.kind == "kan":
        return KanPairFFN(cfg, params, shard)(x)
    if cfg.kind == "kanffn":
        return kan_ffn_apply(params, x, cfg, shard)
    if cfg.kind not in ("mlp", "swiglu", "geglu"):
        raise ValueError(cfg.kind)
    mask = cfg.hidden_mask
    f32 = torch.float32
    if shard is not None:
        width = params["down"]["kernel"].shape[0]
        lo = shard.local(width, cfg.d_ff, "ffn.down")
        mask = None if mask is None else PatternMask(mask.keep[lo:lo + width])

    def down(h: torch.Tensor, kernel: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
        y = f32_matmul(h, kernel)
        if shard is not None:
            return shard.out(y, x.dtype, bias)
        if bias is not None:
            y = y + bias.to(f32)
        return y.to(x.dtype)

    if cfg.kind == "mlp":
        if mask is not None:
            # stage-2 as pure shape reduction: up emits ONLY the kept
            # hidden columns; down consumes only the kept rows
            up_k = _compact(params["up"]["kernel"], mask, 1)
            down_k = _compact(params["down"]["kernel"], mask, 0)
            h = f32_matmul(x, up_k)
            if "bias" in params["up"]:
                h = h + _compact(params["up"]["bias"][None], mask,
                                 1)[0].to(f32)
            h = ACT_FNS[cfg.act](h).to(x.dtype)
            return down(h, down_k, params["down"].get("bias"))
        h = dense(params["up"], x)
        h = ACT_FNS[cfg.act](h.to(f32)).to(x.dtype)
        return down(h, params["down"]["kernel"], params["down"].get("bias"))
    act = F.silu if cfg.kind == "swiglu" else ACT_FNS["gelu"]
    if mask is not None:
        gate_k = _compact(params["gate"]["kernel"], mask, 1)
        up_k = _compact(params["up"]["kernel"], mask, 1)
        down_k = _compact(params["down"]["kernel"], mask, 0)
        g = act(f32_matmul(x, gate_k))
        h = (g * f32_matmul(x, up_k)).to(x.dtype)
        return down(h, down_k, None)
    g = act(dense(params["gate"], x).to(f32)).to(x.dtype)
    h = g * dense(params["up"], x)
    return down(h, params["down"]["kernel"], params["down"].get("bias"))


def kan_ffn_apply(params: Dict, x: torch.Tensor, cfg: FFNConfig,
                  shard: Optional[Shard] = None) -> torch.Tensor:
    """KAN-FFN: fused-v2 KAN up-projection, pattern-sparse linear down.

    Stage 1 (basis_keep, or tiled from pattern_rate) compacts the spline
    contraction inside the fused KAN kernel; stage 2 (hidden_keep)
    statically compacts the hidden lanes entering the down matmul.  One
    ``kan_fused_v2`` and one ``pattern_matmul`` launch on a CUDA tensor.
    Builds the layer on every call; serving holds a ``KanFFN``.
    ``shard``: as ``KanFFN``'s.
    """
    return KanFFN(cfg, params, shard)(x)


def stack_layer_cfgs(model: Any,
                     masks: Optional[Sequence[Optional[PatternMask]]] = None,
                     ) -> List[Tuple[str, Any]]:
    """Per-layer lowering descriptors: ("kan", KANConfig) or ("mlp", dict).

    ``masks`` (one Optional[PatternMask] per layer) overrides the tiled
    masks derived from ``model.pattern_rate``: KAN layers take it over the
    basis dimension, MLP layers over their input dimension.  A None entry
    leaves that layer dense.
    """
    spec = model.spec
    pat = (sparsity_to_pattern(model.pattern_rate)
           if model.pattern_rate > 0 else None)
    if masks is not None and len(masks) != len(model.sizes) - 1:
        raise ValueError(
            f"masks has {len(masks)} entries for "
            f"{len(model.sizes) - 1} layers")
    out: List[Tuple[str, Any]] = []
    for i, (kind, a, b) in enumerate(
            zip(model.layer_kinds, model.sizes, model.sizes[1:])):
        last = i == len(model.sizes) - 2
        override = masks[i] if masks is not None else None
        if kind == "kan":
            if masks is not None:
                kb = (None if override is None
                      else tuple(int(j) for j in override.indices()))
                out.append(("kan", KANConfig(a, b, spec, basis_keep=kb)))
            else:
                out.append(("kan", KANConfig(a, b, spec, pattern=pat)))
        elif kind == "mlp":
            if masks is not None:
                mask = override
            else:
                mask = (tiled_mask(a, pat) if pat is not None and i > 0
                        else None)
            out.append(("mlp", {"n_in": a, "n_out": b, "mask": mask,
                                "act": None if last else "relu"}))
        else:
            raise ValueError(f"unknown stack layer kind {kind!r}")
    return out


def vikin_stack_init(model: Any, generator: Optional[torch.Generator] = None,
                     dtype: torch.dtype = torch.float32) -> List[Params]:
    """He-init MLP layers / KAN-paper init for KAN layers, on the CPU.

    Same shapes and distributions as the JAX ``vikin_stack_init``; the
    draws differ (``tests`` carry weights across with ``convert.py``).
    """
    params: List[Params] = []
    for kind, cfg in stack_layer_cfgs(model):
        if kind == "kan":
            params.append(kan_init(cfg, generator, dtype))
        else:
            a, b = cfg["n_in"], cfg["n_out"]
            params.append({
                "w": torch.randn((a, b), generator=generator, dtype=dtype)
                * float(np.sqrt(2.0 / a)),
                "b": torch.zeros((b,), dtype=dtype),
            })
    return params


class PatternLinear(nn.Module):
    """One MLP layer: ``act(x[..., keep] @ w[keep, :] + b)``.

    The weight rows the mask drops are removed once, here; per call only
    the kept activation lanes are gathered, outside the kernel.
    """

    def __init__(self, cfg: Dict[str, Any], params: Params) -> None:
        super().__init__()
        self.n_in, self.n_out = cfg["n_in"], cfg["n_out"]
        self.act = cfg["act"]
        self.mask: Optional[PatternMask] = cfg["mask"]
        w, b = params["w"], params.get("b")
        if tuple(w.shape) != (self.n_in, self.n_out) or (
                b is not None and tuple(b.shape) != (self.n_out,)):
            raise ValueError(
                f"PatternLinear {self.n_in}->{self.n_out}: got w "
                f"{tuple(w.shape)} and b "
                f"{None if b is None else tuple(b.shape)}")
        self.register_buffer("w", w)
        self.register_buffer("b", b)
        idx = None
        w_c = w
        if self.mask is not None:
            idx = torch.as_tensor(self.mask.indices(), dtype=torch.long,
                                  device=w.device)
            w_c = w.index_select(0, idx)
        self.register_buffer("idx", idx, persistent=False)
        self.register_buffer("w_c", w_c.contiguous(), persistent=False)

    def forward(self, x: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        lead = x.shape[:-1]
        xf = x.reshape(-1, self.n_in)
        if self.idx is not None:
            xf = xf.index_select(1, self.idx)
        y = matmul_compact(xf.contiguous(), self.w_c, self.b, act=self.act,
                           out_dtype=out_dtype)
        return y.reshape(*lead, self.n_out)


class KanFFN(nn.Module):
    """A ``kind == "kanffn"`` FFN holding its weights fused and compacted
    once: the KAN up-projection as a ``KANLayer`` (the kept bases of
    ``basis_keep``) and the down-projection as a ``PatternLinear`` over
    the kept hidden lanes, with its bias and no activation, both in the
    params' dtype (x's dtype in, x's dtype out).

    With ``shard`` (tensor parallelism) ``kan_up`` is this rank's shard of
    the hidden lanes, and the down-projection takes its rows of the
    replicated ``w`` (their cotangents summed over ``model``) and its
    lanes of the hidden mask, without the bias: its f32 partial is summed
    over ``model``, then the bias added (``layers.Shard.out``)."""

    def __init__(self, cfg: FFNConfig, params: Dict,
                 shard: Optional[Shard] = None) -> None:
        super().__init__()
        if cfg.kind != "kanffn":
            raise ValueError(f"KanFFN needs kind='kanffn', got {cfg.kind!r}")
        up_cfg, h = cfg.kanffn_up_cfg(), cfg.kanffn_hidden
        mask, w, b = cfg.kanffn_hidden_mask(), params["w"], params["b"]
        self.shard = shard
        if shard is not None:
            h = params["kan_up"]["w_b"].shape[-1]
            lo = shard.local(h, up_cfg.n_out, "kan_up")
            up_cfg = dataclasses.replace(up_cfg, n_out=h)
            w = shard.enter(w).narrow(0, lo, h)
            mask = None if mask is None else PatternMask(
                mask.keep[lo:lo + h])
            self.register_buffer("b", b, persistent=False)
            b = None
        self.up = KANLayer(up_cfg, params["kan_up"])
        self.down = PatternLinear(
            {"n_in": h, "n_out": cfg.d_model, "mask": mask, "act": None},
            {"w": w, "b": b})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shard is None:
            return self.down(self.up(x))
        part = self.down(self.up(x), torch.float32)
        return self.shard.out(part, x.dtype, self.b)


class KanPairFFN(nn.Module):
    """A ``kind == "kan"`` FFN holding its two KAN layers (``kan_up``,
    ``kan_down``) as ``KANLayer``s: kept bases compacted and weights fused
    once, in the params' dtype (x's dtype in, x's dtype out).  The
    functional ``ffn_apply`` builds one per call.

    With ``shard`` (tensor parallelism) ``kan_up`` is this rank's shard of
    the KAN outputs and ``kan_down`` of its inputs: ``kan_down``'s f32
    partial output is summed over ``model``, then cast
    (``layers.Shard.out``)."""

    def __init__(self, cfg: FFNConfig, params: Dict,
                 shard: Optional[Shard] = None) -> None:
        super().__init__()
        if cfg.kind != "kan":
            raise ValueError(f"KanPairFFN needs kind='kan', got {cfg.kind!r}")
        up_cfg, down_cfg = cfg.kan_cfgs()
        self.shard = shard
        if shard is not None:
            h = params["kan_up"]["w_b"].shape[-1]
            shard.local(h, up_cfg.n_out, "kan_up")
            up_cfg = dataclasses.replace(up_cfg, n_out=h)
            down_cfg = dataclasses.replace(down_cfg, n_in=h)
        self.up = KANLayer(up_cfg, params["kan_up"])
        self.down = KANLayer(down_cfg, params["kan_down"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shard is None:
            return self.down(self.up(x))
        part = self.down(self.up(x), torch.float32)
        return self.shard.out(part, x.dtype)


class VikinStack(nn.Module):
    """A whole KAN/MLP stack, its weights compacted and fused once, in the
    params' dtype: f32 params take f32 x, bf16 params (the reference's
    bf16 serving) bf16 x, every layer emitting its input's dtype."""

    def __init__(self, model: Any, params: Sequence[Params],
                 masks: Optional[Sequence[Optional[PatternMask]]] = None,
                 layer_range: Optional[Tuple[int, int]] = None) -> None:
        super().__init__()
        cfgs = stack_layer_cfgs(model, masks)
        if layer_range is not None:
            lo, hi = layer_range
            if not 0 <= lo < hi <= len(cfgs):
                raise ValueError(
                    f"layer_range {layer_range!r} out of bounds for a "
                    f"{len(cfgs)}-layer stack")
            cfgs = cfgs[lo:hi]
            # accept the full param list (slice it) or a pre-sliced one
            if len(params) != len(cfgs):
                params = params[lo:hi]
        if len(params) != len(cfgs):
            raise ValueError(f"{len(params)} param dicts for a "
                             f"{len(cfgs)}-layer stack")
        self.model = model
        self.kinds = [kind for kind, _ in cfgs]
        self.layers = nn.ModuleList(
            KANLayer(cfg, p) if kind == "kan" else PatternLinear(cfg, p)
            for p, (kind, cfg) in zip(params, cfgs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


def vikin_stack_apply(params: Sequence[Params], x: torch.Tensor, model: Any,
                      *, masks: Optional[Sequence[Optional[PatternMask]]] = None,
                      layer_range: Optional[Tuple[int, int]] = None,
                      ) -> torch.Tensor:
    """Run the stack (or layers ``lo..hi-1`` of it) functionally.

    ``layer_range=(lo, hi)`` runs only those layers against the full or a
    matching pre-sliced ``params``; ``x`` is then layer ``lo``'s input.
    Builds the layers on every call; serving holds a ``VikinStack``.
    Differentiable with respect to the param tensors (and ``x``): the
    weight fusion and compaction are torch ops, and at f32 the KAN and
    matmul kernels carry their gradients (``kernels/grad.py``).
    """
    moved = [{k: v.to(x.device) for k, v in p.items()} for p in params]
    return VikinStack(model, moved, masks, layer_range)(x)
