"""Post-training symmetric int8 quantization for VIKIN stacks.

Counterpart of ``repro/core/quant.py``.  The contract is the reference's:

* **Scales** are symmetric maxima over the calibration data,
  ``scale = max|x| / 127``, zero-point free: MLP weights per OUTPUT
  channel, KAN spline tables per BASIS index (so the fused ``[w_b ; t]``
  rows of one feature carry an (nbk+1)-vector of slot scales, the silu
  row's first), activations per LAYER (one static scalar).
* **Quantize**: ``clip(round(x / scale), -127, 127) -> int8``, rounding
  half to even (``torch.round`` as ``jnp.round``), never -128.
* **Compute**: int8 operands are dequantized on load and accumulated in
  f32.  The int8 matmul accumulates exact integers and the shared
  ``scale_bias_act`` epilogue applies ``s_x * s_w`` once, afterwards.
* **Requantize**: each non-final layer's f32 output is quantized to the
  NEXT layer's input scale; the final layer emits f32.

One difference of arithmetic, not of contract: the reference's served
forward runs under ``jax.jit``, where every activation scale is a
trace-time constant and XLA rewrites ``x / scale`` into ``x * (1 /
scale)`` with the reciprocal rounded to f32.  The codes it serves are
therefore those of ``quantize_static``, which differ from ``round(x /
scale)`` next to half-integers.  The port's forward quantizes its
activations with ``quantize_static`` to serve the reference's codes;
weights are quantized once, outside any jit, by division in both.

``QuantVikinStack`` is the serving module: it builds the int8 fused KAN
weights, the slot scales and slot tables, the compacted int8 MLP weights
and the per-column scales once, on the device, and its forward runs the
int8 kernels (``kernels/kan_fused`` and ``kernels/pattern_matmul``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.core.kan import KANConfig
from repro_torch.core.sparsity import PatternMask
from repro_torch.kernels.epilogue import scale_bias_act
from repro_torch.kernels.kan_fused.ops import (
    flatten_t,
    fuse_wt,
    kan_fused_v2_q8,
    slot_table,
)
from repro_torch.kernels.pattern_matmul.ops import matmul_q8
from repro_torch.models.ffn import stack_layer_cfgs
from repro_torch.utils import host_f32

Q_MAX = 127.0            # symmetric int8 range: [-127, 127] (no -128)
_EPS = 1e-8              # all-zero slices get a harmless positive scale

Scale = Union[float, np.ndarray, torch.Tensor]


def _f32(scale: Scale, device: torch.device) -> torch.Tensor:
    """A scale as an f32 tensor on ``device`` (rounded to f32 first, as
    ``jnp.asarray(scale, jnp.float32)`` does)."""
    if torch.is_tensor(scale):
        return scale.to(device, torch.float32)
    return torch.as_tensor(np.asarray(scale, np.float32), device=device)


# ---------------------------------------------------------------------------
# The shared quantize/dequantize helpers.
# ---------------------------------------------------------------------------


def quantize(x: torch.Tensor, scale: Scale) -> torch.Tensor:
    """f32 -> int8 under a symmetric scale (scalar or broadcastable):
    ``clip(round(x / scale), -127, 127)``."""
    q = torch.round(x.to(torch.float32) / _f32(scale, x.device))
    return torch.clamp(q, -Q_MAX, Q_MAX).to(torch.int8)


def static_reciprocal(scale: float) -> float:
    """``1 / scale`` rounded to f32, as XLA folds it for a constant
    divisor."""
    return float(np.float32(1.0) / np.float32(scale))


def quantize_static(x: torch.Tensor, scale: float) -> torch.Tensor:
    """f32 -> int8 under a static scalar scale, as the reference's jitted
    forward computes it: ``clip(round(x * f32(1 / scale)), -127, 127)``.
    The reciprocal is an f32 value passed as a scalar (no host-to-device
    copy, so a CUDA graph can capture it); the multiply rounds once."""
    q = torch.round(x.to(torch.float32) * static_reciprocal(scale))
    return torch.clamp(q, -Q_MAX, Q_MAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale: Scale) -> torch.Tensor:
    """int8 -> f32 under the same symmetric scale."""
    return q.to(torch.float32) * _f32(scale, q.device)


def symmetric_scale(x: Any,
                    axis: Union[None, int, Tuple[int, ...]] = None
                    ) -> np.ndarray:
    """Calibration-time scale: ``max|x| / 127`` over ``axis`` (host-side)."""
    m = np.max(np.abs(host_f32(x)), axis=axis)
    return np.maximum(m, _EPS) / Q_MAX


# ---------------------------------------------------------------------------
# Per-layer / per-stack scale containers (checkpoint/checkpoint.py carries
# these next to the masks; core/calibrate derives them).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerScales:
    """One layer's symmetric scales.

    ``x`` is the layer's INPUT activation scale.  MLP layers carry ``w``
    (per output channel, shape (n_out,)); KAN layers carry ``w_b``
    (scalar, the silu branch) and ``t`` (per basis, shape (n_bases,)).
    """

    kind: str                              # "kan" | "mlp"
    x: float
    w: Optional[np.ndarray] = None         # mlp: (n_out,)
    w_b: Optional[float] = None            # kan: scalar
    t: Optional[np.ndarray] = None         # kan: (n_bases,)

    def __post_init__(self) -> None:
        if self.kind == "mlp":
            if self.w is None or self.w_b is not None or self.t is not None:
                raise ValueError("mlp LayerScales needs w and only w")
        elif self.kind == "kan":
            if self.w_b is None or self.t is None or self.w is not None:
                raise ValueError("kan LayerScales needs w_b and t")
        else:
            raise ValueError(f"unknown layer kind {self.kind!r}")

    def slot_scales(self, kb: Sequence[int]) -> np.ndarray:
        """(nbk+1,) scale vector of one fused-[w_b ; t] feature slot: the
        silu row's scale followed by the kept bases' scales, matching
        ``kernels.kan_fused.ops.fuse_wt``'s row interleave."""
        if self.kind != "kan":
            raise ValueError("slot_scales is KAN-only")
        return np.concatenate(
            [[np.float32(self.w_b)],
             np.asarray(self.t, np.float32)[list(kb)]]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class StackScales:
    """Calibrated per-layer scales for one KAN/MLP stack (one LayerScales
    per layer, in the order of the stack's masks)."""

    scales: Tuple[LayerScales, ...]

    def __len__(self) -> int:
        return len(self.scales)

    def __getitem__(self, i: int) -> LayerScales:
        return self.scales[i]

    def summary(self) -> dict:
        return {
            "n_layers": len(self.scales),
            "kinds": [s.kind for s in self.scales],
            "x": [round(float(s.x), 6) for s in self.scales],
        }


def derive_layer_scales(kind: str, p: Dict[str, Any],
                        act: np.ndarray) -> LayerScales:
    """One layer's scales from its params + calibration input activations."""
    x = float(symmetric_scale(act))
    if kind == "mlp":
        return LayerScales(kind="mlp", x=x,
                           w=symmetric_scale(p["w"], axis=0))
    return LayerScales(kind="kan", x=x, w_b=float(symmetric_scale(p["w_b"])),
                       t=symmetric_scale(p["t"], axis=(0, 2)))


# ---------------------------------------------------------------------------
# Weight quantization (build time, once per served model).
# ---------------------------------------------------------------------------


def quantize_stack_params(params: Sequence[Dict[str, torch.Tensor]],
                          model: Any, scales: StackScales
                          ) -> List[Dict[str, torch.Tensor]]:
    """f32 stack params -> int8 params (+ f32 bias) under ``scales``, on
    the params' device.

    KAN layers keep the FULL (n_in, n_bases, n_out) table quantized per
    basis; stage-2 compaction happens when the stack is built, from the
    static mask, so one quantized checkpoint serves every mask.
    """
    cfgs = stack_layer_cfgs(model)
    if len(scales) != len(cfgs):
        raise ValueError(
            f"scales cover {len(scales)} layers, model has {len(cfgs)}")
    out = []
    for p, (kind, _), ls in zip(params, cfgs, scales.scales):
        if ls.kind != kind:
            raise ValueError(f"scales kind {ls.kind!r} != layer {kind!r}")
        if kind == "mlp":
            w = torch.as_tensor(p["w"], dtype=torch.float32)
            out.append({
                "w_q": quantize(w, np.asarray(ls.w, np.float32)[None, :]),
                "b": torch.as_tensor(p["b"], dtype=torch.float32,
                                     device=w.device),
            })
        else:
            t = torch.as_tensor(p["t"], dtype=torch.float32)
            out.append({
                "w_b_q": quantize(torch.as_tensor(p["w_b"]), ls.w_b),
                "t_q": quantize(t, np.asarray(ls.t, np.float32)[None, :,
                                                                None]),
            })
    return out


# ---------------------------------------------------------------------------
# The int8 stack (mirror of models/ffn.VikinStack).
# ---------------------------------------------------------------------------


class QuantKANLayer(nn.Module):
    """One int8 KAN layer holding its int8 fused ``[w_b ; t[kb]]`` weights,
    slot scales and slot table; int8 codes in, f32 out."""

    def __init__(self, cfg: KANConfig, qp: Dict[str, torch.Tensor],
                 ls: LayerScales) -> None:
        super().__init__()
        self.cfg = cfg
        self.kb = (tuple(range(cfg.spec.n_bases)) if cfg.kb is None
                   else cfg.kb)
        w_b_q, t_q = qp["w_b_q"], qp["t_q"]
        if tuple(w_b_q.shape) != (cfg.n_in, cfg.n_out) or tuple(
                t_q.shape) != (cfg.n_in, cfg.spec.n_bases, cfg.n_out):
            raise ValueError(
                f"QuantKANLayer {cfg.n_in}->{cfg.n_out}: got w_b_q "
                f"{tuple(w_b_q.shape)} and t_q {tuple(t_q.shape)}")
        dev = w_b_q.device
        self.x_scale = float(ls.x)
        self.register_buffer(
            "wt_q", fuse_wt(w_b_q, flatten_t(t_q, cfg.kb), len(self.kb)),
            persistent=False)
        self.register_buffer(
            "slot_scales", torch.as_tensor(ls.slot_scales(self.kb),
                                           device=dev), persistent=False)
        self.register_buffer("slot_of", slot_table(
            self.kb, cfg.spec.n_bases, dev), persistent=False)

    def forward(self, x_q: torch.Tensor) -> torch.Tensor:
        lead = x_q.shape[:-1]
        y = kan_fused_v2_q8(x_q.reshape(-1, self.cfg.n_in).contiguous(),
                            self.wt_q, self.slot_scales, self.cfg.spec,
                            self.kb, self.x_scale, self.slot_of,
                            blocks=self.cfg.blocks)
        return y.reshape(*lead, self.cfg.n_out)


class QuantPatternLinear(nn.Module):
    """One int8 MLP layer: ``act(acc * (s_x * s_w) + b)`` on the exact
    integer accumulator of the kept int8 lanes; int8 codes in, f32 out."""

    def __init__(self, cfg: Dict[str, Any], qp: Dict[str, torch.Tensor],
                 ls: LayerScales) -> None:
        super().__init__()
        self.n_in, self.n_out = cfg["n_in"], cfg["n_out"]
        self.act = cfg["act"]
        self.mask: Optional[PatternMask] = cfg["mask"]
        w_q, b = qp["w_q"], qp["b"]
        if tuple(w_q.shape) != (self.n_in, self.n_out) or tuple(
                b.shape) != (self.n_out,):
            raise ValueError(
                f"QuantPatternLinear {self.n_in}->{self.n_out}: got w_q "
                f"{tuple(w_q.shape)} and b {tuple(b.shape)}")
        idx = None
        if self.mask is not None:
            idx = torch.as_tensor(self.mask.indices(), dtype=torch.long,
                                  device=w_q.device)
            w_q = w_q.index_select(0, idx)
        self.register_buffer("idx", idx, persistent=False)
        self.register_buffer("w_q_c", w_q.contiguous(), persistent=False)
        self.register_buffer("b", b.to(torch.float32), persistent=False)
        self.register_buffer(
            "col_scale", float(ls.x) * torch.as_tensor(
                np.asarray(ls.w, np.float32), device=w_q.device),
            persistent=False)

    def forward(self, x_q: torch.Tensor) -> torch.Tensor:
        lead = x_q.shape[:-1]
        xf = x_q.reshape(-1, self.n_in)
        if self.idx is not None:
            xf = xf.index_select(1, self.idx)
        acc = matmul_q8(xf.contiguous(), self.w_q_c)
        y = scale_bias_act(acc, self.col_scale, self.b, self.act)
        return y.reshape(*lead, self.n_out)


class QuantVikinStack(nn.Module):
    """A whole int8 KAN/MLP stack, its weights fused and compacted once.

    ``qparams`` are ``quantize_stack_params``'s output on the serving
    device.  The forward takes f32 inputs, quantizes them to layer 0's
    scale, requantizes each hidden output to the next layer's scale and
    returns the last layer's f32 output.
    """

    def __init__(self, model: Any, qparams: Sequence[Dict[str, torch.Tensor]],
                 scales: StackScales,
                 masks: Optional[Sequence[Optional[PatternMask]]] = None
                 ) -> None:
        super().__init__()
        cfgs = stack_layer_cfgs(model, masks)
        if not len(qparams) == len(scales) == len(cfgs):
            raise ValueError(
                f"{len(qparams)} param dicts and {len(scales)} layer scales "
                f"for a {len(cfgs)}-layer stack")
        for (kind, _), ls in zip(cfgs, scales.scales):
            if ls.kind != kind:
                raise ValueError(f"scales kind {ls.kind!r} != layer {kind!r}")
        self.model = model
        self.kinds = [kind for kind, _ in cfgs]
        self.x_scales = [float(ls.x) for ls in scales.scales]
        self.layers = nn.ModuleList(
            QuantKANLayer(cfg, qp, ls) if kind == "kan"
            else QuantPatternLinear(cfg, qp, ls)
            for qp, (kind, cfg), ls in zip(qparams, cfgs, scales.scales))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = quantize_static(x, self.x_scales[0])
        y = x
        for i, layer in enumerate(self.layers):
            y = layer(h)
            if i + 1 < len(self.layers):
                h = quantize_static(y, self.x_scales[i + 1])
        return y


def quant_stack_apply(qparams: Sequence[Dict[str, torch.Tensor]],
                      x: torch.Tensor, model: Any, scales: StackScales, *,
                      masks: Optional[Sequence[Optional[PatternMask]]] = None
                      ) -> torch.Tensor:
    """Run the int8-quantized stack functionally; returns f32 outputs.

    Builds the layers on every call; serving holds a ``QuantVikinStack``.
    """
    moved = [{k: v.to(x.device) for k, v in p.items()} for p in qparams]
    return QuantVikinStack(model, moved, scales, masks)(x)


def quant_error_bound(ls: LayerScales,
                      kb: Optional[Sequence[int]] = None) -> float:
    """Loose per-output worst-case dequantization step of one layer's
    weights: half a quantization step per weight element on the
    widest-scale slot."""
    if ls.kind == "mlp":
        return float(0.5 * np.max(ls.w))
    ss = ls.slot_scales(
        kb if kb is not None else range(len(np.asarray(ls.t))))
    return float(0.5 * np.max(ss))
