"""Post-training calibration: two-stage sparsity masks and int8 scales.

Counterpart of the stack half of ``repro/core/calibrate.py``:

  * **KAN layers** (stage 2 on the basis dimension): the mean |B_i(x)|
    energy of every basis over the layer's calibration inputs, weighted
    by the L1 mass of the spline coefficients that consume it -- a
    Wanda-style ``|activation| x |weight|`` saliency per basis index;
    ``magnitude_mask`` keeps the top m-of-4 bases per group.
  * **MLP layers** (stage 2 on the hidden input dimension): RMS
    activation of each input node times the fan-out L1 of its weight row.
    Layer 0 is never masked -- raw request features always enter dense.
  * **Scales** (``calibrate_scales``): from the same calibration batch,
    the symmetric int8 scales of core/quant.

The dense forward and the basis values run on the params' device: on
the card the forward launches the kernels (``VikinStack`` under
``inference_mode``, as serving runs it), on the CPU their plain versions
run, as the reference calibrates with its trainer's ``impl``.  The
saliencies and scales are then reduced with host numpy, as the
reference's are, so on the CPU a fixed seed gives the reference's masks
and scales bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quant import StackScales, derive_layer_scales
from repro_torch.core.sparsity import (
    GROUP,
    PatternMask,
    magnitude_mask,
    weight_saliency,
)
from repro_torch.core.splines import SplineSpec, bases_dense
from repro_torch.models.ffn import VikinStack, stack_layer_cfgs
from repro_torch.utils import host_f32


@dataclasses.dataclass(frozen=True)
class StackSparsity:
    """Calibrated per-layer masks for one KAN/MLP stack.

    ``masks[i]`` applies to layer i: over the basis dimension for KAN
    layers, over the input (hidden) dimension for MLP layers; None = dense.
    """

    masks: Tuple[Optional[PatternMask], ...]

    def summary(self) -> dict:
        return {
            "n_layers": len(self.masks),
            "keep_rates": [None if m is None else round(1.0 - m.sparsity, 4)
                           for m in self.masks],
            "n_keep": [None if m is None else m.n_keep for m in self.masks],
        }


def keep_per_group_for_rate(rate: float) -> int:
    """Map a pattern-sparsity rate (0/0.25/0.5/0.75) to m-of-4 keeps."""
    m = round((1.0 - rate) * GROUP)
    if not 1 <= m <= GROUP or abs((1.0 - m / GROUP) - rate) > 1e-9:
        raise ValueError(
            f"pattern rate must be one of 0, 0.25, 0.5, 0.75; got {rate}")
    return m


def params_device(params: Sequence[Dict[str, Any]]) -> torch.device:
    """The device of the stack's first tensor leaf (host arrays: CPU)."""
    for p in params:
        for v in p.values():
            if torch.is_tensor(v):
                return v.device
    return torch.device("cpu")


def _f32_on(a: Any, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().to(device, torch.float32)
    return torch.from_numpy(host_f32(a).copy()).to(device)


def stack_activations(params: Sequence[Dict[str, Any]], model: Any,
                      x: np.ndarray) -> List[np.ndarray]:
    """Per-layer *input* activations of a dense forward over ``x``.

    Returns [h_0 .. h_{L-1}] where h_i feeds layer i (h_0 = x), each
    copied to the host.  The stack runs dense (pattern_rate forced to 0),
    because calibration must see the unmasked distribution, on the params'
    device: the kernels on the card, their plain versions on the CPU.
    """
    dense_model = dataclasses.replace(model, pattern_rate=0.0)
    dev = params_device(params)
    stack = VikinStack(dense_model, [{k: _f32_on(v, dev)
                                      for k, v in p.items()} for p in params])
    h = _f32_on(x, dev)
    acts = []
    with torch.inference_mode():
        for layer in stack.layers:
            acts.append(host_f32(h))
            h = layer(h)
    return acts


def kan_basis_saliency(p: Dict[str, Any], spec: SplineSpec,
                       x: np.ndarray) -> np.ndarray:
    """Wanda-style per-basis saliency: mean |B_i(x)| x L1(t[:, i, :]).

    The basis values are taken on the device of ``p["t"]`` through the
    dense basis (the reference's saliency calls no kernel either)."""
    xd = _f32_on(x, params_device([p]))
    b = host_f32(bases_dense(spec.clip(xd), spec))
    act_energy = np.abs(b).mean(axis=(0, 1))                # (n_bases,)
    coeff_mass = np.abs(host_f32(p["t"])).sum(axis=(0, 2))  # (n_bases,)
    return act_energy * coeff_mass


def mlp_input_saliency(p: Dict[str, Any], x: np.ndarray) -> np.ndarray:
    """Wanda saliency per input node: RMS activation x fan-out L1."""
    xf = host_f32(x)
    act_rms = np.sqrt(np.mean(xf * xf, axis=0))             # (n_in,)
    return act_rms * weight_saliency(host_f32(p["w"]))      # (n_in,)


def stack_saliencies(params: Sequence[Dict[str, Any]], model: Any,
                     calib_x: np.ndarray) -> List[Optional[np.ndarray]]:
    """Each layer's stage-2 saliency over ``calib_x`` (per basis for a KAN
    layer, per input node for an MLP layer; None for an MLP layer 0)."""
    dense_model = dataclasses.replace(model, pattern_rate=0.0)
    acts = stack_activations(params, dense_model, calib_x)
    sal: List[Optional[np.ndarray]] = []
    for i, (p, (kind, cfg)) in enumerate(
            zip(params, stack_layer_cfgs(dense_model))):
        if kind == "kan":
            sal.append(kan_basis_saliency(p, cfg.spec, acts[i]))
        elif i == 0:
            sal.append(None)        # raw features are never masked
        else:
            sal.append(mlp_input_saliency(p, acts[i]))
    return sal


def calibrate_stack(params: Sequence[Dict[str, Any]], model: Any,
                    calib_x: np.ndarray, *,
                    keep_per_group: int = 2) -> StackSparsity:
    """Derive the stack's two-stage masks from a trained model.

    ``keep_per_group`` is the m of m-of-4 (2 = the paper's 50% deployment
    rate, Table II); ``calib_x`` is a representative input batch.
    """
    if not 1 <= keep_per_group <= GROUP:
        raise ValueError(f"keep_per_group must be in [1, {GROUP}]")
    sal = stack_saliencies(params, model, calib_x)
    return StackSparsity(tuple(
        None if s is None or keep_per_group == GROUP
        else magnitude_mask(s, keep_per_group) for s in sal))


def masked_pattern_rates(masks: Sequence[Optional[PatternMask]]
                         ) -> List[float]:
    """Per-layer measured sparsity rates (cycle-model inputs)."""
    return [0.0 if m is None else float(m.sparsity) for m in masks]


def calibrate_scales(params: Sequence[Dict[str, Any]], model: Any,
                     calib_x: np.ndarray) -> StackScales:
    """Derive per-layer symmetric int8 scales from the calibration batch.

    Companion to ``calibrate_stack``: per output channel for MLP ``w``,
    per basis for KAN ``t`` plus a scalar for ``w_b``, and one static
    input-activation scalar per layer from the dense forward's
    activations.
    """
    dense_model = dataclasses.replace(model, pattern_rate=0.0)
    acts = stack_activations(params, dense_model, calib_x)
    return StackScales(tuple(
        derive_layer_scales(kind, p, acts[i])
        for i, (p, (kind, _)) in enumerate(
            zip(params, stack_layer_cfgs(dense_model)))))
