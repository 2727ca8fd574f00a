"""Model backends for the continuous-batching engine (runtime/server.py).

Counterpart of ``repro/runtime/backends.py`` without the transformer
backend.  The engine owns slots, the queue and the tick loop; everything
model-shaped lives behind the ``ModelBackend`` protocol:

  * ``init_state``  -- allocate per-slot state (input staging buffers).
  * ``prefill``     -- stage one admitted request into its slot.
  * ``step``        -- one batched engine iteration over the active slots;
                       sets outputs on the Request objects and marks
                       finished ones ``done``.
  * ``batch_report``-- simulated-hardware accounting for the step just
                       executed (VIKIN cycle model).

``VikinBackend`` serves a stacked KAN/MLP feed-forward workload
(configs/vikin_models.PaperModelConfig) on a torch device: a request is
one feature vector, and the batched step pads the active slots into a
power-of-two bucket (>= ``min_bucket`` = 2, as the reference) and runs
the whole stack (models/ffn.VikinStack, or core/quant.QuantVikinStack at
int8) through the fused KAN and pattern-matmul kernels.  Every served
batch is charged its mode-switch schedule in the simulated-cycle report.

``MultiWorkloadBackend`` dispatches the same protocol across several
named VIKIN workloads (``--arch a,b,c``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.calibrate import masked_pattern_rates
from repro_torch.core.engine import VikinHW, serving_report
from repro_torch.core.modes import ExecMode, ModePlan
from repro_torch.core.quant import (
    QuantVikinStack,
    StackScales,
    quantize_stack_params,
)
from repro_torch.core.sparsity import PatternMask
from repro_torch.models.ffn import VikinStack
from repro_torch.utils import next_pow2, resolve_device


@dataclasses.dataclass
class Request:
    """One serving request.

    ``prompt`` is the request payload (a float feature vector for VIKIN
    backends); one-shot backends set ``output``.  Scheduling fields
    (runtime/scheduler.py): ``priority`` (higher is more urgent),
    ``deadline_s`` (engine-clock budget from submission) and ``workload``
    (which of a MultiWorkloadBackend's models serves it).  ``shed`` /
    ``expired`` mark requests the engine refused; ``miss_counted`` guards
    the deadline-miss counter.  The ``t_*``/``sim_*`` stamps feed the
    engine's latency percentiles in both clocks.
    """

    rid: int
    prompt: np.ndarray
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    output: Optional[np.ndarray] = None
    done: bool = False
    priority: int = 0
    deadline_s: Optional[float] = None
    workload: Optional[str] = None
    met_deadline: Optional[bool] = None
    shed: bool = False
    expired: bool = False
    miss_counted: bool = False
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_done: float = 0.0
    sim_submit: float = 0.0
    sim_admit: float = 0.0
    sim_done: float = 0.0

    def result(self) -> Any:
        return self.generated if self.output is None else self.output


class ModelBackend:
    """Protocol (documented base): the engine calls exactly these."""

    # Interconnect modes this backend's chips are PINNED to, or None when
    # the hardware reconfigures with the stream.
    pinned_modes: Optional[FrozenSet[ExecMode]] = None

    def init_state(self, n_slots: int, max_len: int) -> Any:
        raise NotImplementedError

    def validate(self, req: Request) -> None:
        """Reject malformed payloads at submit time."""

    def prefill(self, state: Any, slot: int, req: Request) -> Any:
        """Stage ``req`` into lane ``slot``; returns the new state."""
        raise NotImplementedError

    def step(self, state: Any,
             slot_req: Sequence[Optional[Request]]) -> Any:
        """One batched iteration over active slots; returns the new state."""
        raise NotImplementedError

    def batch_report(self, n_active: int,
                     prev_mode: Optional[ExecMode] = None,
                     ) -> Optional[Dict[str, float]]:
        """Simulated-hardware stats for the step just run, or None.

        ``prev_mode`` is the interconnect mode the previous served batch
        left the engine in (None = cold start); the closing mode comes
        back under ``"exit_mode"``.
        """
        return None


class VikinBackend(ModelBackend):
    """Serve a PaperModelConfig KAN/MLP stack through the fused kernels.

    ``params`` is one dict of tensors (or numpy arrays) per layer in the
    JAX package's layout.  The stack is built once on ``device`` (default
    ``"cuda"``, refused when CUDA is missing); ``device="cpu"`` runs the
    plain PyTorch versions.  ``masks`` (one Optional[PatternMask] per
    layer, e.g. a calibrated checkpoint's) override the config's tiled
    masks, and the cycle model is then charged their measured rates.

    ``precision`` selects the served numerics: "f32" (default) or "int8"
    (post-training quantized, core/quant), which needs the calibrated
    ``scales`` (core/calibrate.calibrate_scales or a checkpoint's
    restore_scales); params are quantized once, here, and the cycle model
    charges int8 DMA bytes.  Requests submit f32 payloads either way.
    """

    min_bucket = 2

    def __init__(self, model: Any, params: Sequence[Dict[str, Any]], *,
                 device: str | torch.device = "cuda",
                 masks: Optional[Sequence[Optional[PatternMask]]] = None,
                 precision: str = "f32",
                 scales: Optional[StackScales] = None) -> None:
        if precision == "bf16":
            raise ValueError(
                "precision='bf16' is not ported yet (ROADMAP item 7): the "
                "port's kernels are f32 and int8 only")
        if precision not in ("f32", "int8"):
            raise ValueError(
                f"unknown precision {precision!r}; expected f32|int8")
        if precision == "int8" and scales is None:
            raise ValueError(
                "precision='int8' requires calibrated scales "
                "(core/calibrate.calibrate_scales or "
                "checkpoint.restore_scales)")
        self.device = resolve_device(device)
        self.model, self.hw = model, VikinHW()
        self.precision, self.scales = precision, scales
        self.masks = list(masks) if masks is not None else None
        self.plan = ModePlan.for_layers(model.layer_kind_enums())
        if self.masks is not None:
            # calibrated model: charge the cycle model the MEASURED
            # per-layer mask sparsity, not the config-level rate
            self.layers = model.layer_works(
                pattern_rates=masked_pattern_rates(self.masks))
        else:
            self.layers = model.layer_works()
        self.n_in = int(model.sizes[0])
        tensors = [{k: torch.as_tensor(v, dtype=torch.float32,
                                       device=self.device)
                    for k, v in p.items()} for p in params]
        self.stack: torch.nn.Module
        if precision == "int8":
            assert scales is not None            # checked above
            self.stack = QuantVikinStack(
                model, quantize_stack_params(tensors, model, scales), scales,
                self.masks)
        else:
            self.stack = VikinStack(model, tensors, self.masks)
        self.stack.eval()
        self._report_cache: Dict[Tuple[int, Optional[ExecMode]],
                                 Dict[str, float]] = {}
        self.n_slots: Optional[int] = None

    def init_state(self, n_slots: int, max_len: int) -> np.ndarray:
        self.n_slots = n_slots
        # staging buffer of request inputs, one lane per slot
        return np.zeros((n_slots, self.n_in), np.float32)

    def validate(self, req: Request) -> None:
        vec = np.asarray(req.prompt, np.float32).reshape(-1)
        if vec.shape[0] != self.n_in:
            raise ValueError(
                f"request {req.rid}: payload has {vec.shape[0]} features, "
                f"model {self.model.name!r} expects {self.n_in}")

    def prefill(self, inputs: np.ndarray, slot: int,
                req: Request) -> np.ndarray:
        inputs = inputs.copy()
        inputs[slot] = np.asarray(req.prompt, np.float32).reshape(-1)
        return inputs

    def bucket(self, n_active: int) -> int:
        """Always a power of two (>= min_bucket), even for non-pow2 slot
        counts."""
        return next_pow2(max(n_active, self.min_bucket))

    def forward(self, xb: np.ndarray) -> np.ndarray:
        """The batched stack forward on one (bucket, n_in) host batch."""
        with torch.inference_mode():
            y = self.stack(torch.from_numpy(xb).to(self.device))
            return y.cpu().numpy()

    def step(self, inputs: np.ndarray,
             slot_req: Sequence[Optional[Request]]) -> np.ndarray:
        active = [s for s, r in enumerate(slot_req) if r is not None]
        bucket = self.bucket(len(active))
        xb = np.zeros((bucket, self.n_in), np.float32)
        for j, s in enumerate(active):
            xb[j] = inputs[s]
        y = self.forward(xb)
        for j, s in enumerate(active):
            slot_req[s].output = y[j].copy()
            slot_req[s].done = True
        return inputs

    def batch_report(self, n_active: int,
                     prev_mode: Optional[ExecMode] = None,
                     ) -> Dict[str, float]:
        """VIKIN cycle model for one served batch (single engine instance:
        compute cycles scale linearly in n_active, every instance pays its
        mode plan, and entering from a disagreeing ``prev_mode`` costs one
        extra flip)."""
        key = (n_active, prev_mode)
        if key not in self._report_cache:
            self._report_cache[key] = serving_report(
                self.layers, self.hw, batch=n_active,
                prev_mode=prev_mode, precision=self.precision)
        return dict(self._report_cache[key])


class MultiWorkloadBackend(ModelBackend):
    """Serve several named workloads (``--arch a,b,c``) from one engine.

    Per-workload state lanes side by side; ``step`` runs one batched
    forward per workload present among the active slots (the batch policy
    keeps each tick single-workload).  ``batch_report`` threads the
    carried interconnect mode through the sub-backends in the order they
    ran and accumulates a per-workload view in ``workload_stats``.
    """

    def __init__(self, backends: Dict[str, ModelBackend]) -> None:
        if not backends:
            raise ValueError("MultiWorkloadBackend needs >= 1 workload")
        self.backends = dict(backends)
        self.plans: Dict[str, ModePlan] = {
            n: b.plan for n, b in self.backends.items()
            if hasattr(b, "plan")}
        self.workload_stats: Dict[str, Dict[str, float]] = {
            n: {} for n in self.backends}
        # (workload, n_active, n_done) per sub-backend stepped this tick
        self._last_served: List[Tuple[str, int, int]] = []

    def bucket_for(self, workload: str, n_active: int) -> int:
        """Padding bucket the named workload would run ``n_active``
        requests in (the scheduler's zero-padding-waste signal)."""
        b = self.backends[workload]
        return b.bucket(n_active) if hasattr(b, "bucket") else n_active

    @property
    def pinned_modes(self) -> Optional[FrozenSet[ExecMode]]:
        """Union of the sub-backends' pins, only when every mode-planned
        sub-backend is pinned."""
        pins: set = set()
        for name, b in self.backends.items():
            p = getattr(b, "pinned_modes", None)
            if p is None:
                if name in self.plans:
                    return None
                continue
            pins |= set(p)
        return frozenset(pins) if pins else None

    def init_state(self, n_slots: int, max_len: int) -> Dict[str, Any]:
        return {n: b.init_state(n_slots, max_len)
                for n, b in self.backends.items()}

    def validate(self, req: Request) -> None:
        if req.workload not in self.backends:
            raise ValueError(
                f"request {req.rid}: unknown workload {req.workload!r}; "
                f"this engine serves {sorted(self.backends)}")
        self.backends[req.workload].validate(req)

    def prefill(self, state: Dict[str, Any], slot: int,
                req: Request) -> Dict[str, Any]:
        state = dict(state)
        state[req.workload] = self.backends[req.workload].prefill(
            state[req.workload], slot, req)
        return state

    def step(self, state: Dict[str, Any],
             slot_req: Sequence[Optional[Request]]) -> Dict[str, Any]:
        state = dict(state)
        order: List[str] = []
        for r in slot_req:
            if r is not None and r.workload not in order:
                order.append(r.workload)
        self._last_served = []
        for name in order:
            view = [r if (r is not None and r.workload == name) else None
                    for r in slot_req]
            state[name] = self.backends[name].step(state[name], view)
            active = [r for r in view if r is not None]
            self._last_served.append(
                (name, len(active), sum(1 for r in active if r.done)))
        return state

    def batch_report(self, n_active: int,
                     prev_mode: Optional[ExecMode] = None,
                     ) -> Optional[Dict[str, float]]:
        total: Dict[str, Any] = {}
        mode = prev_mode
        for name, k, n_done in self._last_served:
            rep = self.backends[name].batch_report(k, prev_mode=mode)
            ws = self.workload_stats[name]
            ws["served"] = ws.get("served", 0.0) + n_done
            ws["batches"] = ws.get("batches", 0.0) + 1
            if rep is None:
                continue
            rep = dict(rep)
            mode = rep.pop("exit_mode", mode)
            for key, v in rep.items():
                total[key] = total.get(key, 0.0) + v
                ws[key] = ws.get(key, 0.0) + v
        if mode is not None:
            total["exit_mode"] = mode
        return total if total else None
