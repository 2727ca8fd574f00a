"""Model backends for the continuous-batching engine (runtime/server.py).

Counterpart of ``repro/runtime/backends.py``.  The engine owns slots,
the queue and the tick loop; everything model-shaped lives behind the
``ModelBackend`` protocol:

  * ``init_state``  -- allocate per-slot state (KV-cache lanes, input
                       staging buffers).
  * ``prefill``     -- stage one admitted request into its slot.
  * ``step``        -- one batched engine iteration over the active slots;
                       sets outputs on the Request objects and marks
                       finished ones ``done``.
  * ``batch_report``-- simulated-hardware accounting for the step just
                       executed (VIKIN cycle model), or None when the
                       backend has no hardware model.

``TransformerBackend`` serves a decoder-only ``ArchConfig`` model
(attention, MoE, RG-LRU and xLSTM blocks): greedy autoregressive decode
over slot caches (KV caches and recurrent states), one token per active
slot a step.  For KAN-FFN hybrids every ``"kan"`` layer's FFN runs the
fused KAN kernel (up) and the pattern-matmul kernel (down), and the
VIKIN cycle model charges each served tick; a MoE of KAN experts runs
every expert's two layers through the fused KAN kernel.

``VikinBackend`` serves a stacked KAN/MLP feed-forward workload
(configs/vikin_models.PaperModelConfig) on a torch device: a request is
one feature vector, and the batched step pads the active slots into a
power-of-two bucket (>= ``min_bucket``, 2 by default as in the
reference) and runs the whole stack (models/ffn.VikinStack at f32 and
bf16, or core/quant.QuantVikinStack at int8) through the fused KAN and
pattern-matmul kernels.  Every served batch is charged its mode-switch
schedule in the simulated-cycle report.

``MultiWorkloadBackend`` dispatches the same protocol across several
named VIKIN workloads (``--arch a,b,c``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.calibrate import masked_pattern_rates
from repro_torch.core.engine import (
    LayerWork,
    VikinArray,
    VikinHW,
    run_model,
    serving_report,
)
from repro_torch.core.modes import (
    RECONFIG_CYCLES,
    ExecMode,
    LayerKind,
    ModePlan,
)
from repro_torch.core.quant import (
    QuantVikinStack,
    StackScales,
    quantize_stack_params,
)
from repro_torch.core.sparsity import PatternMask
from repro_torch.models import transformer as T
from repro_torch.models.ffn import VikinStack
from repro_torch.utils import next_pow2, resolve_device, tree_map


@dataclasses.dataclass
class Request:
    """One serving request.

    ``prompt`` is the request payload: int32 token ids for the
    transformer backend, a float feature vector for VIKIN backends.
    Token backends append into ``generated``; one-shot backends set
    ``output``.  Scheduling fields
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


# ---------------------------------------------------------------------------
# Transformer (autoregressive) backend.
# ---------------------------------------------------------------------------


def transformer_layer_works(cfg: Any) -> List[LayerWork]:
    """Per-phase VIKIN LayerWorks for a kan-ffn transformer arch.

    Every block's attention projections are one parallel-mode (MLP) work
    item, a "kan" FFN is a pipeline-mode KAN up-projection (stage-1 basis
    sparsity) followed by a parallel-mode down matmul (stage-2 hidden
    sparsity), and an "mlp" FFN is its two parallel-mode matmuls -- so
    KAN-FFN phases charge pipeline-mode cycles and everything else stays
    parallel.
    """
    works: List[LayerWork] = []
    hd = cfg.hd
    attn_out = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.d_model
    for i in range(cfg.n_layers):
        block = cfg.pattern[i % len(cfg.pattern)]
        if block == "attn":
            works.append(LayerWork(LayerKind.MLP, cfg.d_model, attn_out))
        else:
            # recurrent/xlstm blocks: their gate/proj matmuls are
            # parallel-mode work of roughly d_model x d_model
            works.append(LayerWork(LayerKind.MLP, cfg.d_model, cfg.d_model))
        fk = cfg.layer_ffn_kind(i)
        if fk == "kan":
            fcfg = cfg.ffn_cfg(i)
            up = fcfg.kanffn_up_cfg()
            h = fcfg.kanffn_hidden
            s1 = 1.0 - up.n_bases_kept / up.spec.n_bases
            hm = fcfg.kanffn_hidden_mask()
            s2 = 0.0 if hm is None else float(hm.sparsity)
            works.append(LayerWork(LayerKind.KAN, cfg.d_model, h,
                                   spec=up.spec, pattern_rate=s1))
            works.append(LayerWork(LayerKind.MLP, h, cfg.d_model,
                                   pattern_rate=s2))
        elif fk == "mlp" and cfg.d_ff > 0:
            gated = cfg.ffn_kind in ("swiglu", "geglu")
            up_out = 2 * cfg.d_ff if gated else cfg.d_ff
            works.append(LayerWork(LayerKind.MLP, cfg.d_model, up_out))
            works.append(LayerWork(LayerKind.MLP, cfg.d_ff, cfg.d_model))
        elif fk == "moe":
            # top_k expert FFNs' worth of parallel-mode work per token
            k = max(cfg.top_k, 1)
            works.append(LayerWork(LayerKind.MLP, cfg.d_model,
                                   2 * k * cfg.d_ff))
            works.append(LayerWork(LayerKind.MLP, k * cfg.d_ff, cfg.d_model))
    return works


def splice_cache(caches: Any, cache: Any, slot: int) -> Any:
    """``caches`` (batch n_slots) with lane ``slot`` replaced by the
    batch-1 ``cache`` of one prefilled request -- KV caches and recurrent
    states (``h``, ``conv``, ``C``, ``n``, ``m``, ``c``) alike: dim 0 of
    each ``"extra"`` layer's tensors, dim 1 under the stacked
    ``"units"``.  Returns new tensors; ``caches`` is left as it was."""
    def put(dim: int):
        def fn(full: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
            out = full.clone()
            out.narrow(dim, slot, 1).copy_(new.to(full.dtype))
            return out
        return fn

    out = {"extra": [tree_map(put(0), f, n)
                     for f, n in zip(caches["extra"], cache["extra"])]}
    if "units" in caches:
        out["units"] = tree_map(put(1), caches["units"], cache["units"])
    return out


def needs_modality_inputs(cfg: Any) -> Optional[str]:
    """Why token-only serving refuses ``cfg`` (an encoder-decoder or a
    frontend arch), in the reference launcher's words, or None."""
    if cfg.enc_dec or cfg.frontend is not None:
        return (f"arch {cfg.name!r} ({cfg.family}) needs modality inputs "
                f"(frames/patches) that the token-only serving path does "
                f"not provide")
    return None


class TransformerBackend(ModelBackend):
    """Slot-cache greedy decode for decoder-only ``ArchConfig`` stacks.

    ``params`` is the tree of ``models/transformer.init_params`` (tensors
    on any device, e.g. ``convert.transformer_params_from_jax`` of the
    reference's); it is moved to ``device`` (default ``"cuda"``, refused
    when CUDA is missing; ``"cpu"`` runs the plain PyTorch versions).
    ``precision`` is "f32" (the params as they are: a bf16 arch stays
    bf16, as in the reference) or "bf16" (the arch's dtype set to bf16
    and every floating param cast once, here); int8 is refused, as the
    reference refuses it.  ``masks`` installs calibrated per-layer
    (basis_keep, hidden_keep) pairs (core/calibrate.
    calibrate_kanffn_masks) as ``cfg.ffn_masks``.  Each KAN-FFN layer is
    built once (``models/ffn.KanFFN``: fused up weights, compacted down
    weights), and each MoE layer of KAN experts (``models/moe.
    KanExperts``: every expert's fused weights).  The encoder-decoder
    and frontend archs are refused (``NotImplementedError``), as the
    reference launcher refuses them: they need modality inputs
    (frames, patches) that token-only serving does not carry
    (``launch/steps`` serves them).  The
    reference's ``impl=`` has no counterpart: the device picks kernels
    or plain versions.

    KAN-FFN archs (``cfg.ffn_kinds`` set) gain the VIKIN cycle model: a
    per-layer ModePlan (attention and down phases parallel, KAN
    up-projections pipeline) charged through ``batch_report`` with the
    cross-tick mode carry-over, counting one model instance per decoded
    token plus one per prefilled prompt token.  Plain archs keep
    ``batch_report() -> None``.
    """

    def __init__(self, cfg: Any, params: Any, *,
                 device: str | torch.device = "cuda", masks: Any = None,
                 precision: str = "f32",
                 hw: Optional[VikinHW] = None) -> None:
        if precision not in ("f32", "bf16"):
            raise ValueError(
                f"TransformerBackend serves f32|bf16, got {precision!r} "
                "(int8 transformer serving is not supported; the vikin "
                "backends own the quantized path)")
        if masks is not None:
            cfg = dataclasses.replace(cfg, ffn_masks=tuple(masks))
        if precision == "bf16" and cfg.dtype != "bfloat16":
            cfg = dataclasses.replace(cfg, dtype="bfloat16")
        why = needs_modality_inputs(cfg)
        if why is not None:
            raise NotImplementedError(why)
        self.device = resolve_device(device)

        def place(a: torch.Tensor) -> torch.Tensor:
            if precision == "bf16" and a.is_floating_point():
                a = a.to(torch.bfloat16)
            return a.to(self.device)

        self.cfg, self.precision = cfg, precision
        self.params = tree_map(place, params)
        self.ffns = T.ffn_modules(self.params, cfg)
        self.n_slots: Optional[int] = None
        self.max_len: Optional[int] = None
        self.hw = hw or VikinHW()
        self.plan: Optional[ModePlan] = None
        self.layers: Optional[List[LayerWork]] = None
        if cfg.ffn_kinds is not None:
            self.layers = transformer_layer_works(cfg)
            self.plan = ModePlan.for_layers([w.kind for w in self.layers])
        self._pending_prefill = 0
        self._report_cache: Dict[Tuple[int, int, Optional[ExecMode]],
                                 Dict[str, float]] = {}

    def init_state(self, n_slots: int, max_len: int) -> Any:
        self.n_slots, self.max_len = n_slots, max_len
        return T.init_caches(self.cfg, n_slots, max_len, self.device)

    def prefill(self, caches: Any, slot: int, req: Request) -> Any:
        """Prefill one request and splice its (batch=1) cache into lane
        ``slot`` of the server's (batch=n_slots) caches."""
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int32)[None, :],
                                 device=self.device)
        if self.layers is not None:
            # each prefilled prompt token is one model instance the cycle
            # model charges on the NEXT tick's report
            self._pending_prefill += tokens.shape[1]
        with torch.no_grad():
            logits, cache = T.prefill(self.params, self.cfg, tokens,
                                      max_len=self.max_len, ffns=self.ffns)
            req.generated.append(int(T.greedy_token(logits)[0, 0]))
            return splice_cache(caches, cache, slot)

    def step(self, caches: Any,
             slot_req: Sequence[Optional[Request]]) -> Any:
        active = [s for s, r in enumerate(slot_req) if r is not None]
        toks = np.zeros((self.n_slots, 1), np.int32)
        for s in active:
            toks[s, 0] = slot_req[s].generated[-1]
        with torch.no_grad():
            logits, caches = T.decode_step(
                self.params, self.cfg, torch.from_numpy(toks).to(self.device),
                caches, ffns=self.ffns)
            nxt = T.greedy_token(logits).cpu().numpy()
        for s in active:
            req = slot_req[s]
            tok = int(nxt[s, 0])
            req.generated.append(tok)
            if (len(req.generated) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id)):
                req.done = True
        return caches

    def batch_report(self, n_active: int,
                     prev_mode: Optional[ExecMode] = None,
                     ) -> Optional[Dict[str, float]]:
        """VIKIN cycle model for the tick just run (kan-ffn archs only).

        ``batch`` = one model instance per active decode slot plus one per
        prompt token prefilled since the last report; ``prev_mode`` is the
        carried interconnect state and ``exit_mode`` hands the closing
        state back to the engine.  Plain archs return None.
        """
        if self.layers is None:
            return None
        pending, self._pending_prefill = self._pending_prefill, 0
        batch = n_active + pending
        if batch <= 0:
            return None
        key = (n_active, pending, prev_mode)
        if key not in self._report_cache:
            self._report_cache[key] = serving_report(
                self.layers, self.hw, batch=batch,
                prev_mode=prev_mode, precision=self.precision)
        return dict(self._report_cache[key])

    def cycle_attribution(self, batch: int,
                          prev_mode: Optional[ExecMode] = None,
                          ) -> Dict[str, object]:
        """Per-layer-phase cycle split whose parts sum EXACTLY to the
        serving report's sim_cycles at the same (batch, prev_mode):
        sum(per_layer_cycles) + reconfig_cycles == sim_cycles."""
        if self.layers is None or self.plan is None:
            raise ValueError("cycle_attribution needs a kan-ffn arch "
                             "(cfg.ffn_kinds set)")
        rep = run_model(self.layers, self.hw, batch=batch)
        switches, _ = self.plan.stream_switches(batch, prev_mode)
        return {
            "per_layer_cycles": [float(lc.total * batch)
                                 for lc in rep.per_layer],
            "reconfig_cycles": float(switches * RECONFIG_CYCLES),
        }


# ---------------------------------------------------------------------------
# VIKIN backend -- stacked KAN/MLP feed-forward serving.
# ---------------------------------------------------------------------------


class VikinBackend(ModelBackend):
    """Serve a PaperModelConfig KAN/MLP stack through the fused kernels.

    ``params`` is one dict of tensors (or numpy arrays) per layer in the
    JAX package's layout.  The stack is built once on ``device`` (default
    ``"cuda"``, refused when CUDA is missing); ``device="cpu"`` runs the
    plain PyTorch versions.  ``masks`` (one Optional[PatternMask] per
    layer, e.g. a calibrated checkpoint's) override the config's tiled
    masks, and the cycle model is then charged their measured rates.

    ``precision`` selects the served numerics: "f32" (default), "bf16"
    (the params cast to bf16 once, here; each batch cast to bf16, every
    layer bf16 in and out with f32 accumulation, the answer cast to f32,
    as the reference's bf16 backend) or "int8" (post-training quantized,
    core/quant), which needs the calibrated ``scales``
    (core/calibrate.calibrate_scales or a checkpoint's restore_scales);
    params are quantized once, here.  The cycle model charges the
    precision's DMA bytes.  Requests submit f32 payloads at every
    precision.

    ``hw`` is the modelled VIKIN engine (default ``VikinHW()``),
    ``min_bucket`` the smallest batch bucket (2, the default, keeps
    batched == single bitwise, as in the reference), and ``nnz_rates``
    the measured input-activation density of each layer, charged to the
    cycle model's MLP zero-skip (default dense).  The reference's
    ``impl=`` has no counterpart: the device picks kernels or plain
    versions.
    """

    def __init__(self, model: Any, params: Sequence[Dict[str, Any]], *,
                 device: str | torch.device = "cuda",
                 hw: Optional[VikinHW] = None, min_bucket: int = 2,
                 nnz_rates: Optional[Sequence[float]] = None,
                 masks: Optional[Sequence[Optional[PatternMask]]] = None,
                 precision: str = "f32",
                 scales: Optional[StackScales] = None) -> None:
        if precision not in ("f32", "bf16", "int8"):
            raise ValueError(
                f"unknown precision {precision!r}; expected f32|bf16|int8")
        if precision == "int8" and scales is None:
            raise ValueError(
                "precision='int8' requires calibrated scales "
                "(core/calibrate.calibrate_scales or "
                "checkpoint.restore_scales)")
        self.device = resolve_device(device)
        self.model, self.hw = model, hw or VikinHW()
        self.precision, self.scales = precision, scales
        self.min_bucket = min_bucket
        self.masks = list(masks) if masks is not None else None
        self.plan = ModePlan.for_layers(model.layer_kind_enums())
        if self.masks is not None:
            # calibrated model: charge the cycle model the MEASURED
            # per-layer mask sparsity, not the config-level rate
            self.layers = model.layer_works(
                nnz_rates, pattern_rates=masked_pattern_rates(self.masks))
        else:
            self.layers = model.layer_works(nnz_rates)
        self.n_in = int(model.sizes[0])
        # the served dtype of the stack's input and weights (int8: f32
        # payloads, quantized inside QuantVikinStack)
        self.dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        # the multi-chip cycle model (runtime/sharded.py); None = one chip
        self.array: Optional[VikinArray] = None
        self._place(params)
        self._report_cache: Dict[Tuple[int, Optional[ExecMode]],
                                 Dict[str, float]] = {}
        self.n_slots: Optional[int] = None

    def make_stack(self, params: Sequence[Dict[str, Any]],
                   device: torch.device,
                   layer_range: Optional[Tuple[int, int]] = None
                   ) -> torch.nn.Module:
        """The served stack (or layers ``lo..hi-1`` of it) on ``device``,
        in the served precision: a ``VikinStack``, or at int8 a
        ``QuantVikinStack`` (whole stacks only)."""
        tensors = [{k: torch.as_tensor(v, dtype=torch.float32, device=device)
                    for k, v in p.items()} for p in params]
        stack: torch.nn.Module
        if self.precision == "int8":
            assert self.scales is not None and layer_range is None
            stack = QuantVikinStack(
                self.model, quantize_stack_params(tensors, self.model,
                                                  self.scales),
                self.scales, self.masks)
        else:
            stack = VikinStack(
                self.model, [{k: v.to(self.dtype) for k, v in p.items()}
                             for p in tensors], self.masks, layer_range)
        return stack.eval()

    def _place(self, params: Sequence[Dict[str, Any]]) -> None:
        """Build what ``run`` serves from: one stack on ``self.device``."""
        self.stack = self.make_stack(params, self.device)

    def stacks(self) -> List[torch.nn.Module]:
        """Every stack module this backend serves from (knob tuning walks
        their layers)."""
        return [self.stack]

    def init_state(self, n_slots: int, max_len: int) -> np.ndarray:
        self.n_slots = n_slots
        # staging buffer of request inputs, one lane per slot
        return np.zeros((n_slots, self.n_in), np.float32)

    def input_dim(self, workload: Optional[str] = None) -> int:
        """Feature width a request payload must have (trace replay uses
        this to synthesize payloads from per-event seeds)."""
        return self.n_in

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

    def warmup(self, n_active: int) -> None:
        """Run one forward at the bucket ``n_active`` requests would use,
        so its kernels are built and loaded and their knobs resolved and
        memoized before a timed region.  Leaves no state behind: later
        outputs do not change by a bit."""
        self.forward(np.zeros((self.bucket(n_active), self.n_in),
                              np.float32))

    def forward(self, xb: np.ndarray) -> np.ndarray:
        """The batched stack forward on one (bucket, n_in) host batch; at
        bf16 the batch is rounded to bf16 and the answer widened to f32, on
        the host (half the bytes each way).  ``run`` is the device part:
        every block it returns is issued before the first is copied back,
        and the blocks are joined on the host."""
        with torch.inference_mode():
            blocks = self.run(torch.from_numpy(xb).to(self.dtype))
            y = torch.cat([b.cpu() for b in blocks])
            return y.to(torch.float32).numpy()

    def run(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The device part of ``forward``: the host batch ``x`` in the
        served dtype -> the answer rows, in order, as tensors on the
        device.  One stack on one device here; the array backends
        (runtime/sharded.py) replace only this."""
        return [self.apply(self.stack, x.to(self.device))]

    def apply(self, stack: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        """``stack(x)``, each row's bits independent of the rows beside
        it.  The kernels are row-independent on the card.  The plain
        versions on the CPU are not: MKL's threads split a product of few
        rows (differently call by call past one thread a core), and
        torch's elementwise CPU loops finish a tensor's tail on another
        code path than its body.  So on the CPU the stack runs one row at
        a time, on one thread: every row is then computed alike whatever
        batch, bucket, shard or stage carries it, and batched == single
        and every array plan hold bitwise on the host as on the card."""
        if x.device.type != "cpu":
            return stack(x)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return torch.cat([stack(row) for row in x.split(1)])
        finally:
            torch.set_num_threads(threads)

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
        extra flip).  ``self.array`` (set by the array backends of
        runtime/sharded.py) swaps in the multi-chip report."""
        key = (n_active, prev_mode)
        if key not in self._report_cache:
            self._report_cache[key] = serving_report(
                self.layers, self.hw, batch=n_active, array=self.array,
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

    def input_dim(self, workload: Optional[str] = None) -> int:
        """Feature width of the named workload's payloads (trace replay)."""
        if workload not in self.backends:
            raise ValueError(
                f"input_dim: unknown workload {workload!r}; this engine "
                f"serves {sorted(self.backends)}")
        return self.backends[workload].input_dim()

    def warmup(self, n_active: int) -> None:
        """``warmup(n_active)`` on every sub-backend."""
        for b in self.backends.values():
            b.warmup(n_active)

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
