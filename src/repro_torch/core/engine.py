"""Cycle-level performance model of the VIKIN engine (paper Secs. III-V).

Host-side copy of ``repro/core/engine.py`` (the port imports nothing of
the JAX package), without the Edge-GPU baseline and the Table I
builders, which are off the serving path.  ``tests/test_torch_serving.py``
holds ``run_model`` and ``serving_report`` exactly equal to the original.

The paper evaluates an FPGA prototype (Virtex-7 @ 115 MHz, FP16, 16-lane
arrays).  Wall-clock time on another device cannot reproduce those
numbers, so they come from this calibrated cycle model, which implements
the paper's dataflow:

  * pipeline mode (KAN, Fig. 3a / Fig. 5): SIMD (16 silu/cyc) || SPU array
    (16 units; iterative Cox-de Boor with stage-buffer reuse; per-input cost
    grows with G+K because the full basis set is produced and the TSE scans
    it) -> TSE (zero-free compaction + m-of-4 pattern filter) -> PE array.
    The PE array is OUTPUT-parallel: 16 PEs each own one output node and
    consume the dense node stream at 2 MACs/cycle (two Spad groups, Fig. 5b).
    Per layer, SPU and PE stages overlap; the longer one sets the time.
  * parallel mode (MLP, Fig. 3b): TSE compacts ReLU-sparse inputs; PE + SPU
    (accumulation mode) arrays together own 32 output nodes per batch at
    1 MAC/cycle each.  Sparse (offset-addressed) weight fetch runs at
    ETA_SPARSE efficiency (bank conflicts / TSE arbitration).
  * mode switches cost RECONFIG_CYCLES (core/modes.py).

Fig. 7's saturation ("throughput mismatch between the PE and SPU arrays")
falls out of max(SPU, PE): once pattern sparsity shrinks PE work below the
SPU's production rate, masking buys nothing, and smaller G/K (cheaper SPU)
restore scaling -- exactly the paper's remark.  Fig. 8's "3.29x ops at 1.24x
latency" falls out too: raising G grows SPU and dense-op work, but zero-free
keeps PE work flat at K+1 non-zeros per input.

Calibration constants (SPU_SCAN_COST, ETA_SPARSE, fill cycles, energy/nJ) are
fit to the paper's reported points (Table II, Figs. 6-7) and documented as
such; sparsity rates are INPUTS, measured from the actually-trained models.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.modes import (
    RECONFIG_CYCLES,
    ExecMode,
    LayerKind,
    ModePlan,
    parse_mode,
)
from repro_torch.core.splines import SplineSpec, spu_op_count

# Bytes per element on the wire, by served precision.  The DMA/byte model
# derives every transfer size from these instead of hard-coding "FP16":
# the serving engine actually runs f32 (or bf16/int8 when quantized), and
# the bytes-halved/quartered DMA stream is precisely the win the paper's
# fixed-point datapath claims -- so it must be charged from the dtype
# served, not from the prototype's native width.
PRECISION_BYTES = {"f32": 4, "f16": 2, "bf16": 2, "int8": 1}


def precision_bytes(precision: str) -> int:
    try:
        return PRECISION_BYTES[precision]
    except KeyError:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of "
            f"{sorted(PRECISION_BYTES)}") from None


# ---------------------------------------------------------------------------
# Hardware description (paper Sec. III / Table II) + calibration constants.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VikinHW:
    n_spu: int = 16            # B-spline units (Sec. III)
    n_pe: int = 16             # processing elements
    pe_muls_kan: int = 2       # two Spad groups feed 2 muls/PE (Fig. 5b)
    simd_lanes: int = 16       # silu throughput (COMPACT SIMD core [1])
    simd_latency: int = 4      # pipelined silu latency
    clock_hz: float = 115e6    # VC709 prototype clock
    spu_scan_cost: float = 4.0  # cycles per basis for produce+TSE-scan (cal.)
    eta_sparse: float = 0.90   # DYNAMIC zero-skip weight-fetch efficiency
    spu_pe_eff: float = 0.80   # SPU-as-PE bandwidth share (4 banks / 32 units)
    outbatch_fill: int = 16    # weight-buffer swap per output batch (cal.)
    # Energy model (dynamic, nJ), calibrated to Table II's GOPS/W points.
    e_mac_nj: float = 0.040
    e_spu_op_nj: float = 0.050
    e_buf_access_nj: float = 0.180
    p_static_w: float = 0.25

    @property
    def kan_macs_per_cycle(self) -> int:
        return self.n_pe * self.pe_muls_kan            # 32

    @property
    def mlp_out_nodes(self) -> int:
        # parallel mode: SPU array mimics the PE array -> 32 nodes/batch
        return self.n_pe + self.n_spu


@dataclasses.dataclass(frozen=True)
class LayerWork:
    """One layer's workload + sparsity statistics."""

    kind: LayerKind
    n_in: int
    n_out: int
    spec: Optional[SplineSpec] = None      # KAN only
    in_nnz_rate: float = 1.0               # measured activation density (MLP)
    pattern_rate: float = 0.0              # stage-2 mask sparsity (0..0.75)

    @property
    def keep_frac(self) -> float:
        return 1.0 - self.pattern_rate

    def nodes_per_input(self, zero_free: bool = True,
                        pattern: bool = True) -> float:
        """Intermediate nodes per input surviving the TSE (KAN layers).

        The TSE filters the whole node stream (bases + silu) in batches of
        four, so the pattern keep-fraction applies to the silu node too.
        """
        s = self.spec
        nodes = float(s.n_active) if zero_free else float(s.n_bases)
        nodes += 1.0                                    # silu node
        if pattern:
            nodes *= self.keep_frac
        return nodes

    def dense_ops(self) -> float:
        """Op count with NO sparsity exploited (Fig. 8 'operations' axis)."""
        if self.kind is LayerKind.KAN:
            s = self.spec
            mac = 2.0 * self.n_in * self.n_out * (s.n_bases + 1)
            eval_ops = self.n_in * spu_op_count(s) * (s.n_bases / s.n_active)
            return mac + eval_ops + 6.0 * self.n_in
        return 2.0 * self.n_in * self.n_out

    def effective_macs(self, zero_free: bool = True,
                       pattern: bool = True) -> float:
        """MACs actually issued to the MAC units after the TSE stages."""
        if self.kind is LayerKind.KAN:
            return self.n_in * self.n_out * self.nodes_per_input(
                zero_free, pattern)
        dens = self.in_nnz_rate if zero_free else 1.0
        keep = self.keep_frac if pattern else 1.0
        return self.n_in * self.n_out * dens * keep

    def streamed_params(self) -> float:
        """Parameter ELEMENTS DMA-streamed to serve one batch of this layer.

        Static stage-2 masks compact the weight stream offline, so only
        kept entries cross the port: a KAN layer streams its fused
        [w_b ; t] table with the kept basis columns (the silu row is
        never maskable), an MLP layer streams the kept weight rows plus
        the bias.  Multiply by the served precision's byte width
        (``precision_bytes``) for bytes -- done by ``serving_report``.
        """
        if self.kind is LayerKind.KAN:
            kept_bases = self.spec.n_bases * self.keep_frac
            return self.n_in * self.n_out * (kept_bases + 1.0)
        return self.n_in * self.keep_frac * self.n_out + self.n_out


# ---------------------------------------------------------------------------
# Per-layer cycle counts.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LayerCycles:
    total: float
    spu: float = 0.0
    pe: float = 0.0
    bound: str = "PE"
    macs: float = 0.0
    spu_ops: float = 0.0


def kan_layer_cycles(
    w: LayerWork,
    hw: VikinHW = VikinHW(),
    zero_free: bool = True,
    pattern: bool = True,
) -> LayerCycles:
    """Pipeline-mode KAN layer (Fig. 3a / Fig. 5)."""
    s = w.spec
    in_batches = math.ceil(w.n_in / hw.n_spu)
    out_batches = math.ceil(w.n_out / hw.n_pe)
    # SPU stage: each SPU owns one input; iterative full-set evaluation +
    # TSE scan costs spu_scan_cost per basis, plus the local recursion.
    spu_per_input = hw.spu_scan_cost * s.n_bases + spu_op_count(s)
    spu_total = in_batches * spu_per_input
    # PE stage: 16 output-parallel PEs x 2 muls consume the dense stream.
    macs = w.effective_macs(zero_free, pattern)
    nodes = w.nodes_per_input(zero_free, pattern)
    pe_total = out_batches * (w.n_in * nodes) / hw.pe_muls_kan
    bound = "SPU" if spu_total >= pe_total else "PE"
    fill = spu_per_input + hw.simd_latency + out_batches * hw.outbatch_fill
    total = max(spu_total, pe_total) + fill
    return LayerCycles(total=total, spu=spu_total, pe=pe_total, bound=bound,
                       macs=macs, spu_ops=spu_per_input * w.n_in)


def mlp_layer_cycles(
    w: LayerWork,
    hw: VikinHW = VikinHW(),
    zero_skip: bool = True,
    pattern: bool = True,
    spu_as_pe: bool = True,
) -> LayerCycles:
    """Parallel-mode MLP layer (Fig. 3b).

    ``zero_skip``/``spu_as_pe`` toggles reproduce the Fig. 6 ablation:
    baseline = neither (PE array only, dense weights).
    """
    # SPU accumulation mode doubles the output nodes per batch, but the four
    # weight-buffer banks are now shared by both arrays (Fig. 5b), so the
    # combined array sustains only spu_pe-adjusted throughput.
    nominal = hw.mlp_out_nodes if spu_as_pe else hw.n_pe
    effective = (hw.n_pe + hw.n_spu * hw.spu_pe_eff) if spu_as_pe else hw.n_pe
    out_batches = math.ceil(w.n_out / nominal)
    kept_per_out = float(w.n_in)
    eta = 1.0
    if zero_skip and w.in_nnz_rate < 1.0:
        # dynamic (offset-addressed) weight fetch -> bank conflicts
        kept_per_out *= w.in_nnz_rate
        eta = hw.eta_sparse
    if pattern and w.pattern_rate > 0.0:
        # static mask: weights pre-arranged offline, fetch stays streaming
        kept_per_out *= w.keep_frac
    pe = out_batches * kept_per_out * (nominal / effective) / eta
    # Front-end fill: INTENTIONALLY hw.simd_lanes (16), not hw.simd_latency
    # (4, the KAN path's term).  In parallel mode the first weight fetch is
    # gated by the TSE compacting a full simd_lanes-wide input group (the
    # zero-skip offsets exist only once the whole group is scanned), not by
    # the silu pipeline depth; the 16-cycle charge is part of the Table II /
    # Fig. 6 calibration.  Pinned by tests/test_engine_calibration.py --
    # "fixing" this to simd_latency shifts every MLP point by -12 cycles.
    fill = hw.simd_lanes + out_batches * hw.outbatch_fill
    macs = w.effective_macs(zero_free=zero_skip, pattern=pattern)
    return LayerCycles(total=pe + fill, pe=pe, bound="PE", macs=macs)


# ---------------------------------------------------------------------------
# Whole-model evaluation.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModelReport:
    cycles: float
    latency_s: float
    macs: float
    spu_ops: float
    dense_ops: float
    gops: float                  # throughput on DENSE ops (paper convention)
    dyn_power_w: float
    gops_per_w: float
    per_layer: List[LayerCycles] = dataclasses.field(default_factory=list)


def run_model(
    layers: Sequence[LayerWork],
    hw: VikinHW = VikinHW(),
    *,
    zero_free: bool = True,
    pattern: bool = True,
    spu_as_pe: bool = True,
    batch: int = 1,
) -> ModelReport:
    """Latency/throughput/energy of a model on VIKIN (single instance)."""
    plan = ModePlan.for_layers([w.kind for w in layers])
    cyc = float(plan.reconfig_cycles)
    per_layer, macs, spu_ops, dense = [], 0.0, 0.0, 0.0
    for w in layers:
        if w.kind is LayerKind.KAN:
            lc = kan_layer_cycles(w, hw, zero_free, pattern)
        else:
            lc = mlp_layer_cycles(w, hw, zero_free, pattern, spu_as_pe)
        per_layer.append(lc)
        cyc += lc.total
        macs += lc.macs
        spu_ops += lc.spu_ops
        dense += w.dense_ops()
    cyc *= batch  # single-instance engine: batches stream sequentially
    macs, spu_ops, dense = macs * batch, spu_ops * batch, dense * batch

    lat = cyc / hw.clock_hz
    e_nj = (2 * macs * hw.e_mac_nj + spu_ops * hw.e_spu_op_nj
            + macs * hw.e_buf_access_nj)
    p_dyn = e_nj * 1e-9 / lat + hw.p_static_w
    gops = dense / lat / 1e9
    return ModelReport(
        cycles=cyc, latency_s=lat, macs=macs, spu_ops=spu_ops,
        dense_ops=dense, gops=gops, dyn_power_w=p_dyn,
        gops_per_w=gops / p_dyn, per_layer=per_layer,
    )


# ---------------------------------------------------------------------------
# Multi-chip VIKIN array (DESIGN.md Sec. 13).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VikinArray:
    """``n_chips`` VIKIN engines behind one host port (scale-out serving).

    The host holds the request batch, scatters row shards to the chips over
    a shared host port, every chip streams its rows through the single-chip
    model (run_model), and the host gathers the output rows back.  Chips
    compute in parallel, so the array's wall cycles are

        max-per-chip compute  +  scatter/gather transfer  +  per-chip DMA

    * Transfer: all batch rows cross the shared port once in (n_in feats)
      and once out (n_out feats) at ``host_bytes_per_cycle`` -- chips do not
      get faster links by existing; the port is the bottleneck resource
      (same assumption as the paper's single-DDR-port prototype, scaled).
    * DMA setup: ``dma_setup_cycles`` per chip per direction, so the fixed
      cost GROWS with n_chips -- which is what makes small batches stop
      profiting from more chips (the classic scale-out knee, pinned in
      tests/test_sharded.py).

    Cycle attribution stays per-row on the chips: every row still pays its
    mode plan on whichever chip serves it, so mode_switches / reconfig
    totals are array-size independent.

    ``plan`` selects how the layer stack maps onto the chips
    (DESIGN.md Sec. 18):

    * ``"data"`` (default, the model above): params replicated, request
      rows split across chips, every chip runs the whole stack and flips
      modes with its row stream.
    * ``"pipeline"``: the stack is cut into contiguous layer stages
      (``stage_map``, or an even split over ``min(n_chips, n_layers)``
      chips), one stage per chip; rows stream through the stages with
      micro-batch overlap, so steady-state wall time is set by the slowest
      stage and the fill/drain bubble is the sum of the OTHER stages.
      Inter-stage activations cross the shared host port.
    * ``"hetero"``: every chip is PINNED to one interconnect mode
      (``mode_pins``; default splits the array half pipeline-mode /
      half parallel-mode).  Each same-mode run of layers row-splits over
      the pool pinned to its mode, so NO chip ever reconfigures --
      reconfig_cycles is identically 0 -- at the cost of each segment
      only using its pool's chips.
    """

    hw: VikinHW = VikinHW()
    n_chips: int = 1
    host_bytes_per_cycle: float = 64.0   # shared host<->array port width
    dma_setup_cycles: float = 96.0       # per chip, per direction
    precision: str = "f32"               # dtype of activations on the wire
    # Derived from ``precision`` when None (was a hard-coded FP16 "2" while
    # serving actually ran f32); an explicit int still overrides.
    bytes_per_feat: Optional[int] = None
    plan: str = "data"                   # data | pipeline | hetero
    stage_map: Optional[Tuple[int, ...]] = None   # pipeline: layers per stage
    mode_pins: Optional[Tuple[ExecMode, ...]] = None  # hetero: mode per chip

    def __post_init__(self) -> None:
        if self.n_chips < 1:
            raise ValueError(f"n_chips must be >= 1, got {self.n_chips}")
        if self.bytes_per_feat is None:
            object.__setattr__(self, "bytes_per_feat",
                               precision_bytes(self.precision))
        if self.plan not in ("data", "pipeline", "hetero"):
            raise ValueError(
                f"unknown array plan {self.plan!r}; expected one of "
                "'data', 'pipeline', 'hetero'")
        if self.stage_map is not None:
            if self.plan != "pipeline":
                raise ValueError(
                    f"stage_map is a pipeline-plan knob; array plan is "
                    f"{self.plan!r}")
            sm = tuple(int(n) for n in self.stage_map)
            if not sm or any(n < 1 for n in sm):
                raise ValueError(
                    f"stage_map entries must be positive layer counts, got "
                    f"{self.stage_map!r}")
            if len(sm) > self.n_chips:
                raise ValueError(
                    f"stage_map asks for {len(sm)} stages but the array has "
                    f"only {self.n_chips} chips (one stage per chip)")
            object.__setattr__(self, "stage_map", sm)
        if self.mode_pins is not None:
            if self.plan != "hetero":
                raise ValueError(
                    f"mode_pins is a hetero-plan knob; array plan is "
                    f"{self.plan!r}")
            pins = tuple(parse_mode(m) for m in self.mode_pins)
            if len(pins) != self.n_chips:
                raise ValueError(
                    f"mode_pins must pin every chip: got {len(pins)} pins "
                    f"for {self.n_chips} chips")
            object.__setattr__(self, "mode_pins", pins)

    def rows_per_chip(self, batch: int) -> int:
        return math.ceil(max(batch, 1) / self.n_chips)

    def comm_cycles(self, batch: int, n_in: int, n_out: int) -> float:
        """Scatter inputs + gather outputs for one served batch."""
        xfer_bytes = max(batch, 1) * (n_in + n_out) * self.bytes_per_feat
        return (xfer_bytes / self.host_bytes_per_cycle
                + 2.0 * self.n_chips * self.dma_setup_cycles)

    def stage_sizes(self, n_layers: int) -> Tuple[int, ...]:
        """Pipeline plan: layers per stage (explicit stage_map, or an even
        cut of the stack over ``min(n_chips, n_layers)`` stages)."""
        if n_layers < 1:
            raise ValueError("stage_sizes needs at least one layer")
        if self.stage_map is not None:
            if sum(self.stage_map) != n_layers:
                raise ValueError(
                    f"stage_map {self.stage_map!r} covers "
                    f"{sum(self.stage_map)} layers but the stack has "
                    f"{n_layers}")
            return self.stage_map
        n_stages = min(self.n_chips, n_layers)
        base, rem = divmod(n_layers, n_stages)
        return tuple(base + (1 if s < rem else 0) for s in range(n_stages))

    def resolved_pins(self) -> Tuple[ExecMode, ...]:
        """Hetero plan: per-chip pinned mode.  Default pins the first
        ``ceil(n_chips/2)`` chips pipeline-mode (KAN) and the rest
        parallel-mode (MLP)."""
        if self.mode_pins is not None:
            return self.mode_pins
        n_pipe = math.ceil(self.n_chips / 2)
        return (ExecMode.PIPELINE,) * n_pipe + (
            ExecMode.PARALLEL,) * (self.n_chips - n_pipe)

    def pool_size(self, mode: ExecMode) -> int:
        return sum(1 for m in self.resolved_pins() if m is mode)


def serving_report(
    layers: Sequence[LayerWork],
    hw: VikinHW = VikinHW(),
    *,
    batch: int = 1,
    array: Optional[VikinArray] = None,
    prev_mode: Optional[ExecMode] = None,
    precision: str = "f32",
) -> dict:
    """One served batch's simulated-hardware accounting (runtime backends).

    Without ``array`` (the single-chip engine), batch rows stream
    sequentially (run_model), so compute cycles scale linearly in
    ``batch`` and each row pays the mode plan.

    Mode flips follow the carry-over contract (DESIGN.md Sec. 14,
    ``ModePlan.stream_switches``): the interconnect stays in whatever mode
    the previous row -- or, via ``prev_mode``, the previous served batch --
    left it, so boundary flips between rows of a first!=last plan and the
    entry flip into a batch whose first mode disagrees with the carried
    mode are charged on top of the per-row internal schedule.
    ``prev_mode=None`` is a cold start (no entry charge), and the report
    carries the closing mode out as ``exit_mode`` (an ExecMode, popped by
    the engine before numeric aggregation) so the caller can thread it into
    the next batch's report.

    With ``array``, rows are split evenly over ``array.n_chips`` chips that
    compute in parallel: ``sim_cycles`` becomes the array's WALL cycles
    (max per-chip compute + host scatter/gather), reported next to the
    per-chip compute (``chip_cycles``) and transfer (``comm_cycles``)
    breakdown.  Mode-switch TOTALS stay per-row-stream attribution (every
    row pays its plan; flip totals are chip-count independent, test-pinned)
    while the wall clock charges each chip its own row stream's flips.
    That is the ``"data"`` plan; ``array.plan`` selects two alternatives
    (DESIGN.md Sec. 18):

    * ``"pipeline"``: layers staged across chips, rows overlapped through
      the stages.  Wall compute is ``(batch-1) * T_max + sum(T_s)`` where
      ``T_s`` is stage ``s``'s one-row time (+ a steady-state re-entry flip
      when its own layer run is mode-mixed), i.e. steady-state issue at the
      bottleneck stage plus the fill/drain bubble
      ``bubble_cycles = sum(T_s) - T_max <= (n_stages-1) * T_max``
      (equality when stages are balanced -- the closed-form bound pinned in
      tests/test_array_plans.py).  The host port carries the input and
      output rows PLUS every inter-stage activation boundary, but DMA setup
      is paid per STAGE, not per chip -- which is why pipeline beats the
      data plan at small batch on deep-enough stacks and loses past the
      crossover batch where the data plan's ``rows/chips`` compute split
      dominates.  Per-chip interconnects never see other stages' modes, so
      there is no cross-batch carry (no ``exit_mode``).
    * ``"hetero"``: chips pinned to one mode each (``array.mode_pins``);
      each same-mode layer segment row-splits over its mode's pool.  No
      interconnect EVER flips: ``mode_switches`` / ``reconfig_cycles`` are
      identically 0 regardless of the stream mix or ``prev_mode``, and
      there is no ``exit_mode`` to carry.  Raises if the stack needs a mode
      no chip is pinned to.

    ``precision`` is the dtype SERVED (what the runtime actually streams:
    "f32" for the plain path, "int8" for the quantized one); it sets the
    byte width of every DMA transfer in ``dma_bytes`` -- activations in
    and out (per row) plus the compacted parameter stream (once per
    batch, the weight buffers are reloaded per served batch).  It does
    not change cycle counts: the lanes are width-agnostic in this model,
    the bytes are the precision win.
    """
    plan = ModePlan.for_layers([w.kind for w in layers])
    batch = max(batch, 1)
    ebytes = precision_bytes(precision)
    dma_bytes = (batch * (layers[0].n_in + layers[-1].n_out) * ebytes
                 + sum(w.streamed_params() for w in layers) * ebytes)
    if array is not None:
        if array.hw != hw:
            raise ValueError(
                "serving_report: array.hw disagrees with the hw argument; "
                "build the VikinArray with the chip model you are reporting "
                "against (the array's hw is what the chips run)")
        if array.precision != precision:
            raise ValueError(
                f"serving_report: array precision {array.precision!r} "
                f"disagrees with the served precision {precision!r}; build "
                "the VikinArray with the dtype actually on the wire")
        if array.plan == "pipeline":
            return _pipeline_report(layers, plan, array, batch, dma_bytes)
        if array.plan == "hetero":
            return _hetero_report(layers, plan, array, batch, dma_bytes)
    switches, exit_mode = plan.stream_switches(batch, prev_mode)
    out = {
        "mode_switches": float(switches),
        "reconfig_cycles": float(switches * RECONFIG_CYCLES),
        "dma_bytes": float(dma_bytes),
    }
    if exit_mode is not None:
        out["exit_mode"] = exit_mode
    if array is None:
        rep = run_model(layers, hw, batch=batch)
        # flips beyond the per-row internal schedule run_model charges
        extra = switches - plan.n_switches * batch
        cycles = rep.cycles + extra * RECONFIG_CYCLES
        out.update(sim_cycles=cycles, sim_latency_s=cycles / hw.clock_hz,
                   sim_macs=rep.macs)
        return out
    rows = array.rows_per_chip(batch)
    chip = run_model(layers, array.hw, batch=rows)
    # wall clock: the slowest chip replays ``rows`` back-to-back instances,
    # so it pays that stream's boundary/entry flips locally
    chip_extra, _ = plan.stream_switches(rows, prev_mode)
    chip_extra -= plan.n_switches * rows
    chip_cycles = chip.cycles + chip_extra * RECONFIG_CYCLES
    comm = array.comm_cycles(batch, layers[0].n_in, layers[-1].n_out)
    cycles = chip_cycles + comm
    out.update(
        sim_cycles=cycles,
        sim_latency_s=cycles / array.hw.clock_hz,
        # all chips together issue every row's MACs, not just the slowest
        # chip's share (n_chips itself is static config, not a per-batch
        # quantity, so it stays out of this additive report)
        sim_macs=chip.macs / rows * batch,
        chip_cycles=chip_cycles,
        comm_cycles=comm,
    )
    return out


def _pipeline_report(
    layers: Sequence[LayerWork],
    plan: ModePlan,
    array: VikinArray,
    batch: int,
    dma_bytes: float,
) -> dict:
    """Pipeline-parallel array accounting (DESIGN.md Sec. 18).

    Stage ``s`` holds a contiguous layer run; one row costs it ``T_s``
    cycles (its layers' run_model time, plus one steady-state re-entry
    flip when the stage itself is mode-mixed -- its interconnect must
    return to the stage's first mode before the next row).  Rows overlap
    through the stages, so the bottleneck stage issues a row every
    ``T_max`` and the ends of the pipe add the fill/drain bubble:

        compute wall = (batch - 1) * T_max + sum(T_s)
        bubble_cycles = sum(T_s) - T_max

    All activation traffic shares the one host port: every row crosses it
    entering stage 0, at each of the ``n_stages - 1`` stage boundaries,
    and leaving the last stage.  DMA setup is paid per stage-endpoint
    (``2 * n_stages``), NOT per chip -- with fewer stages than chips this
    is exactly the fixed-cost edge over the data plan at small batch.
    """
    sizes = array.stage_sizes(len(layers))
    stages: List[Sequence[LayerWork]] = []
    lo = 0
    for n in sizes:
        stages.append(layers[lo:lo + n])
        lo += n
    stage_times: List[float] = []
    macs_row = 0.0
    switches = 0
    for stage in stages:
        splan = ModePlan.for_layers([w.kind for w in stage])
        rep = run_model(stage, array.hw, batch=1)
        t = float(rep.cycles)
        if splan.last_mode is not splan.first_mode:
            t += RECONFIG_CYCLES  # re-enter the stage's first mode per row
        stage_times.append(t)
        macs_row += rep.macs
        # steady state: every stage re-runs its own plan per row, carrying
        # its OWN last mode (stages never see neighbours' interconnects)
        switches += splan.stream_switches(batch, splan.last_mode)[0]
    t_max = max(stage_times)
    bubble = sum(stage_times) - t_max
    chip_cycles = (batch - 1) * t_max + sum(stage_times)
    feats = (layers[0].n_in
             + sum(stage[-1].n_out for stage in stages[:-1])
             + layers[-1].n_out)
    comm = (batch * feats * array.bytes_per_feat / array.host_bytes_per_cycle
            + 2.0 * len(stages) * array.dma_setup_cycles)
    cycles = chip_cycles + comm
    return {
        "mode_switches": float(switches),
        "reconfig_cycles": float(switches * RECONFIG_CYCLES),
        "dma_bytes": float(dma_bytes),
        "sim_cycles": cycles,
        "sim_latency_s": cycles / array.hw.clock_hz,
        "sim_macs": macs_row * batch,
        "chip_cycles": chip_cycles,
        "comm_cycles": comm,
        "bubble_cycles": bubble,
    }


def _hetero_report(
    layers: Sequence[LayerWork],
    plan: ModePlan,
    array: VikinArray,
    batch: int,
    dma_bytes: float,
) -> dict:
    """Heterogeneous mode-pinned array accounting (DESIGN.md Sec. 18).

    Each maximal same-mode layer segment row-splits over the chip pool
    pinned to its mode (data-parallel within the pool); segments run in
    sequence, activations crossing the host port between pools.  Chips
    never reconfigure -- a pipeline-pinned chip only ever sees KAN
    segments -- so flip totals are identically zero whatever the stream
    mix, which is the whole point of the plan (the scheduler stops
    needing to group batches by mode, runtime/scheduler.py).
    """
    pins = array.resolved_pins()
    chip_cycles = 0.0
    macs_row = 0.0
    endpoints = 0
    for mode, lo, hi in plan.segment_slices():
        pool = sum(1 for m in pins if m is mode)
        if pool == 0:
            raise ValueError(
                f"hetero array has no chip pinned to {mode.value!r} but the "
                f"stack needs it (pins: {[m.value for m in pins]}); pin at "
                "least one chip per mode the workload uses")
        rows = math.ceil(batch / pool)
        rep = run_model(layers[lo:hi], array.hw, batch=rows)
        chip_cycles += float(rep.cycles)
        macs_row += rep.macs / rows
        endpoints += pool
    seg_slices = plan.segment_slices()
    feats = (layers[0].n_in
             + sum(layers[hi - 1].n_out for _, _, hi in seg_slices[:-1])
             + layers[-1].n_out)
    comm = (batch * feats * array.bytes_per_feat / array.host_bytes_per_cycle
            + 2.0 * endpoints * array.dma_setup_cycles)
    cycles = chip_cycles + comm
    return {
        "mode_switches": 0.0,
        "reconfig_cycles": 0.0,
        "dma_bytes": float(dma_bytes),
        "sim_cycles": cycles,
        "sim_latency_s": cycles / array.hw.clock_hz,
        "sim_macs": macs_row * batch,
        "chip_cycles": chip_cycles,
        "comm_cycles": comm,
    }
