"""VIKIN's reconfigurable operation modes as a dispatch abstraction.

Host-side copy of ``repro/core/modes.py``; the port imports nothing of the
JAX package.

On the FPGA, "mode" chooses an interconnect configuration: pipeline
(SIMD -> SPU -> TSE -> PE) for KANs vs parallel (TSE -> {SPU-as-PE, PE}) for
MLPs.  Here reconfigurability is dispatch: one code path serves both layer
types with shared kernels, which is the analogue of reusing silicon.

* PIPELINE  -> KAN layers lower to the fused kernel (kan_fused): silu + SPU
              basis recursion + TSE scatter + MAC in one pass.
* PARALLEL  -> MLP layers lower to the pattern-sparse matmul
              (pattern_matmul) with fused activation epilogue; the "SPU
              doubles the PE count" effect is a throughput property of the
              FPGA reproduced in the cycle model (core/engine.py).

``ModePlan.for_layers`` mirrors the host processor's role in the paper: it
inspects the workload (a sequence of layer kinds) and issues the mode switch
schedule, charging a reconfiguration overhead whenever the mode flips.

``ModePlan.stream_switches`` extends that schedule across BATCH boundaries
(the cross-tick carry-over contract, DESIGN.md Sec. 14): the interconnect
stays in whatever mode the previous instance left it, so back-to-back
instances of a same-mode plan charge zero reconfiguration, while entering a
plan whose first layer disagrees with the carried mode pays one extra flip.
The serving engine (runtime/server.Engine) threads the carried mode through
``serving_report(prev_mode=...)`` tick to tick, which is what makes the
mode-affinity scheduler's grouping (runtime/scheduler.py) worth cycles.

Implements the mode-schedule serving contract of DESIGN.md Sec. 11 (each
served workload carries its ModePlan; RECONFIG_CYCLES charged per flip per
served instance) on top of the pipeline/parallel dataflows of Sec. 2 and 7.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple, Union


class ExecMode(enum.Enum):
    PIPELINE = "pipeline"   # KAN dataflow
    PARALLEL = "parallel"   # MLP dataflow


class LayerKind(enum.Enum):
    KAN = "kan"
    MLP = "mlp"


MODE_FOR_KIND = {LayerKind.KAN: ExecMode.PIPELINE, LayerKind.MLP: ExecMode.PARALLEL}


def parse_mode(mode: Union["ExecMode", str]) -> ExecMode:
    """Coerce a mode spelling (ExecMode | "pipeline"/"kan" | "parallel"/"mlp")
    into an ExecMode, for CLI flags and array mode-pin configs."""
    if isinstance(mode, ExecMode):
        return mode
    name = str(mode).strip().lower()
    aliases = {
        "pipeline": ExecMode.PIPELINE, "kan": ExecMode.PIPELINE,
        "parallel": ExecMode.PARALLEL, "mlp": ExecMode.PARALLEL,
    }
    if name not in aliases:
        raise ValueError(
            f"unknown exec mode {mode!r}; expected one of "
            f"{sorted(aliases)} (pipeline=KAN dataflow, parallel=MLP)")
    return aliases[name]

# Interconnect reconfiguration cost, cycles (buffer drain + mux switch).
# Charged by the cycle model on every mode flip; "minimal reconfiguration
# overhead" per paper Sec. IV-A.
RECONFIG_CYCLES = 8


@dataclasses.dataclass(frozen=True)
class ModePlan:
    """Mode schedule for a workload: one entry per layer + flip positions."""

    modes: Tuple[ExecMode, ...]

    @classmethod
    def for_layers(cls, kinds: Sequence[LayerKind]) -> "ModePlan":
        return cls(tuple(MODE_FOR_KIND[k] for k in kinds))

    @property
    def n_switches(self) -> int:
        return sum(
            1 for a, b in zip(self.modes, self.modes[1:]) if a is not b
        )

    @property
    def reconfig_cycles(self) -> int:
        return self.n_switches * RECONFIG_CYCLES

    @property
    def first_mode(self) -> Optional[ExecMode]:
        return self.modes[0] if self.modes else None

    @property
    def last_mode(self) -> Optional[ExecMode]:
        return self.modes[-1] if self.modes else None

    def stream_switches(
        self, batch: int, prev_mode: Optional[ExecMode] = None,
    ) -> Tuple[int, Optional[ExecMode]]:
        """Total interconnect flips for ``batch`` back-to-back instances of
        this plan entered from ``prev_mode``, and the mode the engine is
        left in.

        ``prev_mode=None`` is a cold start: the first instance configures a
        blank interconnect, which is setup, not a reconfiguration -- no
        entry charge.  Between consecutive instances the interconnect
        carries over, so a plan whose last layer's mode differs from its
        first pays one boundary flip per instance boundary; a homogeneous
        plan entered from its own mode pays nothing at all (the carry-over
        contract the mode-affinity scheduler amortizes, DESIGN.md Sec. 14).
        """
        if not self.modes or batch <= 0:
            return 0, prev_mode
        sw = self.n_switches * batch
        if prev_mode is not None and prev_mode is not self.first_mode:
            sw += 1
        if self.last_mode is not self.first_mode:
            sw += batch - 1
        return sw, self.last_mode

    def segments(self) -> List[Tuple[ExecMode, int]]:
        """Run-length encoding: [(mode, n_layers), ...]."""
        out: List[Tuple[ExecMode, int]] = []
        for m in self.modes:
            if out and out[-1][0] is m:
                out[-1] = (m, out[-1][1] + 1)
            else:
                out.append((m, 1))
        return out

    def segment_slices(self) -> List[Tuple[ExecMode, int, int]]:
        """Like :meth:`segments` but with layer index ranges:
        [(mode, start, stop), ...] with ``stop`` exclusive.  This is the
        layer->chip-pool assignment unit of the heterogeneous array plan
        (core/engine.serving_report, DESIGN.md Sec. 18): each maximal
        same-mode run of layers executes on the chip pool pinned to that
        mode, so segment boundaries are exactly where activations cross
        between pools."""
        out: List[Tuple[ExecMode, int, int]] = []
        start = 0
        for mode, n in self.segments():
            out.append((mode, start, start + n))
            start += n
        return out

    def summary(self) -> dict:
        """Servable description of the schedule (launch/serve, benchmarks)."""
        return {
            "modes": [m.value for m in self.modes],
            "segments": [(m.value, n) for m, n in self.segments()],
            "n_switches": self.n_switches,
            "reconfig_cycles": self.reconfig_cycles,
        }
