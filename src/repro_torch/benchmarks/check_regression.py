"""The regression gate of the port's benches (counterpart of
``benchmarks/check_regression.py``).

It compares a fresh bench output of the port with a baseline and exits
non-zero beyond tolerance.  Only deterministic fields gate: simulated
cycles, DMA bytes, mode plans, the bitwise flags, the ``sched:`` row's
fifo-vs-mode-affinity ordering, and the ``openloop:*`` rows' knee, curve
and shed-vs-unbounded ordering (all on the simulated clock).  Wall-clock
fields (``wall_*``, wall ``*_rps``), ``val_mse`` and device names never
gate.

* ``--serving`` reads the port's rows (``repro_torch.benchmarks.
  serving_bench`` and ``loadgen_bench``; ``chiprun_out/serving_bench.json``
  by default, ``--fresh PATH``) and holds them against the JAX package's
  committed ``BENCH_serving.json`` (``--baseline PATH``), read only: the
  port reproduces those simulated rows exactly, so the default relative
  tolerance is 1e-9, and a simulated field moved by 1% fails.
* ``--kernels`` holds the port's ``kernel_bench`` output
  (``chiprun_out/kernel_bench.json`` by default) against a baseline the
  caller names with ``--baseline``: the port has no committed kernel
  baseline, and the JAX package's ``BENCH_kernels.json`` counts Pallas
  dispatches, not the port's launches.

Gates are registered in ``SERVING_GATES`` (one ``GateSpec`` per row-key
prefix) and a row dispatches to the longest prefix it starts with;
``--list-gates`` prints the registry as JSON.  The gate never writes a
``BENCH_*.json`` and never reads git.

Usage (from the repository root, with ``PYTHONPATH=src``)::

  python -m repro_torch.benchmarks.check_regression --serving [--fresh P]
  python -m repro_torch.benchmarks.check_regression --kernels --baseline P
  python -m repro_torch.benchmarks.check_regression --list-gates
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[3]
SERVING = "BENCH_serving.json"
KERNELS = "kernel_bench.json"
SERVING_BASELINE = ROOT / SERVING
SERVING_FRESH = ROOT / "chiprun_out" / "serving_bench.json"
KERNELS_FRESH = ROOT / "chiprun_out" / KERNELS
# the default relative tolerance of simulated fields: the port's cycle
# model is a copy of the reference's, so they agree to the last bit
RTOL = 1e-9

# kernels output: numeric leaves ending in one of these are oracle errors
# (gated by the drift rule); every other numeric leaf is a count/byte/op
# field and must match exactly.  Keys holding a skip substring never gate.
_ERR_KEYS = ("max_err", "max_err_v1", "max_err_v2", "oracle_max_err")
_SKIP_KEYS = ("wall_", "_rps", "val_mse", "time", "_ms", "device")


class Findings:
    """Structured gate results: one record per checked field.

    Passing checks are recorded alongside failures so the step summary
    (``step_summary``) can render EVERY gated field -- baseline vs fresh,
    drift, pass/fail -- while the stdout report lists the failures
    only.
    """

    def __init__(self) -> None:
        self.checks: List[Dict[str, Any]] = []

    def record(self, path: str, ok: bool, msg: str = "",
               base: Any = None, fresh: Any = None) -> None:
        self.checks.append({"path": path, "ok": bool(ok), "msg": msg,
                            "base": base, "fresh": fresh})

    def fail(self, path: str, msg: str,
             base: Any = None, fresh: Any = None) -> None:
        self.record(path, False, msg, base, fresh)

    def require(self, path: str, cond: bool, msg: str,
                base: Any = None, fresh: Any = None) -> bool:
        """Boolean gate: records the field either way, fails on False."""
        self.record(path, bool(cond), "" if cond else msg, base, fresh)
        return bool(cond)

    def eq(self, path: str, base: Any, fresh: Any,
           msg: Optional[str] = None) -> bool:
        return self.require(path, base == fresh,
                            msg or f"{base!r} -> {fresh!r}", base, fresh)

    @property
    def rows(self) -> List[str]:
        return [f"  {c['path']}: {c['msg']}"
                for c in self.checks if not c["ok"]]

    def report(self, label: str) -> bool:
        if self.rows:
            print(f"REGRESSION in {label}:")
            print("\n".join(self.rows))
            return False
        print(f"{label}: no regressions")
        return True


def _fmt_cell(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        return f"{v:g}"
    s = str(v)
    return s if len(s) <= 40 else s[:37] + "..."


def _drift_pct(base: Any, fresh: Any) -> str:
    if (isinstance(base, (int, float)) and not isinstance(base, bool)
            and isinstance(fresh, (int, float))
            and not isinstance(fresh, bool)):
        pct = (float(fresh) - float(base)) / max(abs(float(base)),
                                                 1e-12) * 100.0
        return f"{pct:+.3g}%"
    return ""


def step_summary(results: List[tuple]) -> None:
    """Append a markdown table of every gated field to
    ``$GITHUB_STEP_SUMMARY`` (one section per artifact) when it is set;
    a no-op otherwise."""
    path = os.environ.get("GITHUB_STEP_SUMMARY")
    if not path:
        return
    lines: List[str] = []
    for label, f in results:
        n_fail = sum(1 for c in f.checks if not c["ok"])
        verdict = "PASS" if n_fail == 0 else f"FAIL ({n_fail} regressions)"
        lines.append(f"## Bench gate: `{label}` — {verdict}")
        lines.append("")
        lines.append("| field | baseline | fresh | drift | status |")
        lines.append("|---|---|---|---|---|")
        for c in f.checks:
            status = "✅" if c["ok"] else f"❌ {_fmt_cell(c['msg'])}"
            lines.append(
                f"| `{c['path']}` | {_fmt_cell(c['base'])} "
                f"| {_fmt_cell(c['fresh'])} "
                f"| {_drift_pct(c['base'], c['fresh'])} | {status} |")
        lines.append("")
    with open(path, "a") as fh:
        fh.write("\n".join(lines) + "\n")


def _close(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-12)


# ---------------------------------------------------------------------------
# Kernels artifact: generic walk over the committed structure.
# ---------------------------------------------------------------------------


def check_kernels(base: Any, fresh: Any, f: Findings, *, err_factor: float,
                  err_floor: float, path: str = "") -> None:
    if isinstance(base, dict):
        if not isinstance(fresh, dict):
            f.fail(path, f"expected object, got {type(fresh).__name__}")
            return
        for k, bv in base.items():
            if any(s in k for s in _SKIP_KEYS):
                continue
            if k not in fresh:
                f.fail(f"{path}.{k}", "missing from fresh artifact "
                       "(bench coverage regression)")
                continue
            check_kernels(bv, fresh[k], f, err_factor=err_factor,
                          err_floor=err_floor, path=f"{path}.{k}")
        return
    if isinstance(base, list):
        if not isinstance(fresh, list) or len(fresh) != len(base):
            f.fail(path, f"expected a list of {len(base)}, got {fresh!r}")
            return
        for i, (bv, fv) in enumerate(zip(base, fresh)):
            check_kernels(bv, fv, f, err_factor=err_factor,
                          err_floor=err_floor, path=f"{path}[{i}]")
        return
    key = path.rsplit(".", 1)[-1].split("[", 1)[0]
    if isinstance(base, (int, float)) and not isinstance(base, bool):
        if key in _ERR_KEYS or key.startswith("max_err"):
            # oracle error may wiggle with compiler version; gate on
            # order-of-magnitude drift, not bit equality
            lim = max(err_factor * float(base), err_floor)
            f.require(path, float(fresh) <= lim,
                      f"oracle error {fresh:g} exceeds {lim:g} "
                      f"(baseline {base:g} x{err_factor:g})", base, fresh)
        else:
            f.require(path, _close(float(base), float(fresh), 1e-9),
                      f"count/op field changed: {base!r} -> {fresh!r}",
                      base, fresh)
    else:
        f.eq(path, base, fresh)


# ---------------------------------------------------------------------------
# Serving rows: one rule per row kind (rows may be emitted at other request
# or step counts than the baseline's, so only per-request-normalized and
# structural fields compare).  Each kind is a ``GateSpec`` in
# ``SERVING_GATES``.
# ---------------------------------------------------------------------------


def _cmp(f: Findings, path: str, base: float, fresh: Any,
         rtol: float) -> None:
    if fresh is None:
        f.fail(path, "missing from fresh artifact", base, fresh)
    else:
        f.require(path, _close(float(base), float(fresh), rtol),
                  f"sim drift: {base:g} -> {fresh:g} (rtol {rtol:g})",
                  base, fresh)


GateFn = Callable[..., None]


@dataclasses.dataclass(frozen=True)
class GateSpec:
    """One serving-row gate: a row-key prefix and the check it dispatches.

    ``prefix=""`` is the default gate for unprefixed rows (plain arch
    names).  ``what`` is the human/machine-readable summary surfaced by
    ``--list-gates``.
    """

    prefix: str
    what: str
    check: GateFn


def _gate_sched(f: Findings, name: str, b: Dict, r: Dict,
                *, rtol: float) -> None:
    """Multi-workload scheduler row: count-independent deterministic
    fields, plus the ordering claims the row exists to pin --
    mode-affinity must strictly beat fifo on reconfiguration and never
    pay for it in per-request cycles, with outputs bitwise identical to
    single-request serving under BOTH policies.  (The row may be emitted
    at another request count, so the per-request reconfig amortization
    itself cannot gate; the flip STRUCTURE can: fifo flips once per
    request boundary, affinity a fixed number of times per run.)
    """
    f.require(f"{name}.bitwise_identical",
              r.get("bitwise_identical") is True,
              "scheduled batched outputs no longer bitwise-"
              "identical to single-request serving",
              True, r.get("bitwise_identical"))
    for pol in ("fifo", "mode-affinity"):
        bp = b["policies"][pol]
        rp = r.get("policies", {}).get(pol, {})
        _cmp(f, f"{name}.{pol}.sim_cycles_per_req",
             bp["sim_cycles_per_req"],
             rp.get("sim_cycles_per_req"), rtol)
    rf = r.get("policies", {}).get("fifo", {})
    ra = r.get("policies", {}).get("mode-affinity", {})
    b_ratio = (b["policies"]["fifo"]["mode_switches"]
               / max(b["requests"] - 1, 1))
    r_ratio = (rf.get("mode_switches", 0)
               / max(r.get("requests", 1) - 1, 1))
    _cmp(f, f"{name}.fifo.mode_switches_per_boundary",
         b_ratio, r_ratio, rtol)
    f.eq(f"{name}.mode-affinity.mode_switches",
         b["policies"]["mode-affinity"]["mode_switches"],
         ra.get("mode_switches"),
         f"{b['policies']['mode-affinity']['mode_switches']}"
         f" -> {ra.get('mode_switches')} (count-independent "
         f"total flips per run)")
    f.require(f"{name}.reconfig_cycles",
              (ra.get("reconfig_cycles", float("inf"))
               < rf.get("reconfig_cycles", 0)),
              f"mode-affinity ({ra.get('reconfig_cycles')}) no "
              f"longer strictly below fifo "
              f"({rf.get('reconfig_cycles')})",
              rf.get("reconfig_cycles"), ra.get("reconfig_cycles"))
    f.require(f"{name}.sim_cycles_per_req",
              (ra.get("sim_cycles_per_req", float("inf"))
               <= rf.get("sim_cycles_per_req", 0.0) * (1 + rtol)),
              f"mode-affinity ({ra.get('sim_cycles_per_req')}) "
              f"exceeds fifo ({rf.get('sim_cycles_per_req')})",
              rf.get("sim_cycles_per_req"),
              ra.get("sim_cycles_per_req"))


def _gate_openloop_sweep(f: Findings, name: str, b: Dict, r: Dict,
                         *, rtol: float) -> None:
    """Open-loop latency-vs-load sweep (DESIGN.md Sec. 15).  The whole
    row lives in the simulated domain (trace clock + cycle model), so it
    is machine-independent: the knee and the per-point curve gate at
    tight tolerance, and the trace sha256 pins that the same arrivals
    were replayed.  The *_rps fields here are sim-clock figures, not
    wall clock -- they gate, unlike every wall *_rps elsewhere.
    """
    f.eq(f"{name}.knee_offered_mult", b["knee_offered_mult"],
         r.get("knee_offered_mult"),
         f"saturation knee moved: {b['knee_offered_mult']} "
         f"-> {r.get('knee_offered_mult')}")
    bp, rp = b["points"], r.get("points", [])
    if len(rp) != len(bp):
        f.fail(f"{name}.points",
               f"{len(bp)} load points -> {len(rp)}")
        return
    for i, (pb, pr) in enumerate(zip(bp, rp)):
        pfx = f"{name}.points[{i}]"
        f.eq(f"{pfx}.offered_mult", pb["offered_mult"],
             pr.get("offered_mult"))
        f.require(f"{pfx}.trace_sha256",
                  pr.get("trace_sha256") == pb["trace_sha256"],
                  "replayed trace differs from baseline")
        for k in ("achieved_rps", "p50_latency_s",
                  "p95_latency_s", "p99_latency_s"):
            _cmp(f, f"{pfx}.{k}", pb[k], pr.get(k), rtol)


def _gate_openloop_burst(f: Findings, name: str, b: Dict, r: Dict,
                         *, rtol: float) -> None:
    """Deadline'd burst trace: shedding must yield STRICTLY higher
    goodput than the unbounded baseline on the same arrivals, with the
    queue bound respected at every tick.
    """
    f.require(f"{name}.trace_sha256",
              r.get("trace_sha256") == b["trace_sha256"],
              "replayed trace differs from baseline")
    f.eq(f"{name}.max_queue", b["max_queue"], r.get("max_queue"))
    rs = r.get("shed", {})
    f.require(f"{name}.shed.bound_respected",
              rs.get("bound_respected") is True,
              "queue depth exceeded max_queue during replay",
              True, rs.get("bound_respected"))
    f.require(f"{name}.shed.shed", rs.get("shed", 0) > 0,
              "overload trace no longer triggers shedding",
              b["shed"]["shed"], rs.get("shed"))
    good_u = r.get("unbounded", {}).get("goodput_rps", 0.0)
    good_s = rs.get("goodput_rps", 0.0)
    f.require(f"{name}.goodput_rps", good_s > good_u,
              f"shed goodput ({good_s:g}) no longer strictly "
              f"above unbounded ({good_u:g})", good_u, good_s)
    for side in ("unbounded", "shed"):
        _cmp(f, f"{name}.{side}.goodput_rps",
             b[side]["goodput_rps"],
             r.get(side, {}).get("goodput_rps"), rtol)
        f.eq(f"{name}.{side}.deadline_met",
             b[side]["deadline_met"],
             r.get(side, {}).get("deadline_met"))
    _cmp(f, f"{name}.goodput_gain", b["goodput_gain"],
         r.get("goodput_gain"), rtol)


def _gate_pipe(f: Findings, name: str, b: Dict, r: Dict,
               *, rtol: float) -> None:
    """Pipeline-parallel vs data-parallel row (DESIGN.md Sec. 18).
    Everything gated here is analytical (the batch sweep comes from the
    cycle model at fixed batch sizes) or structural, so it is
    request-count independent; the SERVED per-request figures in the
    single/pipeline legs are informational only (their batch split depends
    on the request count).
    """
    f.eq(f"{name}.devices", b["devices"], r.get("devices"))
    f.eq(f"{name}.n_stages", b["n_stages"], r.get("n_stages"))
    f.eq(f"{name}.stage_sizes", b["stage_sizes"],
         r.get("stage_sizes"))
    f.require(f"{name}.bitwise_identical",
              r.get("bitwise_identical") is True,
              "pipeline-staged outputs no longer bitwise-"
              "identical to single-device serving",
              True, r.get("bitwise_identical"))
    f.require(f"{name}.pipeline_wins_at_batch_1",
              r.get("pipeline_wins_at_batch_1") is True,
              "per-stage DMA setup no longer beats data-parallel "
              "at batch 1", True,
              r.get("pipeline_wins_at_batch_1"))
    f.eq(f"{name}.crossover_batch", b["crossover_batch"],
         r.get("crossover_batch"),
         f"pipeline/data crossover moved: {b['crossover_batch']} "
         f"-> {r.get('crossover_batch')}")
    _cmp(f, f"{name}.bubble_cycles", b["bubble_cycles"],
         r.get("bubble_cycles"), rtol)
    _cmp(f, f"{name}.bubble_bound_cycles", b["bubble_bound_cycles"],
         r.get("bubble_bound_cycles"), rtol)
    f.require(f"{name}.bubble_within_bound",
              r.get("bubble_within_bound") is True,
              "fill/drain bubble exceeds the closed-form "
              "(stages-1)*stage_time bound",
              True, r.get("bubble_within_bound"))
    for k in ("data_reconfig_cycles_per_req",
              "pipeline_reconfig_cycles_per_req"):
        _cmp(f, f"{name}.{k}", b[k], r.get(k), rtol)
    bp, rp = b["sweep"], r.get("sweep", [])
    if len(rp) != len(bp):
        f.fail(f"{name}.sweep",
               f"{len(bp)} sweep points -> {len(rp)}")
        return
    for i, (pb, pr) in enumerate(zip(bp, rp)):
        pfx = f"{name}.sweep[{i}]"
        f.eq(f"{pfx}.batch", pb["batch"], pr.get("batch"))
        for k in ("data_cycles", "pipeline_cycles",
                  "pipeline_over_data"):
            _cmp(f, f"{pfx}.{k}", pb[k], pr.get(k), rtol)


def _gate_hetero(f: Findings, name: str, b: Dict, r: Dict,
                 *, rtol: float) -> None:
    """Heterogeneous mode-pinning row (DESIGN.md Sec. 18).  The headline
    claim -- pinned chips drive reconfiguration to zero on the mixed
    stream without adding batching delay -- gates exactly; served
    per-request cycles do not (the multi-workload batch split depends on
    the request count).
    """
    f.eq(f"{name}.devices", b["devices"], r.get("devices"))
    f.eq(f"{name}.mode_pins", b["mode_pins"], r.get("mode_pins"))
    f.eq(f"{name}.archs", b["archs"], r.get("archs"))
    f.require(f"{name}.bitwise_identical",
              r.get("bitwise_identical") is True,
              "mode-pinned outputs no longer bitwise-identical "
              "to single-device serving",
              True, r.get("bitwise_identical"))
    f.require(f"{name}.reconfig_cycles_hetero",
              r.get("reconfig_cycles_hetero") == 0,
              f"pinned chips pay reconfiguration again: "
              f"{r.get('reconfig_cycles_hetero')} cycles (must "
              f"be exactly 0)", 0, r.get("reconfig_cycles_hetero"))
    _cmp(f, f"{name}.reconfig_cycles_affinity",
         b["reconfig_cycles_affinity"],
         r.get("reconfig_cycles_affinity"), rtol)
    f.eq(f"{name}.affinity_single_chip.mode_switches",
         b["affinity_single_chip"]["mode_switches"],
         r.get("affinity_single_chip", {}).get("mode_switches"),
         "count-independent total flips per run changed")
    f.require(f"{name}.hetero_pinned.mode_switches",
              (r.get("hetero_pinned", {}).get("mode_switches")
               == 0),
              "pinned chips flip modes (must be exactly 0)",
              0, r.get("hetero_pinned", {}).get("mode_switches"))
    f.require(f"{name}.no_added_batching_delay",
              r.get("no_added_batching_delay") is True,
              "mode-pinned placement now queues requests longer "
              "than single-chip mode-affinity",
              True, r.get("no_added_batching_delay"))


def _gate_sharded(f: Findings, name: str, b: Dict, r: Dict,
                  *, rtol: float) -> None:
    """Multi-device data-parallel row: the bitwise single==multi
    identity flag, per-request cycle figures, and the array-level cycle
    speedup."""
    f.eq(f"{name}.devices", b["devices"], r.get("devices"))
    f.require(f"{name}.bitwise_identical",
              r.get("bitwise_identical") is True,
              "multi-device outputs no longer bitwise-identical "
              "to single-device",
              True, r.get("bitwise_identical"))
    for side in ("single", "multi"):
        for k, bv in b[side].items():
            if "cycles_per_req" in k:
                _cmp(f, f"{name}.{side}.{k}", bv,
                     r.get(side, {}).get(k), rtol)
    _cmp(f, f"{name}.array_cycle_speedup", b["array_cycle_speedup"],
         r.get("array_cycle_speedup"), rtol)


def _gate_quant(f: Findings, name: str, b: Dict, r: Dict,
                *, rtol: float) -> None:
    """Int8 quantized serving row (DESIGN.md Sec. 16): the gated fields
    are count-independent -- per-request cycles and the analytical
    batch=1 DMA bytes from the precision-aware cycle model -- plus the
    row's structural claims: int8 DMA must stay at <= half the f32
    bytes, batched int8 serving must stay bitwise identical to
    single-request serving, and the fresh (training-dependent) mse_ratio
    must stay under the committed bound.  The measured mse itself never
    gates (it depends on the training run).
    """
    for side in ("dense", "int8"):
        for k in ("sim_cycles_per_req", "dma_bytes_per_req"):
            _cmp(f, f"{name}.{side}.{k}", b[side][k],
                 r.get(side, {}).get(k), rtol)
    _cmp(f, f"{name}.dma_ratio", b["dma_ratio"],
         r.get("dma_ratio"), rtol)
    f.require(f"{name}.dma_ratio<=0.5",
              r.get("dma_ratio", 1.0) <= 0.5,
              f"int8 DMA bytes ({r.get('dma_ratio')}x f32) no "
              f"longer <= 0.5x the f32 baseline",
              0.5, r.get("dma_ratio"))
    f.eq(f"{name}.mse_ratio_bound", b["mse_ratio_bound"],
         r.get("mse_ratio_bound"),
         f"committed bound changed: {b['mse_ratio_bound']} "
         f"-> {r.get('mse_ratio_bound')}")
    f.require(f"{name}.mse_ratio",
              (r.get("mse_ratio", float("inf"))
               <= b["mse_ratio_bound"]),
              f"int8 served mse ratio {r.get('mse_ratio')} "
              f"exceeds the committed bound "
              f"{b['mse_ratio_bound']}",
              b["mse_ratio_bound"], r.get("mse_ratio"))
    f.require(f"{name}.batched_equals_single",
              r.get("batched_equals_single") is True,
              "int8 batched serving no longer bitwise-identical "
              "to single-request serving",
              True, r.get("batched_equals_single"))
    f.eq(f"{name}.mask_keep_rates", b["mask_keep_rates"],
         r.get("mask_keep_rates"))


def _gate_kanffn(f: Findings, name: str, b: Dict, r: Dict,
                 *, rtol: float) -> None:
    """KAN-FFN transformer serving row (DESIGN.md Sec. 17): every gated
    field is the analytical batch=1 per-request figure
    (count-independent), plus the hybrid's mode-plan flip structure and
    the engine determinism flag.
    """
    for side in ("dense_mlp", "kanffn"):
        for k in ("sim_cycles_per_req", "dma_bytes_per_req"):
            _cmp(f, f"{name}.{side}.{k}", b[side][k],
                 r.get(side, {}).get(k), rtol)
    for k in ("cycle_ratio", "dma_ratio"):
        _cmp(f, f"{name}.{k}", b[k], r.get(k), rtol)
    kb, kr = b["kanffn"], r.get("kanffn", {})
    f.eq(f"{name}.kanffn.mode_plan", kb["mode_plan"],
         kr.get("mode_plan"))
    f.eq(f"{name}.kanffn.mode_switches_per_req",
         kb["mode_switches_per_req"],
         kr.get("mode_switches_per_req"),
         f"{kb['mode_switches_per_req']} -> "
         f"{kr.get('mode_switches_per_req')} "
         f"(count-independent flips per model instance)")
    f.eq(f"{name}.ffn_kinds", b["ffn_kinds"], r.get("ffn_kinds"))
    f.require(f"{name}.batched_equals_single",
              r.get("batched_equals_single") is True,
              "batched kan-ffn decode no longer token-exact "
              "against single-request serving",
              True, r.get("batched_equals_single"))


def _gate_trained(f: Findings, name: str, b: Dict, r: Dict,
                  *, rtol: float) -> None:
    """Trained-then-pruned serving row: dense-vs-sparse per-request
    cycles, the cycle speedup, and the committed mask keep rates."""
    for side in ("dense", "sparse"):
        _cmp(f, f"{name}.{side}.sim_cycles_per_req",
             b[side]["sim_cycles_per_req"],
             r.get(side, {}).get("sim_cycles_per_req"), rtol)
    _cmp(f, f"{name}.cycle_speedup", b["cycle_speedup"],
         r.get("cycle_speedup"), rtol)
    f.eq(f"{name}.mask_keep_rates", b["mask_keep_rates"],
         r.get("mask_keep_rates"))


def _gate_default(f: Findings, name: str, b: Dict, r: Dict,
                  *, rtol: float) -> None:
    """Unprefixed arch rows: per-request simulated cycles, the mode
    plan, and per-request mode-switch rate."""
    _cmp(f, f"{name}.sim_cycles_per_req", b["sim_cycles_per_req"],
         r.get("sim_cycles_per_req"), rtol)
    f.eq(f"{name}.mode_plan", b["mode_plan"], r.get("mode_plan"))
    b_sw = b["mode_switches"] / max(b["requests"], 1)
    r_sw = r.get("mode_switches", 0) / max(r.get("requests", 1), 1)
    _cmp(f, f"{name}.mode_switches_per_req", b_sw, r_sw, rtol)


# The "" entry is the default gate, so every serving row dispatches
# somewhere; ``gate_for`` picks the longest matching prefix.
SERVING_GATES: Tuple[GateSpec, ...] = (
    GateSpec("sched:", "scheduler policy ordering + bitwise identity",
             _gate_sched),
    GateSpec("openloop:sweep:", "open-loop latency/load curve + knee",
             _gate_openloop_sweep),
    GateSpec("openloop:burst:", "burst shedding goodput ordering",
             _gate_openloop_burst),
    GateSpec("pipe:", "pipeline-vs-data crossover + bubble bound",
             _gate_pipe),
    GateSpec("hetero:", "hetero mode-pinning zero-reconfig claims",
             _gate_hetero),
    GateSpec("sharded:", "multi-device bitwise identity + speedup",
             _gate_sharded),
    GateSpec("quant:", "int8 DMA ratio + mse bound + bitwise identity",
             _gate_quant),
    GateSpec("kanffn:", "KAN-FFN cycle/DMA ratios + mode plan",
             _gate_kanffn),
    GateSpec("trained:", "trained sparse cycle speedup + keep rates",
             _gate_trained),
    GateSpec("", "per-arch sim cycles + mode plan (default gate)",
             _gate_default),
)

# Row-key prefixes the baseline must carry, or their gate silently
# vanishes: the reference's committed file has every one.
REQUIRED_BASELINE_PREFIXES: Tuple[Tuple[str, str], ...] = tuple(
    (pfx, f"no {pfx}* rows in the baseline; hold the port against the "
          f"JAX package's committed {SERVING}")
    for pfx in ("sharded:", "openloop:", "pipe:", "hetero:"))


def gate_for(name: str) -> GateSpec:
    """The registered gate with the longest prefix ``name`` starts with
    (the "" default gate matches every row)."""
    return max((s for s in SERVING_GATES if name.startswith(s.prefix)),
               key=lambda s: len(s.prefix))


def gate_manifest() -> Dict[str, Any]:
    """The ``--list-gates`` payload: every serving gate (``default_gated``:
    unprefixed rows fall through to a real gate) and the kernels walk."""
    return {
        SERVING: {
            "gates": [{"prefix": s.prefix, "what": s.what,
                       "check": s.check.__name__}
                      for s in SERVING_GATES],
            "default_gated": any(s.prefix == "" for s in SERVING_GATES),
            "required_baseline_prefixes":
                [p for p, _ in REQUIRED_BASELINE_PREFIXES],
        },
        KERNELS: {
            "all_rows_gated": True,
            "what": "generic structural walk: every baseline numeric "
                    "leaf gates (exact for counts, drift-bounded for "
                    "oracle errors)",
            "skip_substrings": list(_SKIP_KEYS),
            "err_suffixes": list(_ERR_KEYS),
        },
    }


def check_serving(base: Dict, fresh: Dict, f: Findings,
                  *, rtol: float) -> None:
    for pfx, msg in REQUIRED_BASELINE_PREFIXES:
        if not any(n.startswith(pfx) for n in base):
            f.fail(f"{pfx}*", msg)
    for name, b in base.items():
        if name not in fresh:
            f.fail(name, "row missing from the fresh output (bench coverage "
                         "regression); run repro_torch.benchmarks."
                         "serving_bench and loadgen_bench into it")
            continue
        gate_for(name).check(f, name, b, fresh[name], rtol=rtol)


def _load(path: str | Path, what: str) -> Any:
    try:
        return json.loads(Path(path).read_text())
    except OSError as e:
        raise SystemExit(f"cannot read the {what} {path}: {e}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serving", action="store_true",
                    help=f"gate the port's serving rows against {SERVING}")
    ap.add_argument("--kernels", action="store_true",
                    help="gate the port's kernel_bench output against "
                         "--baseline")
    ap.add_argument("--fresh", default=None,
                    help=f"the fresh output (default {SERVING_FRESH} with "
                         f"--serving, {KERNELS_FRESH} with --kernels)")
    ap.add_argument("--baseline", default=None,
                    help=f"the baseline (--serving: default the JAX "
                         f"package's committed {SERVING_BASELINE}; "
                         f"--kernels: required)")
    ap.add_argument("--rtol", type=float, default=RTOL,
                    help="relative tolerance on simulated fields")
    ap.add_argument("--err-factor", type=float, default=4.0,
                    help="allowed oracle-error growth factor")
    ap.add_argument("--err-floor", type=float, default=1e-6,
                    help="oracle errors below this never gate")
    ap.add_argument("--list-gates", action="store_true",
                    help="print the gate registry as JSON and exit")
    args = ap.parse_args(argv)
    if args.list_gates:
        json.dump(gate_manifest(), sys.stdout, indent=2)
        sys.stdout.write("\n")
        return 0
    if args.serving == args.kernels:
        ap.error("pass one of --serving and --kernels")
    f = Findings()
    if args.serving:
        label = SERVING
        check_serving(_load(args.baseline or SERVING_BASELINE, "baseline"),
                      _load(args.fresh or SERVING_FRESH, "fresh output"),
                      f, rtol=args.rtol)
    else:
        if args.baseline is None:
            raise SystemExit(
                "--kernels needs --baseline PATH: the port has no committed "
                "kernel baseline, and the JAX package's BENCH_kernels.json "
                "counts Pallas dispatches, not the port's launches; pass a "
                "kernel_bench JSON of the port (a parent's run on the same "
                "card)")
        label = KERNELS
        check_kernels(_load(args.baseline, "baseline"),
                      _load(args.fresh or KERNELS_FRESH, "fresh output"), f,
                      err_factor=args.err_factor, err_floor=args.err_floor,
                      path=KERNELS)
    ok = f.report(label)
    step_summary([(label, f)])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
