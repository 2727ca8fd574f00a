"""Open-loop load bench of the PyTorch/CUDA port: latency vs offered load.

Counterpart of ``benchmarks/loadgen_bench.py``.  It drives the port's
``runtime/server.Engine`` OPEN-loop from seeded replayable traces
(``runtime/loadgen``) on the deterministic simulated clock and emits two
rows:

* ``openloop:sweep:<arch>`` -- a Poisson arrival sweep across offered
  load multiples of the model's estimated full-occupancy capacity, with
  p50/p95/p99 end-to-end latency and achieved throughput at each point,
  and the saturation KNEE: the first load point whose achieved
  throughput falls below 95% of offered;
* ``openloop:burst:<arch>`` -- one deadline'd bursty trace replayed
  through an unbounded engine and through a bounded one
  (``admission="shed"`` + ``drop_expired``), with the goodput
  (deadline-met completions/s) of each and the trace's sha256.

Every number in both rows lives in the simulated domain (trace clock and
cycle model), so the rows equal the JAX package's committed
``BENCH_serving.json`` rows exactly, on any device.  What the device
changes is which kernels serve the answers.  Capacity here is the
modelled VIKIN FPGA's, not the GPU's: ``chip_smoke.py`` phase 7 sizes its
wall-clock rates from the card instead.

Run (from the repository root, with ``PYTHONPATH=src``)::

    python -m repro_torch.benchmarks.loadgen_bench [--device cpu] [--out PATH]
    python -m repro_torch.benchmarks.loadgen_bench --device cpu --smoke

The rows are merged into ``--out`` (``chiprun_out/serving_bench.json`` by
default, shared with ``repro_torch.benchmarks.serving_bench``).
``--smoke`` writes nothing: a small bursty trace through a tightly
bounded engine must shed, respect the bound and drain.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

from repro_torch.benchmarks.serving_bench import merge_rows, seeded_params
from repro_torch.configs.vikin_models import VIKIN_ARCHS
from repro_torch.kernels.autotune import device_tag
from repro_torch.runtime.backends import VikinBackend
from repro_torch.runtime.loadgen import (
    Trace,
    bursty_trace,
    estimate_capacity_rps,
    poisson_trace,
    replay,
)
from repro_torch.runtime.server import Engine
from repro_torch.utils import resolve_device

#: offered load as multiples of estimated capacity; straddles 1.0 so the
#: sweep always exhibits a knee
LOAD_MULTS = (0.25, 0.5, 0.75, 0.9, 1.1, 1.5, 2.0)
KNEE_FRACTION = 0.95     # knee = first point with achieved < 0.95 x offered
#: the replay report fields a burst row keeps for each engine
BURST_FIELDS = (
    "completed", "deadline_met", "goodput_rps", "achieved_rps",
    "shed", "expired", "rejected", "deadline_misses",
    "queue_depth_hwm", "bound_respected",
    "p50_latency_s", "p95_latency_s", "p99_latency_s")


def warm_buckets(backend, n_slots: int) -> None:
    """``warmup`` (a ``VikinBackend`` or a ``MultiWorkloadBackend``) at
    every bucket a batch of up to ``n_slots`` requests can take, so no
    replay tick builds a kernel or resolves a knob."""
    n = 1
    while True:
        backend.warmup(n)
        if n >= n_slots:
            return
        n = min(2 * n, n_slots)


def _engine(arch: str, *, n_slots: int, device: str, seed: int = 0,
            **overload) -> Engine:
    model = VIKIN_ARCHS[arch]
    backend = VikinBackend(model, seeded_params(model, seed), device=device)
    warm_buckets(backend, n_slots)
    return Engine(backend, n_slots=n_slots, **overload)


def sweep_row(arch: str = "vikin-mlp3", *, n_slots: int = 8,
              events: int = 256, device: str = "cuda", seed: int = 0
              ) -> Dict:
    """Latency-vs-offered-load curve + saturation knee, unbounded engine."""
    cap = estimate_capacity_rps(VIKIN_ARCHS[arch], n_slots=n_slots)
    points = []
    knee: Optional[float] = None
    for mult in LOAD_MULTS:
        trace = poisson_trace(mult * cap, events, seed=seed)
        rep = replay(_engine(arch, n_slots=n_slots, device=device,
                             seed=seed), trace, mode="sim")
        saturated = rep["achieved_rps"] < KNEE_FRACTION * rep["offered_rps"]
        if saturated and knee is None:
            knee = mult
        points.append({
            "offered_mult": mult,
            "offered_rps": rep["offered_rps"],
            "achieved_rps": rep["achieved_rps"],
            "p50_latency_s": rep["p50_latency_s"],
            "p95_latency_s": rep["p95_latency_s"],
            "p99_latency_s": rep["p99_latency_s"],
            "queue_depth_hwm": rep["queue_depth_hwm"],
            "completed": rep["completed"],
            "trace_sha256": trace.sha256(),
        })
    return {
        "arch": arch,
        "n_slots": n_slots,
        "events_per_point": events,
        "seed": seed,
        "capacity_rps_estimate": cap,
        "knee_fraction": KNEE_FRACTION,
        "knee_offered_mult": knee,
        "points": points,
    }


def burst_trace(arch: str = "vikin-mlp3", *, n_slots: int = 8,
                events: int = 320, seed: int = 0
                ) -> Tuple[Trace, float, int]:
    """The burst row's trace, its deadline and the bounded engine's
    ``max_queue``.

    Adversarial by construction: bursts (5x capacity, mean dwell 48
    batch-times) grow an unbounded backlog far past what the 4-batch
    deadline can absorb, so the unbounded engine serves most of the burst
    dead while the bounded engine sheds it at admission."""
    cap = estimate_capacity_rps(VIKIN_ARCHS[arch], n_slots=n_slots)
    batch_s = n_slots / cap              # steady-state batch sim latency
    deadline = 4.0 * batch_s
    trace = bursty_trace(
        0.5 * cap, 5.0 * cap, events,
        mean_calm_s=16.0 * batch_s, mean_burst_s=48.0 * batch_s, seed=seed,
        priority_classes=[(0, 0.7, deadline), (2, 0.3, deadline)])
    return trace, deadline, 2 * n_slots


def burst_row(arch: str = "vikin-mlp3", *, n_slots: int = 8,
              events: int = 320, device: str = "cuda", seed: int = 0
              ) -> Dict:
    """Shed-vs-unbounded goodput under one deadline'd bursty trace."""
    trace, deadline, max_queue = burst_trace(arch, n_slots=n_slots,
                                             events=events, seed=seed)

    def run_one(**overload) -> Dict:
        eng = _engine(arch, n_slots=n_slots, device=device, seed=seed,
                      **overload)
        rep = replay(eng, trace, mode="sim")
        return {k: rep[k] for k in BURST_FIELDS}

    noshed = run_one()
    shed = run_one(max_queue=max_queue, admission="shed", drop_expired=True)
    return {
        "arch": arch,
        "n_slots": n_slots,
        "events": events,
        "seed": seed,
        "deadline_s": deadline,
        "max_queue": max_queue,
        "rate_lo_mult": 0.5,
        "rate_hi_mult": 5.0,
        "trace_sha256": trace.sha256(),
        "unbounded": noshed,
        "shed": shed,
        "goodput_gain": (shed["goodput_rps"]
                         / max(noshed["goodput_rps"], 1e-9)),
        "shed_beats_unbounded": (shed["goodput_rps"]
                                 > noshed["goodput_rps"]),
    }


def smoke(*, device: str = "cuda", arch: str = "vikin-small",
          events: int = 32, n_slots: int = 2, max_queue: int = 4,
          seed: int = 0) -> int:
    """Overload smoke: a small bursty trace through a tightly bounded
    engine must shed (the trace offers far more than capacity), must
    respect the bound at every tick, and must drain.  Prints PASS/FAIL
    lines and returns a process exit code; writes nothing."""
    cap = estimate_capacity_rps(VIKIN_ARCHS[arch], n_slots=n_slots)
    batch_s = n_slots / cap
    trace = bursty_trace(
        1.0 * cap, 6.0 * cap, events,
        mean_calm_s=8.0 * batch_s, mean_burst_s=24.0 * batch_s, seed=seed,
        priority_classes=[(0, 0.7, 4.0 * batch_s), (2, 0.3, 4.0 * batch_s)])
    eng = _engine(arch, n_slots=n_slots, device=device, seed=seed,
                  max_queue=max_queue, admission="shed", drop_expired=True)
    rep = replay(eng, trace, mode="sim")
    checks = {
        "queue bound respected at every tick": rep["bound_respected"],
        "nonzero sheds under overload": rep["shed"] > 0,
        "replay drained (no stall)": not rep["incomplete"],
        "some work still completed": rep["completed"] > 0,
    }
    print(f"[overload-smoke] {arch} on {device_tag(eng.backend.device)} "
          f"events={events} max_queue={max_queue}: "
          f"completed={rep['completed']} shed={rep['shed']} "
          f"expired={rep['expired']} hwm={rep['queue_depth_hwm']} "
          f"goodput={rep['goodput_rps']:.0f}")
    ok = True
    for name, passed in checks.items():
        print(f"  {'PASS' if passed else 'FAIL'}: {name}")
        ok &= bool(passed)
    return 0 if ok else 1


def run(device: str = "cuda", out: Optional[str | Path] = None, *,
        arch: str = "vikin-mlp3", n_slots: int = 8, sweep_events: int = 256,
        burst_events: int = 320, seed: int = 0) -> Dict[str, Dict]:
    """Emit both openloop rows, merged into ``out``."""
    tag = device_tag(resolve_device(device))
    rows = {
        f"openloop:sweep:{arch}": sweep_row(
            arch, n_slots=n_slots, events=sweep_events, device=device,
            seed=seed),
        f"openloop:burst:{arch}": burst_row(
            arch, n_slots=n_slots, events=burst_events, device=device,
            seed=seed),
    }
    for row in rows.values():
        row["device"] = tag
    path = merge_rows(rows, out)
    sw = rows[f"openloop:sweep:{arch}"]
    print(f"openloop:sweep:{arch}: capacity ~"
          f"{sw['capacity_rps_estimate']:.0f} req/s (modelled), knee at "
          f"{sw['knee_offered_mult']}x offered")
    for p in sw["points"]:
        print(f"  {p['offered_mult']:>5.2f}x: offered "
              f"{p['offered_rps']:>8.0f} achieved {p['achieved_rps']:>8.0f} "
              f"req/s, p50/p95/p99 {p['p50_latency_s']*1e6:.1f}/"
              f"{p['p95_latency_s']*1e6:.1f}/{p['p99_latency_s']*1e6:.1f} "
              f"us (sim), hwm {p['queue_depth_hwm']}")
    bu = rows[f"openloop:burst:{arch}"]
    print(f"openloop:burst:{arch}: unbounded goodput "
          f"{bu['unbounded']['goodput_rps']:.0f} -> shed "
          f"{bu['shed']['goodput_rps']:.0f} req/s "
          f"({bu['goodput_gain']:.2f}x, shed={bu['shed']['shed']}, "
          f"hwm {bu['shed']['queue_depth_hwm']} <= "
          f"max_queue {bu['max_queue']}, "
          f"bound_respected={bu['shed']['bound_respected']})")
    print(f"wrote {path} ({tag})")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    ap.add_argument("--out", default=None,
                    help="JSON output path (default "
                         "chiprun_out/serving_bench.json)")
    ap.add_argument("--arch", default="vikin-mlp3",
                    choices=sorted(VIKIN_ARCHS))
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--sweep-events", type=int, default=256)
    ap.add_argument("--burst-events", type=int, default=320)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="overload smoke (tiny bursty trace, asserts "
                         "bound + sheds + drain; writes nothing)")
    args = ap.parse_args()
    if args.smoke:
        sys.exit(smoke(device=args.device))
    run(args.device, args.out, arch=args.arch, n_slots=args.slots,
        sweep_events=args.sweep_events, burst_events=args.burst_events,
        seed=args.seed)


if __name__ == "__main__":
    main()
