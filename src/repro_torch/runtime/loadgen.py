"""Trace-driven open-loop load harness for the serving engine.

Counterpart of ``repro/runtime/loadgen.py``, host-side numpy copied
as is: a trace generated here serializes to the same bytes, and so the
same sha256, as the JAX package's for the same arguments, which is what
proves that two runs, in either package, replayed the same arrivals.

A closed loop (submit a burst, drain it) can never overload the engine:
arrivals wait for completions, so it measures neither the
latency-vs-offered-load curve nor the saturation knee, and it never
exercises admission control.  This module drives
``runtime/server.Engine`` OPEN-loop: a seeded, serializable arrival trace
carries its own clock, and requests arrive on that clock whether or not
the engine is keeping up.

Traces
------
A ``Trace`` is a list of ``TraceEvent`` (arrival time, workload, priority,
deadline, payload seed) plus generator metadata.  Generators are seeded
(`numpy.random.default_rng`) and traces serialize to canonical JSON
(``Trace.to_json`` / ``from_json`` round-trips bit-for-bit; ``sha256()``
fingerprints a trace so a bench row can PROVE two runs replayed the same
arrivals).  Shipped arrival processes:

* ``poisson_trace``  -- memoryless arrivals at a constant rate.
* ``bursty_trace``   -- Markov-modulated Poisson: exponential calm/burst
  dwell times, each state with its own rate.  The adversarial shape for
  bounded queues: the mean load can be sustainable while bursts are not.

Both accept workload and priority/deadline class mixes, so one trace can
describe a mixed-arch population with per-class SLOs.

Replay clocks
-------------
``replay(engine, trace, mode="sim")`` swaps the engine's clock for a
``SimClock``: trace time = the engine's accumulated simulated batch
latency (``stats["sim_latency_s"]``) plus explicit idle jumps to the next
arrival.  Every timestamp, deadline check and scheduling decision then
lives in the deterministic simulated domain -- identical trace + identical
model => bit-identical replay on any machine and on any torch device.
``mode="wall"`` replays against the real clock (sleeping through idle
gaps).  Arrivals are observed at tick granularity;
``submit(..., t_submit=event.t)`` backdates the stamp so queue-wait and
deadlines count from the trace arrival, not the tick boundary that first
saw it.  In wall mode a late wake-up from ``time.sleep`` and the
synchronizing copy at the end of each served batch therefore count in
the latency, as they do for a real client.

Generate a trace file (``--arch`` sizes the rate against the modelled
VIKIN capacity, not a GPU's):

  PYTHONPATH=src python -m repro_torch.runtime.loadgen --kind bursty \
      --arch vikin-mlp3 --load 1.5 --deadline 5e-4 --out /tmp/t.json
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.vikin_models import VIKIN_ARCHS
from repro_torch.core.engine import VikinHW, serving_report
from repro_torch.runtime.server import AdmissionError, _percentile

# (priority, weight, deadline_s-or-None): one entry per request class
PriorityClass = Tuple[int, float, Optional[float]]


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One arrival: at ``t`` seconds (trace clock), a request for
    ``workload`` with the given SLO class; ``seed`` synthesizes its
    payload deterministically at replay time."""

    t: float
    workload: Optional[str] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    seed: int = 0


@dataclasses.dataclass
class Trace:
    """An arrival trace: events sorted by time + generator metadata."""

    events: List[TraceEvent]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def horizon_s(self) -> float:
        """Last arrival time (the offered-load window)."""
        return self.events[-1].t if self.events else 0.0

    def offered_rps(self) -> float:
        return len(self.events) / self.horizon_s if self.horizon_s else 0.0

    # -- canonical JSON: the replayability contract ---------------------
    def to_json(self) -> str:
        payload = {
            "meta": self.meta,
            "events": [[e.t, e.workload, e.priority, e.deadline_s, e.seed]
                       for e in self.events],
        }
        return json.dumps(payload, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        obj = json.loads(text)
        return cls(events=[TraceEvent(t, w, int(p), d, int(s))
                           for t, w, p, d, s in obj["events"]],
                   meta=obj.get("meta", {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_json(f.read())

    def sha256(self) -> str:
        """Fingerprint of the canonical serialization: two runs quoting
        the same hash provably replayed the same arrivals."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()


def _attach_classes(ts: Sequence[float], rng: np.random.Generator,
                    workloads: Optional[Sequence[Tuple[Optional[str], float]]],
                    priority_classes: Optional[Sequence[PriorityClass]],
                    ) -> List[TraceEvent]:
    """Stamp each arrival time with a workload / SLO class draw and a
    payload seed, all from the one generator stream."""
    wl = list(workloads) if workloads else [(None, 1.0)]
    pc = list(priority_classes) if priority_classes else [(0, 1.0, None)]
    wp = np.array([w for _, w in wl], float)
    pp = np.array([w for _, w, _ in pc], float)
    wp, pp = wp / wp.sum(), pp / pp.sum()
    events = []
    for t in ts:
        wi = int(rng.choice(len(wl), p=wp))
        ci = int(rng.choice(len(pc), p=pp))
        prio, _, deadline = pc[ci]
        events.append(TraceEvent(float(t), wl[wi][0], int(prio), deadline,
                                 int(rng.integers(0, 2**31))))
    return events


def poisson_trace(rate_rps: float, n_events: int, *, seed: int = 0,
                  workloads: Any = None,
                  priority_classes: Any = None) -> Trace:
    """Memoryless arrivals at ``rate_rps`` (exponential inter-arrivals)."""
    if rate_rps <= 0 or n_events < 1:
        raise ValueError("poisson_trace needs rate_rps > 0 and n_events >= 1")
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.exponential(1.0 / rate_rps, size=n_events))
    return Trace(
        events=_attach_classes(ts, rng, workloads, priority_classes),
        meta={"kind": "poisson", "rate_rps": rate_rps,
              "n_events": n_events, "seed": seed})


def bursty_trace(rate_lo_rps: float, rate_hi_rps: float, n_events: int, *,
                 mean_calm_s: float, mean_burst_s: float, seed: int = 0,
                 workloads: Any = None,
                 priority_classes: Any = None) -> Trace:
    """Markov-modulated Poisson arrivals: calm periods at ``rate_lo_rps``
    and bursts at ``rate_hi_rps``, with exponential dwell times.  State
    flips are memoryless, so discarding the partial inter-arrival gap at
    a flip keeps the process exact."""
    if min(rate_lo_rps, rate_hi_rps) <= 0 or n_events < 1:
        raise ValueError("bursty_trace needs positive rates and n_events")
    if min(mean_calm_s, mean_burst_s) <= 0:
        raise ValueError("bursty_trace needs positive mean dwell times")
    rng = np.random.default_rng(seed)
    ts: List[float] = []
    t, burst = 0.0, False
    state_end = rng.exponential(mean_calm_s)
    while len(ts) < n_events:
        gap = rng.exponential(1.0 / (rate_hi_rps if burst else rate_lo_rps))
        if t + gap > state_end:
            t = state_end
            burst = not burst
            state_end = t + rng.exponential(
                mean_burst_s if burst else mean_calm_s)
            continue
        t += gap
        ts.append(t)
    return Trace(
        events=_attach_classes(ts, rng, workloads, priority_classes),
        meta={"kind": "bursty", "rate_lo_rps": rate_lo_rps,
              "rate_hi_rps": rate_hi_rps, "mean_calm_s": mean_calm_s,
              "mean_burst_s": mean_burst_s, "n_events": n_events,
              "seed": seed})


# ---------------------------------------------------------------------------
# Clocks + capacity estimate.
# ---------------------------------------------------------------------------


class SimClock:
    """Deterministic trace-time clock: the engine's accumulated simulated
    batch latency plus idle jumps.  While a batch executes, the engine's
    ``batch_report`` advances ``stats["sim_latency_s"]``, so a completion
    stamped after the report lands at the batch's simulated END; while the
    engine is idle, ``jump_to`` fast-forwards to the next arrival."""

    def __init__(self, engine: Any) -> None:
        self.engine = engine
        self._idle = 0.0

    def now(self) -> float:
        return self._idle + self.engine.stats["sim_latency_s"]

    def jump_to(self, t: float) -> None:
        cur = self.now()
        if t > cur:
            self._idle += t - cur


def estimate_capacity_rps(model: Any, *, n_slots: int = 8,
                          hw: Any = None) -> float:
    """Steady-state completions per simulated second at full occupancy,
    from the cycle model alone (no weights, no device): back-to-back
    batches of ``n_slots`` with the mode carried over between them."""
    hw = hw or VikinHW()
    layers = model.layer_works()
    cold = serving_report(layers, hw, batch=n_slots)
    steady = serving_report(layers, hw, batch=n_slots,
                            prev_mode=cold.get("exit_mode"))
    return n_slots / steady["sim_latency_s"]


# ---------------------------------------------------------------------------
# Open-loop replay.
# ---------------------------------------------------------------------------


def _percentiles(xs: List[float]) -> Dict[str, float]:
    s = sorted(xs)
    return {f"p{q}_latency_s": _percentile(s, q) for q in (50, 95, 99)}


def _payload(engine: Any, ev: TraceEvent, multi: bool) -> np.ndarray:
    dim = engine.backend.input_dim(ev.workload if multi else None)
    return np.random.default_rng(ev.seed).random(dim, dtype=np.float32)


def replay(engine: Any, trace: Trace, *, mode: str = "sim",
           max_ticks: int = 1_000_000) -> Dict[str, object]:
    """Drive ``engine`` open-loop through ``trace``; returns a report.

    Arrivals are submitted the moment the engine clock passes their trace
    time -- queue state does NOT gate them, so offered load lands on the
    admission policy exactly as generated.  After the last arrival the
    engine drains (bounded by ``max_ticks``).  The report carries offered
    vs achieved vs GOODput (deadline-met completions per second of
    makespan), end-to-end latency percentiles measured from trace arrival
    time, overload counters, and the max per-workload queue depth observed
    at any tick (``<= max_queue`` whenever a bound is configured --
    enforced at submit, measured here as proof).
    """
    if mode not in ("sim", "wall"):
        raise ValueError(f"replay mode must be 'sim' or 'wall', got {mode!r}")
    events = sorted(trace.events, key=lambda e: e.t)
    multi = hasattr(engine.backend, "backends")
    clock: Optional[SimClock] = None
    if mode == "sim":
        clock = SimClock(engine)
        engine.clock = clock.now
    else:
        t0 = time.perf_counter()
        engine.clock = lambda: time.perf_counter() - t0

    rids: List[Tuple[int, TraceEvent]] = []
    submitted = 0
    max_depth = 0
    i, n, ticks = 0, len(events), 0
    last_progress = (0, 0)
    while True:
        now = engine.clock()
        while i < n and events[i].t <= now:
            ev = events[i]
            i += 1
            try:
                rid = engine.submit(
                    _payload(engine, ev, multi),
                    workload=ev.workload if multi else None,
                    priority=ev.priority, deadline_s=ev.deadline_s,
                    t_submit=ev.t)
                rids.append((rid, ev))
                submitted += 1
            except AdmissionError:
                pass                    # refusals counted in engine.stats
        depth = max(engine.queue_depths().values(), default=0)
        max_depth = max(max_depth, depth)
        busy = any(r is not None for r in engine.slot_req)
        if not busy and not engine._queued():
            if i >= n:
                break
            if clock is not None:
                clock.jump_to(events[i].t)
            else:
                time.sleep(max(0.0, events[i].t - engine.clock()))
            continue
        engine.tick()
        ticks += 1
        progress = (int(engine.stats["ticks"]), i)
        if ticks > max_ticks or progress == last_progress:
            break                       # bounded: report incomplete below
        last_progress = progress

    reqs = {rid: engine._requests[rid] for rid, _ in rids}
    done = [(r, ev) for (rid, ev) in rids
            if (r := reqs[rid]).done]
    latencies = [r.t_done - ev.t for r, ev in done]
    met = sum(1 for r, _ in done if r.met_deadline is not False)
    has_deadlines = any(ev.deadline_s is not None for ev in trace.events)
    makespan = max(engine.clock(), trace.horizon_s)
    s = engine.stats
    report: Dict[str, object] = {
        "mode": mode,
        "offered": n,
        "offered_rps": trace.offered_rps(),
        "submitted": submitted,
        "completed": len(done),
        "rejected": int(s["rejected"]),
        "shed": int(s["shed"]),
        "expired": int(s["expired"]),
        "deadline_misses": int(s["deadline_misses"]),
        "deadline_met": met if has_deadlines else None,
        "makespan_s": makespan,
        "achieved_rps": len(done) / makespan if makespan else 0.0,
        # goodput: completions that MET their deadline per second; without
        # deadlines in the trace it degenerates to achieved throughput
        "goodput_rps": ((met if has_deadlines else len(done)) / makespan
                        if makespan else 0.0),
        "queue_depth_hwm": max_depth,
        "bound_respected": (engine.max_queue is None
                            or max_depth <= engine.max_queue),
        "ticks": ticks,
        "incomplete": bool(engine._queued()
                           or any(r is not None for r in engine.slot_req)),
    }
    report.update(_percentiles(latencies) if latencies
                  else {k: 0.0 for k in
                        ("p50_latency_s", "p95_latency_s", "p99_latency_s")})
    return report


# ---------------------------------------------------------------------------
# CLI: generate a trace file for launch/serve.py --trace.
# ---------------------------------------------------------------------------


def _parse_priorities(spec: Optional[str],
                      deadline_s: Optional[float]) -> Optional[list]:
    """``"0:0.8,2:0.2"`` -> [(0, 0.8, deadline), (2, 0.2, deadline)]."""
    if spec is None:
        return ([(0, 1.0, deadline_s)] if deadline_s is not None else None)
    out = []
    for part in spec.split(","):
        prio, weight = part.split(":")
        out.append((int(prio), float(weight), deadline_s))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Generate a replayable arrival trace (JSON) for "
                    "launch/serve.py --trace / runtime.loadgen.replay")
    ap.add_argument("--kind", default="poisson",
                    choices=["poisson", "bursty"])
    ap.add_argument("--events", type=int, default=64)
    ap.add_argument("--rate", type=float, default=None,
                    help="mean arrival rate, requests/s (trace clock)")
    ap.add_argument("--arch", default=None,
                    help="vikin-* arch: size --load against its estimated "
                         "capacity instead of passing --rate")
    ap.add_argument("--load", type=float, default=1.0,
                    help="with --arch: offered load as a multiple of the "
                         "estimated full-occupancy capacity")
    ap.add_argument("--slots", type=int, default=8,
                    help="with --arch: slot count the capacity estimate "
                         "assumes")
    ap.add_argument("--burst-mult", type=float, default=4.0,
                    help="bursty: burst rate = burst-mult x calm rate")
    ap.add_argument("--mean-calm", type=float, default=None,
                    help="bursty: mean calm dwell, seconds (default: 32 "
                         "mean inter-arrivals)")
    ap.add_argument("--mean-burst", type=float, default=None,
                    help="bursty: mean burst dwell, seconds (default: 8 "
                         "mean inter-arrivals)")
    ap.add_argument("--workloads", default=None,
                    help="comma list of workload names, mixed uniformly "
                         "(multi-arch serving); omit for single-workload")
    ap.add_argument("--priorities", default=None,
                    help="priority classes as 'prio:weight,...', e.g. "
                         "'0:0.8,2:0.2'")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline, seconds (trace clock)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True, help="trace JSON path")
    args = ap.parse_args()

    rate = args.rate
    if rate is None:
        if args.arch is None:
            raise SystemExit("pass --rate, or --arch with --load to size "
                             "the rate against a model's capacity")
        if args.arch not in VIKIN_ARCHS:
            raise SystemExit(f"unknown arch {args.arch!r}; choose from "
                             f"{sorted(VIKIN_ARCHS)}")
        cap = estimate_capacity_rps(VIKIN_ARCHS[args.arch],
                                    n_slots=args.slots)
        rate = args.load * cap
        print(f"{args.arch}: estimated capacity {cap:.0f} req/s at "
              f"{args.slots} slots -> rate {rate:.0f} req/s "
              f"({args.load}x load)")
    workloads = ([(w.strip(), 1.0) for w in args.workloads.split(",")]
                 if args.workloads else None)
    classes = _parse_priorities(args.priorities, args.deadline)
    if args.kind == "poisson":
        trace = poisson_trace(rate, args.events, seed=args.seed,
                              workloads=workloads, priority_classes=classes)
    else:
        calm = args.mean_calm if args.mean_calm is not None else 32.0 / rate
        burst = args.mean_burst if args.mean_burst is not None else 8.0 / rate
        trace = bursty_trace(rate, args.burst_mult * rate, args.events,
                             mean_calm_s=calm, mean_burst_s=burst,
                             seed=args.seed, workloads=workloads,
                             priority_classes=classes)
    trace.save(args.out)
    print(f"wrote {args.out}: {len(trace.events)} events over "
          f"{trace.horizon_s:.6f} s ({trace.offered_rps():.0f} req/s "
          f"offered), sha256 {trace.sha256()[:16]}...")


if __name__ == "__main__":
    main()
