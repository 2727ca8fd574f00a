"""Backend-agnostic continuous-batching engine with slot-based state lanes.

Host-side copy of ``repro/runtime/server.py``: the ``Engine``, and the
transformer ``Server`` (an Engine over a ``TransformerBackend``).  The
port imports nothing of the JAX package.

Continuous-batching-lite: the engine owns ``n_slots`` state lanes; incoming
requests wait in per-workload queues, a pluggable ``BatchPolicy``
(runtime/scheduler.py) picks which of them form each tick's batch, every
engine tick runs ONE batched backend step for all active slots (the batch
dimension is the slot array), and finished slots are recycled -- then
re-admission runs immediately, so a saturated queue keeps all ``n_slots``
busy instead of idling freed slots until the next tick.  What a "step"
means belongs to the ModelBackend (runtime/backends.py): one decoded token
per active slot for transformers, one whole feed-forward inference per
active slot for VIKIN KAN/MLP stacks.  This is the vLLM-style execution
contract scaled down to what one process can test: slot reuse, padding
correctness, per-request determinism (batched output == single-request
output, test-pinned).

Overload machinery (DESIGN.md Sec. 15): per-workload queues can be bounded
(``max_queue``) under an explicit admission policy -- ``reject`` refuses
the incoming request with a typed ``AdmissionError``, ``shed`` evicts the
lowest-priority queued request (or refuses the incoming one when IT is the
weakest) -- and ``drop_expired=True`` sheds queued requests whose deadline
already passed instead of serving them dead.  Backpressure is surfaced in
``stats`` (shed/rejected/expired totals, queue-depth high-water mark) and
broken down per workload / per priority class by ``overload_stats()``.
Deadline misses are counted the moment a QUEUED request goes late (the
per-tick expiry scan), not only at completion, so overload undercounts
nothing.

The engine also aggregates the backend's per-batch simulated-hardware
reports (VIKIN cycles / latency / mode switches) into ``stats`` alongside
wall-clock, threads the simulated interconnect mode from batch to batch
(the carry-over contract of DESIGN.md Sec. 14 -- ``self.hw_mode``), and
records per-request queue-wait and service latency in BOTH clocks, exposed
as p50/p95/p99 via ``latency_stats()`` / merged into ``stats`` by
``run_until_done``.  All request timestamps and deadline checks read
``self.clock`` (default ``time.perf_counter``); the open-loop trace
harness (runtime/loadgen.py) swaps in a deterministic simulated clock, so
deadline semantics hold identically in wall and simulated time.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.runtime.backends import (  # noqa: F401  (Request re-export)
    ModelBackend,
    Request,
    TransformerBackend,
)
from repro_torch.runtime.scheduler import (
    BatchPolicy,
    SchedContext,
    get_policy,
    shed_candidate,
)


class AdmissionError(RuntimeError):
    """``submit`` refused a request under admission control.

    ``action`` is ``"rejected"`` (reject-on-full) or ``"shed"`` (the
    incoming request was itself the lowest-priority shed candidate of its
    full queue).  The refused request never entered the engine: no rid was
    consumed and nothing needs cleanup -- retry later or raise priority.
    """

    def __init__(self, workload: Optional[str], max_queue: int,
                 action: str) -> None:
        self.workload, self.max_queue, self.action = workload, max_queue, action
        super().__init__(
            f"admission {action}: workload {workload!r} queue is at "
            f"max_queue={max_queue}"
            + (" and the incoming request is the lowest-priority shed "
               "candidate" if action == "shed" else ""))


class IncompleteRunError(RuntimeError):
    """``run_until_done`` hit ``max_ticks`` with work still in flight.

    Nothing is dropped: finished results are on ``.completed`` and every
    unfinished request stays queued in the engine, so a follow-up
    ``run_until_done`` call with more ticks returns the full result set.
    ``.shed`` / ``.expired`` list requests the engine REFUSED (evicted by
    shed admission / dropped past their deadline) -- those will never
    finish, so callers can distinguish "engine too slow" (``.pending``)
    from "engine shed work" when a replay ends early.
    """

    def __init__(self, pending: List[int], completed: Dict[int, list],
                 shed: Optional[List[int]] = None,
                 expired: Optional[List[int]] = None) -> None:
        self.pending = sorted(pending)
        self.completed = completed
        self.shed = sorted(shed or [])
        self.expired = sorted(expired or [])
        super().__init__(
            f"run_until_done: {len(self.pending)} request(s) still "
            f"unfinished after max_ticks (rids {self.pending[:8]}"
            f"{'...' if len(self.pending) > 8 else ''}); "
            f"{len(completed)} completed result(s) preserved on "
            f".completed, {len(self.shed)} shed / {len(self.expired)} "
            f"expired (never completing; see .shed/.expired) -- call "
            f"run_until_done again with more ticks for the pending rest")


def _percentile(sorted_xs: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted sample."""
    if not sorted_xs:
        return 0.0
    idx = max(0, int(np.ceil(q / 100.0 * len(sorted_xs))) - 1)
    return float(sorted_xs[idx])


class Engine:
    _LAT_WINDOW = 4096          # samples kept per latency series

    #: admission policies for bounded queues (max_queue):
    #:   unbounded -- no bound (back-compat default; max_queue alone
    #:                upgrades to "reject")
    #:   reject    -- refuse the incoming request with AdmissionError
    #:   shed      -- evict the lowest-priority queued request (newest
    #:                among ties); the incoming request is refused when it
    #:                is itself the weakest
    ADMISSION_POLICIES = ("unbounded", "reject", "shed")

    def __init__(self, backend: ModelBackend, *, n_slots: int = 4,
                 max_len: int = 256,
                 policy: Union[str, "BatchPolicy"] = "mode-affinity",
                 max_queue: Optional[int] = None,
                 admission: str = "unbounded", drop_expired: bool = False,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if admission not in self.ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {admission!r}; "
                             f"choose from {self.ADMISSION_POLICIES}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if admission != "unbounded" and max_queue is None:
            raise ValueError(f"admission={admission!r} needs max_queue")
        if max_queue is not None and admission == "unbounded":
            admission = "reject"        # a bound implies enforcement
        self.backend = backend
        self.n_slots, self.max_len = n_slots, max_len
        self.policy: BatchPolicy = get_policy(policy)
        self.max_queue, self.admission = max_queue, admission
        self.drop_expired = drop_expired
        # the engine's request clock: submit/admit/done stamps, deadline
        # checks, and the scheduler's "now" all read it, so swapping in a
        # virtual clock (loadgen.SimClock) moves deadline semantics into
        # the simulated domain wholesale
        self.clock: Callable[[], float] = clock or time.perf_counter
        self.state = backend.init_state(n_slots, max_len)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self._queues: Dict[Optional[str], List[Request]] = {}
        self._requests: Dict[int, Request] = {}
        self._next_rid = 0
        self.hw_mode = None     # simulated interconnect state, carried
        self.stats: Dict[str, float] = {
            "ticks": 0, "served": 0, "wall_s": 0.0, "sim_cycles": 0.0,
            "sim_latency_s": 0.0, "mode_switches": 0.0,
            "reconfig_cycles": 0.0, "deadline_misses": 0,
            "rejected": 0, "shed": 0, "expired": 0, "queue_depth_hwm": 0,
        }
        # per-workload / per-priority-class overload breakdown
        self._overload: Dict[str, Dict[str, Dict]] = {
            k: {"by_workload": {}, "by_priority": {}}
            for k in ("rejected", "shed", "expired")}
        self._queue_hwm: Dict[Optional[str], int] = {}
        # bounded sample windows: a long-lived engine must not accumulate
        # per-request history forever (same contract as run_until_done not
        # accumulating historical results) -- percentiles reflect the most
        # recent _LAT_WINDOW requests
        self._lat: Dict[str, List[float]] = {
            "queue_wait_wall": [], "queue_wait_sim": [],
            "service_wall": [], "service_sim": [],
        }

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               eos_id: Optional[int] = None, *, priority: int = 0,
               deadline_s: Optional[float] = None,
               workload: Optional[str] = None,
               t_submit: Optional[float] = None) -> int:
        """Queue one request; returns its rid.

        ``t_submit`` backdates the arrival stamp (engine-clock seconds) for
        open-loop trace replay, where a request "arrived" mid-batch but is
        observed at the next tick boundary; deadlines count from it.
        Raises ``ValueError`` on malformed SLO inputs and
        ``AdmissionError`` when a bounded queue refuses the request.
        """
        if deadline_s is not None and not deadline_s > 0:
            raise ValueError(
                f"deadline_s must be a positive wall/sim-second budget, "
                f"got {deadline_s!r} (an already-impossible SLO would be "
                f"silently queued and served dead)")
        if priority < 0:
            raise ValueError(
                f"priority must be >= 0, got {priority!r} (the shed order "
                f"and the batch policies assume a non-negative scale)")
        req = Request(self._next_rid, np.asarray(prompt), max_new_tokens,
                      eos_id, priority=priority, deadline_s=deadline_s,
                      workload=workload)
        self.backend.validate(req)     # reject bad payloads before queueing
        q = self._queues.setdefault(workload, [])
        if self.max_queue is not None and len(q) >= self.max_queue:
            if self.admission == "reject":
                self._count_overload("rejected", req)
                raise AdmissionError(workload, self.max_queue, "rejected")
            victim = shed_candidate(q + [req])
            self._count_overload("shed", victim)
            if victim is req:
                raise AdmissionError(workload, self.max_queue, "shed")
            q.remove(victim)
            victim.shed = True          # stays in _requests for accounting
        self._next_rid += 1
        now = self.clock()
        req.t_submit = now if t_submit is None else t_submit
        req.sim_submit = self.stats["sim_latency_s"]
        q.append(req)
        self._requests[req.rid] = req
        if len(q) > self._queue_hwm.get(workload, 0):
            self._queue_hwm[workload] = len(q)
        total = self._queued()
        if total > self.stats["queue_depth_hwm"]:
            self.stats["queue_depth_hwm"] = total
        return req.rid

    def _queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def queue_depths(self) -> Dict[Optional[str], int]:
        """Current pending-queue depth per workload (in-flight excluded)."""
        return {w: len(q) for w, q in self._queues.items()}

    def _count_overload(self, kind: str, req: Request) -> None:
        self.stats[kind] += 1
        o = self._overload[kind]
        o["by_workload"][req.workload] = (
            o["by_workload"].get(req.workload, 0) + 1)
        o["by_priority"][req.priority] = (
            o["by_priority"].get(req.priority, 0) + 1)

    def overload_stats(self) -> Dict[str, Dict]:
        """Backpressure breakdown: shed/rejected/expired counts per
        workload and per priority class, plus queue-depth high-water marks
        (global total and per workload)."""
        out = {k: {g: dict(v) for g, v in d.items()}
               for k, d in self._overload.items()}
        out["queue_depth_hwm"] = {
            "global": int(self.stats["queue_depth_hwm"]),
            "by_workload": dict(self._queue_hwm)}
        return out

    def _count_miss(self, req: Request) -> None:
        if not req.miss_counted:
            req.miss_counted = True
            self.stats["deadline_misses"] += 1

    def _expire_queued(self) -> None:
        """Count (and under ``drop_expired`` shed) queued requests whose
        deadline already passed: a request going late IN QUEUE is a miss
        at the moment it expires, not when it eventually completes."""
        now = self.clock()
        for w, q in self._queues.items():
            kept: List[Request] = []
            for r in q:
                late = (r.deadline_s is not None
                        and now - r.t_submit > r.deadline_s)
                if late:
                    r.met_deadline = False
                    self._count_miss(r)
                if late and self.drop_expired:
                    r.expired = True
                    self._count_overload("expired", r)
                else:
                    kept.append(r)
            if self.drop_expired and len(kept) != len(q):
                self._queues[w] = kept

    def _bucket_for(self, workload: Optional[str], k: int) -> int:
        b = self.backend
        if hasattr(b, "bucket_for"):
            return b.bucket_for(workload, k)
        if hasattr(b, "bucket"):
            return b.bucket(k)
        return k

    def _plans(self) -> Dict[Optional[str], Any]:
        plans = getattr(self.backend, "plans", None)
        if plans is not None:
            return plans
        plan = getattr(self.backend, "plan", None)
        return {None: plan} if plan is not None else {}

    def _admit(self) -> None:
        free = [s for s, r in enumerate(self.slot_req) if r is None]
        if not free or not self._queued():
            return
        ctx = SchedContext(
            queues=self._queues, free_slots=len(free),
            active=frozenset(r.workload for r in self.slot_req
                             if r is not None),
            hw_mode=self.hw_mode, plans=self._plans(),
            bucket_for=self._bucket_for, max_queue=self.max_queue,
            pinned_modes=getattr(self.backend, "pinned_modes", None),
            now=self.clock())
        picked = self.policy.select(ctx)
        for req, slot in zip(picked, free):
            self._queues[req.workload].remove(req)
            self.state = self.backend.prefill(self.state, slot, req)
            self.slot_req[slot] = req
            req.t_admit = self.clock()
            req.sim_admit = self.stats["sim_latency_s"]
            self._sample("queue_wait_wall", req.t_admit - req.t_submit)
            self._sample("queue_wait_sim", req.sim_admit - req.sim_submit)

    def tick(self) -> None:
        """One engine iteration: expire dead queued work, admit requests,
        run one batched step for all active slots, recycle finished slots,
        re-admit into the freed slots.  Times itself, so ``throughput()``
        reports wall figures whether the engine is driven here or through
        ``run_until_done``."""
        t0 = time.perf_counter()
        self._expire_queued()
        self._admit()
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        self.state = self.backend.step(self.state, self.slot_req)
        self.stats["ticks"] += 1
        rep = self.backend.batch_report(len(active), prev_mode=self.hw_mode)
        if rep is not None:
            rep = dict(rep)
            exit_mode = rep.pop("exit_mode", None)
            if exit_mode is not None:
                self.hw_mode = exit_mode
            for k, v in rep.items():
                self.stats[k] = self.stats.get(k, 0.0) + v
        # read the clock AFTER the batch report: under a simulated clock
        # (loadgen.SimClock tracks sim_latency_s) completions are stamped
        # at the batch's simulated end, not its start
        now = self.clock()
        for s in active:
            req = self.slot_req[s]
            if req.done:
                self.stats["served"] += 1
                req.t_done, req.sim_done = now, self.stats["sim_latency_s"]
                self._sample("service_wall", now - req.t_admit)
                self._sample("service_sim", req.sim_done - req.sim_admit)
                if req.deadline_s is not None:
                    if req.miss_counted:      # went late while queued
                        req.met_deadline = False
                    else:
                        req.met_deadline = (now - req.t_submit
                                            <= req.deadline_s)
                        if not req.met_deadline:
                            self._count_miss(req)
                self.slot_req[s] = None
        # re-admit into freed slots NOW: admission only at tick start left
        # recycled slots idle for a whole tick under a saturated queue
        self._admit()
        self.stats["wall_s"] += time.perf_counter() - t0

    def run_until_done(self, max_ticks: int = 1000) -> Dict[int, list]:
        """Drive ticks until queue and slots drain; returns {rid: result}
        (token lists for autoregressive backends, output arrays for
        one-shot backends) for every request not returned by an earlier
        call -- each request is handed back exactly once, so a long-lived
        engine does not accumulate historical results.  Requests the
        engine refused (shed admission / expired drop) have no result and
        are absent from the dict; their counts are in ``stats`` and
        ``overload_stats()``.

        If ``max_ticks`` elapses with work still queued or in flight,
        raises ``IncompleteRunError`` instead of silently dropping the
        unfinished requests: completed results ride on the exception
        (with shed/expired rids split out from the retryable pending set)
        and every pending request stays owned by the engine for a retry.
        """
        snapshot = dict(self._requests)
        for _ in range(max_ticks):
            self.tick()
            busy = any(r is not None for r in self.slot_req)
            if not busy and not self._queued():
                break
        pending, shed, expired = [], [], []
        for rid, r in snapshot.items():
            if r.done:
                continue
            (shed if r.shed else expired if r.expired else pending).append(rid)
        if pending:
            raise IncompleteRunError(
                pending,
                {rid: r.result() for rid, r in snapshot.items() if r.done},
                shed=shed, expired=expired)
        self.stats.update(self.latency_stats())
        for rid in snapshot:
            del self._requests[rid]
        return {rid: r.result() for rid, r in snapshot.items() if r.done}

    def _sample(self, series: str, value: float) -> None:
        xs = self._lat[series]
        xs.append(value)
        if len(xs) > self._LAT_WINDOW:
            del xs[: len(xs) - self._LAT_WINDOW]

    def latency_stats(self) -> Dict[str, float]:
        """p50/p95/p99 queue-wait and service latency, wall + simulated
        clocks (seconds), over the most recent ``_LAT_WINDOW`` requests."""
        out: Dict[str, float] = {}
        for name, xs in self._lat.items():
            if not xs:
                continue
            s = sorted(xs)
            out[f"p50_{name}_s"] = _percentile(s, 50)
            out[f"p95_{name}_s"] = _percentile(s, 95)
            out[f"p99_{name}_s"] = _percentile(s, 99)
        return out

    def per_workload_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-workload accounting when the backend keeps it (multi-
        workload serving); empty for single-workload backends."""
        return {n: dict(v) for n, v in
                getattr(self.backend, "workload_stats", {}).items()}

    def throughput(self) -> Dict[str, float]:
        """Requests/s in both clocks (wall + simulated VIKIN latency)."""
        served = self.stats["served"]
        out = {"requests": served}
        if self.stats["wall_s"] > 0:
            out["wall_rps"] = served / self.stats["wall_s"]
        if self.stats["sim_latency_s"] > 0:
            out["sim_rps"] = served / self.stats["sim_latency_s"]
        return out


class Server(Engine):
    """Transformer server: an Engine over a TransformerBackend.

    ``masks`` and ``precision`` pass through to the backend for kan-ffn
    archs (calibrated two-stage masks, f32|bf16 serving); ``device``
    picks kernels (``"cuda"``, the default) or plain versions
    (``"cpu"``).  The defaults serve plain archs unchanged."""

    def __init__(self, cfg: Any, params: Any, *, n_slots: int = 4,
                 max_len: int = 256, masks: Any = None,
                 precision: str = "f32",
                 device: str | torch.device = "cuda") -> None:
        super().__init__(
            TransformerBackend(cfg, params, device=device, masks=masks,
                               precision=precision),
            n_slots=n_slots, max_len=max_len)
        self.cfg, self.params = self.backend.cfg, self.backend.params

    @property
    def caches(self) -> Any:
        return self.state
