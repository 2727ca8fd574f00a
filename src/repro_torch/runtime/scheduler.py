"""Mode-aware batch formation for the serving engine (DESIGN.md Sec. 14).

Host-side copy of ``repro/runtime/scheduler.py``; the port imports nothing
of the JAX package.

The paper's host processor earns its "minimal reconfiguration overhead"
(Sec. IV-A) by *scheduling*: it orders work so the pipeline/parallel
interconnect rarely flips.  The engine reproduces the flip COST
(``RECONFIG_CYCLES`` per mode change, core/modes.py) and, since the
carry-over contract (``ModePlan.stream_switches``), the flip OCCASIONS --
a mixed KAN/MLP request stream served strictly FIFO pays an entry flip on
nearly every tick.  This module closes the loop: a pluggable
``BatchPolicy`` decides, each admission round, which queued requests form
the next tick's batch.

Two policies ship:

* ``fifo`` -- the bit-compatible baseline: strict arrival order, one
  workload per batch (the longest same-workload prefix of the arrival
  stream, so a mixed stream degenerates to singleton batches).  Ignores
  priority and deadlines, never trims; on a single-workload engine it is
  exactly the pre-scheduler admission loop.
* ``mode-affinity`` -- the default: forms each batch to (a) keep the
  interconnect in its current mode (amortizing ``RECONFIG_CYCLES`` across
  a run of same-mode batches), (b) minimize zero-padding waste in the
  power-of-two bucket (latency-neutral trim: serve a zero-waste batch size
  when it does not add drain ticks), and (c) respect per-request
  ``priority``/``deadline_s`` -- a workload holding an already-late
  request preempts mode affinity, and within a workload requests are
  ordered (priority desc, absolute deadline, arrival).  A passed-over
  non-empty workload is force-served after ``max_starve_ticks`` admission
  rounds: low-priority work waits at most that bound regardless of the
  mode mix (the starvation bound of DESIGN.md Sec. 14).

Policies see the engine through a read-only ``SchedContext`` and return a
single-workload list of requests (<= free slots); the engine
(runtime/server.Engine) owns queues, slots, prefill and accounting.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.core.modes import ExecMode, ModePlan

from repro_torch.runtime.backends import Request


@dataclasses.dataclass
class SchedContext:
    """Read-only engine snapshot handed to ``BatchPolicy.select``.

    ``queues`` maps workload name (None on single-workload engines) to its
    arrival-ordered pending requests.  ``active`` is the set of workload
    names currently occupying slots -- a policy must only admit requests
    of an already-active workload while any slot is busy (one workload per
    in-flight batch).  ``hw_mode`` is the interconnect mode carried over
    from the previous served batch (None = cold).  ``bucket_for(w, k)``
    returns the padded batch bucket workload ``w`` would run ``k``
    requests in (== k for backends without a padding concept).
    ``max_queue`` is the per-workload admission bound (None = unbounded,
    DESIGN.md Sec. 15): every queue a policy sees has length <= max_queue,
    so deeper backlog was already rejected or shed at submit time.
    ``now`` is the ENGINE clock (wall by default, the simulated trace
    clock under open-loop replay), so deadline decisions stay
    deterministic when the engine is driven by runtime/loadgen.
    ``pinned_modes`` is the set of ExecModes the backend's chips are
    PINNED to (hetero array plan, DESIGN.md Sec. 18), or None when the
    hardware reconfigures with the stream: entering a pinned mode costs
    zero reconfiguration whatever ``hw_mode`` carries, so mode-affinity
    grouping has nothing to amortize for those modes and must not delay
    work to achieve it.
    """

    queues: Dict[Optional[str], List[Request]]
    free_slots: int
    active: frozenset
    hw_mode: Optional[ExecMode]
    plans: Dict[Optional[str], ModePlan]
    bucket_for: Callable[[Optional[str], int], int]
    max_queue: Optional[int] = None
    pinned_modes: Optional[frozenset] = None
    now: float = dataclasses.field(default_factory=time.perf_counter)


class BatchPolicy:
    """Protocol: pick the requests the engine admits this round."""

    name = "base"

    def select(self, ctx: SchedContext) -> List[Request]:
        raise NotImplementedError


def _overdue(req: Request, now: float) -> bool:
    return (req.deadline_s is not None
            and now - req.t_submit > req.deadline_s)


def shed_candidate(reqs: List[Request]) -> Request:
    """The request a full queue gives up first (shed admission,
    DESIGN.md Sec. 15): lowest priority; newest arrival among ties, so
    work already waiting keeps its place over a same-priority newcomer."""
    return min(reqs, key=lambda r: (r.priority, -r.rid))


def _abs_deadline(req: Request) -> float:
    if req.deadline_s is None:
        return math.inf
    return req.t_submit + req.deadline_s


class FifoPolicy(BatchPolicy):
    """Bit-compatible baseline: strict arrival order, no reordering.

    The batch is the longest prefix of the (merged, rid-ordered) arrival
    stream that shares one workload, capped at the free slots.  Priority
    and deadlines are ignored by construction -- this is the pre-scheduler
    engine's admission loop, kept as the comparison baseline for the
    ``sched:*`` benchmark row.
    """

    name = "fifo"

    def select(self, ctx: SchedContext) -> List[Request]:
        # Each per-workload queue is already arrival-ordered (submit
        # appends monotonically increasing rids), so the merged stream's
        # head and its same-workload prefix come from queue heads alone --
        # no flattening/sorting of the whole backlog per admission round.
        heads = [(q[0].rid, w) for w, q in ctx.queues.items() if q]
        if not heads:
            return []
        _, head = min(heads)
        if ctx.active and head not in ctx.active:
            # head-of-line blocking: FIFO never reorders, so a head whose
            # workload cannot join the in-flight batch stalls admission
            return []
        # the prefix ends where any other workload's head interleaves
        limit = min((rid for rid, w in heads if w != head),
                    default=math.inf)
        out: List[Request] = []
        for r in ctx.queues[head]:
            if r.rid > limit or len(out) >= ctx.free_slots:
                break
            out.append(r)
        return out


class ModeAffinityPolicy(BatchPolicy):
    """Group same-ExecMode work; trim padding waste; honor priority/EDF."""

    name = "mode-affinity"

    def __init__(self, max_starve_ticks: int = 8) -> None:
        if max_starve_ticks < 1:
            raise ValueError("max_starve_ticks must be >= 1")
        self.max_starve_ticks = max_starve_ticks
        self._starve: Dict[Optional[str], int] = {}

    # -- request ordering within the chosen workload -----------------------
    @staticmethod
    def _req_key(req: Request) -> Tuple[int, float, int]:
        return (-req.priority, _abs_deadline(req), req.rid)

    # -- workload choice ---------------------------------------------------
    def _score(self, w: Optional[str],
               ctx: SchedContext) -> Tuple[object, ...]:
        """Higher tuple wins: overdue work > mode affinity > priority >
        less padding waste > bigger batch > earlier arrival."""
        q = ctx.queues[w]
        k = min(len(q), ctx.free_slots)
        plan = ctx.plans.get(w)
        first = plan.first_mode if plan is not None else None
        # a workload whose entry mode is chip-PINNED (hetero array plan)
        # flips nothing regardless of the carried mode -- score it affine
        # so mode grouping never delays it (DESIGN.md Sec. 18)
        affine = (ctx.hw_mode is None or first is None
                  or first is ctx.hw_mode
                  or (ctx.pinned_modes is not None
                      and first in ctx.pinned_modes))
        return (
            any(_overdue(r, ctx.now) for r in q),
            affine,
            max(r.priority for r in q),
            -(ctx.bucket_for(w, k) - k),
            k,
            -min(r.rid for r in q),
        )

    def _batch_size(self, w: Optional[str], qlen: int,
                    ctx: SchedContext) -> int:
        """Latency-neutral zero-padding trim: the largest k <= free slots
        whose bucket is exactly k, provided serving k per tick drains the
        queue in the same number of ticks as serving min(qlen, free)."""
        k = min(qlen, ctx.free_slots)
        if ctx.bucket_for(w, k) == k:
            return k
        ticks = math.ceil(qlen / k)
        for cand in range(k - 1, 0, -1):
            if (ctx.bucket_for(w, cand) == cand
                    and math.ceil(qlen / cand) == ticks):
                return cand
        return k

    def select(self, ctx: SchedContext) -> List[Request]:
        cands = [w for w, q in ctx.queues.items() if q]
        if ctx.active:
            cands = [w for w in cands if w in ctx.active]
        if not cands or ctx.free_slots <= 0:
            return []
        starved = [w for w in cands
                   if self._starve.get(w, 0) >= self.max_starve_ticks]
        if starved:
            # most-starved first; arrival of the head request breaks ties
            w = max(starved, key=lambda w: (self._starve[w],
                                            -min(r.rid for r in
                                                 ctx.queues[w])))
        else:
            w = max(cands, key=lambda w: self._score(w, ctx))
        for other, q in ctx.queues.items():
            if q and other != w:
                self._starve[other] = self._starve.get(other, 0) + 1
        self._starve[w] = 0
        q = sorted(ctx.queues[w], key=self._req_key)
        return q[:self._batch_size(w, len(q), ctx)]


POLICIES = {p.name: p for p in (FifoPolicy, ModeAffinityPolicy)}


def get_policy(policy: Union[str, BatchPolicy]) -> BatchPolicy:
    """Resolve a policy name (or pass an instance through)."""
    if isinstance(policy, BatchPolicy):
        return policy
    try:
        return POLICIES[policy]()
    except KeyError:
        raise ValueError(
            f"unknown batch policy {policy!r}; choose from "
            f"{sorted(POLICIES)}") from None
