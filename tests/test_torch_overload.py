"""Overload machinery of the port's Engine: admission control, shedding,
deadline expiry, backpressure stats and the percentile edge cases.

The pins of ``tests/test_overload.py``, on the port's ``Engine`` over a CPU
``VikinBackend``.  Where a pin is a behaviour, the same script also runs
through the reference's ``Engine`` (``impl="jnp"``, the same weights
carried by ``repro_torch.convert``) and both engines' counters, refusals
and served sets must agree.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.vikin_models import VIKIN_ARCHS as J_ARCHS  # noqa: E402
from repro.models.ffn import vikin_stack_init as j_stack_init  # noqa: E402
from repro.runtime import backends as jback  # noqa: E402
from repro.runtime import server as jserver  # noqa: E402
from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.convert import stack_params_from_jax  # noqa: E402
from repro_torch.runtime import backends as tback  # noqa: E402
from repro_torch.runtime import server as tserver  # noqa: E402
from repro_torch.runtime.server import (  # noqa: E402
    AdmissionError,
    Engine,
    IncompleteRunError,
    _percentile,
)

#: engine counters that do not read the host clock
COUNTERS = ("ticks", "served", "sim_cycles", "sim_latency_s",
            "mode_switches", "reconfig_cycles", "deadline_misses",
            "rejected", "shed", "expired", "queue_depth_hwm")


@functools.lru_cache(maxsize=None)
def _np_params(arch):
    jp = j_stack_init(jax.random.key(0), J_ARCHS[arch])
    return [{k: np.asarray(v) for k, v in p.items()} for p in jp]


def _backend(pkg, arch="vikin-small"):
    if pkg == "jax":
        return jback.VikinBackend(J_ARCHS[arch], _np_params(arch),
                                  impl="jnp")
    return tback.VikinBackend(
        VIKIN_ARCHS[arch],
        stack_params_from_jax(_np_params(arch), VIKIN_ARCHS[arch]),
        device="cpu")


def _engine(pkg="torch", arch="vikin-small", n_slots=2, **kw):
    server = jserver if pkg == "jax" else tserver
    return VIKIN_ARCHS[arch], server.Engine(_backend(pkg, arch),
                                            n_slots=n_slots, **kw)


def _prompts(model, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random(model.sizes[0], dtype=np.float32) for _ in range(n)]


def _counters(eng):
    s = eng.stats
    return ({k: s[k] for k in COUNTERS},
            {k: v for k, v in eng.latency_stats().items() if "_sim_" in k},
            eng.overload_stats())


def _both(script):
    """Run ``script(pkg)`` for the port, then for the reference; the
    port's pins are asserted inside it.  Both must return equal results
    (counters, rids, served sets)."""
    got = script("torch")
    assert got == script("jax")
    return got


# ---------------------------------------------------------------------------
# SLO input validation at submit
# ---------------------------------------------------------------------------


def test_submit_rejects_nonpositive_deadline():
    model, eng = _engine()
    (p,) = _prompts(model, 1)
    for bad in (0.0, -1.0, -1e-9):
        with pytest.raises(ValueError, match="deadline_s"):
            eng.submit(p, deadline_s=bad)
    assert eng._queued() == 0          # nothing was silently queued


def test_submit_rejects_negative_priority():
    model, eng = _engine()
    (p,) = _prompts(model, 1)
    with pytest.raises(ValueError, match="priority"):
        eng.submit(p, priority=-1)
    assert eng._queued() == 0


# ---------------------------------------------------------------------------
# Admission control: reject / shed on a bounded queue
# ---------------------------------------------------------------------------


def test_engine_admission_config_validation():
    be = _backend("torch")
    with pytest.raises(ValueError, match="max_queue"):
        Engine(be, max_queue=0)
    with pytest.raises(ValueError, match="max_queue"):
        Engine(be, admission="shed")           # a policy needs a bound
    with pytest.raises(ValueError, match="admission"):
        Engine(be, max_queue=2, admission="nope")
    # a bound alone implies enforcement
    assert Engine(be, max_queue=2).admission == "reject"


def test_reject_admission_refuses_and_counts():
    def script(pkg):
        err = jserver.AdmissionError if pkg == "jax" else AdmissionError
        model, eng = _engine(pkg, max_queue=2, admission="reject")
        ps = _prompts(model, 4)
        r0 = eng.submit(ps[0])
        r1 = eng.submit(ps[1])
        with pytest.raises(err) as ei:
            eng.submit(ps[2], workload=None)
        assert ei.value.action == "rejected" and ei.value.max_queue == 2
        assert eng.stats["rejected"] == 1
        assert eng.overload_stats()["rejected"]["by_workload"] == {None: 1}
        # the refused request consumed no rid and left the queue intact
        out = eng.run_until_done()
        assert sorted(out) == [r0, r1]
        return sorted(out), _counters(eng)

    _both(script)


def test_shed_admission_evicts_lowest_priority():
    def script(pkg):
        model, eng = _engine(pkg, max_queue=2, admission="shed")
        ps = _prompts(model, 3)
        low = eng.submit(ps[0], priority=0)
        high = eng.submit(ps[1], priority=5)
        # a higher-priority newcomer evicts the queued low-priority request
        newcomer = eng.submit(ps[2], priority=3)
        assert eng.stats["shed"] == 1
        assert eng._requests[low].shed is True
        out = eng.run_until_done()
        assert sorted(out) == sorted([high, newcomer])
        assert low not in out
        return sorted(out), _counters(eng)

    _both(script)


def test_shed_admission_refuses_weakest_newcomer():
    def script(pkg):
        err = jserver.AdmissionError if pkg == "jax" else AdmissionError
        model, eng = _engine(pkg, max_queue=2, admission="shed")
        ps = _prompts(model, 3)
        eng.submit(ps[0], priority=4)
        eng.submit(ps[1], priority=4)
        # the newcomer is the weakest: same priority, newest arrival
        with pytest.raises(err) as ei:
            eng.submit(ps[2], priority=4)
        assert ei.value.action == "shed"
        assert eng.stats["shed"] == 1
        assert eng.overload_stats()["shed"]["by_priority"] == {4: 1}
        assert eng._queued() == 2
        return _counters(eng)

    _both(script)


# ---------------------------------------------------------------------------
# Queue-time deadline expiry
# ---------------------------------------------------------------------------


def test_queued_expiry_counts_miss_in_wall_clock():
    """A request going late IN QUEUE is a miss the moment the engine next
    looks, not when it eventually completes."""
    def script(pkg):
        model, eng = _engine(pkg, n_slots=2)
        ps = _prompts(model, 3)
        eng.submit(ps[0])
        eng.submit(ps[1])
        # backdate the doomed request so it is already expired while queued
        missed = eng.submit(ps[2], deadline_s=1e-9,
                            t_submit=eng.clock() - 1.0)
        eng.tick()                          # expiry scan runs at tick start
        assert eng.stats["deadline_misses"] == 1
        assert eng._requests[missed].met_deadline is False
        out = eng.run_until_done()
        assert missed in out                # still served (no drop_expired)
        assert eng.stats["deadline_misses"] == 1   # not double-counted
        return sorted(out), _counters(eng)

    _both(script)


def test_queued_expiry_counts_miss_in_sim_clock():
    """Same on a virtual clock: a queued request expires in simulated
    time."""
    def script(pkg):
        model, eng = _engine(pkg, n_slots=1)
        t = {"now": 0.0}
        eng.clock = lambda: t["now"]
        ps = _prompts(model, 2)
        eng.submit(ps[0])
        doomed = eng.submit(ps[1], deadline_s=0.5)
        t["now"] = 1.0                      # sim time passes while queued
        eng.tick()
        assert eng.stats["deadline_misses"] == 1
        assert eng._requests[doomed].met_deadline is False
        return _counters(eng)

    _both(script)


def test_drop_expired_sheds_queued_dead_requests():
    def script(pkg):
        model, eng = _engine(pkg, n_slots=2, drop_expired=True)
        ps = _prompts(model, 3)
        live = [eng.submit(ps[0]), eng.submit(ps[1])]
        dead = eng.submit(ps[2], deadline_s=1e-9,
                          t_submit=eng.clock() - 1.0)
        out = eng.run_until_done()
        assert sorted(out) == sorted(live)
        assert dead not in out
        assert eng.stats["expired"] == 1
        assert eng.overload_stats()["expired"]["by_priority"] == {0: 1}
        return sorted(out), _counters(eng)

    _both(script)


# ---------------------------------------------------------------------------
# Backpressure surfaces
# ---------------------------------------------------------------------------


def test_queue_depth_high_water_mark():
    def script(pkg):
        model, eng = _engine(pkg, n_slots=2)
        for p in _prompts(model, 5):
            eng.submit(p)
        assert eng.stats["queue_depth_hwm"] == 5
        assert eng.queue_depths() == {None: 5}
        eng.run_until_done()
        hwm = eng.overload_stats()["queue_depth_hwm"]
        assert hwm["global"] == 5 and hwm["by_workload"] == {None: 5}
        return _counters(eng)

    _both(script)


def test_incomplete_run_error_carries_shed_and_expired():
    def script(pkg):
        err = (jserver.IncompleteRunError if pkg == "jax"
               else IncompleteRunError)
        model, eng = _engine(pkg, n_slots=1, max_queue=3, admission="shed",
                             drop_expired=True)
        ps = _prompts(model, 4)
        first = eng.submit(ps[0], priority=1)
        dead = eng.submit(ps[1], deadline_s=1e-9,
                          t_submit=eng.clock() - 1.0, priority=1)
        shed_rid = eng.submit(ps[2], priority=0)
        high = eng.submit(ps[3], priority=2)  # evicts shed_rid
        with pytest.raises(err) as ei:
            eng.run_until_done(max_ticks=1)
        assert shed_rid in ei.value.shed
        assert dead in ei.value.expired
        assert dead not in ei.value.pending
        assert first in ei.value.pending    # live work still retryable
        assert high in ei.value.completed   # served first (priority order)
        # the retry path still completes the live requests
        out = eng.run_until_done()
        assert set(ei.value.pending) <= set(out)
        return (sorted(ei.value.pending), sorted(ei.value.shed),
                sorted(ei.value.expired), sorted(ei.value.completed),
                sorted(out), _counters(eng))

    _both(script)


# ---------------------------------------------------------------------------
# Percentile / latency_stats edge cases
# ---------------------------------------------------------------------------


def test_percentile_empty_and_single_sample():
    assert _percentile([], 50) == 0.0
    assert _percentile([], 99) == 0.0
    for q in (50, 95, 99):
        assert _percentile([3.5], q) == 3.5
        assert _percentile([3.5], q) == jserver._percentile([3.5], q)


def test_percentile_nearest_rank_short_series():
    xs = sorted([1.0, 2.0, 3.0, 4.0])
    assert _percentile(xs, 50) == 2.0
    assert _percentile(xs, 95) == 4.0
    assert _percentile(xs, 99) == 4.0   # p99 of 4 samples = the max
    ys = sorted(np.random.default_rng(0).random(37).tolist())
    for q in (1, 50, 95, 99, 100):
        assert _percentile(ys, q) == jserver._percentile(ys, q)


def test_latency_stats_empty_engine():
    _, eng = _engine()
    assert eng.latency_stats() == {}    # all-idle engine: no series yet
    eng.tick()                          # idle tick is a no-op, still empty
    assert eng.latency_stats() == {}


def test_latency_stats_reports_p99():
    def script(pkg):
        model, eng = _engine(pkg, n_slots=2)
        for p in _prompts(model, 4):
            eng.submit(p)
        eng.run_until_done()
        stats = eng.latency_stats()
        for series in ("queue_wait_sim", "service_sim"):
            for q in (50, 95, 99):
                assert f"p{q}_{series}_s" in stats
            assert (stats[f"p99_{series}_s"] >= stats[f"p95_{series}_s"]
                    >= stats[f"p50_{series}_s"] >= 0.0)
        return _counters(eng)

    _both(script)
