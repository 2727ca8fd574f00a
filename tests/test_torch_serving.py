"""Port parity: cycle model, engine and launcher against the JAX package.

The host-side cycle model is a copy, so its reports are held EXACTLY
equal.  The engines serve the same request stream (outputs within
``1e-4 * (1 + max|ref|)``, stats identical).  The port-side pins mirror
tests/test_runtime.py's VIKIN-engine tests, run on the CPU.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.vikin_models import VIKIN_ARCHS as J_ARCHS  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.modes import ExecMode as JMode  # noqa: E402
from repro.models.ffn import vikin_stack_init as j_stack_init  # noqa: E402
from repro.runtime import backends as jback  # noqa: E402
from repro.runtime import server as jserver  # noqa: E402
from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.convert import stack_params_from_jax  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.modes import ExecMode as TMode  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.ffn import vikin_stack_init  # noqa: E402
from repro_torch.runtime import backends as tback  # noqa: E402
from repro_torch.runtime.server import Engine  # noqa: E402

STAT_KEYS = ("served", "ticks", "sim_cycles", "mode_switches",
             "reconfig_cycles", "sim_latency_s")


def _plain(obj):
    """``obj`` with dataclasses as dicts and enums (each package has its
    own ExecMode/LayerKind classes) as their values."""
    if dataclasses.is_dataclass(obj):
        obj = dataclasses.asdict(obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj.value if hasattr(obj, "value") else obj


@pytest.mark.parametrize("arch", sorted(VIKIN_ARCHS))
def test_cycle_model_exactly_equal(arch):
    jl = J_ARCHS[arch].layer_works()
    tl = VIKIN_ARCHS[arch].layer_works()
    assert _plain(tl) == _plain(jl)
    for batch in (1, 3, 8):
        jr = jeng.run_model(jl, batch=batch)
        tr = teng.run_model(tl, batch=batch)
        assert _plain(tr) == _plain(jr)
        for prev in (None, "pipeline", "parallel"):
            jrep = jeng.serving_report(
                jl, batch=batch, prev_mode=None if prev is None
                else JMode(prev))
            trep = teng.serving_report(
                tl, batch=batch, prev_mode=None if prev is None
                else TMode(prev))
            assert _plain(trep) == _plain(jrep)
    plan_j = jback.ModePlan.for_layers(J_ARCHS[arch].layer_kind_enums())
    plan_t = tback.ModePlan.for_layers(VIKIN_ARCHS[arch].layer_kind_enums())
    assert plan_t.summary() == plan_j.summary()


def _params(arch, seed=0):
    """JAX-drawn weights as numpy, and the port's copy of them."""
    jp = j_stack_init(jax.random.key(seed), J_ARCHS[arch])
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    return np_params, stack_params_from_jax(np_params, VIKIN_ARCHS[arch])


@pytest.mark.parametrize("policy", ["mode-affinity", "fifo"])
def test_same_stream_through_both_engines(policy):
    archs = ("vikin-small", "vikin-mixed")
    jb, tb = {}, {}
    for a in archs:
        np_params, tparams = _params(a)
        jb[a] = jback.VikinBackend(J_ARCHS[a], np_params, impl="jnp")
        tb[a] = tback.VikinBackend(VIKIN_ARCHS[a], tparams, device="cpu")
    jeng_ = jserver.Engine(jback.MultiWorkloadBackend(jb), n_slots=4,
                           policy=policy)
    teng_ = Engine(tback.MultiWorkloadBackend(tb), n_slots=4, policy=policy)
    rng = np.random.default_rng(3)
    rids = []
    for i in range(9):
        a = archs[i % 2]
        x = rng.random(VIKIN_ARCHS[a].sizes[0], dtype=np.float32)
        rids.append((jeng_.submit(x, workload=a), teng_.submit(x, workload=a)))
    jout, tout = jeng_.run_until_done(), teng_.run_until_done()
    for jr, tr in rids:
        ref, got = jout[jr], tout[tr]
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-4 * (1 + np.abs(ref).max())
    for k in STAT_KEYS:
        assert teng_.stats[k] == jeng_.stats[k], k
    assert teng_.per_workload_stats() == jeng_.per_workload_stats()
    assert teng_.hw_mode.value == jeng_.hw_mode.value


def _engine(arch="vikin-small", n_slots=4, seed=0):
    model = VIKIN_ARCHS[arch]
    params = vikin_stack_init(model, torch.Generator().manual_seed(seed))
    return model, params, Engine(
        tback.VikinBackend(model, params, device="cpu"), n_slots=n_slots)


def _burst(model, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random(model.sizes[0], dtype=np.float32) for _ in range(n)]


def test_slot_reuse_and_completion():
    model, _, eng = _engine(n_slots=2)
    rids = [eng.submit(p) for p in _burst(model, 5)]
    out = eng.run_until_done()
    assert sorted(out) == sorted(rids)
    assert all(out[r].shape == (model.sizes[-1],) for r in rids)
    assert eng.stats["served"] == 5
    assert eng.stats["ticks"] == 3          # 2 + 2 + 1 across 2 slots


def test_stats_report_simulated_cycles_and_modes():
    model, _, eng = _engine("vikin-small", n_slots=4)
    for p in _burst(model, 4):
        eng.submit(p)
    eng.run_until_done()
    s = eng.stats
    assert s["sim_cycles"] > 0 and s["sim_latency_s"] > 0
    # mlp->kan: one internal switch per instance plus one boundary flip
    # per instance boundary; 4 rows, one batch, cold start: 4 + 3
    assert s["mode_switches"] == 4 + 3
    assert s["reconfig_cycles"] == 7 * 8
    tp = eng.throughput()
    assert tp["requests"] == 4 and tp["sim_rps"] > 0


def test_step_matches_direct_stack_apply():
    from repro_torch.models.ffn import vikin_stack_apply

    model, params, eng = _engine("vikin-small", n_slots=2)
    prompts = _burst(model, 2)
    rids = [eng.submit(p) for p in prompts]
    out = eng.run_until_done()
    direct = vikin_stack_apply(params, torch.from_numpy(np.stack(prompts)),
                               model).numpy()
    for j, rid in enumerate(rids):
        np.testing.assert_array_equal(out[rid], direct[j])


def test_results_returned_exactly_once():
    model, _, eng = _engine(n_slots=2)
    first = [eng.submit(p) for p in _burst(model, 2, seed=1)]
    assert sorted(eng.run_until_done()) == sorted(first)
    second = [eng.submit(p) for p in _burst(model, 2, seed=2)]
    assert sorted(eng.run_until_done()) == sorted(second)
    assert eng.stats["served"] == 4


def test_rejects_wrong_feature_width_at_submit():
    model, _, eng = _engine()
    good = eng.submit(np.zeros(model.sizes[0], np.float32))
    with pytest.raises(ValueError, match="features"):
        eng.submit(np.zeros(model.sizes[0] + 1, np.float32))
    out = eng.run_until_done()
    assert out[good].shape == (model.sizes[-1],)


def test_bucket_quantization():
    _, _, eng = _engine(n_slots=8)
    b = eng.backend
    assert [b.bucket(n) for n in (1, 2, 3, 4, 5, 8)] == [2, 2, 4, 4, 8, 8]
    _, _, eng3 = _engine(n_slots=3)
    assert [eng3.backend.bucket(n) for n in (1, 2, 3)] == [2, 2, 4]


def test_batched_equals_single_bitwise_on_cpu():
    """Holds for the plain path on the CPU too (chip_smoke.py pins it for
    the kernels on the card)."""
    model, _, eng = _engine("vikin-mixed", n_slots=4)
    prompts = _burst(model, 6)
    rids = [eng.submit(p) for p in prompts]
    batched = eng.run_until_done()
    _, _, solo = _engine("vikin-mixed", n_slots=4)
    for p, rid in zip(prompts, rids):
        srid = solo.submit(p)
        assert np.array_equal(batched[rid], solo.run_until_done()[srid])


def test_serve_main_on_cpu(capsys):
    eng = tserve.main(["--arch", "vikin-small,vikin-kan2", "--requests", "6",
                       "--slots", "2", "--device", "cpu", "--policy",
                       "fifo"])
    out = capsys.readouterr().out
    assert "6 requests in" in out and "policy fifo" in out
    assert "simulated VIKIN:" in out and "mode switches" in out
    assert "workload vikin-kan2: 3 served" in out
    assert eng.stats["served"] == 6
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "vikin-nope", "--device", "cpu"])


def test_cuda_entry_points_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = VIKIN_ARCHS["vikin-small"]
    params = vikin_stack_init(model, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tback.VikinBackend(model, params)            # default device cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", "vikin-small", "--requests", "1"])
