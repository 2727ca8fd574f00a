"""Port parity: the staged array plans (runtime/sharded.
PipelineVikinBackend, HeteroVikinBackend, make_array_backend) and the
launcher's array flags, against the JAX package, on the CPU.

Four logical CPU chips stand for the reference's forced host devices.
Each plan serves bitwise the port's ``--devices 1`` answers (f32 and
bf16), within ``1e-5 * (1 + max|ref|)`` of the reference's single-device
``VikinBackend(impl="jnp")``; its simulated fields equal the reference's
``serving_report(..., array=VikinArray(plan=...))`` exactly; the
VALIDATION leg of tests/test_array_plans.py refuses the same knobs with
the same facts.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.vikin_models import VIKIN_ARCHS as J_ARCHS  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.models.ffn import vikin_stack_init as j_stack_init  # noqa: E402
from repro.runtime import backends as jback  # noqa: E402
from repro.runtime import server as jserver  # noqa: E402
from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.convert import stack_params_from_jax  # noqa: E402
from repro_torch.core.engine import VikinArray  # noqa: E402
from repro_torch.core.modes import ExecMode, parse_mode  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.runtime.backends import (  # noqa: E402
    MultiWorkloadBackend,
    VikinBackend,
)
from repro_torch.runtime.server import Engine  # noqa: E402
from repro_torch.runtime.sharded import (  # noqa: E402
    HeteroVikinBackend,
    PipelineVikinBackend,
    make_array_backend,
)

CHIPS = 4
REF_TOL = 1e-5
# (plan, knobs): the default cuts and an explicit one of each plan
PLANS = [("pipeline", {}), ("pipeline", {"stage_map": [2, 1]}),
         ("hetero", {}),
         ("hetero", {"mode_pins": ["kan", "mlp", "mlp", "mlp"]})]


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj.value if hasattr(obj, "value") else obj


def _params(arch, seed=0):
    jp = j_stack_init(jax.random.key(seed), J_ARCHS[arch])
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    return np_params, stack_params_from_jax(np_params, VIKIN_ARCHS[arch])


def _serve(engine, reqs):
    rids = [engine.submit(r) for r in reqs]
    out = engine.run_until_done()
    return np.stack([out[r] for r in rids]), dict(engine.stats)


def _reqs(arch, n=21, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.random(VIKIN_ARCHS[arch].sizes[0], dtype=np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["vikin-mixed", "vikin-mlp4"])
@pytest.mark.parametrize("plan,knobs", PLANS)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_staged_plans_bitwise_single(arch, plan, knobs, precision):
    _, tparams = _params(arch)
    model, reqs = VIKIN_ARCHS[arch], _reqs(arch)
    y1, s1 = _serve(Engine(VikinBackend(model, tparams, device="cpu",
                                        precision=precision), n_slots=8),
                    reqs)
    be = make_array_backend(model, tparams, devices=CHIPS, plan=plan,
                            device="cpu", precision=precision, **knobs)
    ya, sa = _serve(Engine(be, n_slots=8), reqs)
    assert np.array_equal(y1, ya)
    assert sa["sim_cycles"] == pytest.approx(sa["chip_cycles"]
                                             + sa["comm_cycles"])
    if plan == "hetero":
        assert sa["reconfig_cycles"] == 0 and sa["mode_switches"] == 0
        assert be.pinned_modes == frozenset(be.array.resolved_pins())
    else:
        assert "bubble_cycles" in sa


@pytest.mark.parametrize("plan,knobs", PLANS)
def test_staged_plans_within_tolerance_of_the_reference(plan, knobs):
    arch = "vikin-mixed"
    np_params, tparams = _params(arch)
    reqs = _reqs(arch)
    ya, _ = _serve(Engine(make_array_backend(
        VIKIN_ARCHS[arch], tparams, devices=CHIPS, plan=plan, device="cpu",
        **knobs), n_slots=8), reqs)
    yj, _ = _serve(jserver.Engine(jback.VikinBackend(
        J_ARCHS[arch], np_params, impl="jnp"), n_slots=8), reqs)
    err = float(np.abs(ya - yj).max())
    assert err <= REF_TOL * (1 + float(np.abs(yj).max())), err


@pytest.mark.parametrize("arch", ["vikin-mixed", "vikin-mlp4"])
@pytest.mark.parametrize("plan,knobs", PLANS)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_staged_batch_report_equals_the_reference(arch, plan, knobs,
                                                  precision):
    _, tparams = _params(arch)
    be = make_array_backend(VIKIN_ARCHS[arch], tparams, devices=CHIPS,
                            plan=plan, device="cpu", precision=precision,
                            **knobs)
    jarr = jeng.VikinArray(
        n_chips=CHIPS, precision=precision, plan=plan,
        stage_map=knobs.get("stage_map"),
        mode_pins=(None if "mode_pins" not in knobs
                   else tuple(jeng.parse_mode(m)
                              for m in knobs["mode_pins"])))
    jl = J_ARCHS[arch].layer_works()
    for batch in (1, 5, 12):
        for prev in (None, "pipeline", "parallel"):
            got = be.batch_report(batch, None if prev is None
                                  else ExecMode(prev))
            ref = jeng.serving_report(
                jl, batch=batch, array=jarr, precision=precision,
                prev_mode=None if prev is None else jeng.ExecMode(prev))
            assert _plain(got) == _plain(ref), (batch, prev)


def test_stage_ranges_and_one_stack_a_stage():
    _, tparams = _params("vikin-mixed")
    model = VIKIN_ARCHS["vikin-mixed"]
    pipe = PipelineVikinBackend(model, tparams, devices=CHIPS, device="cpu")
    assert [(lo, hi) for lo, hi, _ in pipe._stage_ranges()] == [
        (0, 1), (1, 2), (2, 3)]
    assert len(pipe.stacks()) == 3
    het = HeteroVikinBackend(model, tparams, devices=CHIPS, device="cpu")
    assert [(lo, hi) for lo, hi, _ in het._stage_ranges()] == [
        (0, 1), (1, 2), (2, 3)]
    assert het.pinned_modes == frozenset(ExecMode)


def test_hetero_stream_is_served_without_mode_grouping():
    """The interleaved stream of the sched: row: hetero arrays pay no
    flip, and every tick serves the workload holding the oldest waiting
    request; one reconfigurable chip a workload groups by mode."""
    archs = ("vikin-kan2", "vikin-mlp3")
    params = {a: _params(a)[1] for a in archs}
    rng = np.random.default_rng(0)
    stream = [(a, rng.random(VIKIN_ARCHS[a].sizes[0], dtype=np.float32))
              for a in archs * 16]

    def order(make):
        mwb = MultiWorkloadBackend({a: make(a) for a in archs})
        seen, prefill = [], mwb.prefill

        def note(state, slot, req):
            seen.append((eng.stats["ticks"], req.rid))
            return prefill(state, slot, req)
        mwb.prefill = note
        eng = Engine(mwb, n_slots=8, policy="mode-affinity")
        for a, x in stream:
            eng.submit(x, workload=a)
        eng.run_until_done()
        heads = [min(r for t, r in seen if t == tick)
                 for tick in sorted({t for t, _ in seen})]
        return heads, eng.stats

    heads, s = order(lambda a: HeteroVikinBackend(
        VIKIN_ARCHS[a], params[a], devices=CHIPS, device="cpu"))
    assert heads == sorted(heads) == [0, 1, 16, 17]
    assert s["reconfig_cycles"] == 0
    heads1, s1 = order(lambda a: VikinBackend(VIKIN_ARCHS[a], params[a],
                                              device="cpu"))
    assert heads1 != sorted(heads1) and s1["reconfig_cycles"] > 0


# the VALIDATION leg of tests/test_array_plans.py: each knob refused with
# the reference's facts, by both packages
@pytest.mark.parametrize("build,match", [
    (lambda A, pm: A(n_chips=4, plan="data", stage_map=(1, 1)),
     "pipeline-plan knob"),
    (lambda A, pm: A(n_chips=2, plan="pipeline", stage_map=(1, 1, 1)),
     "one stage per chip"),
    (lambda A, pm: A(n_chips=4, plan="pipeline",
                     stage_map=(2, 1)).stage_sizes(4),
     "covers 3 layers"),
    (lambda A, pm: A(n_chips=4, plan="pipeline", stage_map=(2, 0)),
     "positive layer counts"),
    (lambda A, pm: A(n_chips=2, plan="pipeline", mode_pins=("kan", "mlp")),
     "hetero-plan knob"),
    (lambda A, pm: A(n_chips=4, plan="hetero", mode_pins=("kan", "mlp")),
     "pin every chip"),
    (lambda A, pm: pm("systolic"), "unknown exec mode"),
    (lambda A, pm: A(n_chips=2, plan="ring"), "unknown array plan"),
])
def test_array_knobs_refused_like_the_reference(build, match):
    for A, pm in ((VikinArray, parse_mode),
                  (jeng.VikinArray, jeng.parse_mode)):
        with pytest.raises(ValueError, match=match):
            build(A, pm)


@pytest.mark.parametrize("kw,match", [
    (dict(plan="pipeline", precision="int8", scales=object()),
     "f32/bf16 only"),
    (dict(plan="hetero", precision="int8", scales=object()),
     "f32/bf16 only"),
    (dict(plan="data", stage_map=(1, 1)), "pipeline/hetero"),
    (dict(plan="pipeline", mode_pins=("kan",)), "hetero-plan knob"),
    (dict(plan="hetero", stage_map=(1, 1)), "pipeline-plan knob"),
    (dict(plan="torus"), "unknown array plan"),
    (dict(plan="hetero", mode_pins=("kan",)), "no chip pinned to"),
])
def test_make_array_backend_refusals(kw, match):
    _, tparams = _params("vikin-small")
    n = len(kw.get("mode_pins", ())) or CHIPS
    with pytest.raises(ValueError, match=match):
        make_array_backend(VIKIN_ARCHS["vikin-small"], tparams, devices=n,
                           device="cpu", **kw)


@pytest.mark.parametrize("plan,extra", [
    ("data", []), ("pipeline", ["--stage-map", "2,1"]),
    ("hetero", ["--stage-map", "kan,kan,mlp,mlp"])])
def test_launcher_serves_every_plan_on_logical_chips(plan, extra, capsys):
    eng = tserve.main(["--arch", "vikin-mixed", "--devices", "4",
                       "--array-plan", plan, *extra, "--requests", "6",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert eng.stats["served"] == 6
    assert {"data": "sharded serving: 4 devices",
            "pipeline": "pipeline serving: 4 chips",
            "hetero": "hetero serving: 4 chips"}[plan] in out
    assert "array: " in out and "scatter/gather cycles" in out
    single = tserve.main(["--arch", "vikin-mixed", "--requests", "6",
                          "--device", "cpu"])
    capsys.readouterr()
    assert eng.stats["served"] == single.stats["served"]


@pytest.mark.parametrize("argv,match", [
    (["--arch", "vikin-mixed", "--array-plan", "pipeline"],
     "needs a multi-chip array"),
    (["--arch", "vikin-mixed", "--devices", "4", "--stage-map", "2,1"],
     "--stage-map only applies"),
    (["--arch", "vikin-mixed", "--devices", "4", "--array-plan",
      "pipeline", "--stage-map", "a,b"], "per-stage layer counts"),
    (["--arch", "vikin-mixed", "--devices", "4", "--array-plan",
      "pipeline", "--precision", "int8"], "f32/bf16 only"),
    (["--arch", "vikin-mixed", "--devices", "2", "--array-plan", "hetero",
      "--stage-map", "mlp,mlp"], "no chip pinned to 'pipeline'"),
    (["--arch", "kanffn-ci", "--devices", "4"], "--devices is vikin-only"),
    (["--arch", "kanffn-ci", "--array-plan", "pipeline"],
     "vikin-only"),
])
def test_launcher_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        tserve.main([*argv, "--device", "cpu"])
