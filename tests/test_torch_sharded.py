"""Port parity: the data plan of the VIKIN array (runtime/sharded.
ShardedVikinBackend, launch/mesh) against the JAX package, on the CPU.

Four logical CPU chips stand for the reference's forced host devices.
The port's array serves bitwise the port's single-device answers (f32,
bf16, int8); its answers are within ``1e-5 * (1 + max|ref|)`` of the
reference's single-device ``VikinBackend(impl="jnp")`` (whose own
subprocess tests pin its array == single bitwise); its simulated fields
equal the reference's ``serving_report(..., array=VikinArray(...))``
exactly; its buckets are the reference's table
(tests/test_sharded.py).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.vikin_models import VIKIN_ARCHS as J_ARCHS  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.models.ffn import vikin_stack_init as j_stack_init  # noqa: E402
from repro.runtime import backends as jback  # noqa: E402
from repro.runtime import server as jserver  # noqa: E402
from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    scales_from_jax,
    stack_params_from_jax,
)
from repro_torch.core.engine import VikinArray  # noqa: E402
from repro_torch.core.modes import ExecMode  # noqa: E402
from repro_torch.launch.mesh import require_devices  # noqa: E402
from repro_torch.launch.mesh import serving_devices  # noqa: E402
from repro_torch.runtime.backends import VikinBackend  # noqa: E402
from repro_torch.runtime.server import Engine  # noqa: E402
from repro_torch.runtime.sharded import ShardedVikinBackend  # noqa: E402

CHIPS = 4
REF_TOL = 1e-5


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj.value if hasattr(obj, "value") else obj


def _setup(arch, precision, seed=0):
    """The reference's draw as numpy, the port's copy, and (int8) both
    packages' scales calibrated by the reference on a seeded batch."""
    model = J_ARCHS[arch]
    jp = j_stack_init(jax.random.key(seed), model)
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    js = ts = None
    if precision == "int8":
        calib = np.random.default_rng(seed).random(
            (64, model.sizes[0])).astype(np.float32)
        js = jcal.calibrate_scales(jp, model, calib)
        ts = scales_from_jax(js)
    return np_params, stack_params_from_jax(np_params, VIKIN_ARCHS[arch]), \
        js, ts


def _serve(engine, reqs):
    rids = [engine.submit(r) for r in reqs]
    out = engine.run_until_done()
    return np.stack([out[r] for r in rids]), dict(engine.stats)


def _reqs(arch, n=21, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.random(VIKIN_ARCHS[arch].sizes[0], dtype=np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["vikin-mixed", "vikin-mlp3",
                                  "vikin-kan2"])
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_data_plan_bitwise_single_and_sim_fields(arch, precision):
    _, tparams, _, ts = _setup(arch, precision)
    model, reqs = VIKIN_ARCHS[arch], _reqs(arch)
    y1, s1 = _serve(Engine(VikinBackend(model, tparams, device="cpu",
                                        precision=precision, scales=ts),
                           n_slots=8), reqs)
    be = ShardedVikinBackend(model, tparams, devices=CHIPS, device="cpu",
                             precision=precision, scales=ts)
    yn, sn = _serve(Engine(be, n_slots=8), reqs)
    assert np.array_equal(y1, yn)
    assert len(be.stacks()) == 1              # four shards, one device
    assert sn["sim_cycles"] == pytest.approx(sn["chip_cycles"]
                                             + sn["comm_cycles"])
    assert sn["mode_switches"] == s1["mode_switches"]
    assert sn["dma_bytes"] == s1["dma_bytes"]
    assert sn["ticks"] == s1["ticks"] == 3


@pytest.mark.parametrize("precision,tol", [("f32", REF_TOL),
                                           ("int8", REF_TOL)])
def test_data_plan_within_tolerance_of_the_reference(precision, tol):
    arch = "vikin-mixed"
    np_params, tparams, js, ts = _setup(arch, precision)
    reqs = _reqs(arch)
    yn, sn = _serve(Engine(ShardedVikinBackend(
        VIKIN_ARCHS[arch], tparams, devices=CHIPS, device="cpu",
        precision=precision, scales=ts), n_slots=8), reqs)
    jb = jback.VikinBackend(J_ARCHS[arch], np_params, impl="jnp",
                            precision=precision, scales=js)
    yj, _ = _serve(jserver.Engine(jb, n_slots=8), reqs)
    err = float(np.abs(yn - yj).max())
    assert err <= tol * (1 + float(np.abs(yj).max())), err


@pytest.mark.parametrize("arch", ["vikin-mixed", "vikin-small"])
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_data_plan_batch_report_equals_the_reference(arch, precision):
    _, tparams, _, ts = _setup(arch, precision)
    be = ShardedVikinBackend(VIKIN_ARCHS[arch], tparams, devices=CHIPS,
                             device="cpu", precision=precision, scales=ts)
    jl = J_ARCHS[arch].layer_works()
    jarr = jeng.VikinArray(n_chips=CHIPS, precision=precision)
    for batch in (1, 5, 12):
        for prev in (None, "pipeline", "parallel"):
            got = be.batch_report(batch, None if prev is None
                                  else ExecMode(prev))
            ref = jeng.serving_report(
                jl, batch=batch, array=jarr, precision=precision,
                prev_mode=None if prev is None else jeng.ExecMode(prev))
            assert _plain(got) == _plain(ref), (batch, prev)


def test_shard_and_global_buckets_are_the_reference_table():
    _, tparams, _, _ = _setup("vikin-small", "f32")
    be = ShardedVikinBackend(VIKIN_ARCHS["vikin-small"], tparams,
                             devices=CHIPS, device="cpu")
    shard = {n: be.shard_bucket(n) for n in (1, 2, 6, 8, 9)}
    assert shard == {1: 2, 2: 2, 6: 2, 8: 2, 9: 4}
    assert {n: be.bucket(n) for n in shard} == {n: CHIPS * b
                                                for n, b in shard.items()}
    assert be.shard_bucket(33) == 16


@pytest.mark.parametrize("n", [1, 2, 6, 9, 33])
def test_per_shard_buckets_keep_every_answer(n):
    """One tick of ``n`` active requests: per-shard buckets of 2, 4 and
    16 rows serve bitwise the single-device bucket's answers."""
    arch = "vikin-mixed"
    _, tparams, _, _ = _setup(arch, "f32")
    reqs = _reqs(arch, n)
    y1, _ = _serve(Engine(VikinBackend(VIKIN_ARCHS[arch], tparams,
                                       device="cpu"), n_slots=n), reqs)
    yn, sn = _serve(Engine(ShardedVikinBackend(
        VIKIN_ARCHS[arch], tparams, devices=CHIPS, device="cpu"),
        n_slots=n), reqs)
    assert np.array_equal(y1, yn) and sn["ticks"] == 1


@pytest.mark.parametrize("kw,match", [
    (dict(array=VikinArray(n_chips=3)), "array models 3 chips"),
    (dict(array=VikinArray(n_chips=CHIPS, plan="pipeline")),
     "is the 'data' array plan"),
    (dict(array=VikinArray(n_chips=CHIPS, precision="bf16")),
     "disagrees with the served precision"),
    (dict(array=VikinArray(n_chips=CHIPS,
                           hw=dataclasses.replace(VikinArray().hw,
                                                  clock_hz=1.0))),
     "array.hw disagrees"),
])
def test_sharded_backend_refuses_a_disagreeing_array(kw, match):
    _, tparams, _, _ = _setup("vikin-small", "f32")
    with pytest.raises(ValueError, match=match):
        ShardedVikinBackend(VIKIN_ARCHS["vikin-small"], tparams,
                            devices=CHIPS, device="cpu", **kw)


def test_devices_resolve_and_refuse(monkeypatch):
    cpu = torch.device("cpu")
    assert require_devices(3, device="cpu") == [cpu] * 3
    assert serving_devices(["cpu", "cpu"]) == [cpu] * 2
    with pytest.raises(ValueError, match="at least 1 device"):
        require_devices(0, device="cpu")
    with pytest.raises(ValueError, match="empty device list"):
        require_devices([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        require_devices(1)                       # default device cuda
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"4 devices requested \(ctx\) but "
                       r"only 1 visible.*\['cuda:0'\] \* 4"):
        require_devices(4, "ctx")
    with pytest.raises(ValueError, match="not visible"):
        require_devices(["cuda:1"])
