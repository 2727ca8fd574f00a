"""The reference's launcher flags and ``VikinBackend`` arguments on the port.

The reference's serve launcher restores a vikin checkpoint from
``--ckpt-dir`` as well as ``--ckpt`` and takes ``--scale smoke|full``
(``reduce()`` under smoke, which leaves a paper model as it is); its
train launcher takes ``--scale`` and the vikin path ignores it.  Its
``VikinBackend`` takes ``hw``, ``min_bucket`` and ``nnz_rates``: the
port's reports must equal the reference's exactly for each.

Answers at ``min_bucket=1`` are held to the reference's within
``8 * eps32 * (1 + max|ref|)``, never bitwise: at batch 1 the reference's
jnp path contracts M=1 in another order than at M>=2 (largest seen
2.4 eps32 on vikin-mixed).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.vikin_models import VIKIN_ARCHS as J_ARCHS  # noqa: E402
from repro.core.engine import VikinHW as JHW  # noqa: E402
from repro.core.modes import ExecMode as JMode  # noqa: E402
from repro.models.ffn import vikin_stack_init as j_init  # noqa: E402
from repro.runtime.backends import VikinBackend as JBackend  # noqa: E402
from repro.runtime.server import Engine as JEngine  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.convert import stack_params_from_jax  # noqa: E402
from repro_torch.core.engine import VikinHW  # noqa: E402
from repro_torch.core.modes import ExecMode  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.ffn import vikin_stack_init  # noqa: E402
from repro_torch.runtime.backends import (  # noqa: E402
    MultiWorkloadBackend,
    VikinBackend,
)
from repro_torch.runtime.server import Engine  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
M1_TOL = 8 * EPS32
HW_OVER = {"clock_hz": 200e6, "simd_lanes": 8, "simd_latency": 6}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A vikin-kan2 checkpoint written by the port's train launcher under
    the reference's ``--scale`` flag."""
    d = tmp_path_factory.mktemp("ck")
    ttrain.main(["--arch", "vikin-kan2", "--steps", "3", "--batch", "8",
                 "--scale", "full", "--device", "cpu", "--ckpt-dir", str(d)])
    return d


def _served(eng, arch):
    """The answers of the launcher's engine to a fresh seeded burst."""
    rids = tserve.submit_burst(eng, tserve.parse_archs(arch), 6, seed=1)
    out = eng.run_until_done()
    return np.stack([out[r] for r in sorted(rids)])


@pytest.mark.parametrize("flag", ["--ckpt-dir", "--ckpt"])
def test_serve_restores_the_checkpoint_from_either_flag(ckpt, flag, capsys):
    eng = tserve.main(["--arch", "vikin-kan2", flag, str(ckpt), "--scale",
                       "full", "--device", "cpu", "--requests", "5"])
    assert f"restored vikin-kan2 from {ckpt} step 3" in capsys.readouterr().out
    model = VIKIN_ARCHS["vikin-kan2"]
    params, step, _ = restore_checkpoint(ckpt, vikin_stack_init(model))
    assert step == 3
    for got, ref in zip(eng.backend.stack.layers[0].state_dict().items(),
                        VikinBackend(model, params, device="cpu").stack
                        .layers[0].state_dict().items()):
        assert got[0] == ref[0] and torch.equal(got[1], ref[1])


def test_serve_ckpt_dir_answers_equal_ckpt(ckpt):
    runs = [_served(tserve.main(["--arch", "vikin-kan2", flag, str(ckpt),
                                 "--device", "cpu"]), "vikin-kan2")
            for flag in ("--ckpt", "--ckpt-dir")]
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.parametrize("arch", ["vikin-kan2", "vikin-mixed",
                                  "vikin-mlp3,vikin-kan2"])
def test_serve_scale_smoke_equals_full(arch):
    """reduce() leaves a paper model as it is, so --scale changes no
    answer and no simulated field."""
    engs = [tserve.main(["--arch", arch, "--scale", scale, "--device", "cpu",
                         "--requests", "6"]) for scale in ("smoke", "full")]
    np.testing.assert_array_equal(_served(engs[0], arch),
                                  _served(engs[1], arch))
    assert engs[0].stats["sim_cycles"] == engs[1].stats["sim_cycles"]


def test_serve_refuses_ckpt_dir_for_several_archs(ckpt):
    with pytest.raises(SystemExit, match="one arch"):
        tserve.main(["--arch", "vikin-kan2,vikin-mlp3", "--ckpt-dir",
                     str(ckpt), "--device", "cpu"])


@pytest.mark.parametrize("scale", ["smoke", "full"])
def test_train_takes_scale(tmp_path, scale):
    out = ttrain.main(["--arch", "vikin-small", "--steps", "2", "--batch",
                       "8", "--scale", scale, "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)])
    assert out["ckpt_dir"] == str(tmp_path)


def test_train_refuses_unknown_scale():
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", "vikin-small", "--scale", "tiny"])


def _pair(arch, **kw):
    """(reference backend, port backend) on the same weights."""
    jp = j_init(jax.random.key(0), J_ARCHS[arch])
    npp = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    jkw, tkw = dict(kw), dict(kw)
    if "hw" in kw:
        jkw["hw"] = dataclasses.replace(JHW(), **kw["hw"])
        tkw["hw"] = dataclasses.replace(VikinHW(), **kw["hw"])
    jb = JBackend(J_ARCHS[arch], jp, **jkw)
    tb = VikinBackend(VIKIN_ARCHS[arch],
                      stack_params_from_jax(npp, VIKIN_ARCHS[arch]),
                      device="cpu", **tkw)
    return jb, tb


def _report(rep):
    rep = dict(rep)
    if "exit_mode" in rep:
        rep["exit_mode"] = rep["exit_mode"].value
    return rep


NNZ = {"vikin-mixed": [1.0, 0.43, 0.61], "vikin-mlp3": [1.0, 0.55],
       "vikin-kan2": [1.0]}
BACKEND_ARGS = {
    "default": {},
    "hw": {"hw": HW_OVER},
    "min_bucket_1": {"min_bucket": 1},
    "nnz_rates": {"nnz": True},
    "all": {"hw": HW_OVER, "min_bucket": 1, "nnz": True},
}


@pytest.mark.parametrize("which", sorted(BACKEND_ARGS))
@pytest.mark.parametrize("arch", sorted(NNZ))
def test_backend_reports_equal_reference(arch, which):
    kw = dict(BACKEND_ARGS[which])
    if kw.pop("nnz", False):
        kw["nnz_rates"] = NNZ[arch]
    jb, tb = _pair(arch, **kw)
    assert tb.min_bucket == jb.min_bucket == kw.get("min_bucket", 2)
    assert dataclasses.asdict(tb.hw) == dataclasses.asdict(jb.hw)
    for n in range(1, 10):
        assert tb.bucket(n) == jb.bucket(n)
        for prev in (None, "parallel", "pipeline"):
            jprev = None if prev is None else JMode(prev)
            tprev = None if prev is None else ExecMode(prev)
            assert _report(tb.batch_report(n, prev_mode=tprev)) == \
                _report(jb.batch_report(n, prev_mode=jprev))


def test_nnz_rates_reach_the_cycle_model():
    """A measured density below 1 makes the MLP layers' zero-skip
    cheaper, in both packages alike."""
    dense = _pair("vikin-mlp3")[1].batch_report(4)
    sparse = _pair("vikin-mlp3", nnz_rates=[1.0, 0.3])[1].batch_report(4)
    assert sparse["sim_cycles"] < dense["sim_cycles"]


@pytest.mark.parametrize("arch", sorted(NNZ))
def test_min_bucket_1_answers_within_a_few_ulp_of_reference(arch):
    jb, tb = _pair(arch, min_bucket=1)
    rng = np.random.default_rng(3)
    for n in (1, 3):
        xs = rng.random((n, 72), dtype=np.float32)
        outs = []
        for backend, engine in ((jb, JEngine), (tb, Engine)):
            eng = engine(backend, n_slots=4)
            rids = [eng.submit(x) for x in xs]
            out = eng.run_until_done()
            outs.append(np.stack([out[r] for r in rids]))
        ref, got = outs
        err = float(np.abs(got - ref).max())
        assert err <= M1_TOL * (1 + float(np.abs(ref).max())), (n, err)


def test_min_bucket_1_serves_one_row_and_multi_buckets_follow():
    """min_bucket=1 serves a lone request as a batch of one; a
    multi-workload engine reads each sub-backend's own bucket."""
    model = VIKIN_ARCHS["vikin-kan2"]
    params = vikin_stack_init(model, torch.Generator().manual_seed(0))
    b1 = VikinBackend(model, params, device="cpu", min_bucket=1)
    b2 = VikinBackend(model, params, device="cpu")
    assert (b1.bucket(1), b2.bucket(1)) == (1, 2)
    multi = MultiWorkloadBackend({"a": b1, "b": b2})
    assert multi.bucket_for("a", 1) == 1 and multi.bucket_for("b", 1) == 2
    eng = Engine(b1, n_slots=2)
    x = np.random.default_rng(0).random(72, dtype=np.float32)
    rid = eng.submit(x)
    got = eng.run_until_done()[rid]
    with torch.inference_mode():
        ref = b1.stack(torch.from_numpy(x[None]))[0].numpy()
    np.testing.assert_array_equal(got, ref)
