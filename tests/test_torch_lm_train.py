"""Port parity: LM training (int8 gradient compression, the bf16 KAN
gradient, the train step, ``Trainer``, its checkpoints and the train
launcher's transformer branch) against the JAX package, on the CPU.

Both packages start from the reference's draw (``init_train_state``),
carried across with ``convert.transformer_params_from_jax``, and see the
same batch.  The reference's step is jitted with ``adamw_update`` (and
``compressed_allreduce``) wrapped to hand back the gradients they got.
Tolerances, each measured with margin on this CPU:

* the compression functions on the same inputs: bitwise (``jnp.round``
  and ``torch.round`` both round half to even);
* a KAN layer's bf16 gradient: bitwise (the port's backward rounds where
  ``jax.grad`` of the reference's jnp layer rounds); its f32 gradient
  within ``1e-6 * (1 + max|ref|)``, as ``tests/test_torch_train.py``
  holds it;
* an f32 step: the loss within 1e-6 relative (largest seen 2.2e-7), each
  gradient leaf within ``1e-5 * (1 + max|ref|)`` (largest seen 1.2e-6,
  paligemma's embedding); under compression an int8 code may round
  across a half-step, so the compressed gradient is held within one
  quantization step of the leaf; three steps' losses within 1e-5;
* a bf16 step (the reduced qwen2-0.5b with the KAN drop-in): the loss
  within 1e-4 relative, each gradient leaf within 2 bf16 ulps of ``1 +
  max|ref|`` (largest seen 0.9 ulp: the reference's XLA fuses bf16 ops
  where the port rounds each).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.optim as j_optim  # noqa: E402
from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core.splines import SplineSpec as JSpec  # noqa: E402
from repro.data.lm import LMDataConfig as JDataConfig  # noqa: E402
from repro.data.lm import SyntheticLM as JSynthetic  # noqa: E402
from repro.kernels.kan_fused.ops import _kan_linear_jnp  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.runtime.trainer import Trainer as JTrainer  # noqa: E402
from repro.runtime.trainer import TrainerConfig as JTrainerConfig  # noqa
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.configs.registry import (  # noqa: E402
    ARCHS,
    get_config,
    get_shape,
)
from repro_torch.convert import transformer_params_from_jax  # noqa: E402
from repro_torch.core.splines import SplineSpec  # noqa: E402
from repro_torch.data.lm import LMDataConfig, SyntheticLM  # noqa: E402
from repro_torch.examples import train_lm as t_example  # noqa: E402
from repro_torch.kernels.kan_fused.ops import kan_linear  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh as make_torch_host_mesh  # noqa
from repro_torch.launch.mesh import set_mesh  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402
from repro_torch.runtime.trainer import (  # noqa: E402
    SimulatedFailure,
    Trainer,
    TrainerConfig,
)
from repro_torch.utils import leaf_from_numpy, leaf_paths  # noqa: E402

LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
STEPS_RTOL = 1e-5
KAN_F32_TOL = 1e-6
BF16_ULP = 2.0 ** -8
BF16_STEP_GRAD_ULPS = 2
BF16_STEP_LOSS_RTOL = 1e-4
KAN_DROP_IN = {"ffn_kind": "kan", "pattern_rate": 0.5}
B, S = 2, 8


def _np(a):
    if torch.is_tensor(a):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _close(got, ref, tol, what=""):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert got.shape == ref.shape, what
    assert np.all(np.isfinite(got)), what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= tol * (1.0 + float(np.abs(ref).max())), (what, err)


def _bits(a):
    """A tensor's or array's raw bytes with its dtype's name (bf16 as the
    16-bit patterns)."""
    if torch.is_tensor(a):
        if a.dtype == torch.bfloat16:
            return "bf16", a.view(torch.int16).numpy().tobytes()
        return str(a.dtype).split(".")[-1], a.numpy().tobytes()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return "bf16", a.view(np.int16).tobytes()
    return a.dtype.name, a.tobytes()


def _jflat(tree):
    return {jtu.keystr(p): v for p, v in jtu.tree_flatten_with_path(tree)[0]}


def _cfgs(arch, **over):
    return (dataclasses.replace(j_get_config(arch).reduce(), **over),
            dataclasses.replace(get_config(arch).reduce(), **over))


def _batch(tcfg, seed=0):
    """Tokens (B, S+1), and the modality stub ``launch/specs`` gives the
    arch, 0.1 N(0, 1) in the params' dtype, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, tcfg.vocab_size,
                                  (B, S + 1)).astype(np.int32)}
    for k, spec in TSP.frontend_specs(tcfg, B).items():
        stub = 0.1 * rng.standard_normal(tuple(spec.shape))
        out[k] = stub.astype(jnp.dtype(tcfg.dtype))
    return out


def _ref_step(jcfg, opts, state, batch, monkeypatch):
    """The reference's jitted step; returns (state, metrics, gradients
    into AdamW, raw gradients before compression or None)."""
    orig_adamw, orig_comp = JS.adamw_update, j_optim.compressed_allreduce

    def adamw(grads, *a, **k):
        p, o, m = orig_adamw(grads, *a, **k)
        return p, o, {**m, "grads": grads}

    def comp(grads, residual, *a, **k):
        deq, res = orig_comp(grads, residual, *a, **k)
        return deq, {"res": res, "raw": grads}

    monkeypatch.setattr(JS, "adamw_update", adamw)
    monkeypatch.setattr(j_optim, "compressed_allreduce", comp)
    step = jax.jit(JS.make_train_step(jcfg, make_host_mesh(), opts))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    monkeypatch.undo()
    grads = metrics.pop("grads")
    raw = None
    if opts.grad_compression:
        raw = new["ef_residual"]["raw"]
        new["ef_residual"] = new["ef_residual"]["res"]
    return new, metrics, grads, raw


def _port_step(tcfg, opts, state, batch, monkeypatch):
    """The port's step with the same gradients handed back."""
    seen = {}
    orig_adamw, orig_comp = TS.adamw_update, TS.compressed_allreduce

    def adamw(grads, *a, **k):
        seen["grads"] = grads
        return orig_adamw(grads, *a, **k)

    def comp(grads, *a, **k):
        seen["raw"] = grads
        return orig_comp(grads, *a, **k)

    monkeypatch.setattr(TS, "adamw_update", adamw)
    monkeypatch.setattr(TS, "compressed_allreduce", comp)
    new, metrics = TS.make_train_step(tcfg, opts)(
        state, {k: leaf_from_numpy(v) for k, v in batch.items()})
    monkeypatch.undo()
    return new, metrics, seen["grads"], seen.get("raw")


def _opts(mod, **kw):
    return mod.StepOptions(lr=1e-2, total_steps=3, warmup=0, **kw)


def _carried(jcfg, opts_j, opts_t, tcfg):
    jstate = JS.init_train_state(jax.random.key(0), jcfg, opts_j)
    tstate = TS.init_train_state(
        tcfg, opts_t, params=transformer_params_from_jax(jstate["params"]))
    return jstate, tstate


def _hold_grads(got, ref, tol, what):
    gf, rf = dict(leaf_paths(got)), _jflat(ref)
    assert sorted(gf) == sorted(rf), what
    for k in rf:
        assert gf[k].dtype == leaf_from_numpy(np.asarray(rf[k])).dtype, k
        _close(gf[k], rf[k], tol, f"{what} {k}")


# ------------------------------------------------------------ compression

def test_compression_bitwise():
    rng = np.random.default_rng(0)
    leaves = {"a": rng.standard_normal((7, 5)).astype(np.float32),
              "b": [rng.standard_normal(13).astype(np.float32) * 1e-3],
              "c": np.asarray(rng.standard_normal((4, 3)) * 3,
                              dtype=jnp.bfloat16)}
    # exact half-steps: x / scale = k + 0.5 rounds to even in both
    leaves["d"] = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -2.5],
                             np.float32)
    jg = jax.tree.map(jnp.asarray, leaves)
    tg = jax.tree.map(leaf_from_numpy, leaves)
    q_j, s_j = j_optim.compress_int8(jnp.asarray(leaves["d"]))
    q_t, s_t = TC.compress_int8(tg["d"])
    assert _bits(q_t) == _bits(np.asarray(q_j))
    assert _bits(s_t) == _bits(np.asarray(s_j))
    assert q_t.tolist() == [127, 0, 2, 2, 0, -2]
    assert _bits(TC.decompress_int8(q_t, s_t)) == _bits(
        np.asarray(j_optim.decompress_int8(q_j, s_j)))
    jr, tr = j_optim.init_compression(jg), TC.init_compression(tg)
    for _ in range(3):      # the residual carried three rounds
        jd, jr = j_optim.compressed_allreduce(jg, jr)
        td, tr = TC.compressed_allreduce(tg, tr)
        for name, got, ref in (("deq", td, jd), ("res", tr, jr)):
            gf, rf = dict(leaf_paths(got)), _jflat(ref)
            assert sorted(gf) == sorted(rf)
            for k in rf:
                assert _bits(gf[k]) == _bits(np.asarray(rf[k])), (name, k)
    # over a mesh axis it needs a process mesh (4 ranks against the
    # reference's shard_map: tests/test_torch_compression.py); on the
    # 1x1 host mesh the all-reduce is the round trip, bitwise
    with pytest.raises(ValueError, match="process mesh"):
        TC.compressed_allreduce(tg, tr, axis_name="data")
    with set_mesh(make_torch_host_mesh()):
        md, mr = TC.compressed_allreduce(tg, tr, axis_name="data")
    td, t2 = TC.compressed_allreduce(tg, tr)
    for got, ref in ((md, td), (mr, t2)):
        for (k, a), (_, b) in zip(leaf_paths(got), leaf_paths(ref)):
            assert _bits(a) == _bits(b), k


# ------------------------------------------------------ the KAN gradient

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("G,K,kb", [(4, 3, (0, 2, 4, 5, 6)), (8, 2, None),
                                    (16, 4, (1, 3, 5, 7, 9, 11, 13, 15, 17,
                                             19)), (4, 1, None)])
def test_kan_grad_matches_jax(G, K, kb, dtype):
    """``kan_linear``'s gradient (x, w_b and t) against ``jax.grad`` of the
    reference's jnp layer: bf16 bitwise, f32 within KAN_F32_TOL; inputs
    past the grid, at both bounds (as the dtype rounds them) and on
    knots."""
    spec, jspec = SplineSpec(G, K), JSpec(G, K)
    kbb = tuple(range(spec.n_bases)) if kb is None else kb
    jdt = jnp.dtype(dtype)
    rng = np.random.default_rng(G * 10 + K)
    n_in, n_out, nb = 24, 10, 40
    x = rng.standard_normal((nb, n_in)).astype(np.float32)
    x[0, :5] = [spec.x0, spec.clip_hi, 1.0, -1.5, 0.0]
    x[1, :G + 1] = np.linspace(-1.0, 1.0, G + 1)
    arrays = [x.astype(jdt),
              (rng.standard_normal((n_in, n_out)) * 0.1).astype(jdt),
              (rng.standard_normal((n_in * len(kbb), n_out)) * 0.1
               ).astype(jdt)]
    cot = rng.standard_normal((nb, n_out)).astype(jdt)

    def f(xx, wb, tf):
        y = _kan_linear_jnp(xx, wb, tf, jspec, kbb, 2)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(cot, jnp.float32))

    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    ts = [leaf_from_numpy(a).requires_grad_(True) for a in arrays]
    y = kan_linear(*ts, spec, kbb)
    assert y.dtype == getattr(torch, dtype)
    (y.float() * leaf_from_numpy(cot).float()).sum().backward()
    for t, r, name in zip(ts, ref, ("dx", "dw_b", "dt")):
        assert t.grad.dtype == t.dtype, name
        if dtype == "bfloat16":
            assert _bits(t.grad) == _bits(np.asarray(r)), name
        else:
            _close(t.grad, r, KAN_F32_TOL, name)


# ------------------------------------------------------------ train steps

@pytest.mark.parametrize("compression", [False, True])
def test_kan_drop_in_step_matches_reference(compression, monkeypatch):
    jcfg, tcfg = _cfgs("qwen2-0.5b", **KAN_DROP_IN)
    oj = _opts(JS, grad_compression=compression)
    ot = _opts(TS, grad_compression=compression)
    jstate, tstate = _carried(jcfg, oj, ot, tcfg)
    batch = _batch(tcfg)
    jnew, jm, jg, jraw = _ref_step(jcfg, oj, jstate, batch, monkeypatch)
    tnew, tm, tg, traw = _port_step(tcfg, ot, tstate, batch, monkeypatch)
    for k in ("loss", "total_loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_RTOL * abs(
            float(jm[k])), k
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        GRAD_TOL * float(jm["grad_norm"])
    assert float(tm["lr"]) == float(jm["lr"])
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    if not compression:
        _hold_grads(tg, jg, GRAD_TOL, "grad")
        return
    _hold_grads(traw, jraw, GRAD_TOL, "raw grad")
    # within one int8 step of the leaf (a code may round across a half)
    rf, gf = _jflat(jraw), dict(leaf_paths(traw))
    for k, v in _jflat(jg).items():
        step = float(np.abs(np.asarray(rf[k], np.float32)).max()) / 127
        assert float(np.abs(_np(dict(leaf_paths(tg))[k]) - _np(v)).max()) \
            <= 1.0001 * step + GRAD_TOL * (1 + float(np.abs(_np(v)).max())), k
        assert _np(gf[k]).shape == _np(v).shape
    assert sorted(dict(leaf_paths(tnew["ef_residual"]))) == sorted(
        _jflat(jnew["ef_residual"]))


def test_kan_drop_in_three_steps(monkeypatch):
    jcfg, tcfg = _cfgs("qwen2-0.5b", **KAN_DROP_IN)
    oj, ot = _opts(JS), _opts(TS)
    jstate, tstate = _carried(jcfg, oj, ot, tcfg)
    jstep = jax.jit(JS.make_train_step(jcfg, make_host_mesh(), oj))
    tstep = TS.make_train_step(tcfg, ot)
    for s in range(3):
        batch = _batch(tcfg, seed=s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, {k: leaf_from_numpy(v)
                                    for k, v in batch.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= STEPS_RTOL * \
            abs(float(jm["loss"])), s


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_zoo_arch_step_matches_reference(arch, monkeypatch):
    """One step of every arch of the zoo, reduced: the loss (with the MoE
    archs' aux at ``aux_weight``) and every gradient leaf; frames or
    patches as ``launch/specs.input_specs`` makes them."""
    jcfg, tcfg = _cfgs(arch)
    oj, ot = _opts(JS), _opts(TS)
    jstate, tstate = _carried(jcfg, oj, ot, tcfg)
    batch = _batch(tcfg)
    specs = TSP.input_specs(tcfg, dataclasses.replace(
        get_shape("train_4k"), seq_len=S, global_batch=B))
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        k: v.shape for k, v in batch.items()}
    _, jm, jg, _ = _ref_step(jcfg, oj, jstate, batch, monkeypatch)
    _, tm, tg, _ = _port_step(tcfg, ot, tstate, batch, monkeypatch)
    for k in ("loss", "total_loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_RTOL * abs(
            float(jm[k])), k
    _hold_grads(tg, jg, GRAD_TOL, arch)


def test_bf16_kan_drop_in_step_matches_reference(monkeypatch):
    """The reference's bf16 step runs on this CPU; the port's bf16 step
    (the bf16 KAN gradient inside) is held to it.  The reference's
    ``kan_init`` leaves the spline coefficients ``t`` f32 in a bf16 model
    (``0.1 * scale_b`` is a numpy float64, which promotes); carried
    across, they keep f32 here too, and so do their gradients."""
    jcfg, tcfg = _cfgs("qwen2-0.5b", dtype="bfloat16", **KAN_DROP_IN)
    oj, ot = _opts(JS), _opts(TS)
    jstate, tstate = _carried(jcfg, oj, ot, tcfg)
    dtypes = {k: v.dtype for k, v in leaf_paths(tstate["params"])}
    assert {k for k, d in dtypes.items() if d != torch.bfloat16} == {
        f"['units']['slot0']['ffn']['{w}']['t']"
        for w in ("kan_up", "kan_down")}
    batch = _batch(tcfg)
    _, jm, jg, _ = _ref_step(jcfg, oj, jstate, batch, monkeypatch)
    _, tm, tg, _ = _port_step(tcfg, ot, tstate, batch, monkeypatch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        BF16_STEP_LOSS_RTOL * abs(float(jm["loss"]))
    _hold_grads(tg, jg, BF16_STEP_GRAD_ULPS * BF16_ULP, "bf16 grad")


# ------------------------------------------------------------ the Trainer

def _tiny(tmp_path, max_steps=8, failure_at=None, ckpt_every=2, params=None):
    cfg = get_config("qwen2-0.5b").reduce(n_layers=2, d_model=32, d_ff=64,
                                          vocab_size=64)
    data = SyntheticLM(LMDataConfig(vocab_size=64, seq_len=16,
                                    global_batch=4, seed=7))
    tcfg = TrainerConfig(max_steps=max_steps, ckpt_dir=str(tmp_path / "ck"),
                         ckpt_every=ckpt_every, failure_at=failure_at,
                         log_every=100)
    opts = TS.StepOptions(lr=1e-2, total_steps=max_steps, warmup=0)
    return Trainer(cfg, tcfg, "cpu", data, opts, params=params)


def test_trainer_loss_decreases(tmp_path):
    out = _tiny(tmp_path, max_steps=12).run()
    losses = [m["loss"] for m in out["metrics"]]
    assert out["final_step"] == 12
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()
    assert all(m["step_time_s"] > 0 for m in out["metrics"])


def test_trainer_failure_injection_raises(tmp_path):
    tr = _tiny(tmp_path, failure_at=3)
    with pytest.raises(SimulatedFailure):
        tr.run()
    assert tr.step == 3


def test_trainer_restart_is_bitwise_a_clean_run(tmp_path):
    """Killed at step 5, restarted from the checkpoint at step 4: the
    final params, moments and losses are the clean run's, bit for bit."""
    clean = _tiny(tmp_path / "a")
    clean_out = clean.run()
    faulty = _tiny(tmp_path / "b", failure_at=5, ckpt_every=1)
    out = faulty.run_with_restarts(max_restarts=2)
    assert out["final_step"] == 8
    for (ka, a), (kb, b) in zip(leaf_paths(clean.state),
                                leaf_paths(faulty.state)):
        assert ka == kb and _bits(a) == _bits(b), ka
    by_step = {m["step"]: m["loss"] for m in out["metrics"]}
    assert [by_step[m["step"]] for m in clean_out["metrics"]] == \
        [m["loss"] for m in clean_out["metrics"]]


def test_trainer_straggler_watchdog_fires(tmp_path):
    events = []
    tr = _tiny(tmp_path, max_steps=10)
    tr.on_straggler = lambda s, dt: events.append(s)
    for s in range(6):
        tr._watchdog(s, 0.01)
    tr._watchdog(6, 0.5)
    assert events == [6]


def test_trainer_matches_reference_trainer(tmp_path):
    """The reference's Trainer and the port's from the same params: every
    step's loss, and a checkpoint either wrote restores in the other."""
    jcfg = j_get_config("qwen2-0.5b").reduce(n_layers=2, d_model=32,
                                             d_ff=64, vocab_size=64)
    jdata = JSynthetic(JDataConfig(vocab_size=64, seq_len=16,
                                   global_batch=4, seed=7))
    jtr = JTrainer(jcfg, JTrainerConfig(
        max_steps=4, ckpt_dir=str(tmp_path / "j"), ckpt_every=2,
        log_every=100), make_host_mesh(), jdata,
        JS.StepOptions(lr=1e-2, total_steps=4, warmup=0))
    params0 = transformer_params_from_jax(jtr.state["params"])
    jout = jtr.run()
    tr = _tiny(tmp_path / "t", max_steps=4, params=params0)
    out = tr.run()
    for jm, tm in zip(jout["metrics"], out["metrics"]):
        assert abs(tm["loss"] - jm["loss"]) <= STEPS_RTOL * abs(jm["loss"])
    # the reference's checkpoint into the port's state, and back
    restored, step, _ = restore_checkpoint(str(tmp_path / "j"), tr.state)
    assert step == 4
    want = _jflat(jtr.state)
    got = dict(leaf_paths(restored))
    assert sorted(got) == sorted(want)
    for k in want:
        assert _bits(got[k]) == _bits(np.asarray(want[k])), k
    back, step, _ = j_restore(str(tmp_path / "t" / "ck"), jtr.state)
    assert step == 4
    for k, v in _jflat(back).items():
        assert _bits(np.asarray(v)) == _bits(dict(leaf_paths(tr.state))[k])


# ------------------------------------------------------------ entry points

def test_launcher_trains_a_transformer_on_cpu(tmp_path, capsys):
    out = ttrain.main(["--arch", "qwen2-0.5b", "--steps", "3", "--seq", "8",
                       "--batch", "2", "--ffn", "kan", "--pattern", "0.5",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 3 and len(out["metrics"]) == 3
    assert np.isfinite([m["loss"] for m in out["metrics"]]).all()
    assert "final step 3, loss" in capsys.readouterr().out
    assert (tmp_path / "step_3" / "manifest.json").exists()


@pytest.mark.parametrize("arch,shape", [("xlstm-125m", "long_500k"),
                                        ("qwen2-0.5b", "decode_32k")])
def test_launcher_dry_run_writes_both_meshes(arch, shape, tmp_path,
                                             monkeypatch):
    # --dry-run counts the cell on meta on both production meshes
    # (launch/dryrun), as the reference re-execs its dryrun, and exits
    # with its code
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--arch", arch, "--shape", shape, "--dry-run"])
    assert e.value.code == 0
    for tag, mesh in (("single", "16x16"), ("multi", "2x16x16")):
        rec = json.loads((tmp_path / f"{arch}__{shape}__{tag}.json")
                         .read_text())
        assert rec["ok"] and rec["mesh"] == mesh and rec["shape"] == shape
        assert rec["full"]["flops"] > 0 and rec["counted_by"] == "torch meta"


def test_example_restarts_after_injected_failure(tmp_path, capsys):
    out = t_example.main(["--steps", "12", "--ffn", "kan", "--pattern",
                          "0.5", "--inject-failure", "--seq", "8",
                          "--batch", "2", "--d-model", "32", "--layers", "2",
                          "--vocab", "64", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 12
    text = capsys.readouterr().out
    assert "injected failure at step 6" in text and "done: step 12" in text
