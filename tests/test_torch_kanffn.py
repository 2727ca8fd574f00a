"""Port parity: the FFN family, KAN-FFN transformer serving, its
calibration and the launcher's transformer path, against the JAX package.

On the CPU the port's fused-KAN and pattern-matmul kernels run their
plain versions.  Weights are the reference's ``jax.random`` draws carried
across by ``convert.transformer_params_from_jax``; prompts and inputs are
numpy draws from a seed.

Tolerances: f32 within ``TOL * (1 + max|ref|)``, ``TOL = 1e-5`` (the same
f32 ops, other summation orders; at M=1 the reference's own jnp path and
its kernel differ by an ulp, ``ROADMAP.md`` §3, so M=1 is held to
``M1_TOL``, a few ulps); whole models ``MODEL_TOL = 1e-4``.  bf16 within
one bf16 ulp an FFN (``2**-8 * (1 + max|ref|)``), and a model within one
ulp a layer.  bf16 KAN-FFN layers are held against the reference's
``impl="pallas_interpret"``: its bf16 masked ``impl="jnp"`` path fails
under XLA on the CPU.  Greedy tokens are compared exactly at f32.
"""
import dataclasses
import re
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.configs.registry import KANFFN_ARCHS as J_ARCHS  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core.engine import serving_report as j_report  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import ffn as JF  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime.backends import TransformerBackend as JBackend  # noqa
from repro.runtime.server import Server as JServer  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs.registry import ARCHS as T_ZOO  # noqa: E402
from repro_torch.configs.registry import KANFFN_ARCHS as T_ARCHS  # noqa
from repro_torch.convert import transformer_params_from_jax  # noqa: E402
from repro_torch.core.calibrate import calibrate_kanffn_masks  # noqa: E402
from repro_torch.core.engine import serving_report  # noqa: E402
from repro_torch.core.modes import RECONFIG_CYCLES, ExecMode  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import ffn as TF  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime.backends import TransformerBackend  # noqa: E402
from repro_torch.runtime.server import Engine, Server  # noqa: E402

TOL = 1e-5
M1_TOL = 8 * float(np.finfo(np.float32).eps)
MODEL_TOL = 1e-4
BF16_ULP = 2.0 ** -8


def close(got, ref, tol=TOL):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    scale = 1.0 + float(np.abs(ref).max())
    assert err <= tol * scale, (err, tol * scale)


def to_t(tree):
    return transformer_params_from_jax(jax.tree.map(np.asarray, tree))


def f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# -------------------------------------------------------------- ffn_apply
def _masks(cfg, seed=0):
    """A (basis_keep, hidden_keep) pair drawn from a seed."""
    rng = np.random.default_rng(seed)
    nb = cfg.kanffn_up_cfg().spec.n_bases
    h = cfg.kanffn_hidden
    return (tuple(sorted(int(i) for i in rng.choice(nb, nb // 2, False))),
            tuple(sorted(int(i) for i in rng.choice(h, h // 2, False))))


FFN_KINDS = ["mlp", "swiglu", "geglu", "kan", "kanffn"]


@pytest.mark.parametrize("kind", FFN_KINDS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_apply_every_kind(kind, masked, dtype):
    """f32 against the reference's jnp path; bf16 against
    ``pallas_interpret`` for the KAN kinds (its masked jnp path fails on
    the CPU), and its jnp path for the plain products."""
    kw = dict(d_model=32, d_ff=64, kind=kind, act="gelu", bias=kind == "mlp")
    if masked and kind != "kanffn":
        kw["pattern_rate"] = 0.5
    if masked and kind == "kanffn":
        kw["basis_keep"], kw["hidden_keep"] = _masks(JF.FFNConfig(**kw))
    interp = dtype == "bfloat16" and kind in ("kan", "kanffn")
    jc = JF.FFNConfig(**kw, kan_impl="pallas_interpret" if interp else "jnp")
    tc = TF.FFNConfig(**kw)
    assert tc.kanffn_hidden == jc.kanffn_hidden
    pj = JF.ffn_init(jax.random.key(3), jc, getattr(jnp, dtype))
    if kind == "mlp":
        pj = jax.tree.map(lambda a: a + jnp.asarray(0.01, a.dtype), pj)
    x = np.random.default_rng(4).normal(size=(2, 5, 32)).astype(np.float32)
    ref = JF.ffn_apply(pj, jnp.asarray(x, dtype), jc)
    got = TF.ffn_apply(to_t(pj), torch.from_numpy(x).to(getattr(torch,
                                                                dtype)), tc)
    assert got.dtype == getattr(torch, dtype)
    close(got, f32(ref), 2 * BF16_ULP if dtype == "bfloat16" else TOL)


def test_ffn_init_shapes_and_kan_impl():
    for kind in FFN_KINDS:
        jc = JF.FFNConfig(d_model=16, d_ff=48, kind=kind, bias=True)
        tc = TF.FFNConfig(d_model=16, d_ff=48, kind=kind, bias=True)
        shapes = jax.tree.map(lambda a: tuple(a.shape),
                              JF.ffn_init(jax.random.key(0), jc))
        got = jax.tree.map(lambda a: tuple(a.shape),
                           TF.ffn_init(torch.Generator().manual_seed(0), tc))
        assert got == shapes, kind
    with pytest.raises(ValueError, match="impl"):
        TF.FFNConfig(d_model=16, d_ff=48, kind="kanffn", kan_impl="jnp")
    with pytest.raises(ValueError, match="unknown ffn kind"):
        TF.ffn_init(None, TF.FFNConfig(d_model=16, d_ff=48, kind="moe"))


@pytest.mark.parametrize("masked", [False, True])
def test_kan_ffn_at_m1_within_a_few_ulps(masked):
    kw = dict(d_model=32, d_ff=64, kind="kanffn")
    if masked:
        kw["basis_keep"], kw["hidden_keep"] = _masks(JF.FFNConfig(**kw), 1)
    jc, tc = JF.FFNConfig(**kw, kan_impl="jnp"), TF.FFNConfig(**kw)
    pj = JF.ffn_init(jax.random.key(5), jc)
    x = np.random.default_rng(6).normal(size=(1, 32)).astype(np.float32)
    close(TF.kan_ffn_apply(to_t(pj), torch.from_numpy(x), tc),
          f32(JF.kan_ffn_apply(pj, jnp.asarray(x), jc)), M1_TOL)


def test_kan_ffn_module_is_one_kan_and_one_matmul():
    kw = dict(d_model=32, d_ff=64, kind="kanffn")
    bk, hk = _masks(JF.FFNConfig(**kw), 2)
    tc = TF.FFNConfig(**kw, basis_keep=bk, hidden_keep=hk)
    f = TF.KanFFN(tc, TF.ffn_init(torch.Generator().manual_seed(0), tc))
    assert f.up.kb == bk
    assert f.down.w_c.shape == (len(hk), 32)
    assert f.up.wt.shape == (32 * (len(bk) + 1), tc.kanffn_hidden)
    with pytest.raises(ValueError, match="kanffn"):
        TF.KanFFN(dataclasses.replace(tc, kind="kan"), {})


# ------------------------------------------------------- serving checks
@pytest.fixture(scope="module")
def ci_setup():
    cfg = T_ARCHS["kanffn-ci"]
    pj = JT.init_params(jax.random.key(0), J_ARCHS["kanffn-ci"])
    return cfg, pj, to_t(pj)


def _prompts(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size,
                         size=int(rng.integers(3, 8))).astype(np.int32)
            for _ in range(n)]


def _backend(cfg, params, **kw):
    return TransformerBackend(cfg, params, device="cpu", **kw)


def test_batched_equals_single_token_exact(ci_setup):
    cfg, _, params = ci_setup
    backend = _backend(cfg, params)
    prompts = _prompts(cfg, 5)
    eng = Engine(backend, n_slots=4, max_len=32)
    rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
    batched = eng.run_until_done()
    for i, p in enumerate(prompts):
        eng1 = Engine(backend, n_slots=4, max_len=32)
        rid = eng1.submit(p, max_new_tokens=4)
        assert batched[rids[i]] == eng1.run_until_done()[rid], i


def test_mode_plan_shape(ci_setup):
    cfg, _, params = ci_setup
    plan = _backend(cfg, params).plan
    assert plan.summary()["segments"] == [
        ("parallel", 4), ("pipeline", 1), ("parallel", 4)]
    assert plan.n_switches == 2
    assert plan.first_mode == plan.last_mode == ExecMode.PARALLEL


def test_stream_switches_carry_over(ci_setup):
    cfg, _, params = ci_setup
    plan = _backend(cfg, params).plan
    assert plan.stream_switches(3, None) == (6, ExecMode.PARALLEL)
    assert plan.stream_switches(3, ExecMode.PARALLEL) == (
        6, ExecMode.PARALLEL)
    assert plan.stream_switches(3, ExecMode.PIPELINE) == (
        7, ExecMode.PARALLEL)


@pytest.mark.parametrize("policy", ["fifo", "mode-affinity"])
def test_engine_flip_count_pins(ci_setup, policy):
    cfg, _, params = ci_setup
    prompts = _prompts(cfg, 4)
    new_tokens = 4
    eng = Engine(_backend(cfg, params), n_slots=2, max_len=32, policy=policy)
    for p in prompts:
        eng.submit(p, max_new_tokens=new_tokens)
    eng.run_until_done()
    instances = sum(len(p) for p in prompts) + len(prompts) * (new_tokens - 1)
    assert eng.stats["mode_switches"] == 2 * instances
    assert eng.stats["reconfig_cycles"] == 2 * instances * RECONFIG_CYCLES
    assert eng.hw_mode == ExecMode.PARALLEL


def test_cycle_attribution_sums_to_report(ci_setup):
    cfg, pj, params = ci_setup
    backend = _backend(cfg, params)
    ref = JBackend(J_ARCHS["kanffn-ci"], pj, impl="jnp")
    for batch in (1, 2, 5):
        for prev in (None, ExecMode.PARALLEL, ExecMode.PIPELINE):
            att = backend.cycle_attribution(batch, prev_mode=prev)
            rep = serving_report(backend.layers, backend.hw, batch=batch,
                                 prev_mode=prev, precision="f32")
            total = sum(att["per_layer_cycles"]) + att["reconfig_cycles"]
            assert np.isclose(total, rep["sim_cycles"], rtol=1e-12)
            assert len(att["per_layer_cycles"]) == len(backend.layers)
    jprev = type(ref.plan.first_mode)
    att_j = ref.cycle_attribution(3, prev_mode=jprev.PIPELINE)
    assert backend.cycle_attribution(3, ExecMode.PIPELINE) == att_j
    rep_j = j_report(ref.layers, ref.hw, batch=3, precision="f32")
    rep_t = serving_report(backend.layers, backend.hw, batch=3,
                           precision="f32")
    assert {k: v for k, v in rep_t.items() if k != "exit_mode"} == {
        k: v for k, v in rep_j.items() if k != "exit_mode"}


def test_engine_total_factorizes(ci_setup):
    cfg, _, params = ci_setup
    backend = _backend(cfg, params)
    prompts = _prompts(cfg, 3, seed=7)
    eng = Engine(backend, n_slots=2, max_len=32)
    for p in prompts:
        eng.submit(p, max_new_tokens=3)
    eng.run_until_done()
    instances = sum(len(p) for p in prompts) + len(prompts) * 2
    per_instance = serving_report(backend.layers, backend.hw, batch=1,
                                  precision="f32")["sim_cycles"]
    assert np.isclose(eng.stats["sim_cycles"], instances * per_instance,
                      rtol=1e-9)


def test_plain_arch_keeps_null_report(ci_setup):
    cfg, _, _ = ci_setup
    plain = dataclasses.replace(cfg, name="plain", ffn_kinds=None,
                                ffn_masks=None)
    params = TT.init_params(plain, torch.Generator().manual_seed(0))
    backend = _backend(plain, params)
    assert backend.plan is None and backend.layers is None
    assert backend.batch_report(2) is None
    with pytest.raises(ValueError, match="kan-ffn"):
        backend.cycle_attribution(1)


def test_masked_serving_runs_and_is_cheaper(ci_setup):
    cfg, pj, params = ci_setup
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    masks = calibrate_kanffn_masks(params, cfg, tokens, keep_per_group=2)
    assert masks == jcal.calibrate_kanffn_masks(
        pj, J_ARCHS["kanffn-ci"], tokens, keep_per_group=2, impl="jnp")
    assert masks[0] is None and masks[2] is None
    backend = _backend(cfg, params, masks=masks)
    eng = Engine(backend, n_slots=2, max_len=32)
    rid = eng.submit(np.array([3, 1, 4], np.int32), max_new_tokens=3)
    assert len(eng.run_until_done()[rid]) == 3
    dense = _backend(cfg, params)
    c_masked = serving_report(backend.layers, backend.hw, batch=1,
                              precision="f32")["sim_cycles"]
    c_dense = serving_report(dense.layers, dense.hw, batch=1,
                             precision="f32")["sim_cycles"]
    assert c_masked < c_dense


def test_backend_refusals(ci_setup):
    cfg, _, params = ci_setup
    with pytest.raises(ValueError, match="int8"):
        _backend(cfg, params, precision="int8")
    with pytest.raises(NotImplementedError, match="needs modality inputs"):
        _backend(T_ZOO["whisper-medium"].reduce(), params)


def test_bf16_backend_casts_the_params_once(ci_setup):
    cfg, _, params = ci_setup
    be = _backend(cfg, params, precision="bf16")
    assert be.cfg.dtype == "bfloat16" and be.precision == "bf16"
    assert all(a.dtype == torch.bfloat16 for a in jax.tree_util.tree_leaves(
        be.params))
    assert be.ffns[1].up.wt.dtype == torch.bfloat16
    assert params["embed"]["table"].dtype == torch.float32


# ------------------------------------------------- tokens vs reference
@pytest.mark.parametrize("arch", ["kanffn-ci", "qwen2-0.5b-kanffn"])
def test_server_tokens_equal_the_reference_at_f32(arch):
    jc = J_ARCHS[arch] if arch == "kanffn-ci" else J_ARCHS[arch].reduce()
    tc = T_ARCHS[arch] if arch == "kanffn-ci" else T_ARCHS[arch].reduce()
    pj = JT.init_params(jax.random.key(1), jc)
    prompts = _prompts(tc, 5, seed=3)
    js = JServer(jc, pj, n_slots=4, max_len=32, impl="jnp")
    ts = Server(tc, to_t(pj), n_slots=4, max_len=32, device="cpu")
    for p in prompts:
        js.submit(p, max_new_tokens=6)
        ts.submit(p, max_new_tokens=6)
    assert ts.run_until_done() == js.run_until_done()
    for k in ("served", "ticks", "sim_cycles", "dma_bytes", "mode_switches",
              "reconfig_cycles"):
        assert ts.stats[k] == js.stats[k], k
    assert ts.caches is ts.state


def test_single_token_prompts_m1(ci_setup):
    """One-token prompts prefill at M=1 (the reference's own fault there
    is an ulp): prefill logits within M1_TOL-scale of the reference."""
    cfg, pj, params = ci_setup
    jc = J_ARCHS["kanffn-ci"]
    tok = np.array([[17]], np.int32)
    lj, _ = JT.prefill(pj, jc, jnp.asarray(tok), max_len=16)
    lt, _ = TT.prefill(params, cfg, torch.from_numpy(tok), max_len=16)
    close(lt, f32(lj), MODEL_TOL)


@pytest.mark.parametrize("arch", ["kanffn-ci", "qwen2-0.5b-kanffn"])
def test_calibrated_masks_equal_the_reference(arch):
    jc = J_ARCHS[arch] if arch == "kanffn-ci" else J_ARCHS[arch].reduce()
    tc = T_ARCHS[arch] if arch == "kanffn-ci" else T_ARCHS[arch].reduce()
    pj = JT.init_params(jax.random.key(2), jc)
    toks = np.random.default_rng(4).integers(0, jc.vocab_size,
                                             size=(3, 16)).astype(np.int32)
    for keep in (1, 2, 3, 4):
        got = calibrate_kanffn_masks(to_t(pj), tc, toks, keep_per_group=keep)
        want = jcal.calibrate_kanffn_masks(pj, jc, toks, keep_per_group=keep,
                                           impl="jnp")
        assert got == want, keep
    with pytest.raises(ValueError, match="keep_per_group"):
        calibrate_kanffn_masks(to_t(pj), tc, toks, keep_per_group=5)
    with pytest.raises(ValueError, match="kan-ffn"):
        calibrate_kanffn_masks(to_t(pj), dataclasses.replace(
            tc, ffn_kinds=None, scan_layers=True), toks)


def test_masked_bf16_serving_against_pallas_interpret():
    """The bf16 KAN-FFN model with calibrated masks: prefill and decode
    logits against the reference's ``pallas_interpret`` path, one bf16
    ulp a layer."""
    jc = J_ARCHS["qwen2-0.5b-kanffn"].reduce(dtype="bfloat16")
    tc = T_ARCHS["qwen2-0.5b-kanffn"].reduce(dtype="bfloat16")
    pj = JT.init_params(jax.random.key(3), jc)
    pt = to_t(pj)
    toks = np.random.default_rng(5).integers(0, jc.vocab_size,
                                             size=(2, 10)).astype(np.int32)
    masks = calibrate_kanffn_masks(pt, tc, toks)
    jm = dataclasses.replace(jc, ffn_masks=masks, ffn_impl="pallas_interpret")
    tm = dataclasses.replace(tc, ffn_masks=masks)
    prompt = toks[:1, :6]
    lj, cj = JT.prefill(pj, jm, jnp.asarray(prompt), max_len=16)
    lt, ct = TT.prefill(pt, tm, torch.from_numpy(prompt), max_len=16)
    tol = 2 * tc.n_layers * BF16_ULP
    close(lt, f32(lj), tol)
    for _ in range(3):
        tok = np.asarray(JT.greedy_token(lj))
        lj, cj = JT.decode_step(pj, jm, jnp.asarray(tok), cj)
        lt, ct = TT.decode_step(pt, tm, torch.from_numpy(tok.copy()), ct)
        close(lt, f32(lj), tol)


# --------------------------------------------------------------- launcher
def _launch(capsys, *argv):
    srv = tserve.main(["--device", "cpu", "--requests", "3",
                       "--new-tokens", "3", *argv])
    return srv, capsys.readouterr().out


def _cycles(out):
    return float(re.search(r"simulated VIKIN: (\d+) cycles", out).group(1))


@pytest.mark.parametrize("arch,scale,precision", [
    ("kanffn-ci", "full", "f32"), ("qwen2-0.5b-kanffn", "smoke", "f32"),
    ("qwen2-0.5b-kanffn", "smoke", "bf16")])
def test_launcher_serves_kanffn_and_matches_the_reference_cycles(
        capsys, monkeypatch, arch, scale, precision):
    srv, out = _launch(capsys, "--arch", arch, "--scale", scale,
                       "--precision", precision)
    assert "kan-ffn hybrid" in out and "mode plan:" in out
    assert "simulated VIKIN" in out and isinstance(srv, Server)
    assert srv.stats["served"] == 3
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--scale", scale, "--requests", "3",
        "--new-tokens", "3", "--impl", "jnp", "--precision", precision])
    jserve.main()
    ref = capsys.readouterr().out
    assert _cycles(out) == _cycles(ref)


def test_launcher_serves_a_plain_arch(capsys):
    srv, out = _launch(capsys, "--arch", "qwen2-0.5b")
    assert "3 requests" in out and "simulated VIKIN" not in out
    assert srv.backend.plan is None


@pytest.mark.parametrize("argv,match", [
    (["--arch", "whisper-medium"], "modality"),
    (["--arch", "paligemma-3b"], "modality"),
    (["--arch", "kanffn-ci", "--trace", "t.json"], "--trace"),
    (["--arch", "kanffn-ci", "--max-queue", "4"], "max-queue"),
    (["--arch", "kanffn-ci", "--admission", "shed"], "max-queue"),
    (["--arch", "kanffn-ci", "--precision", "int8"], "int8"),
    (["--arch", "qwen2-0.5b", "--precision", "bf16"], "plain arch"),
    (["--arch", "kanffn-ci,vikin-mlp3"], "vikin-only"),
    (["--arch", "nope"], "unknown arch"),
])
def test_launcher_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        tserve.main(["--device", "cpu", *argv])
    if "nope" not in argv:
        with pytest.raises(SystemExit, match="transformer"):
            tserve.parse_archs("kanffn-ci")


def test_launcher_ckpt_dir_round_trip(tmp_path, capsys):
    """Params saved in the reference's layout come back through
    ``--ckpt-dir``, and the reference restores the port's file."""
    cfg = T_ARCHS["qwen2-0.5b-kanffn"].reduce()
    params = TT.init_params(cfg, torch.Generator().manual_seed(7))
    save_checkpoint(str(tmp_path), 5, {"params": params})
    srv, out = _launch(capsys, "--arch", "qwen2-0.5b-kanffn",
                       "--ckpt-dir", str(tmp_path))
    assert "restored params from step 5" in out
    got = jax.tree_util.tree_leaves(srv.params)
    assert all(torch.equal(a, b) for a, b in
               zip(got, jax.tree_util.tree_leaves(params)))
    jp = JT.init_params(jax.random.key(0), J_ARCHS["qwen2-0.5b-kanffn"]
                        .reduce())
    restored, step, _ = j_restore(str(tmp_path), {"params": jp})
    assert step == 5
    for a, b in zip(jax.tree_util.tree_leaves(restored["params"]),
                    jax.tree_util.tree_leaves(params)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_bf16_params_round_trip_through_a_checkpoint(tmp_path):
    cfg = T_ARCHS["kanffn-ci"]
    params = TT.init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                            torch.Generator().manual_seed(8))
    save_checkpoint(str(tmp_path), 1, params)
    from repro_torch.checkpoint import restore_checkpoint

    back, _, _ = restore_checkpoint(str(tmp_path), params)
    # every leaf bf16 but the KAN layers' f32 spline coefficients t, as the
    # reference draws them
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
               zip(jax.tree_util.tree_leaves(back),
                   jax.tree_util.tree_leaves(params)))
    assert {a.dtype for a in jax.tree_util.tree_leaves(back)} == {
        torch.bfloat16, torch.float32}
