"""Port parity: training (the kernels' gradients, StackTrainer and the
train launcher) against the JAX package, on the CPU.

The reference differentiates its jnp path with ``jax.grad``; the port's
f32 KAN and matmul wrappers carry ``torch.autograd.Function``s whose
backward is written out in torch ops (on the CPU their forward is the
plain version, and the KAN backward's bases come from the spline-basis
wrapper's plain version).  Tolerances, each measured with margin:

* a layer gradient within ``1e-6 * (1 + max|ref|)`` (largest seen
  2.1e-7: the analytic spline derivative and XLA's autodiff of the de
  Boor recursion round apart);
* StackTrainer: each step's loss within 1e-5 relative and its gradient
  norm within 1e-5 relative; params after the run within ``2e-5 * (1 +
  max|ref|)`` a leaf (largest seen 2.4e-6 after one vikin-mixed step,
  1.0e-6 after 25 vikin-small steps): Adam's first steps are about
  ``lr * sign(g)``, so a gradient entry near zero turns an ulp of
  difference into a larger share of a step of size lr = 1e-2.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.checkpoint import restore_masks as j_restore_masks  # noqa: E402
from repro.checkpoint import restore_scales as j_restore_scales  # noqa
from repro.configs.vikin_models import VIKIN_ARCHS as J_ARCHS  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core.kan import KANConfig as JKANConfig  # noqa: E402
from repro.core.kan import kan_apply as j_kan_apply  # noqa: E402
from repro.core.splines import SplineSpec as JSpec  # noqa: E402
from repro.data.stack_task import task_for_model as j_task  # noqa: E402
from repro.kernels.pattern_matmul.ops import (  # noqa: E402
    pattern_linear as j_pattern_linear,
)
from repro.models.ffn import vikin_stack_init as j_stack_init  # noqa: E402
from repro.runtime.trainer import StackTrainer as JTrainer  # noqa: E402
from repro.runtime.trainer import (  # noqa: E402
    StackTrainerConfig as JTrainerConfig,
)
from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    stack_params_from_jax,
    stack_params_to_numpy,
)
from repro_torch.core.kan import KANConfig, kan_apply  # noqa: E402
from repro_torch.core.splines import SplineSpec  # noqa: E402
from repro_torch.data.stack_task import task_for_model  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.kan_fused.ops import (  # noqa: E402
    KanFusedV2,
    fuse_wt,
    kan_fused_v1,
    kan_fused_v2,
    kan_fused_v2_q8,
    kan_linear,
)
from repro_torch.kernels.kan_fused.ref import kan_fused_v2_ref  # noqa
from repro_torch.kernels.pattern_matmul.ops import (  # noqa: E402
    MatmulCompact,
    matmul_compact,
)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.ffn import vikin_stack_apply  # noqa: E402
from repro_torch.runtime.trainer import (  # noqa: E402
    StackTrainer,
    StackTrainerConfig,
)
from repro_torch.utils import leaf_paths  # noqa: E402

GRAD_TOL = 1e-6
LOSS_RTOL = 1e-5
PARAM_TOL = 2e-5


def _close(got, ref, tol, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    assert np.all(np.isfinite(got)), what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= tol * (1.0 + float(np.abs(ref).max())), (what, err)


def _nodes(t):
    """Names of the autograd nodes behind ``t``."""
    seen, todo = [], [t.grad_fn]
    while todo:
        n = todo.pop()
        if n is not None and type(n).__name__ not in seen:
            seen.append(type(n).__name__)
            todo.extend(f for f, _ in n.next_functions)
    return seen


def _kan_inputs(rng, spec, B, n_in):
    """Uniform inputs past the grid on both sides, with x0, x1 - eps (as
    f32), the float just below it, 0, -1.5, 1.0 and the knots."""
    x = rng.uniform(-1.3, 1.3, (B, n_in)).astype(np.float32)
    hi = np.float32(spec.clip_hi)
    x[0, :6] = [spec.x0, hi, np.nextafter(hi, np.float32(0)), 0.0, -1.5,
                1.0]
    knots = np.linspace(spec.x0, spec.x1, spec.grid_size + 1)
    x[1, :min(n_in, knots.size)] = knots[:n_in]
    return x


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("G,K", [(4, 3), (8, 2), (16, 4), (4, 1), (2, 3)])
def test_kan_layer_grads_match_jax(G, K, masked):
    rng = np.random.default_rng(G * 10 + K)
    n_in, n_out, B = 9, 7, 33
    spec = SplineSpec(G, K)
    kb = tuple(range(0, spec.n_bases, 2)) if masked else None
    x = _kan_inputs(rng, spec, B, n_in)
    w_b = rng.standard_normal((n_in, n_out)).astype(np.float32)
    t = (rng.standard_normal((n_in, spec.n_bases, n_out)) * 0.3).astype(
        np.float32)
    cot = rng.standard_normal((B, n_out)).astype(np.float32)
    jcfg = JKANConfig(n_in, n_out, JSpec(G, K), basis_keep=kb, impl="jnp")
    (jp, jx) = jax.grad(
        lambda p, xx: jnp.sum(j_kan_apply(p, xx, jcfg) * cot),
        argnums=(0, 1))({"w_b": w_b, "t": t}, x)
    tp = {"w_b": torch.tensor(w_b, requires_grad=True),
          "t": torch.tensor(t, requires_grad=True)}
    tx = torch.tensor(x, requires_grad=True)
    y = kan_apply(tp, tx, KANConfig(n_in, n_out, spec, basis_keep=kb))
    assert "KanFusedV2Backward" in _nodes(y)
    (y * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad, jx, GRAD_TOL, "dx")
    _close(tp["w_b"].grad, jp["w_b"], GRAD_TOL, "dw_b")
    _close(tp["t"].grad, jp["t"], GRAD_TOL, "dt")


def test_kan_grad_at_the_clip_bounds_is_jax_half():
    """``jnp.clip``'s gradient at a bound is 1/2 (JAX splits the tie);
    ``torch.clamp``'s is 1.  Inputs exactly at x0 and at x1 - eps (as
    f32), spline branch only: the port's gradient is JAX's, and half of
    what autograd through the plain version gives."""
    spec = SplineSpec(4, 3)
    x = np.array([[spec.x0, np.float32(spec.clip_hi)]], np.float32)
    t = np.random.default_rng(5).standard_normal((2, spec.n_bases, 3)
                                                 ).astype(np.float32)
    w_b = np.zeros((2, 3), np.float32)
    jcfg = JKANConfig(2, 3, JSpec(4, 3), impl="jnp")
    jx = jax.grad(lambda xx: jnp.sum(j_kan_apply(
        {"w_b": w_b, "t": t}, xx, jcfg)))(x)
    kb = tuple(range(spec.n_bases))
    wt = fuse_wt(torch.from_numpy(w_b), torch.from_numpy(t).reshape(-1, 3),
                 spec.n_bases)
    tx = torch.tensor(x, requires_grad=True)
    kan_fused_v2(tx, wt, spec, kb).sum().backward()
    # silu's share, the same in all three
    xs = torch.tensor(x, requires_grad=True)
    (xs * torch.sigmoid(xs)).sum().backward()
    assert np.all(np.abs(np.asarray(jx)) > 1e-3)
    _close(tx.grad, jx, GRAD_TOL)
    px = torch.tensor(x, requires_grad=True)
    kan_fused_v2_ref(px, wt, spec, kb).sum().backward()
    spline_port = tx.grad - xs.grad * wt[0::spec.n_bases + 1].sum(-1)
    spline_plain = px.grad - xs.grad * wt[0::spec.n_bases + 1].sum(-1)
    _close(spline_port, 0.5 * spline_plain.numpy(), GRAD_TOL)


@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("bias", [False, True])
def test_matmul_grads_match_jax(act, bias):
    """Rows of zeros with a zero bias column put relu exactly at 0,
    where both gradients are 0."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((12, 10)).astype(np.float32)
    x[:3] = 0.0
    w = rng.standard_normal((10, 6)).astype(np.float32)
    b = (rng.standard_normal(6).astype(np.float32) if bias
         else np.zeros(6, np.float32))
    b[:2] = 0.0
    cot = rng.standard_normal((12, 6)).astype(np.float32)

    def f(xx, ww, bb):
        return jnp.sum(j_pattern_linear(xx, ww, None, bb if bias else None,
                                        act=act, impl="jnp") * cot)
    jg = jax.grad(f, argnums=(0, 1, 2))(x, w, b)
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y = matmul_compact(tx, tw, tb if bias else None, act)
    assert "MatmulCompactBackward" in _nodes(y)
    (y * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad, jg[0], GRAD_TOL, "dx")
    _close(tw.grad, jg[1], GRAD_TOL, "dw")
    if bias:
        _close(tb.grad, jg[2], GRAD_TOL, "db")
    # the case exercised: pre-activations exactly 0 (relu's kink)
    assert torch.all(y.detach()[:3, :2] == 0)


def test_gradient_refused_where_the_reference_does_not_train():
    spec = SplineSpec(4, 3)
    kb = tuple(range(spec.n_bases))
    x = torch.rand((4, 3), requires_grad=True)
    wt = torch.rand((3 * (len(kb) + 1), 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kan_fused_v1(x, wt[:3], wt[3:3 + 3 * len(kb)], spec, kb)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kan_fused_v2_q8(torch.zeros((4, 3), dtype=torch.int8),
                        torch.zeros_like(wt, dtype=torch.int8),
                        torch.ones(len(kb) + 1, requires_grad=True), spec,
                        kb, 0.1)


def test_bf16_v2_gradient_runs():
    """The bf16 version-2 layer has a gradient (bf16 x and wt, bf16 out):
    through ``KanFusedV2``, each gradient in its operand's dtype; a bf16
    x with an f32 output (a tensor-parallel partial) has one too, bitwise
    the bf16 output's under the same cotangent values."""
    spec = SplineSpec(4, 3)
    kb = (0, 2, 4, 5, 6)
    g = torch.Generator().manual_seed(3)
    x = (torch.rand((6, 3), generator=g) * 2.4 - 1.2).to(torch.bfloat16)
    wt = torch.randn((3 * (len(kb) + 1), 2), generator=g).to(torch.bfloat16)
    x.requires_grad_(True)
    wt.requires_grad_(True)
    y = kan_fused_v2(x, wt, spec, kb)
    assert y.dtype == torch.bfloat16
    assert "KanFusedV2Backward" in _nodes(y)
    y.float().sum().backward()
    for t in (x, wt):
        assert t.grad.dtype == torch.bfloat16
        assert torch.isfinite(t.grad.float()).all() and t.grad.abs().sum() > 0
    want = (x.grad.clone(), wt.grad.clone())
    x.grad = wt.grad = None
    y32 = kan_fused_v2(x, wt, spec, kb, out_dtype=torch.float32)
    assert y32.dtype == torch.float32 and "KanFusedV2Backward" in _nodes(y32)
    y32.backward(torch.ones_like(y32))
    assert all(torch.equal(a, b) for a, b in zip((x.grad, wt.grad), want))


def test_serving_path_takes_no_gradient_path():
    """Under no_grad / inference_mode (serving), or with no operand
    requiring grad, the wrappers run exactly their plain forward: no
    autograd node, bitwise the same output as the Function's forward."""
    spec = SplineSpec(4, 3)
    kb = (0, 2, 3, 6)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((8, 5), generator=g) * 2.4 - 1.2
    wt = torch.randn((5 * (len(kb) + 1), 4), generator=g)
    with_grad = kan_fused_v2(x, wt.clone().requires_grad_(True), spec, kb)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            y = kan_fused_v2(x, wt.clone().requires_grad_(True), spec, kb)
            m = matmul_compact(x, torch.ones((5, 3), requires_grad=True),
                               act="relu")
        assert y.grad_fn is None and m.grad_fn is None
        assert torch.equal(y, with_grad.detach())
    assert kan_fused_v2(x, wt, spec, kb).grad_fn is None
    assert KanFusedV2 is not None and MatmulCompact is not None


def test_stack_apply_is_differentiable_and_takes_the_functions():
    model = dataclasses.replace(VIKIN_ARCHS["vikin-small"], pattern_rate=0.0)
    jp = j_stack_init(jax.random.key(0), J_ARCHS["vikin-small"])
    params = stack_params_from_jax(
        [{k: np.asarray(v) for k, v in p.items()} for p in jp], model)
    for p in params:
        for v in p.values():
            v.requires_grad_(True)
    x = torch.rand((6, 16))
    vikin_stack_apply(params, x, model).square().sum().backward()
    assert all(v.grad is not None and torch.count_nonzero(v.grad) > 0
               for p in params for v in p.values())
    # kan_linear's functional form too
    spec = model.spec
    w_b = torch.rand((4, 3), requires_grad=True)
    t_flat = torch.rand((4 * spec.n_bases, 3), requires_grad=True)
    kan_linear(torch.rand((2, 4)), w_b, t_flat, spec).sum().backward()
    assert w_b.grad is not None and t_flat.grad is not None


def _ref_and_port_trainers(arch, loss, steps, batch=64):
    classify = loss == "xent"
    data = j_task(J_ARCHS[arch], classify=classify)
    jt = JTrainer(J_ARCHS[arch], data,
                  JTrainerConfig(steps=steps, batch_size=batch, loss=loss))
    init = [{k: np.asarray(v) for k, v in p.items()} for p in jt.params]
    tt = StackTrainer(VIKIN_ARCHS[arch], task_for_model(
        VIKIN_ARCHS[arch], classify=classify),
        StackTrainerConfig(steps=steps, batch_size=batch, loss=loss,
                           device="cpu"),
        params=stack_params_from_jax(init, VIKIN_ARCHS[arch]))
    return jt, tt


def _step_both(jt, tt, steps):
    for s in range(steps):
        x, y = jt._batch_at(s)
        jt.params, jt._opt, jl, jg = jt._jit_step(jt.params, jt._opt, x, y)
        tl, tg = tt.train_step(s)
        assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl)), s
        assert abs(float(tg) - float(jg)) <= LOSS_RTOL * float(jg), s
    for (kt, a), (kj, b) in zip(leaf_paths(tt.params),
                                leaf_paths(jt.params)):
        assert kt == kj
        _close(a.numpy(), np.asarray(b), PARAM_TOL, kt)


def test_one_vikin_mixed_step_matches_reference():
    """Full width 72->304->32->96, mlp/kan/mlp, the Traffic task, batch
    64: loss, gradient norm and params after one AdamW step."""
    jt, tt = _ref_and_port_trainers("vikin-mixed", "mse", 1)
    _step_both(jt, tt, 1)


@pytest.mark.parametrize("loss", ["mse", "xent"])
def test_stack_trainer_matches_reference(loss):
    """25 steps of vikin-small (the teacher task): every loss and
    gradient norm, then the params; and evaluate's keys and values."""
    jt, tt = _ref_and_port_trainers("vikin-small", loss, 25)
    _step_both(jt, tt, 25)
    jm, tm = jt.evaluate(), tt.evaluate()
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= 1e-5 * (1 + abs(jm[k])), k
    masks = jcal.calibrate_stack(jt.params, J_ARCHS["vikin-small"],
                                 jt.data["train_x"][:64]).masks
    js, ts = jt.evaluate(masks=masks), tt.evaluate(masks=masks)
    for k in js:
        assert abs(ts[k] - js[k]) <= 1e-5 * (1 + abs(js[k])), k


def test_stack_trainer_run_and_seeded_batches():
    model = VIKIN_ARCHS["vikin-small"]
    data = task_for_model(model)
    cfg = StackTrainerConfig(steps=4, batch_size=8, device="cpu",
                             log_every=2)
    out = StackTrainer(model, data, cfg).run()
    assert sorted(out) == ["metrics", "params", "val_mse"]
    assert [m["step"] for m in out["metrics"]] == [0, 2, 3]
    jt = JTrainer(J_ARCHS["vikin-small"], data, JTrainerConfig(
        steps=4, batch_size=8))
    tt = StackTrainer(model, data, cfg)
    for s in (0, 1, 17):
        for a, b in zip(tt._batch_at(s), jt._batch_at(s)):
            assert np.array_equal(a, b)
    again = StackTrainer(model, data, cfg).run()
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaf_paths(out["params"]), leaf_paths(again["params"])))
    with pytest.raises(ValueError, match="loss"):
        StackTrainer(model, data, dataclasses.replace(cfg, loss="l1"))


def test_train_launcher_checkpoint_restores_in_the_reference_and_serves(
        tmp_path, capsys):
    """``repro_torch.launch.train`` on the CPU: its checkpoint restores
    bitwise in the reference (params, masks, scales), its masks are the
    reference's ``calibrate_stack`` on the same params, and
    ``repro_torch.launch.serve --ckpt`` serves it at f32 and int8."""
    ck = str(tmp_path / "ck")
    extra = ttrain.main(["--arch", "vikin-small", "--steps", "12",
                         "--batch", "16", "--pattern", "0.5", "--device",
                         "cpu", "--precision", "int8", "--ckpt-dir", ck])
    printed = capsys.readouterr().out
    assert "repro_torch.launch.serve --arch vikin-small --ckpt" in printed
    assert "val int8-sparse mse" in printed
    jmodel = J_ARCHS["vikin-small"]
    target = j_stack_init(jax.random.key(1), jmodel)
    jparams, step, jextra = j_restore(ck, target)
    assert step == 12
    assert {k: v for k, v in jextra.items()} == {
        k: v for k, v in extra.items() if k != "ckpt_dir"}
    assert sorted(jextra) == sorted([
        "arch", "task", "loss", "pattern_rate", "seed", "mask_keep_rates",
        "val_dense", "val_sparse", "sim_cycles_dense", "sim_cycles_sparse",
        "precision", "scale_x"])
    calib_x = j_task(jmodel)["train_x"][:256]
    jm = jcal.calibrate_stack(jparams, jmodel, calib_x, keep_per_group=2)
    saved = j_restore_masks(ck)
    assert [None if m is None else m.keep.tolist() for m in saved] == \
        [None if m is None else m.keep.tolist() for m in jm.masks]
    js = jcal.calibrate_scales(jparams, jmodel, calib_x)
    rs = j_restore_scales(ck)
    assert rs.summary()["kinds"] == js.summary()["kinds"]
    assert abs(rs.scales[0].x - js.scales[0].x) == 0.0
    assert jextra["mask_keep_rates"] == jm.summary()["keep_rates"]
    for precision in ("f32", "int8"):
        eng = tserve.main(["--arch", "vikin-small", "--ckpt", ck,
                           "--device", "cpu", "--precision", precision,
                           "--requests", "4"])
        assert eng.stats["served"] == 4
    # a transformer arch trains (tests/test_torch_lm_train.py); its
    # --dry-run counts one rank's step on meta and writes its record
    from repro_torch.launch import dryrun
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "OUT_DIR", tmp_path / "dryrun")
        with pytest.raises(SystemExit) as e:
            ttrain.main(["--arch", "xlstm-125m", "--shape", "long_500k",
                         "--dry-run"])
    assert e.value.code == 0
    assert json.loads((tmp_path / "dryrun" / "xlstm-125m__long_500k__"
                       "single.json").read_text())["ok"]
    # the reference serves what the port trained, from the same numbers
    back = stack_params_to_numpy(
        tserve.restore_checkpoint(ck, [
            {k: torch.zeros(np.shape(v)) for k, v in p.items()}
            for p in jparams])[0])
    for a, b in zip(back, jparams):
        for k in a:
            assert np.array_equal(a[k], np.asarray(b[k]))
    assert _build.LAUNCHES == {k: 0 for k in _build.LAUNCHES}
