"""Port parity: AdamW, its clip and decay mask, and the LR schedules
against the JAX package's ``repro.optim``.

Both compute in f32 in the same order, but XLA's reductions (a leaf's
sum of squares) and its ``pow`` and ``cos`` may round an ulp apart from
torch's: ``global_norm`` is held within 1e-6 relative, a schedule within
2 ulp (2.4e-7 relative), and params after N steps within ``2e-6 * lr *
N`` plus 2 ulp of the param (a step moves a param by at most about lr;
the tolerance is a few ulp of such steps, where Adam's ``m / sqrt(v)``
amplifies the gradient norm's ulp, plus the rounding of ``p - step``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as jad  # noqa: E402
from repro.optim import schedules as jsch  # noqa: E402
from repro_torch.optim import adamw as tad  # noqa: E402
from repro_torch.optim import schedules as tsch  # noqa: E402
from repro_torch.utils import leaf_paths  # noqa: E402


def _tree(rng, scale=1.0):
    """A stack-shaped tree: mlp, kan, mlp layer dicts."""
    shapes = [{"w": (6, 9), "b": (9,)}, {"w_b": (9, 4), "t": (9, 7, 4)},
              {"w": (4, 3), "b": (3,)}]
    return [{k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in d.items()} for d in shapes]


def _torch(tree):
    return [{k: torch.from_numpy(v.copy()) for k, v in d.items()}
            for d in tree]


def _jax(tree):
    return [{k: jnp.asarray(v) for k, v in d.items()} for d in tree]


def _close(t_tree, j_tree, atol, rtol=0.0):
    for (kt, a), (kj, b) in zip(leaf_paths(t_tree), leaf_paths(j_tree)):
        assert kt == kj
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=kt)


def test_global_norm_and_leaf_order_match_reference():
    tree = _tree(np.random.default_rng(0))
    got = float(tad.global_norm(_torch(tree)))
    want = float(jad.global_norm(_jax(tree)))
    assert abs(got - want) <= 1e-6 * want
    # the reference's leaf order: list index, then sorted dict key
    assert [k for k, _ in leaf_paths(_torch(tree))] == [
        "[0]['b']", "[0]['w']", "[1]['t']", "[1]['w_b']", "[2]['b']",
        "[2]['w']"]


@pytest.mark.parametrize("clip", [None, 1.0, 100.0])
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("tokens", [("['b']",), ("bias", "norm")])
def test_adamw_matches_reference_over_20_steps(clip, wd, tokens):
    rng = np.random.default_rng(1)
    params, lr = _tree(rng), 1e-2
    jcfg = jad.AdamWConfig(lr=jsch.constant_schedule(lr), weight_decay=wd,
                           grad_clip_norm=clip, no_decay_tokens=tokens)
    tcfg = tad.AdamWConfig(lr=tsch.constant_schedule(lr), weight_decay=wd,
                           grad_clip_norm=clip, no_decay_tokens=tokens)
    jp, tp = _jax(params), _torch(params)
    js, ts = jad.adamw_init(jp), tad.adamw_init(tp)
    for step in range(1, 21):
        grads = _tree(rng, scale=0.5)
        jp, js, jm = jad.adamw_update(_jax(grads), js, jp, jcfg)
        tp, ts, tm = tad.adamw_update(_torch(grads), ts, tp, tcfg)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        assert float(tm["lr"]) == float(jm["lr"])
        assert int(ts.count) == int(js.count) == step
        if step == 1:
            _close(tp, jp, atol=2e-6 * lr, rtol=2.4e-7)
            _close(ts.mu, js.mu, atol=1e-7, rtol=1e-6)
            _close(ts.nu, js.nu, atol=1e-8, rtol=1e-6)
    _close(tp, jp, atol=2e-6 * lr * 20, rtol=2.4e-7)
    for (_, a), (_, b) in zip(leaf_paths(tp), leaf_paths(_torch(params))):
        assert a.dtype == b.dtype and not torch.equal(a, b)


def test_adamw_clip_scales_gradients_by_global_norm():
    """A clipped update equals the unclipped update of the gradients
    scaled by ``clip / (gnorm + 1e-9)``."""
    rng = np.random.default_rng(2)
    params, grads = _torch(_tree(rng)), _torch(_tree(rng, scale=10.0))
    gnorm = float(tad.global_norm(grads))
    assert gnorm > 1.0
    cfg = tad.AdamWConfig(lr=tsch.constant_schedule(1e-3))
    clipped = tad.adamw_update(grads, tad.adamw_init(params), params, cfg)
    scale = torch.tensor(1.0, dtype=torch.float32) / (
        torch.tensor(gnorm, dtype=torch.float32) + 1e-9)
    scaled = [{k: g * scale for k, g in d.items()} for d in grads]
    plain = tad.adamw_update(
        scaled, tad.adamw_init(params), params,
        tad.AdamWConfig(lr=tsch.constant_schedule(1e-3),
                        grad_clip_norm=None))
    assert float(clipped[2]["grad_norm"]) == gnorm
    for (_, a), (_, b) in zip(leaf_paths(clipped[0]),
                              leaf_paths(plain[0])):
        assert torch.equal(a, b)
        assert a.dtype == torch.float32


def test_adamw_decay_mask_skips_matching_paths():
    """Zero gradients: only the decayed leaves move, by lr * wd * p."""
    rng = np.random.default_rng(3)
    params = _torch(_tree(rng))
    zeros = [{k: torch.zeros_like(v) for k, v in d.items()} for d in params]
    cfg = tad.AdamWConfig(lr=tsch.constant_schedule(0.5), weight_decay=0.1,
                          grad_clip_norm=None, no_decay_tokens=("['b']",))
    new = tad.adamw_update(zeros, tad.adamw_init(params), params, cfg)[0]
    for (path, a), (_, p) in zip(leaf_paths(new), leaf_paths(params)):
        if path.endswith("['b']"):
            assert torch.equal(a, p), path
        else:
            assert torch.equal(a, p - 0.5 * 0.1 * p), path
    # the reference's mask on the same tree
    jmask = jad._decay_mask(_jax(_tree(np.random.default_rng(3))),
                            ("['b']",))
    tmask = tad._decay_mask(params, ("['b']",))
    assert [v for _, v in leaf_paths(tmask)] == [
        bool(v) for _, v in leaf_paths(jmask)]


def test_adamw_keeps_a_bf16_param_dtype_with_f32_moments():
    p = [{"w": torch.ones((3, 2), dtype=torch.bfloat16)}]
    g = [{"w": torch.full((3, 2), 0.5, dtype=torch.bfloat16)}]
    st = tad.adamw_init(p)
    assert st.mu[0]["w"].dtype == torch.float32
    new, st, _ = tad.adamw_update(g, st, p, tad.AdamWConfig(
        lr=tsch.constant_schedule(1e-2)))
    assert new[0]["w"].dtype == torch.bfloat16
    assert st.nu[0]["w"].dtype == torch.float32


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (3e-4,)),
    ("linear_schedule", (1e-3, 100)),
    ("linear_schedule", (1e-3, 100, 10, 0.1)),
    ("cosine_schedule", (1e-3, 100)),
    ("cosine_schedule", (2e-2, 57, 7, 0.05)),
])
def test_schedules_match_reference(name, args):
    jf, tf = getattr(jsch, name)(*args), getattr(tsch, name)(*args)
    for step in (0, 1, 3, 7, 10, 31, 56, 57, 99, 100, 150):
        want = np.float32(jf(step))
        got = tf(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - float(want)) <= 2.4e-7 * abs(float(want)), (
            step, float(got), float(want))
        assert float(tf(torch.tensor(step, dtype=torch.int32))) == float(got)
