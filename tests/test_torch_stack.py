"""Port parity: whole VIKIN stacks, on weights carried over from JAX.

JAX draws the weights (``vikin_stack_init``); ``repro_torch.convert``
carries them into the port; both run the same seeded numpy inputs.
Tolerance ``1e-4 * (1 + max|ref|)`` for whole stacks.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.vikin_models import VIKIN_ARCHS as J_ARCHS  # noqa: E402
from repro.core.sparsity import PatternMask as JMask  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.convert import masks_from_keep, stack_params_from_jax  # noqa: E402
from repro_torch.models import ffn as tffn  # noqa: E402

TOL = 1e-4


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and not np.isnan(got).any()
    err = float(np.abs(got - ref).max())
    assert err <= tol * (1.0 + float(np.abs(ref).max())), err


def _jax_params(arch, seed=0):
    model = J_ARCHS[arch]
    params = jffn.vikin_stack_init(jax.random.key(seed), model)
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _inputs(model, B, seed=0):
    return np.random.default_rng(seed).random(
        (B, model.sizes[0]), dtype=np.float32)


@pytest.mark.parametrize("arch", sorted(VIKIN_ARCHS))
def test_full_stack_matches_jax(arch):
    jmodel, tmodel = J_ARCHS[arch], VIKIN_ARCHS[arch]
    assert tmodel == tmodel.__class__(**{
        f: getattr(jmodel, f) for f in tmodel.__dataclass_fields__})
    np_params = _jax_params(arch)
    x = _inputs(tmodel, 4)
    ref = jffn.vikin_stack_apply(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in np_params],
        jnp.asarray(x), jmodel, impl="jnp")
    params = stack_params_from_jax(np_params, tmodel)
    got = tffn.vikin_stack_apply(params, torch.from_numpy(x), tmodel)
    _close(got.numpy(), ref)
    # the module (weights fused once) is the same function
    stack = tffn.VikinStack(tmodel, params)
    np.testing.assert_array_equal(stack(torch.from_numpy(x)).numpy(),
                                  got.numpy())


def test_layer_range_chains_to_full_stack():
    model = VIKIN_ARCHS["vikin-mixed"]
    params = stack_params_from_jax(_jax_params("vikin-mixed", 1), model)
    x = torch.from_numpy(_inputs(model, 3, 1))
    full = tffn.vikin_stack_apply(params, x, model)
    h = tffn.vikin_stack_apply(params, x, model, layer_range=(0, 1))
    h = tffn.vikin_stack_apply(params[1:], h, model, layer_range=(1, 3))
    np.testing.assert_array_equal(h.numpy(), full.numpy())
    with pytest.raises(ValueError, match="out of bounds"):
        tffn.vikin_stack_apply(params, x, model, layer_range=(2, 5))


def test_calibrated_masks_match_jax():
    """Per-layer masks (as a calibrated checkpoint carries them) override
    the tiled ones in both packages."""
    arch = "vikin-mixed"
    jmodel, tmodel = J_ARCHS[arch], VIKIN_ARCHS[arch]
    keeps = [None, np.array([1, 1, 0, 1, 0, 1, 1], bool),
             np.tile(np.array([1, 1, 0, 0], bool), 8)]
    np_params = _jax_params(arch, 2)
    x = _inputs(tmodel, 4, 2)
    jmasks = [None if k is None else JMask(k) for k in keeps]
    ref = jffn.vikin_stack_apply(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in np_params],
        jnp.asarray(x), jmodel, impl="jnp", masks=jmasks)
    tmasks = masks_from_keep(keeps)
    got = tffn.vikin_stack_apply(stack_params_from_jax(np_params, tmodel),
                                 torch.from_numpy(x), tmodel, masks=tmasks)
    _close(got.numpy(), ref)
    for (jk, jc), (tk, tc) in zip(jffn.stack_layer_cfgs(jmodel, jmasks),
                                  tffn.stack_layer_cfgs(tmodel, tmasks)):
        assert jk == tk
        if tk == "kan":
            assert tc.kb == jc.kb
        else:
            assert (tc["mask"] is None) == (jc["mask"] is None)
            assert tc["act"] == jc["act"]


def test_stack_layer_cfgs_match_jax():
    for arch in VIKIN_ARCHS:
        jc = jffn.stack_layer_cfgs(J_ARCHS[arch])
        tc = tffn.stack_layer_cfgs(VIKIN_ARCHS[arch])
        for (jk, jcfg), (tk, tcfg) in zip(jc, tc):
            assert jk == tk
            if tk == "kan":
                assert (tcfg.n_in, tcfg.n_out, tcfg.kb) == (
                    jcfg.n_in, jcfg.n_out, jcfg.kb)
            else:
                jm, tm = jcfg["mask"], tcfg["mask"]
                assert (tm is None) == (jm is None)
                if tm is not None:
                    np.testing.assert_array_equal(tm.indices(), jm.indices())
                assert tcfg["act"] == jcfg["act"]
    # vikin-mixed: kb=(0,2,4,5,6) on the KAN layer, Kc=16 into the last MLP
    (_, _), (_, kan), (_, mlp) = tffn.stack_layer_cfgs(
        VIKIN_ARCHS["vikin-mixed"])
    assert kan.kb == (0, 2, 4, 5, 6) and mlp["mask"].n_keep == 16


def test_vikin_stack_init_shapes_and_seed():
    model = VIKIN_ARCHS["vikin-mixed"]
    a = tffn.vikin_stack_init(model, torch.Generator().manual_seed(0))
    b = tffn.vikin_stack_init(model, torch.Generator().manual_seed(0))
    jp = _jax_params("vikin-mixed")
    for pa, pb, pj in zip(a, b, jp):
        assert {k: tuple(v.shape) for k, v in pa.items()} == {
            k: v.shape for k, v in pj.items()}
        for k in pa:
            assert torch.equal(pa[k], pb[k])


def test_convert_rejects_mismatched_params():
    model = VIKIN_ARCHS["vikin-small"]
    np_params = _jax_params("vikin-small")
    with pytest.raises(ValueError, match="layer dicts"):
        stack_params_from_jax(np_params[:1], model)
    bad = [dict(np_params[0]), dict(np_params[1])]
    bad[0]["w"] = bad[0]["w"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        stack_params_from_jax(bad, model)
    bad = [dict(np_params[0]), {"w": np_params[1]["w_b"]}]
    with pytest.raises(ValueError, match="keys"):
        stack_params_from_jax(bad, model)
