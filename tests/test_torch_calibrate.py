"""Port parity: calibration (masks and int8 scales) against the JAX package.

The reference calibrates through its jnp path; the port through the
kernels' plain versions on the CPU.  The raw input and the weights are
the same bits, so layer 0's activation scale and every weight scale are
held bitwise; hidden activations differ by ulps, so hidden activation
scales are held within 1e-6 relative and activations within
``1e-5 * (1 + max|ref|)``; masks are held equal on the seeds used here.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.vikin_models import VIKIN_ARCHS as J_ARCHS  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.models.ffn import stack_layer_cfgs  # noqa: E402
from repro.models.ffn import vikin_stack_init as j_stack_init  # noqa: E402
from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.convert import stack_params_from_jax  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core.splines import SplineSpec  # noqa: E402

ARCHS = ("vikin-small", "vikin-kan2", "vikin-mlp3", "vikin-mixed")


@functools.lru_cache(maxsize=None)
def _setup(arch, seed=0, n_calib=64):
    model = J_ARCHS[arch]
    jp = j_stack_init(jax.random.key(seed), model)
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    calib_x = np.random.default_rng(seed).random(
        (n_calib, model.sizes[0])).astype(np.float32)
    return jp, calib_x, stack_params_from_jax(np_params, VIKIN_ARCHS[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_calibrate_scales_match_reference(arch):
    jp, calib_x, tp = _setup(arch)
    js = jcal.calibrate_scales(jp, J_ARCHS[arch], calib_x)
    ts = tcal.calibrate_scales(tp, VIKIN_ARCHS[arch], calib_x)
    assert len(ts) == len(js) and ts.summary()["kinds"] == js.summary()[
        "kinds"]
    for i, (t, j) in enumerate(zip(ts.scales, js.scales)):
        assert t.kind == j.kind
        if i == 0:
            assert t.x == j.x
        else:
            assert abs(t.x - j.x) <= 1e-6 * j.x, (i, t.x, j.x)
        if t.kind == "mlp":
            np.testing.assert_array_equal(t.w, j.w)
        else:
            assert t.w_b == j.w_b
            np.testing.assert_array_equal(t.t, j.t)


@pytest.mark.parametrize("keep", [1, 2, 3, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_calibrate_stack_masks_match_reference(arch, keep):
    jp, calib_x, tp = _setup(arch)
    jm = jcal.calibrate_stack(jp, J_ARCHS[arch], calib_x,
                              keep_per_group=keep)
    tm = tcal.calibrate_stack(tp, VIKIN_ARCHS[arch], calib_x,
                              keep_per_group=keep)
    assert tm.summary() == jm.summary()
    for t, j in zip(tm.masks, jm.masks):
        assert (t is None) == (j is None)
        if t is not None:
            np.testing.assert_array_equal(t.keep, j.keep)
    assert tcal.masked_pattern_rates(tm.masks) == \
        jcal.masked_pattern_rates(jm.masks)


@pytest.mark.parametrize("arch", ["vikin-mixed", "vikin-kan3"])
def test_stack_activations_and_saliencies_match_reference(arch):
    jp, calib_x, tp = _setup(arch)
    ja = jcal.stack_activations(jp, J_ARCHS[arch], calib_x)
    ta = tcal.stack_activations(tp, VIKIN_ARCHS[arch], calib_x)
    assert len(ta) == len(ja)
    np.testing.assert_array_equal(ta[0], ja[0])
    for a, b in zip(ta, ja):
        assert a.shape == b.shape and a.dtype == np.float32
        err = np.abs(a - b).max()
        assert err <= 1e-5 * (1 + np.abs(b).max()), err
    dense = dataclasses.replace(J_ARCHS[arch], pattern_rate=0.0)
    for i, (kind, cfg) in enumerate(stack_layer_cfgs(dense)):
        if kind == "kan":
            spec = SplineSpec(cfg.spec.grid_size, cfg.spec.order)
            j = jcal.kan_basis_saliency(jp[i], cfg.spec, ja[i])
            t = tcal.kan_basis_saliency(tp[i], spec, ja[i])
        else:
            j = jcal.mlp_input_saliency(jp[i], ja[i])
            t = tcal.mlp_input_saliency(tp[i], ja[i])
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


def test_keep_per_group_for_rate():
    for rate, m in ((0.0, 4), (0.25, 3), (0.5, 2), (0.75, 1)):
        assert tcal.keep_per_group_for_rate(rate) == m == \
            jcal.keep_per_group_for_rate(rate)
    for bad in (0.3, 1.0, -0.25):
        with pytest.raises(ValueError, match="pattern rate"):
            tcal.keep_per_group_for_rate(bad)
    jp, calib_x, tp = _setup("vikin-small")
    with pytest.raises(ValueError, match="keep_per_group"):
        tcal.calibrate_stack(tp, VIKIN_ARCHS["vikin-small"], calib_x,
                             keep_per_group=0)


@pytest.mark.parametrize("keep", [1, 2, 3])
@pytest.mark.parametrize("n", [8, 30, 3])
def test_magnitude_mask_and_weight_saliency_match_reference(keep, n):
    rng = np.random.default_rng(n * 10 + keep)
    w = rng.standard_normal((n, 5)).astype(np.float32)
    sal_t = tsp.weight_saliency(w)
    np.testing.assert_array_equal(sal_t, jsp.weight_saliency(w))
    np.testing.assert_array_equal(tsp.magnitude_mask(sal_t, keep).keep,
                                  jsp.magnitude_mask(sal_t, keep).keep)


def test_calibration_runs_on_the_cpu_from_any_device_tensors():
    """Params may be tensors or arrays; calibration runs on the params'
    device (here the CPU for both) and gives the same scales either way."""
    jp, calib_x, tp = _setup("vikin-mixed")
    model = VIKIN_ARCHS["vikin-mixed"]
    as_np = [{k: v.numpy() for k, v in p.items()} for p in tp]
    a = tcal.calibrate_scales(tp, model, calib_x)
    b = tcal.calibrate_scales(as_np, model, calib_x)
    for x, y in zip(a.scales, b.scales):
        assert x.x == y.x


@pytest.mark.parametrize("arch", ["vikin-mixed", "vikin-kan3"])
def test_stack_saliencies_give_the_reference_masks(arch):
    """``stack_saliencies`` (what ``calibrate_stack`` ranks) gives, through
    ``magnitude_mask``, the reference's masks; None only for an MLP
    layer 0."""
    jp, calib_x, tp = _setup(arch)
    sal = tcal.stack_saliencies(tp, VIKIN_ARCHS[arch], calib_x)
    jm = jcal.calibrate_stack(jp, J_ARCHS[arch], calib_x, keep_per_group=2)
    kinds = VIKIN_ARCHS[arch].layer_kinds
    for i, (s, j) in enumerate(zip(sal, jm.masks)):
        assert (s is None) == (i == 0 and kinds[0] == "mlp") == (j is None)
        if s is not None:
            np.testing.assert_array_equal(tsp.magnitude_mask(s, 2).keep,
                                          j.keep)
