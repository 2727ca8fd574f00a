"""Port parity: version-1 KAN layers and the rest of ``core/kan.py``.

On the CPU ``kan_fused_v1`` runs its plain version (the CUDA kernel is
held against that on the card by chip_smoke.py and
``tests/test_torch_gpu.py``).  Inputs are made with numpy from a seed;
weights made by the JAX package are carried across with ``convert``.
Tolerances: ``1e-5 * (1 + max|ref|)`` for a layer (the two packages
contract in different orders, and at batch 1 the JAX jnp path and its
interpret kernel themselves differ by an ulp), ``1e-4 * (1 + max|ref|)``
for ``extend_grid``'s coefficients (two pseudo-inverses), and the JAX
tests' ``1e-3`` for the function a refit keeps.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kan as jkan  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.core import splines as jsl  # noqa: E402
from repro.kernels.kan_fused import ops as jkf  # noqa: E402
from repro.kernels.kan_fused.kan_fused import kan_fused_pallas  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import kan as tkan  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import splines as tsl  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.kan_fused import ops as tkf  # noqa: E402

TOL = 1e-5


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert not np.isnan(got).any()
    err = float(np.abs(got - ref).max())
    assert err <= tol * (1.0 + float(np.abs(ref).max())), err


def _kb(n_bases, rate):
    return tuple(int(i) for i in tsp.tiled_mask(
        n_bases, tsp.sparsity_to_pattern(rate)).indices())


def _layer_inputs(seed, B, n_in, n_out, n_bases, nbk):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, n_in)) * 1.5).astype(np.float32)
    w_b = rng.uniform(-0.3, 0.3, (n_in, n_out)).astype(np.float32)
    t_flat = (rng.standard_normal((n_in * nbk, n_out)) * 0.05).astype(
        np.float32)
    return x, w_b, t_flat


@pytest.mark.parametrize("shape", [(1, 1, 3), (5, 9, 13), (33, 72, 96)])
@pytest.mark.parametrize("rate", [0.25, 0.5, 0.75])
@pytest.mark.parametrize("g,k", [(2, 1), (4, 3), (8, 2), (16, 4)])
def test_plain_v1_matches_jax_jnp_and_interpret_kernel(g, k, rate, shape):
    B, n_in, n_out = shape
    js, ts = jsl.SplineSpec(g, k), tsl.SplineSpec(g, k)
    kb = _kb(ts.n_bases, rate)
    assert kb == tuple(int(i) for i in jsp.tiled_mask(
        js.n_bases, jsp.sparsity_to_pattern(rate)).indices())
    x, w_b, t_flat = _layer_inputs(g * 10 + k, B, n_in, n_out, ts.n_bases,
                                   len(kb))
    got = tkf.kan_fused_v1(torch.from_numpy(x), torch.from_numpy(w_b),
                           torch.from_numpy(t_flat), ts, kb).numpy()
    jx, jw, jt = jnp.asarray(x), jnp.asarray(w_b), jnp.asarray(t_flat)
    _close(got, jkf.kan_linear(jx, jw, jt, js, kb, impl="jnp", version=1))
    _close(got, kan_fused_pallas(jx, jw, jt, js, kb, interpret=True))
    # the functional form at version 1 is the same function
    np.testing.assert_array_equal(
        tkf.kan_linear(torch.from_numpy(x), torch.from_numpy(w_b),
                       torch.from_numpy(t_flat), ts, kb, version=1).numpy(),
        got)


def _jax_layer(seed, n_in, n_out, spec, pattern=None):
    jcfg = jkan.KANConfig(n_in, n_out, spec, pattern=pattern, impl="jnp")
    jp = {k: np.asarray(v) for k, v in
          jkan.kan_init(jax.random.key(seed), jcfg).items()}
    return jcfg, jp


@pytest.mark.parametrize("pattern", [None, (1, 0, 1, 0)])
def test_kan_layer_v1_matches_v2_and_jax(pattern):
    js, ts = jsl.SplineSpec(4, 3), tsl.SplineSpec(4, 3)
    jcfg, jp = _jax_layer(0, 24, 12, js, pattern)
    cfg2 = tkan.KANConfig(24, 12, ts, pattern=pattern)
    cfg1 = dataclasses.replace(cfg2, version=1)
    params = convert.kan_params_from_jax(jp, cfg2)
    x = (np.random.default_rng(3).standard_normal((6, 24)) * 1.5).astype(
        np.float32)
    xt = torch.from_numpy(x)
    v1, v2 = tkan.KANLayer(cfg1, params), tkan.KANLayer(cfg2, params)
    assert hasattr(v1, "t_flat") and not hasattr(v1, "wt")
    assert hasattr(v2, "wt") and not hasattr(v2, "t_flat")
    y1 = v1(xt)
    _close(y1.numpy(), v2(xt).numpy())
    # the layer and the functional form agree, batch dims preserved
    np.testing.assert_array_equal(
        y1.numpy(), tkan.kan_apply(params, xt, cfg1).numpy())
    assert v1(xt.reshape(2, 3, 24)).shape == (2, 3, 12)
    jy = jkan.kan_apply(jp, jnp.asarray(x),
                        dataclasses.replace(jcfg, version=1))
    _close(y1.numpy(), jy)


def test_kan_stack_apply_matches_jax():
    js, ts = jsl.SplineSpec(4, 3), tsl.SplineSpec(4, 3)
    layers = [_jax_layer(s, a, b, js, pat) for s, a, b, pat in
              ((0, 72, 32, None), (1, 32, 96, (1, 0, 1, 0)))]
    jcfgs = [c for c, _ in layers]
    tcfgs = [tkan.KANConfig(c.n_in, c.n_out, ts, pattern=c.pattern,
                            version=v) for c, v in zip(jcfgs, (2, 1))]
    tps = [convert.kan_params_from_jax(p, c)
           for (_, p), c in zip(layers, tcfgs)]
    x = np.random.default_rng(9).standard_normal((4, 72)).astype(np.float32)
    y, hidden = tkan.kan_stack_apply(tps, torch.from_numpy(x), tcfgs,
                                     return_hidden=True)
    jy, jhidden = jkan.kan_stack_apply(
        [p for _, p in layers], jnp.asarray(x),
        [dataclasses.replace(c, version=v) for c, v in zip(jcfgs, (2, 1))],
        return_hidden=True)
    assert y.shape == (4, 96) and len(hidden) == 2
    for got, ref in zip(hidden, jhidden):
        _close(got.numpy(), ref)
    _close(y.numpy(), jy)
    np.testing.assert_array_equal(
        tkan.kan_stack_apply(tps, torch.from_numpy(x), tcfgs).numpy(),
        y.numpy())


@pytest.mark.parametrize("batch", [1, 8])
def test_kan_op_counts_exactly_equal(batch):
    for g in tsl.VALID_G:
        for k in tsl.VALID_K:
            for pat in (None, (1, 0, 1, 0), (1, 0, 0, 0)):
                tc = tkan.KANConfig(72, 32, tsl.SplineSpec(g, k),
                                    pattern=pat)
                jc = jkan.KANConfig(72, 32, jsl.SplineSpec(g, k),
                                    pattern=pat)
                assert tkan.kan_op_counts(tc, batch) == \
                    jkan.kan_op_counts(jc, batch)
                assert tc.param_count() == jc.param_count()


def test_extend_grid_matches_jax_and_keeps_the_function():
    js, ts = jsl.SplineSpec(4, 3), tsl.SplineSpec(4, 3)
    jcfg, jp = _jax_layer(0, 9, 13, js)
    cfg = tkan.KANConfig(9, 13, ts)
    params = convert.kan_params_from_jax(jp, cfg)
    p2, cfg2 = tkan.extend_grid(params, cfg, 16)
    jp2, jcfg2 = jkan.extend_grid({k: jnp.asarray(v) for k, v in jp.items()},
                                  jcfg, 16)
    assert cfg2.spec == tsl.SplineSpec(16, 3)
    assert dataclasses.replace(cfg2, spec=ts) == cfg
    assert p2["t"].shape == (9, 19, 13) and p2["w_b"] is params["w_b"]
    _close(p2["t"].numpy(), jp2["t"], tol=1e-4)
    x = (np.random.default_rng(1).standard_normal((17, 9)) * 0.7).astype(
        np.float32)
    y1 = tkan.kan_apply(params, torch.from_numpy(x), cfg)
    y2 = tkan.kan_apply(p2, torch.from_numpy(x), cfg2)
    np.testing.assert_allclose(y2.numpy(), y1.numpy(), atol=1e-3)


def test_kan_params_from_jax_checks_keys_and_shapes():
    cfg = tkan.KANConfig(4, 3, tsl.SplineSpec(4, 3))
    good = {"w_b": np.zeros((4, 3), np.float32),
            "t": np.ones((4, 7, 3), np.float64)}
    p = convert.kan_params_from_jax(good, cfg)
    assert p["t"].dtype == torch.float32 and p["t"].shape == (4, 7, 3)
    with pytest.raises(ValueError, match="keys"):
        convert.kan_params_from_jax({"w_b": good["w_b"]}, cfg)
    with pytest.raises(ValueError, match="shape"):
        convert.kan_params_from_jax({**good, "t": good["t"][:, :6]}, cfg)


def test_version_is_validated():
    with pytest.raises(ValueError, match="version"):
        tkan.KANConfig(4, 3, version=3)
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="version"):
        tkf.kan_linear(x, torch.zeros((4, 3)), torch.zeros((28, 3)),
                       tsl.SplineSpec(4, 3), version=0)


def test_cpu_runs_the_plain_v1_without_launching():
    before = dict(_build.LAUNCHES)
    x, w_b, t_flat = _layer_inputs(0, 3, 8, 5, 7, 7)
    tkf.kan_fused_v1(torch.from_numpy(x), torch.from_numpy(w_b),
                     torch.from_numpy(t_flat), tsl.SplineSpec(4, 3),
                     tuple(range(7)))
    assert _build.LAUNCHES == before


def test_v1_has_no_fallback_on_other_devices():
    kb = (0, 2, 4, 5, 6)
    with pytest.raises(ValueError, match="no kernel"):
        tkf.kan_fused_v1(torch.empty((2, 8), device="meta"),
                         torch.empty((8, 4), device="meta"),
                         torch.empty((8 * 5, 4), device="meta"),
                         tsl.SplineSpec(4, 3), kb)
