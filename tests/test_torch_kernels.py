"""Port parity: the kernel modules' plain versions against the JAX ones.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels
are held against those on the card by chip_smoke.py).  Inputs are made
with numpy from a seed and handed to both packages.  Tolerance
``1e-5 * (1 + max|ref|)``: the two contract in different orders.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kan as jkan  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.core import splines as jsl  # noqa: E402
from repro.kernels.kan_fused import ops as jkf  # noqa: E402
from repro.kernels.pattern_matmul import ops as jpm  # noqa: E402
from repro_torch.core import kan as tkan  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import splines as tsl  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import epilogue as tep  # noqa: E402
from repro_torch.kernels.kan_fused import ops as tkf  # noqa: E402
from repro_torch.kernels.pattern_matmul import ops as tpm  # noqa: E402
from repro_torch.kernels.pattern_matmul.ref import (  # noqa: E402
    pattern_matmul_ref,
)

TOL = 1e-5
KB_MASKED = (0, 2, 4, 5, 6)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert not np.isnan(got).any()
    err = float(np.abs(got - ref).max())
    assert err <= tol * (1.0 + float(np.abs(ref).max())), err


def _kan_inputs(seed, B, n_in=24, n_out=12, G=4, K=3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, n_in)) * 1.5).astype(np.float32)
    w_b = rng.uniform(-0.3, 0.3, (n_in, n_out)).astype(np.float32)
    t = (rng.standard_normal((n_in, G + K, n_out)) * 0.05).astype(np.float32)
    return x, w_b, t


@pytest.mark.parametrize("kb", [None, KB_MASKED])
@pytest.mark.parametrize("B", [2, 5])
def test_kan_linear_matches_jax(kb, B):
    x, w_b, t = _kan_inputs(B, B)
    js, ts = jsl.SplineSpec(4, 3), tsl.SplineSpec(4, 3)
    ref = jkf.kan_linear(jnp.asarray(x), jnp.asarray(w_b),
                         jkf.flatten_t(jnp.asarray(t), kb), js, kb,
                         impl="jnp")
    got = tkf.kan_linear(torch.from_numpy(x), torch.from_numpy(w_b),
                         tkf.flatten_t(torch.from_numpy(t), kb), ts, kb)
    _close(got.numpy(), ref)


def test_kan_linear_matches_jax_pallas_interpret():
    x, w_b, t = _kan_inputs(7, 4, n_in=16, n_out=8)
    js, ts = jsl.SplineSpec(4, 3), tsl.SplineSpec(4, 3)
    ref = jkf.kan_linear(jnp.asarray(x), jnp.asarray(w_b),
                         jkf.flatten_t(jnp.asarray(t), KB_MASKED), js,
                         KB_MASKED, impl="pallas_interpret")
    got = tkf.kan_linear(torch.from_numpy(x), torch.from_numpy(w_b),
                         tkf.flatten_t(torch.from_numpy(t), KB_MASKED), ts,
                         KB_MASKED)
    _close(got.numpy(), ref)


def test_flatten_and_fuse_bitwise():
    _, w_b, t = _kan_inputs(3, 2)
    for kb in (None, KB_MASKED):
        jt = jkf.flatten_t(jnp.asarray(t), kb)
        tt = tkf.flatten_t(torch.from_numpy(t), kb)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        nbk = 7 if kb is None else len(kb)
        np.testing.assert_array_equal(
            tkf.fuse_wt(torch.from_numpy(w_b), tt, nbk).numpy(),
            np.asarray(jkf.fuse_wt(jnp.asarray(w_b), jt, nbk)))
    with pytest.raises(ValueError, match="t_flat"):
        tkf.fuse_wt(torch.from_numpy(w_b), tt[:-1], len(KB_MASKED))


def test_slot_table():
    s = tkf.slot_table(KB_MASKED, 7, torch.device("cpu"))
    assert s.dtype == torch.int32
    assert s.tolist() == [0, -1, 1, -1, 2, 3, 4]
    assert tkf.slot_table(tuple(range(7)), 7, torch.device("cpu")).tolist() \
        == list(range(7))


@pytest.mark.parametrize("pattern", [None, (1, 0, 1, 0)])
def test_kan_layer_module_and_dense_oracle(pattern):
    x, w_b, t = _kan_inputs(11, 5)
    cfg = tkan.KANConfig(24, 12, tsl.SplineSpec(4, 3), pattern=pattern)
    jcfg = jkan.KANConfig(24, 12, jsl.SplineSpec(4, 3), pattern=pattern,
                          impl="jnp")
    params = {"w_b": torch.from_numpy(w_b), "t": torch.from_numpy(t)}
    xt = torch.from_numpy(x)
    layer = tkan.KANLayer(cfg, params)
    fn = tkan.kan_apply(params, xt, cfg)
    # the module fuses once, the functional form per call: same function
    np.testing.assert_array_equal(layer(xt).numpy(), fn.numpy())
    # leading batch dims are preserved
    assert layer(xt.reshape(5, 1, 24)).shape == (5, 1, 12)
    jparams = {"w_b": jnp.asarray(w_b), "t": jnp.asarray(t)}
    _close(fn.numpy(), jkan.kan_apply(jparams, jnp.asarray(x), jcfg))
    dense = tkan.kan_reference_dense(params, xt, cfg)
    _close(dense.numpy(),
           jkan.kan_reference_dense(jparams, jnp.asarray(x), jcfg))
    _close(fn.numpy(), dense.numpy())
    assert cfg.kb == jcfg.kb and cfg.n_bases_kept == jcfg.n_bases_kept


def test_kan_init_shapes_and_scales():
    cfg = tkan.KANConfig(64, 32)
    p = tkan.kan_init(cfg, torch.Generator().manual_seed(0))
    assert p["w_b"].shape == (64, 32) and p["t"].shape == (64, 7, 32)
    assert float(p["w_b"].abs().max()) <= 1 / 8
    assert abs(float(p["t"].std()) - 0.1 / 8) < 0.1 / 8 * 0.1
    q = tkan.kan_init(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(p["t"], q["t"])


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_pattern_linear_matches_jax(act, masked, bias):
    rng = np.random.default_rng(
        [tep.ACT_CODES[act], int(masked), int(bias)])
    x = rng.standard_normal((5, 30)).astype(np.float32)
    w = (rng.standard_normal((30, 20)) * 0.3).astype(np.float32)
    b = rng.standard_normal(20).astype(np.float32) if bias else None
    jmask = jsp.tiled_mask(30, (1, 0, 1, 0)) if masked else None
    tmask = tsp.tiled_mask(30, (1, 0, 1, 0)) if masked else None
    ref = jpm.pattern_linear(jnp.asarray(x), jnp.asarray(w), jmask,
                             None if b is None else jnp.asarray(b), act=act,
                             impl="jnp")
    tb = None if b is None else torch.from_numpy(b)
    got = tpm.pattern_linear(torch.from_numpy(x), torch.from_numpy(w), tmask,
                             tb, act=act)
    _close(got.numpy(), ref)
    # the compact path equals the dense masked oracle
    _close(got.numpy(), pattern_matmul_ref(torch.from_numpy(x),
                                           torch.from_numpy(w), tmask, tb,
                                           act).numpy())


def test_pattern_linear_matches_jax_pallas_interpret():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 24)) * 0.3).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    ref = jpm.pattern_linear(jnp.asarray(x), jnp.asarray(w),
                             jsp.tiled_mask(32, (1, 0, 1, 0)),
                             jnp.asarray(b), act="relu",
                             impl="pallas_interpret")
    got = tpm.pattern_linear(torch.from_numpy(x), torch.from_numpy(w),
                             tsp.tiled_mask(32, (1, 0, 1, 0)),
                             torch.from_numpy(b), act="relu")
    _close(got.numpy(), ref)


def test_gelu_is_the_tanh_form():
    v = torch.linspace(-6, 6, 101)
    tanh_form = 0.5 * v * (1 + torch.tanh(
        (2 / np.pi) ** 0.5 * (v + 0.044715 * v ** 3)))
    _close(tep.ACTS["gelu"](v).numpy(), tanh_form.numpy(), tol=1e-6)
    assert set(tep.ACTS) == set(tep.ACT_CODES)


def test_cpu_runs_the_plain_version_without_launching():
    before = dict(_build.LAUNCHES)
    x, w_b, t = _kan_inputs(5, 3)
    ts = tsl.SplineSpec(4, 3)
    tkf.kan_linear(torch.from_numpy(x), torch.from_numpy(w_b),
                   tkf.flatten_t(torch.from_numpy(t), None), ts)
    tpm.matmul_compact(torch.ones(3, 4), torch.ones(4, 2))
    assert _build.LAUNCHES == before


def _refuse(*_, **__):
    raise AssertionError("a plain version ran off the CPU")


def test_no_fallback_on_other_devices(monkeypatch):
    """The wrappers never fall back to the plain version off the CPU: a
    meta tensor (the dry run, ``launch/dryrun``) gets the card's checks
    and its output, and nothing runs or launches."""
    monkeypatch.setattr(tkf, "kan_fused_v2_ref", _refuse)
    monkeypatch.setattr(tpm, "matmul_compact_ref", _refuse)
    before = dict(_build.LAUNCHES)
    x = torch.empty((2, 8), device="meta")
    wt = torch.empty((8 * 6, 4), device="meta")
    y = tkf.kan_fused_v2(x, wt, tsl.SplineSpec(4, 3), KB_MASKED)
    assert y.is_meta and y.shape == (2, 4)
    y = tpm.matmul_compact(x, torch.empty((8, 4), device="meta"))
    assert y.is_meta and y.shape == (2, 4)
    assert _build.LAUNCHES == before
