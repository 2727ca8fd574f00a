"""Port parity: the PyTorch spline and mask foundation against the JAX one.

The port applies the same f32 operations in the same order as the JAX
functions (run eagerly, op by op), so the results are held BITWISE.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import sparsity as jsp  # noqa: E402
from repro.core import splines as jsl  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import splines as tsl  # noqa: E402

GK = [(g, k) for g in (4, 8, 16) for k in (1, 3, 4)]


def _inputs(seed, spec, n=320):
    """Inside and outside [x0, x1], plus the edges and every knot; one
    length for every spec, so JAX compiles each op shape once."""
    edges = np.asarray([spec.x0, spec.x1, spec.x1 - 1e-6, spec.x0 - 1e-7,
                        *spec.knots()], np.float32)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.5, 2.5, n - edges.size).astype(np.float32)
    return np.concatenate([x, edges])


@pytest.mark.parametrize("G,K", GK)
def test_splines_bitwise(G, K):
    """locate_cell, bases_local, bases_dense (clipped and raw),
    scatter_kept and scatter_local, all bitwise in f32."""
    js, ts = jsl.SplineSpec(G, K), tsl.SplineSpec(G, K)
    x = _inputs(G * 10 + K, ts)
    jraw, traw = jnp.asarray(x), torch.from_numpy(x)
    jx, tx = js.clip(jraw), ts.clip(traw)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))

    jc, jr = jsl.locate_cell(jx, js)
    tc, tr = tsl.locate_cell(tx, ts)
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))

    jv, jcell = jsl.bases_local(jx, js)
    tv, tcell = tsl.bases_local(tx, ts)
    assert tv.shape == (x.size, K + 1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tcell.numpy(), np.asarray(jcell))

    td = tsl.bases_dense(tx, ts)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jsl.bases_dense(jx, js)))
    np.testing.assert_array_equal(tsl.bases_dense(traw, ts).numpy(),
                                  np.asarray(jsl.bases_dense(jraw, js)))

    kb = tuple(int(i) for i in jsp.tiled_mask(js.n_bases,
                                              (1, 0, 1, 0)).indices())
    jk = jsl.scatter_kept(jv, jcell, jnp.asarray(kb, jnp.int32), js.n_active)
    tk = tsl.scatter_kept(tv, tcell, torch.tensor(kb, dtype=torch.int32),
                          ts.n_active)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    tl = tsl.scatter_local(tv, tcell, ts)
    np.testing.assert_array_equal(tl.numpy(),
                                  np.asarray(jsl.scatter_local(jv, jcell, js)))
    # the zero-free path reconstructs the dense oracle on clipped inputs
    np.testing.assert_allclose(tl.numpy(), td.numpy(), atol=1e-6)


def test_spec_validation_knots_and_op_counts():
    for G in jsl.VALID_G:
        for K in jsl.VALID_K:
            js, ts = jsl.SplineSpec(G, K), tsl.SplineSpec(G, K)
            np.testing.assert_array_equal(ts.knots(), js.knots())
            assert (ts.n_bases, ts.n_active, ts.inv_h) == (
                js.n_bases, js.n_active, js.inv_h)
            for sb in (True, False):
                assert (tsl.spu_op_count(ts, sb)
                        == jsl.spu_op_count(js, sb))
            assert tsl.dense_eval_op_count(ts) == jsl.dense_eval_op_count(js)
    assert tsl.INV_LUT == jsl.INV_LUT
    with pytest.raises(ValueError, match="G must be"):
        tsl.SplineSpec(3, 3)
    with pytest.raises(ValueError, match="K must be"):
        tsl.SplineSpec(4, 5)
    with pytest.raises(ValueError, match="x1 must exceed"):
        tsl.SplineSpec(4, 3, x0=1.0, x1=1.0)


def test_silu_matches():
    x = np.random.default_rng(5).normal(0, 4, 513).astype(np.float32)
    np.testing.assert_allclose(tsl.silu(torch.from_numpy(x)).numpy(),
                               np.asarray(jsl.silu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [1, 4, 7, 16, 32, 45, 304])
@pytest.mark.parametrize("rate", [0.0, 0.25, 0.5, 0.75])
def test_tiled_mask_indices_equal(n, rate):
    pat = tsp.sparsity_to_pattern(rate)
    assert pat == jsp.sparsity_to_pattern(rate)
    tm, jm = tsp.tiled_mask(n, pat), jsp.tiled_mask(n, pat)
    np.testing.assert_array_equal(tm.indices(), jm.indices())
    np.testing.assert_array_equal(tm.keep, jm.keep)
    assert (tm.n, tm.n_keep, tm.sparsity) == (jm.n, jm.n_keep, jm.sparsity)


def test_trailing_group_kept_whole():
    """On 7 bases, (1,0,1,0) keeps the partial trailing group whole."""
    assert tuple(tsp.tiled_mask(7, (1, 0, 1, 0)).indices()) == (0, 2, 4, 5, 6)
    assert tsp.tiled_mask(32, (1, 0, 1, 0)).n_keep == 16
    with pytest.raises(ValueError):
        tsp.sparsity_to_pattern(0.3)
    with pytest.raises(ValueError):
        tsp.PatternMask(np.ones(4, np.int32))
