"""Port parity: the xLSTM cells (``models/xlstm.py``) against the JAX
package.

Weights are the reference's ``jax.random`` draws carried across by
``convert.transformer_params_from_jax``; inputs are numpy draws from a
seed.  Tolerance ``TOL * (1 + max|ref|)``, ``TOL = 1e-5`` at f32 (the same
f32 ops, other summation orders and a few ulps of ``exp``/``log``).  bf16
runs are held against the reference's bf16 run within ``BF16_TOL`` = two
bf16 ulps: both round every bf16 op to bf16, but XLA may keep a fused
chain in f32 (excess precision) where PyTorch rounds after each op.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import xlstm as JX  # noqa: E402
from repro_torch.convert import transformer_params_from_jax  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.utils import leaf_paths  # noqa: E402

TOL = 1e-5
BF16_TOL = 2 * 2.0 ** -8


def close(got, ref, tol=TOL):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    scale = 1.0 + (float(np.abs(ref).max()) if ref.size else 0.0)
    assert err <= tol * scale, (err, tol * scale)


def to_t(tree):
    return transformer_params_from_jax(jax.tree.map(np.asarray, tree))


def both(a, dtype):
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(
        getattr(torch, dtype))


def close_tree(got, ref, tol):
    ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    got_l = leaf_paths(got)
    assert [p for p, _ in got_l] == [jax.tree_util.keystr(p) for p in ref]
    for (path, g), r in zip(got_l, ref.values()):
        assert g.dtype == getattr(torch, jnp.dtype(r.dtype).name), path
        close(g, r, tol)


CFG = TX.XLSTMConfig(d_model=32, n_heads=4)
J_CFG = JX.XLSTMConfig(d_model=32, n_heads=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(dtype, with_state):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    jx, tx = both(x, dtype)
    jw, tw = both(w, dtype)
    js = ts = None
    if with_state:
        js, ts = both(rng.normal(size=(2, 3, 12)).astype(np.float32), dtype)
    yj, sj = JX._causal_conv(jx, jw, js)
    yt, st = TX._causal_conv(tx, tw, ts)
    assert yt.dtype == tx.dtype and st.dtype == tx.dtype
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    close(yt, yj, tol)
    close(st, sj, 0)


def _mlstm(cfg_t, cfg_j, S, dtype, seed, state=None):
    pj = JX.mlstm_init(jax.random.key(seed), cfg_j, getattr(jnp, dtype))
    x = np.random.default_rng(seed).normal(size=(2, S, cfg_t.d_model))
    jx, tx = both(x.astype(np.float32), dtype)
    js = None if state is None else jax.tree.map(jnp.asarray, state)
    ts = None if state is None else to_t(state)
    return (JX.mlstm_apply(pj, jx, cfg_j, js),
            TX.mlstm_apply(to_t(pj), tx, cfg_t, ts))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(5, 128), (12, 4), (20, 2)],
                         ids=["one_chunk", "unrolled", "scanned"])
def test_mlstm_apply(dtype, S, chunk):
    """One chunk, 3 unrolled chunks, and 10 chunks (past
    UNROLL_MAX_CHUNKS: the reference's scan branch)."""
    cfg_t = TX.XLSTMConfig(d_model=32, n_heads=4, chunk=chunk)
    cfg_j = JX.XLSTMConfig(d_model=32, n_heads=4, chunk=chunk)
    (yj, sj), (yt, st) = _mlstm(cfg_t, cfg_j, S, dtype, 1)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    assert yt.dtype == getattr(torch, dtype)
    close(yt, yj, tol)
    close_tree(st, sj, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_carried_state_and_decode(dtype):
    """A prefill's state carried into a 3-token continuation and into
    single-token decode steps (chunks of length 1)."""
    (yj, sj), (yt, st) = _mlstm(CFG, J_CFG, 6, dtype, 2)
    state = jax.tree.map(np.asarray, sj)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    (yj2, sj2), (yt2, st2) = _mlstm(CFG, J_CFG, 3, dtype, 2, state)
    close(yt2, yj2, tol)
    close_tree(st2, sj2, tol)
    (yj1, sj1), (yt1, st1) = _mlstm(CFG, J_CFG, 1, dtype, 2, state)
    close(yt1, yj1, tol)
    close_tree(st1, sj1, tol)


def test_mlstm_refuses_a_ragged_scanned_prompt():
    """Past UNROLL_MAX_CHUNKS chunks the reference scans and asserts
    S % L == 0; the port refuses the same prompt."""
    cfg_t = TX.XLSTMConfig(d_model=32, n_heads=4, chunk=2)
    cfg_j = JX.XLSTMConfig(d_model=32, n_heads=4, chunk=2)
    pj = JX.mlstm_init(jax.random.key(0), cfg_j)
    x = np.zeros((1, 19, 32), np.float32)
    with pytest.raises(AssertionError):
        JX.mlstm_apply(pj, jnp.asarray(x), cfg_j)
    with pytest.raises(AssertionError):
        TX.mlstm_apply(to_t(pj), torch.from_numpy(x), cfg_t)
    # 17 tokens at chunk 4 is 5 chunks: unrolled, ragged allowed in both
    cfg_t = TX.XLSTMConfig(d_model=32, n_heads=4, chunk=4)
    cfg_j = JX.XLSTMConfig(d_model=32, n_heads=4, chunk=4)
    (yj, _), (yt, _) = _mlstm(cfg_t, cfg_j, 17, "float32", 3)
    close(yt, yj)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_apply(dtype, with_state):
    pj = JX.slstm_init(jax.random.key(4), J_CFG, getattr(jnp, dtype))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    jx, tx = both(x, dtype)
    js = ts = None
    if with_state:
        _, js = JX.slstm_apply(pj, jx, J_CFG)
        ts = to_t(jax.tree.map(np.asarray, js))
    yj, sj = JX.slstm_apply(pj, jx, J_CFG, js)
    yt, st = TX.slstm_apply(to_t(pj), tx, CFG, ts)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    assert yt.dtype == getattr(torch, dtype)
    close(yt, yj, tol)
    close_tree(st, sj, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_states(dtype):
    close_tree(TX.mlstm_init_state(3, CFG, getattr(torch, dtype)),
               JX.mlstm_init_state(3, J_CFG, getattr(jnp, dtype)), 0)
    close_tree(TX.slstm_init_state(3, CFG), JX.slstm_init_state(3, J_CFG), 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_trees_match_the_reference(dtype):
    """Same leaves, shapes and dtypes; sLSTM's recurrent matrices are
    orthogonal per the reference's initializer (columns of the
    (4*H*hd, hd) matrix orthonormal), scaled by 0.6."""
    g = torch.Generator().manual_seed(0)
    for t_init, j_init in ((TX.mlstm_init, JX.mlstm_init),
                           (TX.slstm_init, JX.slstm_init)):
        pt = t_init(g, CFG, getattr(torch, dtype))
        pj = j_init(jax.random.key(0), J_CFG, getattr(jnp, dtype))
        ref = jax.tree_util.tree_flatten_with_path(pj)[0]
        got = leaf_paths(pt)
        assert [p for p, _ in got] == [jax.tree_util.keystr(p)
                                       for p, _ in ref]
        for (_, a), (_, b) in zip(got, ref):
            assert tuple(a.shape) == b.shape
            assert a.dtype == getattr(torch, jnp.dtype(b.dtype).name)
    r = TX.slstm_init(g, CFG)["r"].reshape(-1, CFG.d_model // CFG.n_heads)
    gram = (r.t() @ r) / 0.36
    assert torch.allclose(gram, torch.eye(gram.shape[0]), atol=1e-5)


@pytest.mark.parametrize("batch,seq,chunk", [(1, 128, 128), (4, 4096, 128),
                                             (2, 524288, 64), (3, 7, 2)])
def test_flop_counts_equal_the_reference(batch, seq, chunk):
    for d, h in ((768, 4), (32, 4), (4096, 16)):
        ct = TX.XLSTMConfig(d_model=d, n_heads=h, chunk=chunk)
        cj = JX.XLSTMConfig(d_model=d, n_heads=h, chunk=chunk)
        assert TX.slstm_scan_flops(ct, batch, seq) == JX.slstm_scan_flops(
            cj, batch, seq)
        assert TX.mlstm_chunk_flops(ct, batch, seq) == JX.mlstm_chunk_flops(
            cj, batch, seq)
        assert (ct.d_inner, ct.head_dim) == (cj.d_inner, cj.head_dim)
