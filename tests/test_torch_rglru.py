"""Port parity: the RG-LRU block (``models/rglru.py``) against the JAX
package.

Weights are the reference's ``jax.random`` draws carried across by
``convert.transformer_params_from_jax``; inputs are numpy draws from a
seed.  f32 within ``TOL * (1 + max|ref|)``, ``TOL = 1e-5``: the same f32
ops, but the reference runs the recurrence as an associative scan and
the port as a loop over time, which rounds a few ulps apart.  The
recurrence alone is held to ``SCAN_TOL`` (8 f32 ulps of 1 + max|h|)
against a float64 loop.  bf16 against the reference's bf16 run within
``BF16_TOL`` = two bf16 ulps (XLA may keep a fused bf16 chain in f32).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import rglru as JR  # noqa: E402
from repro_torch.convert import transformer_params_from_jax  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.utils import leaf_paths  # noqa: E402

TOL = 1e-5
SCAN_TOL = 8 * float(np.finfo(np.float32).eps)
BF16_TOL = 2 * 2.0 ** -8
CFG_T = TR.RGLRUConfig(d_model=24)
CFG_J = JR.RGLRUConfig(d_model=24)


def close(got, ref, tol=TOL):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    scale = 1.0 + float(np.abs(ref).max())
    assert err <= tol * scale, (err, tol * scale)


def to_t(tree):
    return transformer_params_from_jax(jax.tree.map(np.asarray, tree))


def _params(dtype, seed=0, cast_lambda=False):
    pj = JR.rglru_init(jax.random.key(seed), CFG_J, getattr(jnp, dtype))
    if cast_lambda:
        # a bf16 server casts every floating leaf, lambda included
        pj = jax.tree.map(lambda a: a.astype(jnp.bfloat16), pj)
    return pj, to_t(pj)


def _x(S, dtype, seed=0):
    x = np.random.default_rng(seed).normal(size=(2, S, 24)).astype(
        np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype,cast_lambda", [
    ("float32", False), ("bfloat16", False), ("bfloat16", True)])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_apply(dtype, cast_lambda, with_state):
    pj, pt = _params(dtype, 1, cast_lambda)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    js = ts = None
    if with_state:
        jx0, _ = _x(5, dtype, 7)
        _, js = JR.rglru_apply(pj, jx0, CFG_J)
        ts = to_t(js)
    jx, tx = _x(9, dtype, 2)
    yj, sj = JR.rglru_apply(pj, jx, CFG_J, js)
    yt, st = TR.rglru_apply(pt, tx, CFG_T, ts)
    assert yt.dtype == tx.dtype
    assert st["h"].dtype == torch.float32 and st["conv"].dtype == tx.dtype
    close(yt, yj, tol)
    close(st["h"], sj["h"], tol)
    close(st["conv"], sj["conv"], 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_decode_steps(dtype):
    """A prefill's state, then three single-token decode steps, each
    against the reference's."""
    pj, pt = _params(dtype, 3)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    jx, tx = _x(4, dtype, 3)
    _, sj = JR.rglru_apply(pj, jx, CFG_J)
    st = to_t(sj)
    for t in range(3):
        jx1, tx1 = _x(1, dtype, 10 + t)
        yj, sj = JR.rglru_decode_step(pj, jx1, CFG_J, sj)
        yt, st = TR.rglru_decode_step(pt, tx1, CFG_T, st)
        close(yt, yj, tol)
        close(st["h"], sj["h"], tol)
        st = to_t(sj)   # each step from the reference's state


@pytest.mark.parametrize("S", [1, 2, 7, 33])
def test_lru_scan_is_the_recurrence(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, size=(3, S, 16)).astype(np.float32)
    b = rng.normal(size=(3, S, 16)).astype(np.float32)
    h = np.zeros((3, 16))
    want = []
    for t in range(S):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want.append(h)
    want = np.stack(want, 1)
    got = TR._lru_scan(torch.from_numpy(a), torch.from_numpy(b))
    close(got, want, SCAN_TOL)
    close(got, JR._lru_scan(jnp.asarray(a), jnp.asarray(b)), SCAN_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_state_and_tree(dtype):
    st = TR.rglru_init_state(3, CFG_T, getattr(torch, dtype))
    sj = JR.rglru_init_state(3, CFG_J, getattr(jnp, dtype))
    for k in ("conv", "h"):
        assert tuple(st[k].shape) == sj[k].shape
        assert st[k].dtype == getattr(torch, jnp.dtype(sj[k].dtype).name)
        assert not bool(st[k].any())
    pt = TR.rglru_init(torch.Generator().manual_seed(0), CFG_T,
                       getattr(torch, dtype))
    pj = JR.rglru_init(jax.random.key(0), CFG_J, getattr(jnp, dtype))
    ref = jax.tree_util.tree_flatten_with_path(pj)[0]
    got = leaf_paths(pt)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        assert tuple(a.shape) == b.shape
        assert a.dtype == getattr(torch, jnp.dtype(b.dtype).name)
    # a at r = 1 spans [0.9, 0.999], as the reference's Lambda init
    a_1 = torch.exp(-TR.C_FACTOR * torch.logaddexp(
        pt["lambda"], torch.zeros(())))
    assert bool(((a_1 >= 0.9 - 1e-5) & (a_1 <= 0.999 + 1e-5)).all())

