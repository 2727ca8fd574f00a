"""Port parity: the spline-basis kernel's plain version against the JAX one.

On the CPU ``spline_basis`` runs its plain version (the CUDA kernel is
held against that, bitwise, on the card by chip_smoke.py and
``tests/test_torch_gpu.py``).  Inputs are made with numpy from a seed and
handed to both packages.  Tolerances: ``1e-6 * (1 + max|ref|)`` in f32
(the same f32 operations in the same order; the bound only absorbs a
reordering the JAX compiler may make) and ``2e-2 * (1 + max|ref|)`` in
bf16, the bound of ``tests/test_splines.py`` scaled by the extrapolated
values outside [x0, x1) (the recursion rounds to bf16 at other places in
the two frameworks).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import splines as jsl  # noqa: E402
from repro.kernels import autotune as jax_autotune  # noqa: E402
from repro.kernels.spline_basis import ops as jsb  # noqa: E402
from repro.kernels.spline_basis.ref import (  # noqa: E402
    spline_basis_ref as jax_spline_basis_ref,
)
from repro.kernels.spline_basis.spline_basis import (  # noqa: E402
    spline_basis_pallas,
)
from repro_torch.core import splines as tsl  # noqa: E402
from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels.spline_basis import ops as tsb  # noqa: E402
from repro_torch.kernels.spline_basis.ref import (  # noqa: E402
    spline_basis_plain,
    spline_basis_ref,
)

SPECS = [(g, k) for g in tsl.VALID_G for k in tsl.VALID_K]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-6),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(n, seed, outside):
    """n inputs in [x0, x1) or spread over [-2.5, 2.5] (past both ends)."""
    rng = np.random.default_rng(seed)
    lo, hi = (-2.5, 2.5) if outside else (-1.0, 1.0 - 1e-4)
    return rng.uniform(lo, hi, n).astype(np.float32)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert not np.isnan(got).any()
    err = float(np.abs(got - ref).max())
    assert err <= tol * (1.0 + float(np.abs(ref).max())), err


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("G,K", SPECS)
def test_plain_matches_jax_jnp_and_interpret_kernel(G, K, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    js, ts = jsl.SplineSpec(G, K), tsl.SplineSpec(G, K)
    for n in (1, 7, 128, 1025):
        for outside in (False, True):
            x = _inputs(n, G * 100 + K * 10 + n, outside)
            got = tsb.spline_basis(torch.from_numpy(x).to(tdt), ts)
            assert got.dtype == tdt and got.shape == (n, G + K)
            got = got.to(torch.float32).numpy()
            jx = jnp.asarray(x).astype(jdt)
            _close(got, jsb.spline_basis(jx, js, impl="jnp"), tol)
            _close(got, spline_basis_pallas(jx, js, block_n=128,
                                            interpret=True), tol)


def test_shape_and_dense_oracle_from_a_2d_input():
    js, ts = jsl.SplineSpec(16, 3), tsl.SplineSpec(16, 3)
    x = _inputs(300, 5, False).reshape(10, 30)
    got = tsb.spline_basis(torch.from_numpy(x), ts)
    assert got.shape == (10, 30, ts.n_bases)
    ref = jax_spline_basis_ref(jnp.asarray(x).reshape(-1), js)
    _close(got.numpy(), np.asarray(ref).reshape(10, 30, js.n_bases), 1e-5)
    _close(got.reshape(-1, ts.n_bases).numpy(),
           spline_basis_ref(torch.from_numpy(x).reshape(-1), ts).numpy(),
           1e-5)


@pytest.mark.parametrize("G,K", SPECS)
def test_gather_scatter_round_trip(G, K):
    ts = tsl.SplineSpec(G, K)
    x = _inputs(257, G + K, False)
    vals, cell = tsl.bases_local(torch.from_numpy(x), ts)
    back = tsl.gather_local(tsl.scatter_local(vals, cell, ts), cell, ts)
    np.testing.assert_array_equal(back.numpy(), vals.numpy())


def test_gather_local_matches_jax_bitwise():
    js, ts = jsl.SplineSpec(4, 3), tsl.SplineSpec(4, 3)
    x = _inputs(257, 1, True)
    dense = np.random.default_rng(2).random((257, 7)).astype(np.float32)
    cell = tsl.locate_cell(torch.from_numpy(x), ts)[0]
    np.testing.assert_array_equal(
        tsl.gather_local(torch.from_numpy(dense), cell, ts).numpy(),
        np.asarray(jsl.gather_local(jnp.asarray(dense),
                                    jnp.asarray(cell.numpy()), js)))


def test_spline_basis_local_matches_jax():
    """The JAX function is jitted, and XLA may fuse the recursion's
    multiply-adds, so the values are held to the f32 bound, the cells
    exactly."""
    js, ts = jsl.SplineSpec(8, 3), tsl.SplineSpec(8, 3)
    x = _inputs(64, 3, True).reshape(8, 8)
    tv, tc = tsb.spline_basis_local(torch.from_numpy(x), ts)
    jv, jc = jsb.spline_basis_local(jnp.asarray(x), js)
    assert tv.shape == (8, 8, 4) and tc.dtype == torch.int32
    _close(tv.numpy(), jv, 1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_plain_version_does_not_clip():
    """Outside [x0, x1) the values are the edge cell's extrapolation (the
    KAN layers clip; this function does not)."""
    ts = tsl.SplineSpec(4, 3)
    x = torch.tensor([-2.0, 1.7])
    b = spline_basis_plain(x, ts)
    clipped = spline_basis_plain(ts.clip(x), ts)
    assert not torch.equal(b, clipped)
    assert float(b.min()) < 0.0 or float(b.max()) > 1.0


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", path)
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    autotune.reset_cache()
    yield path
    autotune.reset_cache()


def test_resolve_block_n_precedence(tmp_cache, monkeypatch):
    """explicit > cached > searched (only when enabled) > default."""
    searched = []

    def tune():
        searched.append(1)
        return {"block_n": 128}

    args = (4096, 7, torch.float32)
    assert tsb.resolve_block_n(*args, device="cpu", tune=tune) == \
        tsb.DEFAULT_BLOCK_N
    assert not searched
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    assert tsb.resolve_block_n(*args, device="cpu", tune=tune) == 128
    assert searched == [1]
    autotune.get_cache().store(
        autotune.cache_key("spline_basis", (4096, 7), torch.float32, "cpu"),
        {"block_n": 512})
    assert tsb.resolve_block_n(*args, device="cpu", tune=tune) == 512
    assert searched == [1]
    assert tsb.resolve_block_n(*args, block_n=64, device="cpu",
                               tune=tune) == 64
    # the default is a candidate: inputs a block, as the JAX knob
    assert {"block_n": tsb.DEFAULT_BLOCK_N} in \
        autotune.candidates_spline_basis(4096, 7)
    # the cpu entry is not the card's
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE")
    assert tsb.resolve_block_n(*args, device="cuda") == tsb.DEFAULT_BLOCK_N


def test_block_n_candidates_match_jax():
    """``block_n`` has the JAX kernel's meaning, inputs a block, and the
    same candidate grid where the output stretch fits in shared memory."""
    for n in (1, 300, 2432, 10 ** 6):
        want = jax_autotune.candidates_spline_basis(n, 7, jnp.float32)
        assert autotune.candidates_spline_basis(n, 7) == want


@pytest.mark.parametrize("block_n,G,K,match", [
    (0, 4, 3, "power of two"), (48, 4, 3, "power of two"),
    (16, 4, 3, "power of two"), (8192, 4, 3, "power of two"),
    (4096, 16, 4, "shared memory")])
def test_bad_block_n_raises_on_cpu(tmp_cache, block_n, G, K, match):
    """A knob the kernel does not take raises before any launch, from an
    argument or from the cache, on the CPU too."""
    spec = tsl.SplineSpec(G, K)
    x = torch.linspace(-1, 1, 50)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        tsb.spline_basis(x, spec, block_n=block_n)
    with pytest.raises(ValueError, match=match):
        tsb.check_block_n(block_n, spec.n_bases)
    autotune.get_cache().store(autotune.cache_key(
        "spline_basis", (50, spec.n_bases), torch.float32, "cpu"),
        {"block_n": block_n})
    with pytest.raises(ValueError, match=match):
        tsb.resolve_block_n(50, spec.n_bases, torch.float32, device="cpu")
    assert _build.LAUNCHES == before
    # the extremes it does take, and the default, change no result
    plain = spline_basis_plain(x, spec)
    for good in (32, 2048, tsb.DEFAULT_BLOCK_N):
        assert torch.equal(tsb.spline_basis(x, spec, block_n=good), plain)


def test_cpu_runs_the_plain_version_without_launching():
    before = dict(_build.LAUNCHES)
    tsb.spline_basis(torch.linspace(-1, 1, 50), tsl.SplineSpec(4, 3))
    assert _build.LAUNCHES == before
    assert _build.KERNELS["spline_basis"][1] == "spline_basis_f32"


def test_no_fallback_on_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        tsb.spline_basis(torch.empty(8, device="meta"), tsl.SplineSpec(4, 3))
