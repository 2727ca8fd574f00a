"""Port parity: the paper-model helpers against the JAX package, exactly.

``PAPER_MODELS`` with ``param_count`` and ``reduce``; the Edge-GPU
baseline and the Table I layer builders of ``core/engine``; and the
sparsity helpers ``PatternMask.is_tiled``, ``compact_rows``,
``compact_cols_activation``, ``activation_nnz_rate``,
``spline_nnz_rate`` and ``combined_keep_rate``.  The configurations are
those of ``tests/test_engine.py``, ``test_engine_calibration.py`` and
``test_sparsity_props.py``; every report is held exactly equal to the
reference's (host arithmetic in the same order), and a gather is exact.
"""
import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import vikin_models as jvm  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.core.splines import SplineSpec as JSpec  # noqa: E402
from repro_torch.configs import vikin_models as tvm  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core.splines import SplineSpec as TSpec  # noqa: E402

PATTERNS = [(1, 1, 1, 1), (1, 1, 1, 0), (1, 0, 1, 0), (1, 0, 0, 0),
            (0, 1, 0, 1), (0, 0, 1, 1)]


def _plain(obj):
    """A report as plain data: dataclasses as dicts, enums as values."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


# (name, builder(engine module, SplineSpec class) -> list of LayerWork):
# the layer lists of the reference's engine tests
LAYER_CASES = {
    "fig8_g2": lambda e, S: e.kan_layers([72, 32, 96], S(2, 3)),
    "fig8_g16": lambda e, S: e.kan_layers([72, 32, 96], S(16, 3)),
    "fig6_mlp4": lambda e, S: e.mlp_layers([72, 304, 304, 96],
                                           nnz_rates=[1.0, 0.55, 0.55]),
    "table2_kan2": lambda e, S: e.kan_layers([72, 96], S(4, 3),
                                             pattern_rate=0.5),
    "table2_mlp3": lambda e, S: e.mlp_layers(
        [72, 304, 96], nnz_rates=[1.0, 0.55], pattern_rate=0.25),
    "mixed": lambda e, S: (e.mlp_layers([72, 304])
                           + e.kan_layers([304, 96], S(4, 3))),
    "kan2_dense": lambda e, S: e.kan_layers([72, 96], S(4, 3)),
    "mlp3_default_nnz": lambda e, S: e.mlp_layers([72, 304, 96]),
    "fig7_kan3_p75": lambda e, S: e.kan_layers([72, 32, 96], S(4, 3),
                                               pattern_rate=0.75),
}
RUN_FLAGS = [{}, {"zero_free": False, "pattern": False, "spu_as_pe": False},
             {"zero_free": True, "pattern": False, "spu_as_pe": False},
             {"zero_free": True, "pattern": False, "spu_as_pe": True},
             {"batch": 8}]


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_builders_equal_reference(case):
    build = LAYER_CASES[case]
    assert _plain(build(teng, TSpec)) == _plain(build(jeng, JSpec))


@pytest.mark.parametrize("flags", range(len(RUN_FLAGS)))
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_run_model_of_paper_layers_equals_reference(case, flags):
    build, kw = LAYER_CASES[case], RUN_FLAGS[flags]
    got = teng.run_model(build(teng, TSpec), teng.VikinHW(), **kw)
    ref = jeng.run_model(build(jeng, JSpec), jeng.VikinHW(), **kw)
    assert _plain(got) == _plain(ref)


@pytest.mark.parametrize("precision", ["f16", "f32", "int8"])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_edge_gpu_equals_reference(case, batch, precision):
    build = LAYER_CASES[case]
    t = teng.EdgeGPU(precision=precision)
    j = jeng.EdgeGPU(precision=precision)
    assert _plain(t) == _plain(j)
    assert t.latency_s(build(teng, TSpec)) == j.latency_s(build(jeng, JSpec))
    assert t.report(build(teng, TSpec), batch=batch) == \
        j.report(build(jeng, JSpec), batch=batch)


def test_table2_pins_through_the_port():
    """test_engine_calibration's pins, and test_engine's Table II bands
    and GPU directions, hold on the port's copy."""
    hw, gpu = teng.VikinHW(), teng.EdgeGPU()
    kan2 = LAYER_CASES["table2_kan2"](teng, TSpec)
    mlp3 = LAYER_CASES["table2_mlp3"](teng, TSpec)
    rk, rm = teng.run_model(kan2, hw), teng.run_model(mlp3, hw)
    assert rk.cycles == pytest.approx(708.0, abs=1e-6)
    assert rm.cycles == pytest.approx(1304.4444444444446, abs=1e-6)
    assert rk.gops_per_w == pytest.approx(18.491155738795054, rel=1e-9)
    assert rm.gops_per_w == pytest.approx(9.980952710111195, rel=1e-9)
    gk, gm = gpu.report(kan2), gpu.report(mlp3)
    assert gk["latency_s"] > rk.latency_s
    assert rk.gops_per_w / gk["gops_per_w"] > 3
    assert gm["latency_s"] < rm.latency_s
    assert rm.gops_per_w / gm["gops_per_w"] > 1.5


@pytest.mark.parametrize("name", sorted(jvm.PAPER_MODELS))
def test_paper_models_param_count_and_reduce_equal_reference(name):
    t, j = tvm.PAPER_MODELS[name], jvm.PAPER_MODELS[name]
    assert list(tvm.PAPER_MODELS) == list(jvm.PAPER_MODELS)
    assert _plain(t) == _plain(j)
    assert t.param_count() == j.param_count()
    assert t.reduce() == t and _plain(t.reduce()) == _plain(j.reduce())
    for over in ({"grid": 16}, {"pattern_rate": 0.5}, {"order": 2}):
        rt, rj = t.reduce(**over), j.reduce(**over)
        assert _plain(rt) == _plain(rj)
        assert rt.param_count() == rj.param_count()
        assert _plain(rt.layer_works()) == _plain(rj.layer_works())


@pytest.mark.parametrize("arch", sorted(jvm.VIKIN_ARCHS))
def test_vikin_archs_param_count_equal_reference(arch):
    t, j = tvm.VIKIN_ARCHS[arch], jvm.VIKIN_ARCHS[arch]
    assert t.param_count() == j.param_count()
    assert t.reduce() == t


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n", [1, 3, 4, 7, 8, 13, 72, 97])
def test_is_tiled_equals_reference(n, pattern):
    t = tsp.tiled_mask(n, pattern).is_tiled()
    j = jsp.tiled_mask(n, pattern).is_tiled()
    if j is None:
        assert t is None
    else:
        np.testing.assert_array_equal(t, j)
        if n >= tsp.GROUP:
            np.testing.assert_array_equal(t, np.asarray(pattern, bool))


@pytest.mark.parametrize("keep", [
    [1, 0, 1, 0, 0, 1, 0, 1],                  # two different groups
    [1, 0, 1, 0, 1, 0, 1, 0, 0],               # partial group dropped
    [1, 1, 0, 0, 1, 1, 0, 0, 1],
])
def test_is_tiled_rejects_like_reference(keep):
    keep = np.asarray(keep, bool)
    t, j = tsp.PatternMask(keep).is_tiled(), jsp.PatternMask(keep).is_tiled()
    assert (t is None) == (j is None)
    if j is not None:
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_compaction_equals_reference(pattern, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 60))
    m_t, m_j = tsp.tiled_mask(n, pattern), jsp.tiled_mask(n, pattern)
    w = rng.normal(size=(n, 5)).astype(np.float32)
    x = rng.normal(size=(3, 2, n)).astype(np.float32)
    rows = tsp.compact_rows(torch.from_numpy(w), m_t)
    cols = tsp.compact_cols_activation(torch.from_numpy(x), m_t)
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(jsp.compact_rows(jnp.asarray(w), m_j)))
    np.testing.assert_array_equal(
        cols.numpy(),
        np.asarray(jsp.compact_cols_activation(jnp.asarray(x), m_j)))
    # gather then scatter back == multiply by the dense mask
    back = np.zeros_like(w)
    back[m_t.indices()] = rows.numpy()
    np.testing.assert_array_equal(back, w * m_t.keep[:, None])


@pytest.mark.parametrize("atol", [0.0, 0.1, 0.5])
def test_activation_nnz_rate_equals_reference(atol):
    rng = np.random.default_rng(7)
    x = np.maximum(rng.normal(size=(33, 304)), 0).astype(np.float32)
    x[0, :5] = [-0.2, 0.0, 0.1, 0.5, -0.5]
    got = tsp.activation_nnz_rate(torch.from_numpy(x), atol)
    assert got == jsp.activation_nnz_rate(jnp.asarray(x), atol)
    assert got == pytest.approx(float(np.mean(np.abs(x) > atol)), rel=1e-6)


@pytest.mark.parametrize("G", [2, 4, 8, 16])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_spline_and_combined_rates_equal_reference(G, K):
    s = tsp.spline_nnz_rate(G, K)
    assert s == jsp.spline_nnz_rate(G, K) == (K + 1) / (G + K)
    for p in (0.0, 0.25, 0.5, 0.75):
        assert tsp.combined_keep_rate(s, p) == jsp.combined_keep_rate(s, p)
