"""Port parity: the int8 serving path against the JAX package.

Weights are drawn by JAX and carried across with ``repro_torch.convert``;
scales are calibrated by the reference and carried across with
``convert.scales_from_jax``; inputs come from numpy seeds.  Tolerances:

* quantize / dequantize / scales / int8 weights and the int8 pattern
  matmul: bitwise (exact integer accumulation, the same two roundings);
* one int8 KAN layer: ``1e-5 * (1 + max|ref|)`` (real-valued activations,
  summed in another order);
* whole int8 stacks and served answers: ``1e-4 * (1 + max|ref|)``.

The reference's served forward runs under ``jax.jit``, where XLA turns the
activation quantizer's ``x / scale`` into ``x * f32(1 / scale)``; the
port's forward quantizes with ``quantize_static``, which computes that.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import save_checkpoint  # noqa: E402
from repro.configs.vikin_models import VIKIN_ARCHS as J_ARCHS  # noqa: E402
from repro.core import calibrate as jcal  # noqa: E402
from repro.core import quant as jq  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.core import splines as jsl  # noqa: E402
from repro.kernels.kan_fused import ops as jkf  # noqa: E402
from repro.kernels.pattern_matmul import ops as jpm  # noqa: E402
from repro.models.ffn import vikin_stack_init as j_stack_init  # noqa: E402
from repro.runtime import backends as jback  # noqa: E402
from repro.runtime import server as jserver  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointMismatchError,
    restore_checkpoint,
    restore_masks,
    restore_scales,
)
from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    scales_from_jax,
    stack_params_from_jax,
)
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import splines as tsl  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.kan_fused import ops as tkf  # noqa: E402
from repro_torch.kernels.pattern_matmul import ops as tpm  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.ffn import vikin_stack_init  # noqa: E402
from repro_torch.runtime import backends as tback  # noqa: E402
from repro_torch.runtime.server import Engine  # noqa: E402

KERNEL_TOL = 1e-5
STACK_TOL = 1e-4
KB_MASKED = (0, 2, 4, 5, 6)


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and not np.isnan(got).any()
    err = float(np.abs(got - ref).max())
    assert err <= tol * (1.0 + float(np.abs(ref).max())), err


@functools.lru_cache(maxsize=None)
def _reference(arch, seed=0, n_calib=64):
    """JAX weights (as numpy) and reference-calibrated scales for ``arch``,
    with the port's copies of both."""
    model = J_ARCHS[arch]
    jp = j_stack_init(jax.random.key(seed), model)
    np_params = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    calib_x = np.random.default_rng(seed).random(
        (n_calib, model.sizes[0])).astype(np.float32)
    js = jcal.calibrate_scales(jp, model, calib_x)
    return (np_params, js, calib_x,
            stack_params_from_jax(np_params, VIKIN_ARCHS[arch]),
            scales_from_jax(js))


def _jparams(np_params):
    return [{k: jnp.asarray(v) for k, v in p.items()} for p in np_params]


# ---------------------------------------------------------------------------
# quantize / dequantize / scales
# ---------------------------------------------------------------------------


def _sweep(scale, seed):
    """A dense seeded sweep over the int8 range with every exact tie
    (k + 0.5) * s and its two f32 neighbours."""
    s = np.float32(scale)
    k = np.arange(-131, 131, dtype=np.float32)
    ties = ((k + np.float32(0.5)) * s).astype(np.float32)
    dense = (np.random.default_rng(seed).uniform(-140, 140, 20000)
             * s).astype(np.float32)
    return np.concatenate([ties, np.nextafter(ties, np.float32(np.inf)),
                           np.nextafter(ties, np.float32(-np.inf)), dense,
                           np.float32([0.0, -0.0, 1e-30])])


@pytest.mark.parametrize("scale", [1 / 127, 0.013, 0.003141, 0.0078125,
                                   0.7 / 127, 2.5e-4])
def test_quantize_matches_reference_bitwise_with_ties(scale):
    x = _sweep(scale, int(scale * 1e6))
    xt = torch.from_numpy(x)
    s = float(np.float32(scale))
    # eager: the reference divides (weights are quantized this way)
    q = tq.quantize(xt, s)
    assert q.dtype == torch.int8 and int(q.min()) >= -127
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jq.quantize(jnp.asarray(x), s)))
    # a trace-time constant scale, as in the reference's jitted forward
    jit_ref = np.asarray(jax.jit(lambda v: jq.quantize(v, s))(jnp.asarray(x)))
    np.testing.assert_array_equal(tq.quantize_static(xt, s).numpy(), jit_ref)
    # dequantize is one f32 multiply in both
    np.testing.assert_array_equal(
        tq.dequantize(q, s).numpy(), np.asarray(jq.dequantize(
            jnp.asarray(q.numpy()), s)))


def test_xla_rewrites_the_constant_division():
    """Why the forward uses ``quantize_static``: under jit the reference's
    codes are not ``round(x / s)`` next to ties."""
    s = float(np.float32(0.013))
    x = _sweep(s, 5)
    eager = np.asarray(jq.quantize(jnp.asarray(x), s))
    jitted = np.asarray(jax.jit(lambda v: jq.quantize(v, s))(jnp.asarray(x)))
    differ = eager != jitted
    assert 0 < int(differ.sum()) < 0.01 * x.size
    # only next to half-integers of x / s
    frac = np.abs(np.abs(x[differ].astype(np.float64) / s) % 1 - 0.5)
    assert frac.max() < 1e-5


def test_symmetric_scale_and_per_channel_quantize_bitwise():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((40, 12)) * 0.3).astype(np.float32)
    t = (rng.standard_normal((8, 7, 6)) * 0.05).astype(np.float32)
    t[:, 3, :] = 0.0                                       # _EPS floor
    for a, axis in ((w, None), (w, 0), (t, (0, 2))):
        np.testing.assert_array_equal(tq.symmetric_scale(a, axis),
                                      jq.symmetric_scale(a, axis))
        np.testing.assert_array_equal(
            tq.symmetric_scale(torch.from_numpy(a), axis),
            jq.symmetric_scale(a, axis))
    sw = tq.symmetric_scale(w, 0)[None, :]
    np.testing.assert_array_equal(
        tq.quantize(torch.from_numpy(w), sw).numpy(),
        np.asarray(jq.quantize(jnp.asarray(w), sw)))
    st = tq.symmetric_scale(t, (0, 2))[None, :, None]
    qt = tq.quantize(torch.from_numpy(t), st)
    np.testing.assert_array_equal(
        qt.numpy(), np.asarray(jq.quantize(jnp.asarray(t), st)))
    assert int(qt.abs().max()) == 127 and int(qt.min()) >= -127


@pytest.mark.parametrize("arch", ["vikin-small", "vikin-mixed"])
def test_quantize_stack_params_bitwise(arch):
    np_params, js, _, tparams, ts = _reference(arch)
    jqp = jq.quantize_stack_params(_jparams(np_params), J_ARCHS[arch], js)
    tqp = tq.quantize_stack_params(tparams, VIKIN_ARCHS[arch], ts)
    for jl, tl in zip(jqp, tqp):
        assert sorted(jl) == sorted(tl)
        for k in jl:
            assert tl[k].dtype == (torch.int8 if k != "b" else torch.float32)
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
    for jls, tls in zip(js.scales, ts.scales):
        if tls.kind == "kan":
            kb = (0, 2, 3, 6)
            np.testing.assert_array_equal(tls.slot_scales(kb),
                                          jls.slot_scales(kb))
            assert tq.quant_error_bound(tls, kb) == jq.quant_error_bound(
                jls, kb)
        assert tq.quant_error_bound(tls) == jq.quant_error_bound(jls)
    with pytest.raises(ValueError, match="layers"):
        tq.quantize_stack_params(tparams, VIKIN_ARCHS[arch],
                                 tq.StackScales(ts.scales[:1]))


def test_dequantized_weights_within_half_a_step():
    _, _, _, tparams, ts = _reference("vikin-small")
    tqp = tq.quantize_stack_params(tparams, VIKIN_ARCHS["vikin-small"], ts)
    for p, qp, ls in zip(tparams, tqp, ts.scales):
        if ls.kind == "mlp":
            s = np.asarray(ls.w)[None, :]
            deq = tq.dequantize(qp["w_q"], s).numpy()
            assert np.all(np.abs(deq - p["w"].numpy()) <= 0.5 * s * (1 + 1e-6))
            assert torch.equal(qp["b"], p["b"])
        else:
            s = np.asarray(ls.t)[None, :, None]
            deq = tq.dequantize(qp["t_q"], s).numpy()
            assert np.all(np.abs(deq - p["t"].numpy()) <= 0.5 * s * (1 + 1e-6))


# ---------------------------------------------------------------------------
# the two int8 layer functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_pattern_linear_q8_matches_reference_bitwise(act, masked, bias):
    rng = np.random.default_rng([int(act is None), int(masked), int(bias)])
    x_q = rng.integers(-127, 128, (6, 36)).astype(np.int8)
    w_q = rng.integers(-127, 128, (36, 20)).astype(np.int8)
    col = (rng.uniform(0.5, 2.0, 20) * 1e-4).astype(np.float32)
    b = rng.standard_normal(20).astype(np.float32) if bias else None
    jmask = jsp.tiled_mask(36, (1, 0, 1, 1)) if masked else None
    tmask = tsp.tiled_mask(36, (1, 0, 1, 1)) if masked else None
    ref = jpm.pattern_linear_q8(jnp.asarray(x_q), jnp.asarray(w_q),
                                jnp.asarray(col), jmask,
                                None if b is None else jnp.asarray(b),
                                act=act, impl="jnp")
    got = tpm.pattern_linear_q8(torch.from_numpy(x_q), torch.from_numpy(w_q),
                                torch.from_numpy(col), tmask,
                                None if b is None else torch.from_numpy(b),
                                act=act)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_matmul_q8_is_exact_at_the_largest_codes():
    """Kc = 304 rows of +-127 codes: the f32 accumulator is the exact
    integer (304 * 127^2 = 4.9e6 < 2^24)."""
    x = torch.full((3, 304), 127, dtype=torch.int8)
    w = torch.full((304, 5), -127, dtype=torch.int8)
    w[::2] = 127
    y = tpm.matmul_q8(x, w)
    exact = (x.long() @ w.long()).to(torch.float32)
    assert torch.equal(y, exact) and float(y[0, 0]) == 0.0
    assert torch.equal(tpm.matmul_q8(x, -w), -exact)


def _kan_q8_inputs(seed, B, n_in, n_out, nbk):
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, (B, n_in)).astype(np.int8)
    wt_q = rng.integers(-127, 128, (n_in * (nbk + 1), n_out)).astype(np.int8)
    ss = tuple(float(v) for v in
               (rng.uniform(0.5, 2.0, nbk + 1) * 2e-3).astype(np.float32))
    return x_q, wt_q, ss


@pytest.mark.parametrize("kb", [None, KB_MASKED])
@pytest.mark.parametrize("B", [2, 5])
@pytest.mark.parametrize("x_scale", [1 / 127, 0.02])
def test_kan_linear_q8_matches_reference(kb, B, x_scale):
    spec_j, spec_t = jsl.SplineSpec(4, 3), tsl.SplineSpec(4, 3)
    nbk = 7 if kb is None else len(kb)
    x_q, wt_q, ss = _kan_q8_inputs(B * 10 + nbk, B, 24, 12, nbk)
    xs = float(np.float32(x_scale))
    ref = jkf.kan_linear_q8(jnp.asarray(x_q), jnp.asarray(wt_q), ss, spec_j,
                            kb, x_scale=xs, impl="jnp")
    got = tkf.kan_linear_q8(torch.from_numpy(x_q), torch.from_numpy(wt_q),
                            ss, spec_t, kb, x_scale=xs)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, KERNEL_TOL)


def test_kan_linear_q8_matches_reference_pallas_interpret():
    spec_j, spec_t = jsl.SplineSpec(4, 3), tsl.SplineSpec(4, 3)
    x_q, wt_q, ss = _kan_q8_inputs(3, 4, 16, 8, len(KB_MASKED))
    ref = jkf.kan_linear_q8(jnp.asarray(x_q), jnp.asarray(wt_q), ss, spec_j,
                            KB_MASKED, x_scale=0.01, impl="pallas_interpret")
    got = tkf.kan_linear_q8(torch.from_numpy(x_q), torch.from_numpy(wt_q),
                            ss, spec_t, KB_MASKED, x_scale=0.01)
    _close(got.numpy(), ref, KERNEL_TOL)


def test_q8_wrappers_on_cpu_launch_nothing_and_check_inputs():
    before = dict(_build.LAUNCHES)
    x_q, wt_q, ss = _kan_q8_inputs(1, 3, 8, 4, 5)
    tkf.kan_linear_q8(torch.from_numpy(x_q), torch.from_numpy(wt_q), ss,
                      tsl.SplineSpec(4, 3), KB_MASKED, x_scale=0.01)
    tpm.matmul_q8(torch.ones(3, 4, dtype=torch.int8),
                  torch.ones(4, 2, dtype=torch.int8))
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError, match="slot_scales"):
        tkf.kan_linear_q8(torch.from_numpy(x_q), torch.from_numpy(wt_q),
                          ss[:-1], tsl.SplineSpec(4, 3), KB_MASKED,
                          x_scale=0.01)
    meta = torch.empty((2, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpm.matmul_q8(meta, torch.empty((8, 4), dtype=torch.int8,
                                        device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tkf.kan_fused_v2_q8(meta, torch.empty((48, 4), dtype=torch.int8,
                                              device="meta"),
                            torch.ones(6), tsl.SplineSpec(4, 3), KB_MASKED,
                            0.01)


# ---------------------------------------------------------------------------
# whole int8 stacks
# ---------------------------------------------------------------------------


def _jit_forward(np_params, arch, js, masks=None):
    """The reference's int8 forward as its VikinBackend serves it: jitted,
    with the scales as trace-time constants."""
    jqp = jq.quantize_stack_params(_jparams(np_params), J_ARCHS[arch], js)
    return jax.jit(lambda v: jq.quant_stack_apply(
        jqp, v, J_ARCHS[arch], js, impl="jnp", masks=masks))


@pytest.mark.parametrize("arch", ["vikin-small", "vikin-kan2", "vikin-mlp3",
                                  "vikin-mixed"])
def test_quant_stack_apply_matches_reference(arch):
    np_params, js, _, tparams, ts = _reference(arch)
    x = np.random.default_rng(1).random((8, J_ARCHS[arch].sizes[0]),
                                        dtype=np.float32)
    ref = np.asarray(_jit_forward(np_params, arch, js)(jnp.asarray(x)))
    # layer-0 codes, bitwise
    s0 = js[0].x
    np.testing.assert_array_equal(
        tq.quantize_static(torch.from_numpy(x), ts[0].x).numpy(),
        np.asarray(jax.jit(lambda v: jq.quantize(v, s0))(jnp.asarray(x))))
    tqp = tq.quantize_stack_params(tparams, VIKIN_ARCHS[arch], ts)
    got = tq.quant_stack_apply(tqp, torch.from_numpy(x), VIKIN_ARCHS[arch],
                               ts)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, STACK_TOL)
    # the module (weights fused and compacted once) is the same function
    stack = tq.QuantVikinStack(VIKIN_ARCHS[arch], tqp, ts)
    np.testing.assert_array_equal(stack(torch.from_numpy(x)).numpy(),
                                  got.numpy())
    assert stack(torch.from_numpy(x).reshape(2, 4, -1)).shape == (
        2, 4, VIKIN_ARCHS[arch].sizes[-1])


def test_quant_stack_apply_matches_reference_pallas_interpret():
    np_params, js, _, tparams, ts = _reference("vikin-small")
    x = np.random.default_rng(2).random((4, 16), dtype=np.float32)
    jqp = jq.quantize_stack_params(_jparams(np_params),
                                   J_ARCHS["vikin-small"], js)
    ref = jax.jit(lambda v: jq.quant_stack_apply(
        jqp, v, J_ARCHS["vikin-small"], js, impl="pallas_interpret"))(
            jnp.asarray(x))
    tqp = tq.quantize_stack_params(tparams, VIKIN_ARCHS["vikin-small"], ts)
    got = tq.quant_stack_apply(tqp, torch.from_numpy(x),
                               VIKIN_ARCHS["vikin-small"], ts)
    _close(got.numpy(), ref, STACK_TOL)


def test_int8_tracks_the_f32_stack():
    from repro_torch.models.ffn import vikin_stack_apply

    _, _, calib_x, tparams, ts = _reference("vikin-mixed")
    model = VIKIN_ARCHS["vikin-mixed"]
    x = torch.from_numpy(calib_x[:16])
    y_q = tq.quant_stack_apply(
        tq.quantize_stack_params(tparams, model, ts), x, model, ts)
    y_f = vikin_stack_apply(tparams, x, model)
    rel = float(torch.linalg.norm(y_q - y_f) / torch.linalg.norm(y_f))
    assert rel < 0.1, rel


# ---------------------------------------------------------------------------
# checkpoints written by the reference, restored and served by the port
# ---------------------------------------------------------------------------

SMALL_DENSE = dataclasses.replace(J_ARCHS["vikin-small"], pattern_rate=0.0)
T_SMALL_DENSE = dataclasses.replace(VIKIN_ARCHS["vikin-small"],
                                    pattern_rate=0.0)


def _reference_checkpoint(tmp_path):
    np_params, js, calib_x, _, _ = _reference("vikin-small")
    jp = _jparams(np_params)
    masks = list(jcal.calibrate_stack(
        jp, SMALL_DENSE, calib_x,
        keep_per_group=jcal.keep_per_group_for_rate(0.5)).masks)
    save_checkpoint(str(tmp_path), 7, jp, extra={"arch": "vikin-small"},
                    masks=masks, scales=js)
    return np_params, js, masks, calib_x


def test_reference_checkpoint_restored_bit_exact_and_served(tmp_path):
    np_params, js, jmasks, calib_x = _reference_checkpoint(tmp_path)
    template = vikin_stack_init(T_SMALL_DENSE,
                                torch.Generator().manual_seed(9))
    params, step, extra = restore_checkpoint(str(tmp_path), template)
    assert step == 7 and extra == {"arch": "vikin-small"}
    for p, ref in zip(params, np_params):
        assert sorted(p) == sorted(ref)
        for k in p:
            assert torch.is_tensor(p[k])
            np.testing.assert_array_equal(p[k].numpy(), ref[k])
    masks = restore_masks(str(tmp_path))
    for m, jm in zip(masks, jmasks):
        assert (m is None) == (jm is None)
        if m is not None:
            np.testing.assert_array_equal(m.keep, jm.keep)
    scales = restore_scales(str(tmp_path))
    for ls, jls in zip(scales.scales, js.scales):
        assert ls.kind == jls.kind and ls.x == jls.x
        for f in ("w", "w_b", "t"):
            np.testing.assert_array_equal(getattr(ls, f), getattr(jls, f))

    x = calib_x[:8]
    jb = jback.VikinBackend(SMALL_DENSE, _jparams(np_params), impl="jnp",
                            masks=jmasks, precision="int8", scales=js)
    ref = jb._fwd(jb.params, jnp.asarray(x))
    be = tback.VikinBackend(T_SMALL_DENSE, params, device="cpu", masks=masks,
                            precision="int8", scales=scales)
    _close(be.forward(x), np.asarray(ref), STACK_TOL)
    # the cycle model is charged the restored masks' rates
    assert be.layers == T_SMALL_DENSE.layer_works(
        pattern_rates=[0.0 if m is None else m.sparsity for m in masks])


def test_restore_names_mismatches(tmp_path):
    _reference_checkpoint(tmp_path)
    template = vikin_stack_init(T_SMALL_DENSE,
                                torch.Generator().manual_seed(0))
    template[0]["w"] = template[0]["w"].double()
    template[1]["t"] = template[1]["t"][:, :2]
    with pytest.raises(CheckpointMismatchError) as ei:
        restore_checkpoint(str(tmp_path), template)
    msg = str(ei.value)
    assert "dtype mismatch at [0]['w']" in msg and "cast=True" in msg
    assert "shape mismatch at [1]['t']" in msg
    template[1]["t"] = torch.zeros((32, 7, 8))
    params, _, _ = restore_checkpoint(str(tmp_path), template, cast=True)
    assert params[0]["w"].dtype == torch.float64
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), template)


def test_restore_scales_names_bad_keys(tmp_path):
    _reference_checkpoint(tmp_path)
    step_dir = tmp_path / "step_7"
    good = dict(np.load(step_dir / "scales.npz"))
    for key, bad in (("t_1", np.ones((2, 3), np.float32)),
                     ("x_0", np.float32(0.0))):
        z = dict(good)
        z[key] = bad
        np.savez(step_dir / "scales.npz", **z)
        with pytest.raises(CheckpointMismatchError, match=key):
            restore_scales(str(tmp_path))


def test_restore_without_masks_or_scales(tmp_path):
    np_params, _, _, _, _ = _reference("vikin-small")
    save_checkpoint(str(tmp_path), 3, _jparams(np_params))
    assert restore_masks(str(tmp_path)) is None
    assert restore_scales(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# int8 serving through the Engine
# ---------------------------------------------------------------------------


def test_int8_engine_batched_single_and_stats_match_reference():
    arch = "vikin-mixed"
    np_params, js, calib_x, tparams, ts = _reference(arch)
    reqs = [calib_x[i] for i in range(5)]

    def port_backend():
        return tback.VikinBackend(VIKIN_ARCHS[arch], tparams, device="cpu",
                                  precision="int8", scales=ts)

    eng = Engine(port_backend(), n_slots=4)
    rids = [eng.submit(r) for r in reqs]
    batched = eng.run_until_done()
    for r, rid in zip(reqs, rids):
        solo = Engine(port_backend(), n_slots=1)
        srid = solo.submit(r)
        np.testing.assert_array_equal(batched[rid],
                                      solo.run_until_done()[srid])
    jeng = jserver.Engine(jback.VikinBackend(
        J_ARCHS[arch], _jparams(np_params), impl="jnp", precision="int8",
        scales=js), n_slots=4)
    jrids = [jeng.submit(r) for r in reqs]
    jout = jeng.run_until_done()
    for rid, jrid in zip(rids, jrids):
        _close(batched[rid], jout[jrid], STACK_TOL)
    for k in ("served", "ticks", "sim_cycles", "dma_bytes", "mode_switches",
              "reconfig_cycles"):
        assert eng.stats[k] == jeng.stats[k], k
    f32 = tback.VikinBackend(VIKIN_ARCHS[arch], tparams, device="cpu")
    assert eng.backend.batch_report(4)["dma_bytes"] * 4 == \
        f32.batch_report(4)["dma_bytes"]


def test_backend_precision_errors():
    _, _, _, tparams, ts = _reference("vikin-small")
    model = VIKIN_ARCHS["vikin-small"]
    with pytest.raises(ValueError, match="requires calibrated scales"):
        tback.VikinBackend(model, tparams, device="cpu", precision="int8")
    with pytest.raises(ValueError, match="ROADMAP item 7"):
        tback.VikinBackend(model, tparams, device="cpu", precision="bf16")
    with pytest.raises(ValueError, match="unknown precision"):
        tback.VikinBackend(model, tparams, device="cpu", precision="fp4")
    bad = tq.StackScales(tuple(reversed(ts.scales)))
    with pytest.raises(ValueError, match="kind"):
        tback.VikinBackend(model, tparams, device="cpu", precision="int8",
                           scales=bad)


def test_serve_main_int8_on_cpu(capsys):
    eng = tserve.main(["--arch", "vikin-kan2,vikin-mlp3,vikin-mixed",
                       "--precision", "int8", "--device", "cpu",
                       "--requests", "12"])
    out = capsys.readouterr().out
    assert "12 requests in" in out and "serving precision: int8" in out
    assert out.count("no checkpoint: calibrated int8 scales") == 3
    assert eng.stats["served"] == 12
    for b in eng.backend.backends.values():
        assert b.precision == "int8"
        assert isinstance(b.stack, tq.QuantVikinStack)


def test_serve_main_int8_from_reference_checkpoint(tmp_path, capsys):
    _reference_checkpoint(tmp_path)
    eng = tserve.main(["--arch", "vikin-small", "--precision", "int8",
                       "--device", "cpu", "--requests", "4", "--ckpt",
                       str(tmp_path)])
    out = capsys.readouterr().out
    assert f"restored vikin-small from {tmp_path} step 7" in out
    assert "restored per-layer masks (kept)" in out
    assert eng.stats["served"] == 4
    assert eng.backend.masks is not None and eng.backend.precision == "int8"
    with pytest.raises(SystemExit, match="single --arch"):
        tserve.main(["--arch", "vikin-small,vikin-kan2", "--device", "cpu",
                     "--ckpt", str(tmp_path)])
