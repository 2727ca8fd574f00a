"""The port's CUDA kernels on the card, each against its plain version.

These need an NVIDIA GPU (and ``nvcc`` to build the kernels); elsewhere
they skip.  Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance ``1e-5 * (1 + max|plain|)``: kernel and plain version sum in
different orders (and the kernel's FMAs round once where the plain
matmul may round twice).  The int8 matmul is held bitwise: its
accumulator is an exact integer in both.  So is the spline-basis kernel:
every value is one chain of round-to-nearest f32 operations in both, and
its scatter only adds zeros.  The two matmul kernels give bitwise the
same output under every tile (bm, bk, bn) they take: the f32 one sums
each output in one fixed order, the int8 one exactly.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.core.sparsity import (  # noqa: E402
    sparsity_to_pattern,
    tiled_mask,
)
from repro_torch.core.kan import KANConfig, KANLayer, kan_init  # noqa: E402
from repro_torch.core.splines import VALID_G, VALID_K, SplineSpec  # noqa
from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels.kan_fused.ops import (  # noqa: E402
    kan_fused_v1,
    kan_fused_v2,
    kan_fused_v2_q8,
    slot_table,
)
from repro_torch.kernels.kan_fused.ref import (  # noqa: E402
    kan_fused_v1_ref,
    kan_fused_v2_q8_ref,
    kan_fused_v2_ref,
)
from repro_torch.kernels.pattern_matmul import ops as tpm_ops  # noqa: E402
from repro_torch.kernels.pattern_matmul.ops import (  # noqa: E402
    default_blocks,
    matmul_compact,
    matmul_q8,
)
from repro_torch.kernels.pattern_matmul.ref import (  # noqa: E402
    matmul_compact_ref,
    matmul_q8_ref,
)
from repro_torch.kernels.spline_basis.ops import spline_basis  # noqa: E402
from repro_torch.kernels.spline_basis.ref import (  # noqa: E402
    spline_basis_plain,
)
from repro_torch.models.ffn import vikin_stack_init  # noqa: E402
from repro_torch.benchmarks import loadgen_bench  # noqa: E402
from repro_torch.runtime.backends import (  # noqa: E402
    MultiWorkloadBackend,
    VikinBackend,
)
from repro_torch.runtime.loadgen import poisson_trace, replay  # noqa: E402
from repro_torch.runtime.server import Engine  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    # the plain versions use torch.matmul: hold them to IEEE f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, tol=TOL):
    assert got.shape == ref.shape
    assert not (torch.isnan(got).any() or torch.isnan(ref).any())
    err = float((got - ref).abs().max())
    assert err <= tol * (1.0 + float(ref.abs().max())), err


def _kan_case(dev, seed, B, n_in, n_out, spec, kb):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, n_in), generator=gen) * 1.5    # past [x0, x1]
    wt = torch.randn((n_in * (len(kb) + 1), n_out), generator=gen) * 0.1
    return x.to(dev), wt.to(dev)


@pytest.mark.parametrize("G,K,rate", [(4, 3, 0.5), (16, 4, 0.0),
                                      (2, 1, 0.75), (8, 2, 0.25)])
@pytest.mark.parametrize("B,n_in,n_out", [(1, 72, 96), (33, 45, 13),
                                          (300, 304, 32)])
def test_kan_kernel_matches_plain(cuda, G, K, rate, B, n_in, n_out):
    spec = SplineSpec(G, K)
    kb = tuple(int(i) for i in tiled_mask(
        spec.n_bases, sparsity_to_pattern(rate)).indices())
    x, wt = _kan_case(cuda, G * 10 + K, B, n_in, n_out, spec, kb)
    got = kan_fused_v2(x, wt, spec, kb)
    torch.cuda.synchronize()
    _close(got, kan_fused_v2_ref(x, wt, spec, kb))


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("M,K,N", [(2, 72, 304), (17, 16, 96),
                                   (130, 152, 65), (5, 0, 8)])
def test_pattern_matmul_kernel_matches_plain(cuda, act, bias, M, K, N):
    gen = torch.Generator().manual_seed(M * 1000 + K + N)
    x = torch.randn((M, K), generator=gen).to(cuda)
    w = (torch.randn((K, N), generator=gen) * 0.1).to(cuda)
    b = torch.randn((N,), generator=gen).to(cuda) if bias else None
    got = matmul_compact(x, w, b, act)
    torch.cuda.synchronize()
    _close(got, matmul_compact_ref(x, w, b, act))


# M, Kc and N of the sweeps: every serving bucket, a ragged batch and a
# large one; contraction depths from 1 to vikin's widest; ragged widths.
SWEEP_M = tuple(range(1, 17)) + (33, 8192)
SWEEP_KC = (1, 16, 37, 72, 228, 304)
SWEEP_N = (1, 33, 96, 304)
# vikin-mixed's and vikin-mlp3's matmul layers (Kc, N, act)
VIKIN_MATMULS = ((72, 304, "relu"), (16, 96, None), (228, 96, None))


def _knob(c):
    return (c["bm"], c["bk"], c["bn"])


@pytest.mark.parametrize("Kc", SWEEP_KC)
@pytest.mark.parametrize("N", SWEEP_N)
def test_pattern_matmul_sweep_matches_plain(cuda, Kc, N):
    """Every M of the sweep, every act, with and without bias, at the
    default tiles of each M's bucket."""
    gen = torch.Generator().manual_seed(Kc * 1000 + N)
    w = (torch.randn((Kc, N), generator=gen) * 0.1).to(cuda)
    b = torch.randn((N,), generator=gen).to(cuda)
    for M in SWEEP_M:
        x = torch.randn((M, Kc), generator=gen).to(cuda)
        for act in (None, "relu", "gelu", "silu"):
            for bias in (None, b):
                got = matmul_compact(x, w, bias, act)
                torch.cuda.synchronize()
                _close(got, matmul_compact_ref(x, w, bias, act))


@pytest.mark.parametrize("Kc", SWEEP_KC)
@pytest.mark.parametrize("N", SWEEP_N)
def test_matmul_q8_sweep_bitwise(cuda, Kc, N):
    gen = torch.Generator().manual_seed(Kc * 1000 + N + 1)
    w = torch.randint(-127, 128, (Kc, N), generator=gen, dtype=torch.int8)
    for M in SWEEP_M:
        x = torch.randint(-127, 128, (M, Kc), generator=gen,
                          dtype=torch.int8)
        got = matmul_q8(x.to(cuda), w.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), (x.long() @ w.long()).to(
            torch.float32)), M


@pytest.mark.parametrize("M", [8, 8192])
@pytest.mark.parametrize("Kc,N,act", VIKIN_MATMULS)
def test_every_knob_gives_the_default_output_bitwise(cuda, M, Kc, N, act):
    """Every candidate tile of the autotune grid: the f32 kernel bitwise
    equal to itself at the default tiles (and within tolerance of the
    plain version), the int8 kernel bitwise equal to its plain version."""
    gen = torch.Generator().manual_seed(M + Kc + N)
    x = torch.rand((M, Kc), generator=gen).to(cuda)
    w = (torch.randn((Kc, N), generator=gen) * 0.1).to(cuda)
    b = torch.randn((N,), generator=gen).to(cuda)
    ref = matmul_compact(x, w, b, act)
    _close(ref, matmul_compact_ref(x, w, b, act))
    cands = autotune.candidates_pattern_matmul(M, Kc, N, torch.float32)
    assert default_blocks(M, Kc, torch.float32) in cands
    for c in cands:
        got = matmul_compact(x, w, b, act, blocks=_knob(c))
        torch.cuda.synchronize()
        assert torch.equal(got, ref), c
    x_q = torch.randint(-127, 128, (M, Kc), generator=gen,
                        dtype=torch.int8).to(cuda)
    w_q = torch.randint(-127, 128, (Kc, N), generator=gen,
                        dtype=torch.int8).to(cuda)
    plain = matmul_q8_ref(x_q, w_q)
    for c in autotune.candidates_pattern_matmul(M, Kc, N, torch.int8):
        got = matmul_q8(x_q, w_q, blocks=_knob(c))
        torch.cuda.synchronize()
        assert torch.equal(got, plain), c


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_rows_are_independent_of_M_under_every_knob(cuda, dtype):
    gen = torch.Generator().manual_seed(11)
    if dtype == torch.int8:
        x = torch.randint(-127, 128, (37, 72), generator=gen,
                          dtype=torch.int8).to(cuda)
        w = torch.randint(-127, 128, (72, 304), generator=gen,
                          dtype=torch.int8).to(cuda)

        def run(xs, knob):
            return matmul_q8(xs, w, blocks=knob)
    else:
        x = torch.randn((37, 72), generator=gen).to(cuda)
        w = (torch.randn((72, 304), generator=gen) * 0.1).to(cuda)
        b = torch.randn((304,), generator=gen).to(cuda)

        def run(xs, knob):
            return matmul_compact(xs, w, b, "relu", blocks=knob)
    full = run(x, None)
    for c in autotune.candidates_pattern_matmul(37, 72, 304, dtype):
        knob = _knob(c)
        assert torch.equal(run(x, knob), full), c
        for lo, hi in ((0, 1), (3, 11), (16, 37)):
            assert torch.equal(run(x[lo:hi].contiguous(), knob),
                               full[lo:hi]), (c, lo, hi)


def test_rows_beyond_65535_tiles_run(cuda):
    """M above 65535 * bm of the smallest bm: M tiles go on grid.x."""
    gen = torch.Generator().manual_seed(12)
    M = 65535 * 8 + 1
    x = torch.randn((M, 16), generator=gen).to(cuda)
    w = torch.randn((16, 33), generator=gen).to(cuda)
    got = matmul_compact(x, w, None, "relu", blocks=(8, 16, 8))
    torch.cuda.synchronize()
    _close(got, matmul_compact_ref(x, w, None, "relu"))
    M = 65535 * 16 + 1
    x_q = torch.randint(-127, 128, (M, 32), generator=gen,
                        dtype=torch.int8).to(cuda)
    w_q = torch.randint(-127, 128, (32, 33), generator=gen,
                        dtype=torch.int8).to(cuda)
    got = matmul_q8(x_q, w_q, blocks=(16, 32, 32))
    torch.cuda.synchronize()
    assert torch.equal(got, matmul_q8_ref(x_q, w_q))


def test_bad_knobs_raise_before_launch_on_cuda(cuda):
    x = torch.randn((8, 72), device=cuda)
    w = torch.randn((72, 304), device=cuda)
    before = dict(_build.LAUNCHES)
    for knob in ((8, 30, 32), (12, 32, 32), (128, 4096, 128)):
        with pytest.raises(ValueError):
            matmul_compact(x, w, blocks=knob)
    for knob in ((16, 48, 32), (8, 32, 32), (128, 8192, 128)):
        with pytest.raises(ValueError):
            matmul_q8(x.to(torch.int8), w.to(torch.int8), blocks=knob)
    assert dict(_build.LAUNCHES) == before


def test_tune_pattern_matmul_round_trips_on_the_card(cuda, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    autotune.reset_cache()
    try:
        gen = torch.Generator().manual_seed(13)
        x = torch.rand((8, 72), generator=gen).to(cuda)
        w = torch.randn((72, 304), generator=gen).to(cuda)
        b = torch.randn((304,), generator=gen).to(cuda)
        default = matmul_compact(x, w, b, "relu")
        best = autotune.tune_pattern_matmul(x, w, b, act="relu", reps=3)
        key = autotune.cache_key("pattern_matmul", (8, 72, 304),
                                 torch.float32, cuda)
        assert autotune.AutotuneCache(str(tmp_path / "autotune.json")
                                      ).lookup(key) == best
        autotune.DISPATCH_LOG.clear()
        assert torch.equal(matmul_compact(x, w, b, "relu"), default)
        assert autotune.DISPATCH_LOG == [
            ("pattern_matmul", key, best, "cache")]
        x_q = torch.randint(-127, 128, (8192, 16), generator=gen,
                            dtype=torch.int8).to(cuda)
        w_q = torch.randint(-127, 128, (16, 96), generator=gen,
                            dtype=torch.int8).to(cuda)
        best_q = autotune.tune_pattern_matmul(x_q, w_q, reps=3)
        assert best_q in autotune.candidates_pattern_matmul(
            8192, 16, 96, torch.int8)
        assert torch.equal(matmul_q8(x_q, w_q), matmul_q8_ref(x_q, w_q))
    finally:
        autotune.reset_cache()


def test_kernels_are_row_independent_bitwise(cuda):
    """Each row's result does not depend on the batch it ran in."""
    spec, kb = SplineSpec(4, 3), (0, 2, 4, 5, 6)
    x, wt = _kan_case(cuda, 3, 37, 304, 96, spec, kb)
    full = kan_fused_v2(x, wt, spec, kb)
    for lo, hi in ((0, 1), (5, 7), (16, 37)):
        part = kan_fused_v2(x[lo:hi].contiguous(), wt, spec, kb)
        assert torch.equal(part, full[lo:hi])
    xm = x[:, :152].contiguous()
    w = (wt[:152, :] * 0.5).contiguous()
    full = matmul_compact(xm, w, None, "relu")
    for lo, hi in ((0, 1), (3, 20), (30, 37)):
        part = matmul_compact(xm[lo:hi].contiguous(), w, None, "relu")
        assert torch.equal(part, full[lo:hi])


def test_wrappers_count_launches_and_reject_bad_inputs(cuda):
    spec, kb = SplineSpec(4, 3), (0, 2, 4, 5, 6)
    x, wt = _kan_case(cuda, 4, 4, 8, 16, spec, kb)
    slot = slot_table(kb, spec.n_bases, cuda)
    before = dict(_build.LAUNCHES)
    kan_fused_v2(x, wt, spec, kb, slot)
    matmul_compact(x, wt[:8].contiguous())
    assert _build.LAUNCHES["kan_fused_v2"] == before["kan_fused_v2"] + 1
    assert _build.LAUNCHES["pattern_matmul"] == before["pattern_matmul"] + 1
    with pytest.raises(TypeError, match="f32 only"):
        kan_fused_v2(x.double(), wt, spec, kb, slot)
    with pytest.raises(ValueError, match="contiguous"):
        kan_fused_v2(x.t(), wt, spec, kb, slot)
    with pytest.raises(ValueError, match="expected"):
        kan_fused_v2(x, wt[:-1], spec, kb, slot)
    with pytest.raises(TypeError, match="f32 only"):
        matmul_compact(x.half(), wt[:8].half())
    with pytest.raises(ValueError, match="on cpu"):
        matmul_compact(x, wt[:8].cpu())
    assert _build.LAUNCHES["kan_fused_v2"] == before["kan_fused_v2"] + 1
    assert _build.LAUNCHES["pattern_matmul"] == before["pattern_matmul"] + 1


@pytest.mark.parametrize("arch", ["vikin-mixed", "vikin-mlp4", "vikin-kan3"])
def test_backend_on_cuda_matches_cpu(cuda, arch):
    model = VIKIN_ARCHS[arch]
    params = vikin_stack_init(model, torch.Generator().manual_seed(0))
    xb = np.random.default_rng(1).random((8, model.sizes[0]),
                                         dtype=np.float32)
    got = VikinBackend(model, params, device="cuda").forward(xb)
    ref = VikinBackend(model, params, device="cpu").forward(xb)
    _close(torch.from_numpy(got), torch.from_numpy(ref), tol=1e-4)


def _q8_kan_case(dev, seed, B, n_in, n_out, nbk):
    gen = torch.Generator().manual_seed(seed)
    x_q = torch.randint(-127, 128, (B, n_in), generator=gen, dtype=torch.int8)
    wt_q = torch.randint(-127, 128, (n_in * (nbk + 1), n_out), generator=gen,
                         dtype=torch.int8)
    ss = torch.rand((nbk + 1,), generator=gen) * 2e-3 + 1e-4
    return x_q.to(dev), wt_q.to(dev), ss.to(dev)


@pytest.mark.parametrize("G,K,rate", [(4, 3, 0.5), (16, 4, 0.0),
                                      (2, 1, 0.75)])
@pytest.mark.parametrize("B,n_in,n_out", [(1, 72, 96), (33, 45, 13),
                                          (300, 304, 32)])
@pytest.mark.parametrize("x_scale", [1 / 127, 0.02])
def test_kan_q8_kernel_matches_plain(cuda, G, K, rate, B, n_in, n_out,
                                     x_scale):
    spec = SplineSpec(G, K)
    kb = tuple(int(i) for i in tiled_mask(
        spec.n_bases, sparsity_to_pattern(rate)).indices())
    x_q, wt_q, ss = _q8_kan_case(cuda, G * 10 + K, B, n_in, n_out, len(kb))
    got = kan_fused_v2_q8(x_q, wt_q, ss, spec, kb, x_scale)
    torch.cuda.synchronize()
    _close(got, kan_fused_v2_q8_ref(x_q, wt_q, ss, spec, kb, x_scale))


@pytest.mark.parametrize("M,K,N", [(2, 72, 304), (17, 16, 96),
                                   (130, 152, 65), (5, 0, 8), (1, 303, 1),
                                   (8192, 16, 96)])
def test_matmul_q8_kernel_matches_plain_bitwise(cuda, M, K, N):
    gen = torch.Generator().manual_seed(M * 1000 + K + N)
    x = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8)
    got = matmul_q8(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, matmul_q8_ref(x.to(cuda), w.to(cuda)))
    assert torch.equal(got.cpu(), (x.long() @ w.long()).to(torch.float32))


def test_q8_kernels_are_row_independent_bitwise(cuda):
    spec, kb = SplineSpec(4, 3), (0, 2, 4, 5, 6)
    x_q, wt_q, ss = _q8_kan_case(cuda, 5, 37, 304, 96, len(kb))
    full = kan_fused_v2_q8(x_q, wt_q, ss, spec, kb, 0.01)
    for lo, hi in ((0, 1), (5, 7), (16, 37)):
        part = kan_fused_v2_q8(x_q[lo:hi].contiguous(), wt_q, ss, spec, kb,
                               0.01)
        assert torch.equal(part, full[lo:hi])
    xm = x_q[:, :152].contiguous()
    w = wt_q[:152].contiguous()
    full = matmul_q8(xm, w)
    for lo, hi in ((0, 1), (3, 20), (30, 37)):
        assert torch.equal(matmul_q8(xm[lo:hi].contiguous(), w),
                           full[lo:hi])


def test_q8_wrappers_count_launches_and_reject_bad_inputs(cuda):
    spec, kb = SplineSpec(4, 3), (0, 2, 4, 5, 6)
    x_q, wt_q, ss = _q8_kan_case(cuda, 6, 4, 8, 16, len(kb))
    before = dict(_build.LAUNCHES)
    kan_fused_v2_q8(x_q, wt_q, ss, spec, kb, 0.01)
    matmul_q8(x_q, wt_q[:8].contiguous())
    assert _build.LAUNCHES["kan_fused_v2_q8"] == \
        before["kan_fused_v2_q8"] + 1
    assert _build.LAUNCHES["pattern_matmul_q8"] == \
        before["pattern_matmul_q8"] + 1
    with pytest.raises(TypeError, match="int8 codes"):
        kan_fused_v2_q8(x_q.float(), wt_q, ss, spec, kb, 0.01)
    with pytest.raises(TypeError, match="int8 codes"):
        kan_fused_v2_q8(x_q, wt_q, ss.double(), spec, kb, 0.01)
    with pytest.raises(ValueError, match="slot_scales"):
        kan_fused_v2_q8(x_q, wt_q, ss[:-1], spec, kb, 0.01)
    with pytest.raises(TypeError, match="int8 codes"):
        matmul_q8(x_q.float(), wt_q[:8].float())
    with pytest.raises(ValueError, match="contiguous"):
        matmul_q8(x_q, wt_q[:8].t().contiguous().t())
    assert _build.LAUNCHES["kan_fused_v2_q8"] == \
        before["kan_fused_v2_q8"] + 1
    assert _build.LAUNCHES["pattern_matmul_q8"] == \
        before["pattern_matmul_q8"] + 1


@pytest.mark.parametrize("arch", ["vikin-mixed", "vikin-mlp3", "vikin-kan2"])
def test_int8_backend_on_cuda_launches_only_q8_kernels(cuda, arch):
    """A CUDA tensor never reaches a plain version: the int8 forward
    launches the q8 kernels once per layer, and no f32 kernel."""
    from repro_torch.core.calibrate import calibrate_scales

    model = VIKIN_ARCHS[arch]
    params = vikin_stack_init(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    scales = calibrate_scales(params, model, rng.random(
        (256, model.sizes[0])).astype(np.float32))
    xb = rng.random((8, model.sizes[0]), dtype=np.float32)
    be = VikinBackend(model, params, device="cuda", precision="int8",
                      scales=scales)
    be.forward(xb)
    before = dict(_build.LAUNCHES)
    got = be.forward(xb)
    moved = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert moved == {**{k: 0 for k in before},
                     "kan_fused_v2_q8": model.layer_kinds.count("kan"),
                     "pattern_matmul_q8": model.layer_kinds.count("mlp")}
    assert np.isfinite(got).all() and got.shape == (8, model.sizes[-1])
    if "kan" in model.layer_kinds[:-1]:
        # a KAN output requantized for the next layer may round across a
        # half-step where kernel and plain version differ by an ulp;
        # chip_smoke.py checks such chains code by code
        return
    ref = VikinBackend(model, params, device="cpu", precision="int8",
                       scales=scales).forward(xb)
    _close(torch.from_numpy(got), torch.from_numpy(ref), tol=1e-4)


@pytest.mark.parametrize("G", VALID_G)
@pytest.mark.parametrize("K", VALID_K)
def test_spline_basis_kernel_bitwise(cuda, G, K):
    """At every block_n candidate, ragged n, and inputs past both ends of
    [x0, x1) (extrapolated, not clipped)."""
    spec = SplineSpec(G, K)
    rng = np.random.default_rng(G * 10 + K)
    for n in (1, 7, 1025, 4096):
        x = torch.from_numpy(rng.uniform(-2.5, 2.5, n).astype(
            np.float32)).to(cuda)
        plain = spline_basis_plain(x, spec)
        for cand in autotune.candidates_spline_basis(n, spec.n_bases) + [
                {"block_n": 32}, {"block_n": 128}]:
            got = spline_basis(x, spec, block_n=cand["block_n"])
            torch.cuda.synchronize()
            assert torch.equal(got, plain), (n, cand)
    x2 = x[:4000].reshape(40, 100)
    assert torch.equal(spline_basis(x2, spec),
                       spline_basis_plain(x2.reshape(-1), spec).reshape(
                           40, 100, spec.n_bases))


def test_no_kernel_instance_spills(cuda):
    """ptxas compiles every instance of the ten kernels with no register
    spill (chip_smoke.py phase 1 holds the same)."""
    usage = _build.resource_usage()
    assert sorted(usage) == sorted(_build.KERNELS)
    for name, entries in usage.items():
        assert entries, name
        for e in entries:
            assert e["spill_stores"] == 0 and e["spill_loads"] == 0, \
                (name, e)


def test_spline_basis_kernel_takes_bf16_and_refuses_f16_and_bad_block_n(cuda):
    """The spline-basis kernels take f32 and bf16 (the bf16 one bitwise
    its plain version, into a bf16 output) and refuse f16 and a block_n
    they do not take, before any launch."""
    spec = SplineSpec(4, 3)
    x = torch.linspace(-1.5, 1.5, 64, device=cuda)
    before = dict(_build.LAUNCHES)
    got = spline_basis(x.bfloat16(), spec)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, spline_basis_plain(x.bfloat16(), spec))
    assert _build.LAUNCHES["spline_basis_bf16"] == \
        before["spline_basis_bf16"] + 1
    before = dict(_build.LAUNCHES)
    with pytest.raises(TypeError, match="f32 or bf16"):
        spline_basis(x.half(), spec)
    for bn in (0, 48, 8192):
        with pytest.raises(ValueError, match="block_n"):
            spline_basis(x, spec, block_n=bn)
        with pytest.raises(ValueError, match="block_n"):
            spline_basis(x.bfloat16(), spec, block_n=bn)
    with pytest.raises(ValueError, match="shared memory"):
        spline_basis(x, SplineSpec(16, 4), block_n=4096)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("G,K", [(4, 3), (16, 4), (2, 1)])
def test_spline_basis_kernel_misaligned_output_bitwise(cuda, G, K):
    """An output that starts 4, 8 or 12 bytes past a 16-byte boundary,
    and ragged tiles: the words before the first aligned one and the tail
    are stored one at a time, the rest 16 bytes at a time, bitwise the
    plain version's and with no word outside the output touched."""
    spec = SplineSpec(G, K)
    nb = spec.n_bases
    rng = np.random.default_rng(G + K)
    for n in (1, 3, 1025, 5000):
        x = torch.from_numpy(rng.uniform(-2.5, 2.5, n).astype(
            np.float32)).to(cuda)
        plain = spline_basis_plain(x, spec)
        for off in (1, 2, 3):
            for bn in (32, 256, 1024):
                buf = torch.full((n * nb + 8,), -7.0, device=cuda)
                _build.launch("spline_basis", x.data_ptr(),
                              buf[off:].data_ptr(), n, G, K,
                              float(spec.x0), float(spec.inv_h), bn,
                              torch.cuda.current_stream(cuda).cuda_stream)
                torch.cuda.synchronize()
                got = buf[off:off + n * nb].reshape(n, nb)
                assert torch.equal(got, plain), (n, off, bn)
                assert bool((buf[:off] == -7.0).all())
                assert bool((buf[off + n * nb:] == -7.0).all())


@pytest.mark.parametrize("G,K,rate", [(4, 3, 0.5), (16, 4, 0.0),
                                      (2, 1, 0.75), (8, 2, 0.25)])
@pytest.mark.parametrize("B,n_in,n_out", [(1, 72, 96), (33, 45, 13),
                                          (300, 304, 32)])
def test_kan_v1_kernel_matches_plain_and_v2(cuda, G, K, rate, B, n_in,
                                             n_out):
    spec = SplineSpec(G, K)
    kb = tuple(int(i) for i in tiled_mask(
        spec.n_bases, sparsity_to_pattern(rate)).indices())
    x, wt = _kan_case(cuda, G * 10 + K, B, n_in, n_out, spec, kb)
    w3 = wt.reshape(n_in, len(kb) + 1, n_out)
    w_b = w3[:, 0].contiguous()
    t_flat = w3[:, 1:].reshape(n_in * len(kb), n_out).contiguous()
    got = kan_fused_v1(x, w_b, t_flat, spec, kb)
    torch.cuda.synchronize()
    _close(got, kan_fused_v1_ref(x, w_b, t_flat, spec, kb))
    _close(got, kan_fused_v2(x, wt, spec, kb))


def test_kan_v1_kernel_is_row_independent_bitwise(cuda):
    spec, kb = SplineSpec(4, 3), (0, 2, 4, 5, 6)
    gen = torch.Generator().manual_seed(7)
    x = (torch.randn((37, 304), generator=gen) * 1.5).to(cuda)
    w_b = (torch.randn((304, 96), generator=gen) * 0.1).to(cuda)
    t_flat = (torch.randn((304 * 5, 96), generator=gen) * 0.1).to(cuda)
    full = kan_fused_v1(x, w_b, t_flat, spec, kb)
    for lo, hi in ((0, 1), (5, 7), (16, 37)):
        part = kan_fused_v1(x[lo:hi].contiguous(), w_b, t_flat, spec, kb)
        assert torch.equal(part, full[lo:hi])


def test_v1_layer_on_cuda_matches_v2_and_cpu(cuda):
    cfg = KANConfig(72, 96, SplineSpec(4, 3), pattern=(1, 0, 1, 0))
    params = kan_init(cfg, torch.Generator().manual_seed(0))
    xb = torch.from_numpy(np.random.default_rng(1).random(
        (8, 72), dtype=np.float32))
    v1 = KANLayer(dataclasses.replace(cfg, version=1),
                  {k: v.to(cuda) for k, v in params.items()})
    v2 = KANLayer(cfg, {k: v.to(cuda) for k, v in params.items()})
    before = dict(_build.LAUNCHES)
    got = v1(xb.to(cuda))
    assert _build.LAUNCHES["kan_fused_v1"] == before["kan_fused_v1"] + 1
    assert _build.LAUNCHES["kan_fused_v2"] == before["kan_fused_v2"]
    _close(got, v2(xb.to(cuda)))
    ref = KANLayer(dataclasses.replace(cfg, version=1), params)(xb)
    _close(got.cpu(), ref)


def test_new_wrappers_count_launches_and_reject_bad_inputs(cuda):
    spec, kb = SplineSpec(4, 3), (0, 2, 4, 5, 6)
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((4, 8), generator=gen).to(cuda)
    w_b = torch.randn((8, 16), generator=gen).to(cuda)
    t_flat = torch.randn((8 * 5, 16), generator=gen).to(cuda)
    before = dict(_build.LAUNCHES)
    kan_fused_v1(x, w_b, t_flat, spec, kb)
    spline_basis(x, spec)
    spline_basis(x.cpu(), spec)
    kan_fused_v1(x.cpu(), w_b.cpu(), t_flat.cpu(), spec, kb)
    assert _build.LAUNCHES["kan_fused_v1"] == before["kan_fused_v1"] + 1
    assert _build.LAUNCHES["spline_basis"] == before["spline_basis"] + 1
    with pytest.raises(TypeError, match="f32 only"):
        kan_fused_v1(x, w_b.double(), t_flat, spec, kb)
    with pytest.raises(ValueError, match="expected"):
        kan_fused_v1(x, w_b, t_flat[:-8], spec, kb)
    with pytest.raises(ValueError, match="contiguous"):
        kan_fused_v1(x, w_b.t().contiguous().t(), t_flat, spec, kb)
    assert _build.LAUNCHES["kan_fused_v1"] == before["kan_fused_v1"] + 1


# vikin-mixed's and vikin-kan2's KAN layers (n_in, n_out), kb (0,2,4,5,6)
VIKIN_KANS = ((304, 32), (72, 96))
KAN_KB = (0, 2, 4, 5, 6)


def _kan_knob(c):
    return (c["bm"], c["bi"], c["bn"])


def _kan_q8_case(dev, seed, B, n_in, n_out, nbk):
    """int8 codes with slot scales that differ per slot by up to 4x, so a
    scale read from the wrong slot shows."""
    gen = torch.Generator().manual_seed(seed)
    x_q = torch.randint(-127, 128, (B, n_in), generator=gen,
                        dtype=torch.int8)
    wt_q = torch.randint(-127, 128, (n_in * (nbk + 1), n_out), generator=gen,
                         dtype=torch.int8)
    ss = torch.linspace(5e-4, 2e-3, nbk + 1)[torch.randperm(
        nbk + 1, generator=gen)]
    return x_q.to(dev), wt_q.to(dev), ss.to(dev)


@pytest.mark.parametrize("B", [8, 8192])
@pytest.mark.parametrize("n_in,n_out", VIKIN_KANS)
def test_every_kan_knob_gives_the_default_output_bitwise(cuda, B, n_in,
                                                         n_out):
    """Both KAN kernels at every candidate (bm, bi, bn): bitwise the
    default knob's output, which is within tolerance of the plain
    version."""
    spec, kb = SplineSpec(4, 3), KAN_KB
    nbk = len(kb)
    x, wt = _kan_case(cuda, B + n_in, B, n_in, n_out, spec, kb)
    slot = slot_table(kb, spec.n_bases, cuda)
    ref = kan_fused_v2(x, wt, spec, kb, slot)
    _close(ref, kan_fused_v2_ref(x, wt, spec, kb))
    for c in autotune.candidates_kan_fused(B, n_in, n_out, nbk,
                                           torch.float32):
        got = kan_fused_v2(x, wt, spec, kb, slot, blocks=_kan_knob(c))
        torch.cuda.synchronize()
        assert torch.equal(got, ref), c
    x_q, wt_q, ss = _kan_q8_case(cuda, B + n_in + 1, B, n_in, n_out, nbk)
    ref = kan_fused_v2_q8(x_q, wt_q, ss, spec, kb, 0.02, slot)
    _close(ref, kan_fused_v2_q8_ref(x_q, wt_q, ss, spec, kb, 0.02))
    for c in autotune.candidates_kan_fused(B, n_in, n_out, nbk, torch.int8):
        got = kan_fused_v2_q8(x_q, wt_q, ss, spec, kb, 0.02, slot,
                              blocks=_kan_knob(c))
        torch.cuda.synchronize()
        assert torch.equal(got, ref), c


@pytest.mark.parametrize("n_in,n_out", [(37, 13), (300, 33), (300, 96),
                                        (1, 5), (32, 8)])
@pytest.mark.parametrize("G,K,rate", [(4, 3, 0.5), (16, 4, 0.0),
                                      (2, 1, 0.75)])
def test_kan_kernels_at_ragged_widths_under_every_knob(cuda, n_in, n_out, G,
                                                       K, rate):
    """n_in not a multiple of the 32-feature chunk, n_out not a multiple
    of bn: both kernels within tolerance of the plain version, every
    candidate bitwise the default."""
    spec = SplineSpec(G, K)
    kb = tuple(int(i) for i in tiled_mask(
        spec.n_bases, sparsity_to_pattern(rate)).indices())
    nbk = len(kb)
    B = 19
    x, wt = _kan_case(cuda, n_in + n_out + G, B, n_in, n_out, spec, kb)
    ref = kan_fused_v2(x, wt, spec, kb)
    _close(ref, kan_fused_v2_ref(x, wt, spec, kb))
    for c in autotune.candidates_kan_fused(B, n_in, n_out, nbk,
                                           torch.float32):
        assert torch.equal(kan_fused_v2(x, wt, spec, kb,
                                        blocks=_kan_knob(c)), ref), c
    x_q, wt_q, ss = _kan_q8_case(cuda, n_in + n_out, B, n_in, n_out, nbk)
    ref = kan_fused_v2_q8(x_q, wt_q, ss, spec, kb, 0.02)
    _close(ref, kan_fused_v2_q8_ref(x_q, wt_q, ss, spec, kb, 0.02))
    for c in autotune.candidates_kan_fused(B, n_in, n_out, nbk, torch.int8):
        assert torch.equal(kan_fused_v2_q8(x_q, wt_q, ss, spec, kb, 0.02,
                                           blocks=_kan_knob(c)), ref), c


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_kan_batched_equals_single_under_different_knobs(cuda, dtype):
    """A row gives the same bits alone as in a batch, with one knob
    forced for the batch and every other candidate for the rows."""
    spec, kb = SplineSpec(4, 3), KAN_KB
    nbk = len(kb)
    if dtype == torch.int8:
        x, wt, ss = _kan_q8_case(cuda, 21, 37, 304, 32, nbk)

        def run(xs, knob):
            return kan_fused_v2_q8(xs, wt, ss, spec, kb, 0.02, blocks=knob)
    else:
        x, wt = _kan_case(cuda, 21, 37, 304, 32, spec, kb)

        def run(xs, knob):
            return kan_fused_v2(xs, wt, spec, kb, blocks=knob)
    full = run(x, (32, 512, 32))
    for c in autotune.candidates_kan_fused(2, 304, 32, nbk, dtype):
        for lo, hi in ((0, 1), (5, 7), (35, 37)):
            assert torch.equal(run(x[lo:hi].contiguous(), _kan_knob(c)),
                               full[lo:hi]), (c, lo, hi)


def test_kan_wrappers_launch_once_a_call_under_every_knob(cuda):
    """One layer call is one launch, whether or not the features are
    split over a cluster; a bad knob raises before any launch."""
    spec, kb = SplineSpec(4, 3), KAN_KB
    x, wt = _kan_case(cuda, 22, 8, 304, 32, spec, kb)
    x_q, wt_q, ss = _kan_q8_case(cuda, 22, 8, 304, 32, len(kb))
    for knob in ((8, 32, 8), (8, 64, 32), (8, 512, 8), None):
        before = dict(_build.LAUNCHES)
        kan_fused_v2(x, wt, spec, kb, blocks=knob)
        kan_fused_v2_q8(x_q, wt_q, ss, spec, kb, 0.02, blocks=knob)
        after = dict(_build.LAUNCHES)
        assert after["kan_fused_v2"] == before["kan_fused_v2"] + 1
        assert after["kan_fused_v2_q8"] == before["kan_fused_v2_q8"] + 1
        assert sum(after.values()) == sum(before.values()) + 2
    before = dict(_build.LAUNCHES)
    for knob in ((8, 40, 8), (12, 32, 8), (8, 32, 8 * 3)):
        with pytest.raises(ValueError):
            kan_fused_v2(x, wt, spec, kb, blocks=knob)
        with pytest.raises(ValueError):
            kan_fused_v2_q8(x_q, wt_q, ss, spec, kb, 0.02, blocks=knob)
    assert dict(_build.LAUNCHES) == before


def test_kan_slot_scales_are_read_per_slot(cuda):
    """Swapping two slots' scales changes exactly the outputs whose rows
    use those slots: the kernel reads each weight's own slot scale."""
    spec, kb = SplineSpec(4, 3), KAN_KB
    nbk = len(kb)
    x_q, wt_q, ss = _kan_q8_case(cuda, 23, 16, 72, 96, nbk)
    got = kan_fused_v2_q8(x_q, wt_q, ss, spec, kb, 0.02)
    _close(got, kan_fused_v2_q8_ref(x_q, wt_q, ss, spec, kb, 0.02))
    swapped = ss.clone()
    swapped[[0, nbk]] = ss[[nbk, 0]]
    moved = kan_fused_v2_q8(x_q, wt_q, swapped, spec, kb, 0.02)
    _close(moved, kan_fused_v2_q8_ref(x_q, wt_q, swapped, spec, kb, 0.02))
    assert not torch.equal(moved, got)


def test_kan_config_blocks_reach_the_kernel(cuda, tmp_path, monkeypatch):
    """``KANConfig.blocks`` is the knob ``KANLayer`` launches with, and a
    tuned knob round-trips through the cache and changes no bit."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    autotune.reset_cache()
    try:
        cfg = KANConfig(304, 32, SplineSpec(4, 3), pattern=(1, 0, 1, 1))
        params = kan_init(cfg, torch.Generator().manual_seed(24))
        params = {k: v.to(cuda) for k, v in params.items()}
        x = torch.rand((8, 304), generator=torch.Generator().manual_seed(
            25)).to(cuda)
        base = KANLayer(cfg, params)(x)
        for knob in ((8, 32, 8), (8, 128, 16)):
            layer = KANLayer(dataclasses.replace(cfg, blocks=knob), params)
            assert torch.equal(layer(x), base), knob
        kb = KANLayer(cfg, params).kb
        wt = KANLayer(cfg, params).wt
        best = autotune.tune_kan_fused(x, wt, cfg.spec, kb)
        assert best in autotune.candidates_kan_fused(8, 304, 32, len(kb),
                                                     torch.float32)
        fresh = autotune.AutotuneCache(autotune.get_cache().path)
        assert fresh.lookup(autotune.cache_key(
            "kan_fused_v2", (8, 304, 32, len(kb)), torch.float32,
            cuda)) == best
        assert torch.equal(KANLayer(cfg, params)(x), base)
    finally:
        autotune.reset_cache()


@pytest.mark.parametrize("B", [8, 8192])
@pytest.mark.parametrize("n_in,n_out", VIKIN_KANS)
def test_every_v1_knob_gives_the_default_output_bitwise(cuda, B, n_in,
                                                        n_out):
    """The version-1 kernel at every candidate (bm, bi, bn): bitwise the
    default knob's output, which is within tolerance of the plain version
    and of the v2 kernel on the same weights."""
    spec, kb = SplineSpec(4, 3), KAN_KB
    nbk = len(kb)
    x, wt = _kan_case(cuda, B + n_in + 2, B, n_in, n_out, spec, kb)
    w3 = wt.reshape(n_in, nbk + 1, n_out)
    w_b = w3[:, 0].contiguous()
    t_flat = w3[:, 1:].reshape(n_in * nbk, n_out).contiguous()
    slot = slot_table(kb, spec.n_bases, cuda)
    ref = kan_fused_v1(x, w_b, t_flat, spec, kb, slot)
    _close(ref, kan_fused_v1_ref(x, w_b, t_flat, spec, kb))
    _close(ref, kan_fused_v2(x, wt, spec, kb, slot))
    cands = autotune.candidates_kan_fused(B, n_in, n_out, nbk,
                                          torch.float32, 1)
    assert cands
    for c in cands:
        got = kan_fused_v1(x, w_b, t_flat, spec, kb, slot,
                           blocks=_kan_knob(c))
        torch.cuda.synchronize()
        assert torch.equal(got, ref), c


@pytest.mark.parametrize("n_in,n_out", [(37, 13), (300, 33), (1, 5)])
def test_v1_at_ragged_widths_under_every_knob(cuda, n_in, n_out):
    spec = SplineSpec(4, 3)
    kb = (0, 2, 4, 5, 6)
    x, wt = _kan_case(cuda, n_in + n_out + 3, 19, n_in, n_out, spec, kb)
    w3 = wt.reshape(n_in, len(kb) + 1, n_out)
    w_b = w3[:, 0].contiguous()
    t_flat = w3[:, 1:].reshape(n_in * len(kb), n_out).contiguous()
    ref = kan_fused_v1(x, w_b, t_flat, spec, kb)
    _close(ref, kan_fused_v1_ref(x, w_b, t_flat, spec, kb))
    for c in autotune.candidates_kan_fused(19, n_in, n_out, len(kb),
                                           torch.float32, 1):
        assert torch.equal(kan_fused_v1(x, w_b, t_flat, spec, kb,
                                        blocks=_kan_knob(c)), ref), c


def test_v1_batched_equals_single_under_different_knobs(cuda):
    spec, kb = SplineSpec(4, 3), KAN_KB
    x, wt = _kan_case(cuda, 26, 37, 304, 32, spec, kb)
    w3 = wt.reshape(304, len(kb) + 1, 32)
    w_b = w3[:, 0].contiguous()
    t_flat = w3[:, 1:].reshape(304 * len(kb), 32).contiguous()
    full = kan_fused_v1(x, w_b, t_flat, spec, kb, blocks=(32, 512, 32))
    for c in autotune.candidates_kan_fused(2, 304, 32, len(kb),
                                           torch.float32, 1):
        for lo, hi in ((0, 1), (5, 7), (35, 37)):
            assert torch.equal(kan_fused_v1(x[lo:hi].contiguous(), w_b,
                                            t_flat, spec, kb,
                                            blocks=_kan_knob(c)),
                               full[lo:hi]), (c, lo, hi)


def test_v1_runs_more_row_tiles_than_grid_y_holds(cuda):
    """B = 65535 * 16 + 1 at vikin-kan2's 72->96 (row tiles sit on
    grid.x): one launch, within tolerance of the v2 kernel and of the
    plain version."""
    spec, kb = SplineSpec(4, 3), KAN_KB
    B = 65535 * 16 + 1
    gen = torch.Generator(device=cuda).manual_seed(27)
    x = torch.rand((B, 72), generator=gen, device=cuda) * 3.0 - 1.5
    wt = torch.randn((72 * (len(kb) + 1), 96), generator=gen,
                     device=cuda) * 0.1
    w3 = wt.reshape(72, len(kb) + 1, 96)
    w_b = w3[:, 0].contiguous()
    t_flat = w3[:, 1:].reshape(72 * len(kb), 96).contiguous()
    before = dict(_build.LAUNCHES)
    got = kan_fused_v1(x, w_b, t_flat, spec, kb)
    assert _build.LAUNCHES["kan_fused_v1"] == before["kan_fused_v1"] + 1
    assert got.shape == (B, 96)
    _close(got, kan_fused_v2(x, wt, spec, kb))
    _close(got, kan_fused_v1_ref(x, w_b, t_flat, spec, kb))


def test_v1_layer_takes_config_blocks_and_tunes(cuda, tmp_path,
                                                monkeypatch):
    """``KANConfig(version=1, blocks=...)`` is the knob the v1 layer
    launches with (one launch a call), and a version-1 search round-trips
    under ``kan_fused_v1`` and changes no bit."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    autotune.reset_cache()
    try:
        cfg = KANConfig(304, 32, SplineSpec(4, 3), pattern=(1, 0, 1, 1),
                        version=1)
        params = kan_init(cfg, torch.Generator().manual_seed(28))
        params = {k: v.to(cuda) for k, v in params.items()}
        x = torch.rand((8, 304), generator=torch.Generator().manual_seed(
            29)).to(cuda)
        layer = KANLayer(cfg, params)
        base = layer(x)
        for knob in ((8, 32, 8), (8, 128, 16), (64, 512, 32)):
            before = dict(_build.LAUNCHES)
            got = KANLayer(dataclasses.replace(cfg, blocks=knob), params)(x)
            after = dict(_build.LAUNCHES)
            assert after["kan_fused_v1"] == before["kan_fused_v1"] + 1
            assert sum(after.values()) == sum(before.values()) + 1
            assert torch.equal(got, base), knob
        best = autotune.tune_kan_fused(x, layer.w_b, cfg.spec, layer.kb,
                                       version=1, t_flat=layer.t_flat)
        dims = (8, 304, 32, len(layer.kb))
        assert best in autotune.candidates_kan_fused(*dims, torch.float32, 1)
        fresh = autotune.AutotuneCache(autotune.get_cache().path)
        assert fresh.lookup(autotune.cache_key(
            "kan_fused_v1", dims, torch.float32, cuda)) == best
        assert torch.equal(KANLayer(cfg, params)(x), base)
    finally:
        autotune.reset_cache()


def test_warmup_builds_every_bucket_and_a_wall_replay_builds_nothing(
        cuda, tmp_path, monkeypatch):
    """warm_buckets runs one forward at each bucket of up to 8 requests,
    which loads the kernels and resolves their knobs; an open-loop wall
    replay afterwards loads no library and resolves no knob."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    autotune.reset_cache()
    try:
        model = VIKIN_ARCHS["vikin-mixed"]
        be = VikinBackend(model, vikin_stack_init(
            model, torch.Generator().manual_seed(0)), device="cuda")
        _build.reset_launches()
        loadgen_bench.warm_buckets(be, 8)
        torch.cuda.synchronize()
        # 1 and 2 requests both pad to bucket 2, then buckets 4 and 8
        assert _build.LAUNCHES["kan_fused_v2"] == 4
        assert _build.LAUNCHES["pattern_matmul"] == 8
        assert _build.BUILDS["kan_fused_v2"] >= 1
        assert _build.BUILDS["pattern_matmul"] >= 1
        assert autotune.RESOLVED
        builds, resolved = dict(_build.BUILDS), set(autotune.RESOLVED)
        eng = Engine(be, n_slots=8)
        _build.reset_launches()
        rep = replay(eng, poisson_trace(20000.0, 300, seed=0), mode="wall")
        torch.cuda.synchronize()
        assert dict(_build.BUILDS) == builds
        assert set(autotune.RESOLVED) == resolved
        assert rep["completed"] == 300 and not rep["incomplete"]
        ticks = int(eng.stats["ticks"])
        assert _build.LAUNCHES["kan_fused_v2"] == ticks
        assert _build.LAUNCHES["pattern_matmul"] == 2 * ticks
    finally:
        autotune.reset_cache()


def test_sim_replay_on_the_card_matches_the_committed_burst_row(cuda):
    committed = json.loads((Path(__file__).resolve().parents[1]
                            / "BENCH_serving.json").read_text())
    row = loadgen_bench.burst_row("vikin-mlp3", device="cuda")
    assert json.loads(json.dumps(row)) == committed[
        "openloop:burst:vikin-mlp3"]


def test_multi_workload_backend_input_dim_and_warmup_on_the_card(cuda):
    archs = ("vikin-kan2", "vikin-mlp3", "vikin-mixed")
    params = {a: vikin_stack_init(VIKIN_ARCHS[a],
                                  torch.Generator().manual_seed(0))
              for a in archs}
    engines = {}
    for dev in ("cuda", "cpu"):
        multi = MultiWorkloadBackend(
            {a: VikinBackend(VIKIN_ARCHS[a], params[a], device=dev)
             for a in archs})
        for a in archs:
            assert multi.input_dim(a) == VIKIN_ARCHS[a].sizes[0]
        with pytest.raises(ValueError, match="unknown workload"):
            multi.input_dim(None)
        _build.reset_launches()
        loadgen_bench.warm_buckets(multi, 4)
        if dev == "cuda":
            torch.cuda.synchronize()
            # buckets 2, 2, 4 on each arch: vikin-mixed and vikin-kan2
            # hold a KAN layer, every arch but vikin-kan2 matmul layers
            assert _build.LAUNCHES["kan_fused_v2"] == 3 * 2
            assert _build.LAUNCHES["pattern_matmul"] == 3 * (2 + 2)
        engines[dev] = Engine(multi, n_slots=4)
    trace = poisson_trace(20000.0, 60, seed=3,
                          workloads=[(a, 1.0) for a in archs])
    reps = {dev: replay(eng, trace, mode="sim")
            for dev, eng in engines.items()}
    assert reps["cuda"] == reps["cpu"]
    assert reps["cuda"]["completed"] == 60
    for rid, r in engines["cpu"]._requests.items():
        got = engines["cuda"]._requests[rid].output
        _close(torch.from_numpy(got), torch.from_numpy(r.output), tol=1e-4)


# ---------------------------------------------------------------------------
# bf16: the four bf16 kernels against their plain versions.  KAN at f32 out
# within TOL * (1 + max|plain|), at bf16 out and the matmul within one bf16
# ulp, 2**-8 * (1 + max|plain|) (the f32 totals differ in summation order
# and may round to neighbouring bf16 values); the spline basis bitwise.
# Every knob gives bitwise the default's output and a row does not depend
# on its batch.
# ---------------------------------------------------------------------------

BF16_ULP = 2.0 ** -8
BF = torch.bfloat16


def _bf16_kan_case(dev, seed, B, n_in, n_out, nbk):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((B, n_in), generator=gen) * 1.5).to(dev, BF)
    wt = (torch.randn((n_in * (nbk + 1), n_out), generator=gen)
          * 0.1).to(dev, BF)
    w3 = wt.reshape(n_in, nbk + 1, n_out)
    return (x, wt, w3[:, 0].contiguous(),
            w3[:, 1:].reshape(n_in * nbk, n_out).contiguous())


def _check_kan_bf16(x, wt, w_b, t_flat, spec, kb, blocks=None):
    """v2 and v1 at f32 and bf16 out against their plain versions; the
    bf16 output is the f32 one rounded once.  Returns (v2, v1) at bf16
    out."""
    outs = []
    for version in (2, 1):
        if version == 2:
            run = lambda od: kan_fused_v2(x, wt, spec, kb, blocks=blocks,
                                          out_dtype=od)
            ref = lambda od: kan_fused_v2_ref(x, wt, spec, kb, od)
        else:
            run = lambda od: kan_fused_v1(x, w_b, t_flat, spec, kb,
                                          blocks=blocks, out_dtype=od)
            ref = lambda od: kan_fused_v1_ref(x, w_b, t_flat, spec, kb, od)
        got32, got = run(torch.float32), run(None)
        torch.cuda.synchronize()
        assert got32.dtype == torch.float32 and got.dtype == BF
        _close(got32, ref(torch.float32))
        _close(got.float(), ref(None).float(), BF16_ULP)
        assert torch.equal(got, got32.to(BF))
        outs.append(got)
    return outs


@pytest.mark.parametrize("G,K,rate", [(4, 3, 0.5), (16, 4, 0.0),
                                      (2, 1, 0.75)])
@pytest.mark.parametrize("B,n_in,n_out", [(1, 72, 96), (33, 45, 13),
                                          (300, 304, 32), (77, 37, 13),
                                          (8, 301, 33)])
def test_bf16_kan_kernels_match_plain(cuda, G, K, rate, B, n_in, n_out):
    """Odd n_in and n_out stage their rows an element at a time."""
    spec = SplineSpec(G, K)
    kb = tuple(int(i) for i in tiled_mask(
        spec.n_bases, sparsity_to_pattern(rate)).indices())
    x, wt, w_b, t_flat = _bf16_kan_case(cuda, G * 10 + K, B, n_in, n_out,
                                        len(kb))
    before = dict(_build.LAUNCHES)
    _check_kan_bf16(x, wt, w_b, t_flat, spec, kb)
    assert _build.LAUNCHES["kan_fused_v2_bf16"] == \
        before["kan_fused_v2_bf16"] + 2
    assert _build.LAUNCHES["kan_fused_v1_bf16"] == \
        before["kan_fused_v1_bf16"] + 2
    assert _build.LAUNCHES["kan_fused_v2"] == before["kan_fused_v2"]


@pytest.mark.parametrize("B", [8, 8192])
@pytest.mark.parametrize("n_in,n_out", VIKIN_KANS)
def test_bf16_every_kan_knob_gives_the_default_output_bitwise(cuda, B, n_in,
                                                              n_out):
    spec, kb = SplineSpec(4, 3), (0, 2, 4, 5, 6)
    x, wt, w_b, t_flat = _bf16_kan_case(cuda, B + n_in, B, n_in, n_out, 5)
    v2, v1 = _check_kan_bf16(x, wt, w_b, t_flat, spec, kb)
    for version, ref in ((2, v2), (1, v1)):
        for c in autotune.candidates_kan_fused(B, n_in, n_out, 5, BF,
                                               version):
            if version == 2:
                got = kan_fused_v2(x, wt, spec, kb, blocks=_kan_knob(c))
            else:
                got = kan_fused_v1(x, w_b, t_flat, spec, kb,
                                   blocks=_kan_knob(c))
            assert torch.equal(got, ref), (version, c)


def test_bf16_kan_batched_equals_single(cuda):
    """At every bucket and at B=8192, each row alone (under another knob)
    is bitwise the row in the batch, both versions."""
    spec, kb = SplineSpec(4, 3), (0, 2, 4, 5, 6)
    x, wt, w_b, t_flat = _bf16_kan_case(cuda, 5, 8192, 304, 32, 5)
    for B in (2, 4, 8, 16, 8192):
        full2 = kan_fused_v2(x[:B], wt, spec, kb, blocks=(16, 512, 32))
        full1 = kan_fused_v1(x[:B], w_b, t_flat, spec, kb,
                             blocks=(16, 512, 32))
        for i in (0, B // 2, B - 1):
            xi = x[i:i + 1].contiguous()
            assert torch.equal(kan_fused_v2(xi, wt, spec, kb,
                                            blocks=(8, 32, 8)),
                               full2[i:i + 1]), (B, i)
            assert torch.equal(kan_fused_v1(xi, w_b, t_flat, spec, kb,
                                            blocks=(8, 64, 16)),
                               full1[i:i + 1]), (B, i)


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("M,K,N", [(2, 72, 304), (8, 228, 96), (17, 16, 96),
                                   (130, 152, 65), (999, 147, 301),
                                   (5, 0, 8), (8192, 72, 304)])
def test_bf16_matmul_kernel_matches_plain(cuda, act, bias, M, K, N):
    """Odd K and N stage and store an element at a time."""
    gen = torch.Generator().manual_seed(M * 1000 + K + N)
    x = torch.randn((M, K), generator=gen).to(cuda, BF)
    w = (torch.randn((K, N), generator=gen) * 0.1).to(cuda, BF)
    b = torch.randn((N,), generator=gen).to(cuda, BF) if bias else None
    before = dict(_build.LAUNCHES)
    got = matmul_compact(x, w, b, act)
    got32 = matmul_compact(x, w, b, act, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == BF and got32.dtype == torch.float32
    _close(got.float(), matmul_compact_ref(x, w, b, act).float(), BF16_ULP)
    _close(got32, matmul_compact_ref(x, w, b, act, torch.float32))
    assert torch.equal(got, got32.to(BF))
    assert _build.LAUNCHES["pattern_matmul_bf16"] == \
        before["pattern_matmul_bf16"] + 2
    assert _build.LAUNCHES["pattern_matmul"] == before["pattern_matmul"]


@pytest.mark.parametrize("M", [8, 8192])
@pytest.mark.parametrize("Kc,N,act", VIKIN_MATMULS)
def test_bf16_every_matmul_tile_gives_the_default_output_bitwise(
        cuda, M, Kc, N, act):
    gen = torch.Generator().manual_seed(M + Kc + N)
    x = torch.rand((M, Kc), generator=gen).to(cuda, BF)
    w = (torch.randn((Kc, N), generator=gen) * 0.1).to(cuda, BF)
    b = torch.randn((N,), generator=gen).to(cuda, BF)
    ref = matmul_compact(x, w, b, act)
    for c in autotune.candidates_pattern_matmul(M, Kc, N, BF):
        assert torch.equal(matmul_compact(x, w, b, act, blocks=_knob(c)),
                           ref), c


def test_bf16_matmul_batched_equals_single(cuda):
    gen = torch.Generator().manual_seed(3)
    for Kc, N, act in VIKIN_MATMULS:
        x = torch.rand((8192, Kc), generator=gen).to(cuda, BF)
        w = (torch.randn((Kc, N), generator=gen) * 0.1).to(cuda, BF)
        b = torch.randn((N,), generator=gen).to(cuda, BF)
        for B in (2, 4, 8, 16, 8192):
            full = matmul_compact(x[:B], w, b, act, blocks=(128, 64, 64))
            for i in (0, B // 2, B - 1):
                one = matmul_compact(x[i:i + 1].contiguous(), w, b, act,
                                     blocks=(16, 16, 8))
                assert torch.equal(one, full[i:i + 1]), (Kc, B, i)


# The tensor-core KAN body's edges: n_in not a multiple of 32 (a zero-
# padded last chunk), 21 fused rows a feature (G=16, K=4, every basis
# kept), the silu row alone (nbk = 0: a chunk is two k16 steps), bm = 8
# (one m16 tile, rows 8..15 zero), n_out not a multiple of 8, and the
# features split over a cluster; each under every candidate knob, bitwise
# the default's.
@pytest.mark.parametrize("G,K,kb,B,n_in,n_out", [
    (4, 3, KAN_KB, 8, 45, 13), (16, 4, tuple(range(20)), 8, 37, 33),
    (16, 4, tuple(range(20)), 300, 100, 24), (4, 3, (), 8, 70, 13),
    (4, 3, (), 33, 304, 32), (2, 1, (1,), 1, 301, 9)])
def test_bf16_kan_mma_edges_under_every_knob(cuda, G, K, kb, B, n_in,
                                             n_out):
    spec = SplineSpec(G, K)
    x, wt, w_b, t_flat = _bf16_kan_case(cuda, B * 7 + n_in, B, n_in, n_out,
                                        len(kb))
    ref = _check_kan_bf16(x, wt, w_b, t_flat, spec, kb)[0]
    cands = autotune.candidates_kan_fused(B, n_in, n_out, len(kb), BF)
    assert {"bm": 8, "bi": 32, "bn": 8} in cands
    for c in cands:
        assert torch.equal(kan_fused_v2(x, wt, spec, kb,
                                        blocks=_kan_knob(c)), ref), c


@pytest.mark.parametrize("M,Kc,N", [(8192 + 77, 72, 304), (5000, 228, 96),
                                    (4099, 16, 96), (300, 1000, 40)])
def test_bf16_matmul_persistent_rows_under_every_tile(cuda, M, Kc, N):
    """Row counts that are no multiple of bm, and enough row tiles that a
    block of the persistent grid walks several (deep slabs and shallow
    ones, Kc past bk): every candidate tile bitwise the default's, which
    holds to the plain version."""
    gen = torch.Generator().manual_seed(M + Kc)
    x = torch.randn((M, Kc), generator=gen).to(cuda, BF)
    w = (torch.randn((Kc, N), generator=gen) * 0.1).to(cuda, BF)
    b = torch.randn((N,), generator=gen).to(cuda, BF)
    ref = matmul_compact(x, w, b, "relu")
    _close(ref.float(), matmul_compact_ref(x, w, b, "relu").float(),
           BF16_ULP)
    for c in autotune.candidates_pattern_matmul(M, Kc, N, BF):
        assert torch.equal(matmul_compact(x, w, b, "relu", blocks=_knob(c)),
                           ref), c


@pytest.mark.parametrize("M,Kc,N", [(100, 72, 304), (40, 228, 96),
                                    (77, 147, 301)])
def test_bf16_matmul_one_tile_and_persistent_kernels_agree(cuda, M, Kc, N):
    """M of one row tile runs the first design's kernel, more rows the
    persistent one: at these shapes the candidate tiles take both,
    bitwise alike at both output dtypes (odd N: stores an element at a
    time)."""
    gen = torch.Generator().manual_seed(M + Kc + N)
    x = torch.randn((M, Kc), generator=gen).to(cuda, BF)
    w = (torch.randn((Kc, N), generator=gen) * 0.1).to(cuda, BF)
    b = torch.randn((N,), generator=gen).to(cuda, BF)
    ref = matmul_compact(x, w, b, "gelu")
    ref32 = matmul_compact(x, w, b, "gelu", out_dtype=torch.float32)
    _close(ref32, matmul_compact_ref(x, w, b, "gelu", torch.float32))
    one = set()
    for c in autotune.candidates_pattern_matmul(M, Kc, N, BF):
        one.add(M <= c["bm"])
        assert torch.equal(matmul_compact(x, w, b, "gelu", blocks=_knob(c)),
                           ref), c
        assert torch.equal(matmul_compact(x, w, b, "gelu", blocks=_knob(c),
                                          out_dtype=torch.float32),
                           ref32), c
    assert one == {True, False}


def test_bf16_matmul_streams_a_column_tile_too_deep_to_keep(cuda):
    """At Kc = 1000 a 128-column tile of w_c does not fit in shared memory
    beside 128-row x slabs and rides a bk slab with each of them; an
    8-column one stays: both bitwise equal, the f32 output within 1e-5 of
    the plain version and the bf16 output that rounded once."""
    gen = torch.Generator().manual_seed(1000)
    x = torch.randn((600, 1000), generator=gen).to(cuda, BF)
    w = (torch.randn((1000, 200), generator=gen) * 0.02).to(cuda, BF)
    assert tpm_ops.kernel_smem(128, 16, 128, 1000, BF) < \
        2 * 1008 * 136                         # the slabs, not the tile
    got = matmul_compact(x, w, None, None, blocks=(128, 16, 128))
    assert torch.equal(got, matmul_compact(x, w, None, None,
                                           blocks=(16, 256, 8)))
    got32 = matmul_compact(x, w, None, None, blocks=(128, 16, 128),
                           out_dtype=torch.float32)
    _close(got32, matmul_compact_ref(x, w, None, None, torch.float32))
    assert torch.equal(got, got32.to(BF))


@pytest.mark.parametrize("G", VALID_G)
@pytest.mark.parametrize("K", VALID_K)
def test_bf16_spline_basis_kernel_bitwise(cuda, G, K):
    """In range and past both ends, ragged n, every block_n candidate."""
    spec = SplineSpec(G, K)
    rng = np.random.default_rng(G * 10 + K)
    for n in (1, 7, 1025, 4096):
        x = torch.from_numpy(rng.uniform(-2.5, 2.5, n).astype(
            np.float32)).to(cuda, BF)
        plain = spline_basis_plain(x, spec)
        for cand in autotune.candidates_spline_basis(n, spec.n_bases, BF) + [
                {"block_n": 32}, {"block_n": 128}]:
            got = spline_basis(x, spec, block_n=cand["block_n"])
            torch.cuda.synchronize()
            assert got.dtype == BF and torch.equal(got, plain), (n, cand)


@pytest.mark.parametrize("G,K", [(4, 3), (16, 4)])
def test_bf16_spline_basis_misaligned_output_bitwise(cuda, G, K):
    """Outputs 2..14 bytes past a 16-byte boundary, guard elements on both
    sides untouched."""
    spec = SplineSpec(G, K)
    nb = spec.n_bases
    x = torch.from_numpy(np.random.default_rng(G).uniform(
        -2.5, 2.5, 1025).astype(np.float32)).to(cuda, BF)
    plain = spline_basis_plain(x, spec)
    n = x.numel()
    for off in range(1, 8):
        buf = torch.full((n * nb + 16,), -7.0, device=cuda, dtype=BF)
        _build.launch("spline_basis_bf16", x.data_ptr(),
                      buf[off:].data_ptr(), n, G, K, float(spec.x0),
                      float(spec.inv_h), 256,
                      torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert torch.equal(buf[off:off + n * nb].reshape(n, nb), plain), off
        assert bool((buf[:off] == -7.0).all())
        assert bool((buf[off + n * nb:] == -7.0).all())


SERVE_TOL_BF16 = 2.0 ** -8


@pytest.mark.parametrize("arch", ["vikin-mixed", "vikin-mlp3", "vikin-kan2"])
def test_bf16_backend_on_cuda_serves_through_bf16_kernels(cuda, arch):
    """A served burst at bf16: answers within one bf16 ulp a layer of the
    stack through the plain versions on the card, only bf16 kernels
    launched, batched == single bitwise."""
    model = VIKIN_ARCHS[arch]
    params = vikin_stack_init(model, torch.Generator().manual_seed(0))
    be = VikinBackend(model, params, device=cuda, precision="bf16")
    cpu = VikinBackend(model, params, device="cpu", precision="bf16")
    rng = np.random.default_rng(2)
    xs = [rng.random(model.sizes[0], dtype=np.float32) for _ in range(11)]
    before = dict(_build.LAUNCHES)
    eng = Engine(be, n_slots=4)
    rids = [eng.submit(x) for x in xs]
    out = eng.run_until_done()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    kinds = model.layer_kinds
    ticks = int(eng.stats["ticks"])
    want = {k: 0 for k in launched}
    want["kan_fused_v2_bf16"] = ticks * kinds.count("kan")
    want["pattern_matmul_bf16"] = ticks * kinds.count("mlp")
    assert launched == want
    h = torch.from_numpy(np.stack(xs)).to(cuda, BF)
    with torch.inference_mode():
        for layer in be.stack.layers:
            if hasattr(layer, "wt"):
                h = kan_fused_v2_ref(h, layer.wt, layer.cfg.spec, layer.kb)
            else:
                xc = h if layer.idx is None else h.index_select(1, layer.idx)
                h = matmul_compact_ref(xc.contiguous(), layer.w_c, layer.b,
                                       layer.act)
    served = torch.from_numpy(np.stack([out[r] for r in rids]))
    _close(served, h.float().cpu(), SERVE_TOL_BF16 * len(kinds))
    _close(served, torch.from_numpy(cpu.forward(np.stack(xs))),
           SERVE_TOL_BF16 * len(kinds))
    solo = Engine(VikinBackend(model, params, device=cuda,
                               precision="bf16"), n_slots=4)
    for x, rid in zip(xs[:4], rids):
        srid = solo.submit(x)
        assert np.array_equal(solo.run_until_done()[srid], out[rid])
    assert eng.stats["sim_cycles"] > 0


# ---------------------------------------------------------------- training
# A gradient through the kernels' autograd Functions (the f32 v2 KAN and
# pattern-matmul kernels forward, the spline-basis kernel in the KAN
# backward) against autograd through the plain versions on the card:
# within TOL * max|plain| of each leaf (its gradient is far below 1).

from repro_torch.benchmarks.kernel_ab import plain_grads  # noqa: E402
from repro_torch.core import calibrate as tcal  # noqa: E402
from repro_torch.core.sparsity import magnitude_mask  # noqa: E402
from repro_torch.data.stack_task import task_for_model  # noqa: E402
from repro_torch.runtime.trainer import (  # noqa: E402
    StackTrainer,
    StackTrainerConfig,
)
from repro_torch.utils import leaf_paths  # noqa: E402

STEP_LAUNCHES = {"vikin-mixed": {"kan_fused_v2": 1, "pattern_matmul": 2,
                                 "spline_basis": 2},
                 "vikin-kan2": {"kan_fused_v2": 1, "spline_basis": 1},
                 "vikin-mlp3": {"pattern_matmul": 2}}


@pytest.mark.parametrize("arch", sorted(STEP_LAUNCHES))
def test_train_step_grads_and_launches(cuda, arch):
    model = VIKIN_ARCHS[arch]
    tr = StackTrainer(model, task_for_model(model),
                      StackTrainerConfig(batch_size=64, device="cuda"))
    x, y = tr.batch(0)
    _build.reset_launches()
    got = dict(leaf_paths(tr.value_and_grad(x, y)[1]))
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        STEP_LAUNCHES[arch]
    ref = plain_grads(tr.params, model, x, y)[1]
    assert sorted(got) == sorted(ref)
    for k in ref:
        err = float((got[k] - ref[k]).abs().max())
        assert err <= TOL * float(ref[k].abs().max()), (k, err)


@pytest.mark.parametrize("G,K", [(4, 3), (8, 2), (16, 4), (4, 1)])
def test_kan_grad_on_card_matches_cpu(cuda, G, K):
    """The same layer's gradient on the card (kernels) and on the CPU
    (plain versions), inputs at x0, at x1 - eps, outside the grid and on
    knots included."""
    spec = SplineSpec(G, K)
    kb = tuple(range(0, spec.n_bases, 2))
    gen = torch.Generator().manual_seed(G + K)
    x = torch.rand((40, 37), generator=gen) * 2.6 - 1.3
    x[0, :4] = torch.tensor([spec.x0, spec.clip_hi, 1.0, -1.5])
    x[1, :G + 1] = torch.linspace(-1.0, 1.0, G + 1)
    wt = torch.randn((37 * (len(kb) + 1), 11), generator=gen) * 0.3
    g = torch.randn((40, 11), generator=gen)
    out = {}
    for dev in ("cpu", cuda):
        xd = x.to(dev).clone().requires_grad_(True)
        wd = wt.to(dev).clone().requires_grad_(True)
        (kan_fused_v2(xd, wd, spec, kb) * g.to(dev)).sum().backward()
        out[str(dev)] = (xd.grad.cpu(), wd.grad.cpu())
    for got, ref in zip(out["cuda"], out["cpu"]):
        _close(got, ref)


@pytest.mark.parametrize("arch", ["vikin-mixed", "vikin-kan2"])
def test_train_bitwise_reproducible(cuda, arch):
    model = VIKIN_ARCHS[arch]
    data = task_for_model(model)
    runs = []
    for _ in range(2):
        tr = StackTrainer(model, data, StackTrainerConfig(
            batch_size=64, device="cuda"))
        losses = [tr.train_step(s)[0] for s in range(30)]
        runs.append((torch.stack(losses).cpu(),
                     [p.cpu() for _, p in leaf_paths(tr.params)]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_calibration_on_card_runs_the_kernels_and_matches_cpu(cuda):
    """Params on the card calibrate through the kernels (one dense
    forward each for the masks and the scales); the masks are the CPU
    calibration's except where two saliencies tie within twice the
    card-vs-CPU difference, and the activation scales agree within TOL."""
    model = VIKIN_ARCHS["vikin-mixed"]
    tr = StackTrainer(model, task_for_model(model),
                      StackTrainerConfig(batch_size=64, device="cuda"))
    for s in range(20):
        tr.train_step(s)
    calib_x = task_for_model(model)["train_x"][:256]
    cpu = [{k: v.cpu() for k, v in p.items()} for p in tr.params]
    _build.reset_launches()
    card_masks = tcal.calibrate_stack(tr.params, model, calib_x).masks
    card_scales = tcal.calibrate_scales(tr.params, model, calib_x)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        {"kan_fused_v2": 2, "pattern_matmul": 4}
    cpu_scales = tcal.calibrate_scales(cpu, model, calib_x)
    for a, b in zip(card_scales.scales, cpu_scales.scales):
        assert abs(a.x - b.x) <= TOL * abs(b.x)
    sal_card = tcal.stack_saliencies(tr.params, model, calib_x)
    for m, s_c, s_d in zip(card_masks,
                           tcal.stack_saliencies(cpu, model, calib_x),
                           sal_card):
        if s_c is None:
            assert m is None
            continue
        assert np.array_equal(m.keep, magnitude_mask(s_d, 2).keep)
        noise = float(np.abs(s_d - s_c).max())
        cpu_keep = magnitude_mask(s_c, 2).keep
        for a, b in zip(np.nonzero(m.keep & ~cpu_keep)[0],
                        np.nonzero(cpu_keep & ~m.keep)[0]):
            assert abs(float(s_c[a]) - float(s_c[b])) <= 2 * noise
