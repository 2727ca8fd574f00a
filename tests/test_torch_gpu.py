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
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the LM train step runs under deterministic algorithms, whose cuBLAS
# setting torch reads once a process
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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



# ---------------- the bf16 spline basis, bf16 v1 and the mixed KAN kernel
def _bits_equal(got, ref):
    """bf16 outputs bitwise equal, NaN for NaN (the kernel's NaN is the
    card's canonical one, torch's another payload)."""
    gn, rn = torch.isnan(got.float()), torch.isnan(ref.float())
    return bool(torch.equal(gn, rn)) and bool(
        ((got.view(torch.int16) == ref.view(torch.int16)) | gn).all())


@pytest.mark.parametrize("G", VALID_G)
@pytest.mark.parametrize("K", VALID_K)
def test_bf16_spline_basis_bitwise_on_every_bf16_pattern(cuda, G, K):
    """The packed bf16x2 kernel on all 65 536 bf16 bit patterns but NaN
    and inf (huge inputs extrapolate to inf and NaN): bitwise its plain
    version at every block_n, into outputs 2..14 bytes past a 16-byte
    boundary, and from an x that is not 4-byte aligned."""
    spec = SplineSpec(G, K)
    nb = spec.n_bases
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    xs = bits.view(BF)
    x = xs[torch.isfinite(xs.float())].contiguous().to(cuda)
    n = x.numel()
    assert n == 65536 - 256
    plain = spline_basis_plain(x, spec)
    for bn in sorted({c["block_n"] for c in autotune.candidates_spline_basis(
            n, nb, BF)} | {32, 64, 128}):
        got = spline_basis(x, spec, block_n=bn)
        torch.cuda.synchronize()
        assert got.dtype == BF and _bits_equal(got, plain), bn
    for off in range(1, 8):
        buf = torch.full((n * nb + 16,), -7.0, device=cuda, dtype=BF)
        _build.launch("spline_basis_bf16", x.data_ptr(),
                      buf[off:].data_ptr(), n, G, K, float(spec.x0),
                      float(spec.inv_h), 256,
                      torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert _bits_equal(buf[off:off + n * nb].reshape(n, nb), plain), off
        assert bool((buf[:off] == -7.0).all())
        assert bool((buf[off + n * nb:] == -7.0).all())
    shifted = torch.empty(n + 1, dtype=BF, device=cuda)
    shifted[1:] = x
    assert _bits_equal(spline_basis(shifted[1:], spec), plain)


V1_BF16_CASES = [((4, 3), (0, 2, 4, 5, 6), (8, 304, 32)),
                 ((4, 3), (0, 2, 4, 5, 6), (8192, 304, 32)),
                 ((4, 3), (0, 2, 4, 5, 6), (77, 301, 33)),
                 ((16, 4), tuple(range(20)), (77, 37, 33)),
                 ((4, 3), (), (33, 304, 32)),
                 ((2, 1), (0, 1), (300, 64, 256))]


@pytest.mark.parametrize("GK,kb,shape", V1_BF16_CASES)
def test_bf16_v1_on_tensor_cores(cuda, GK, kb, shape):
    """bf16 version 1 (two MMA chains): within one bf16 ulp of its plain
    version and of bf16 version 2 (f32 out within TOL of its plain
    version), every knob of its grid (full 8192 tiles too) bitwise the
    default's, each row alone bitwise its row in the batch."""
    B, n_in, n_out = shape
    spec = SplineSpec(*GK)
    x, wt, w_b, t_flat = _bf16_kan_case(cuda, B + n_in, B, n_in, n_out,
                                        len(kb))
    v2, v1 = _check_kan_bf16(x, wt, w_b, t_flat, spec, kb)
    _close(v1.float(), v2.float(), BF16_ULP)
    cands = autotune.candidates_kan_fused(B, n_in, n_out, len(kb), BF, 1)
    for c in cands:
        got = kan_fused_v1(x, w_b, t_flat, spec, kb, blocks=_kan_knob(c))
        assert torch.equal(got, v1), c
    for i in sorted({0, B // 2, B - 1}):
        one = kan_fused_v1(x[i:i + 1].contiguous(), w_b, t_flat, spec, kb,
                           blocks=(8, 64, 16))
        assert torch.equal(one, v1[i:i + 1]), i
    if B >= 64 and n_out >= 128:
        assert any(c["bm"] * c["bn"] == 8192 for c in cands)


def test_bf16_v1_refuses_f32_weights_on_the_card(cuda):
    spec, kb = SplineSpec(4, 3), (0, 2, 4, 5, 6)
    x, _, w_b, t_flat = _bf16_kan_case(cuda, 1, 8, 64, 16, len(kb))
    before = dict(_build.LAUNCHES)
    with pytest.raises(TypeError, match="ROADMAP"):
        kan_fused_v1(x, w_b, t_flat.float(), spec, kb)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("B,n_in,n_out,GK,kb", [
    (1024, 896, 608, (4, 3), (0, 2, 4, 5, 6)),
    (1024, 608, 896, (4, 3), (0, 2, 4, 5, 6)),
    (96, 1024, 512, (4, 3), (0, 2, 4, 5, 6)),
    (77, 37, 13, (4, 3), (0, 2, 4, 5, 6)),
    (33, 301, 33, (16, 4), tuple(range(20))),
    (8, 304, 32, (4, 3), (0, 2, 4, 5, 6))])
def test_mixed_kernel_matches_plain_under_every_knob(cuda, B, n_in, n_out,
                                                     GK, kb):
    """A bf16 x against f32 fused rows launches the mixed kernel, with no
    cast: within TOL of its plain version at f32 out, one bf16 ulp at
    bf16 out (the f32 output rounded once), every knob bitwise the
    default's, each row alone bitwise its row in the batch."""
    spec = SplineSpec(*GK)
    gen = torch.Generator().manual_seed(B + n_in)
    x = (torch.randn((B, n_in), generator=gen) * 1.5).to(cuda, BF)
    wt = (torch.randn((n_in * (len(kb) + 1), n_out), generator=gen)
          * 0.05).to(cuda)
    before = dict(_build.LAUNCHES)
    got32 = kan_fused_v2(x, wt, spec, kb, out_dtype=torch.float32)
    got = kan_fused_v2(x, wt, spec, kb)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                if v != before[k]}
    assert launched == {"kan_fused_v2_mixed": 2}
    assert got.dtype == BF and got32.dtype == torch.float32
    _close(got32, kan_fused_v2_ref(x, wt, spec, kb, torch.float32))
    _close(got.float(), kan_fused_v2_ref(x, wt, spec, kb).float(), BF16_ULP)
    assert torch.equal(got, got32.to(BF))
    cands = autotune.candidates_kan_fused(B, n_in, n_out, len(kb), BF, 2,
                                          torch.float32)
    for c in cands[::2] if B >= 1024 else cands:
        assert torch.equal(kan_fused_v2(x, wt, spec, kb,
                                        blocks=_kan_knob(c)), got), c
    for i in sorted({0, B // 2, B - 1}):
        one = kan_fused_v2(x[i:i + 1].contiguous(), wt, spec, kb,
                           blocks=(8, 128, 8))
        assert torch.equal(one, got[i:i + 1]), i
    with pytest.raises(TypeError, match="wt"):
        kan_fused_v2(x.float(), wt.to(BF), spec, kb)


def _mixed_layer(dev, n_in, n_out, seed=1):
    """The f32 fused rows of a seeded bf16 KAN drop-in layer (its t f32,
    as the reference's kan_init draws it)."""
    from repro_torch.kernels.kan_fused.ops import flatten_t, fuse_wt
    cfg = KANConfig(n_in, n_out, SplineSpec(4, 3), basis_keep=KAN_KB)
    p = kan_init(cfg, torch.Generator(device=dev).manual_seed(seed), BF)
    wt = fuse_wt(p["w_b"], flatten_t(p["t"], KAN_KB), len(KAN_KB))
    assert wt.dtype == torch.float32
    return cfg, p, wt


@pytest.mark.parametrize("scale", [1e-30, 1e20, "ties"])
def test_mixed_kernel_at_extreme_weights_and_bf16_ties(cuda, scale):
    """f32 rows of tiny (1e-30) or huge (1e20) magnitude, and rows exactly
    half a bf16 ulp off a bf16 value (where rounding to bf16 ties and the
    split's hi plane drops the tie bit): within TOL of the plain version
    at f32 out and one bf16 ulp at bf16 out, each relative to the rows'
    scale, one mixed launch a call."""
    spec, kb = SplineSpec(4, 3), KAN_KB
    gen = torch.Generator().manual_seed(7)
    x = (torch.randn((256, 608), generator=gen) * 1.5).to(cuda, BF)
    wt = torch.randn((608 * (len(kb) + 1), 96), generator=gen) * 0.05
    s = 1.0 if scale == "ties" else scale
    if scale == "ties":
        base = wt.to(BF).float()
        _, e = torch.frexp(base)
        wt = base + torch.ldexp(torch.sign(base), e - 9)
        assert not torch.equal(wt, base)
    else:
        wt = wt * scale
    wt = wt.to(cuda)
    before = dict(_build.LAUNCHES)
    got32 = kan_fused_v2(x, wt, spec, kb, out_dtype=torch.float32)
    got = kan_fused_v2(x, wt, spec, kb)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _build.LAUNCHES.items()
            if v != before[k]} == {"kan_fused_v2_mixed": 2}
    ref32 = kan_fused_v2_ref(x, wt, spec, kb, torch.float32)
    assert torch.isfinite(ref32).all() and float(ref32.abs().max()) > 0
    _close(got32 / s, ref32 / s)
    _close(got.float() / s, kan_fused_v2_ref(x, wt, spec, kb).float() / s,
           BF16_ULP)
    assert torch.equal(got, got32.to(BF))


def test_mixed_kernel_launches_once_a_layer_call(cuda):
    """A ``KANLayer`` of a bf16 model (f32 t) is one ``kan_fused_v2_mixed``
    launch a call and no other kernel: the split into bf16 planes happens
    inside the launch."""
    cfg, p, _ = _mixed_layer(cuda, 896, 608)
    layer = KANLayer(cfg, p)
    assert layer.wt.dtype == torch.float32
    x = (torch.randn((1024, 896), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda) * 1.5).to(BF)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        for _ in range(3):
            y = layer(x)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in _build.LAUNCHES.items()
            if v != before[k]} == {"kan_fused_v2_mixed": 3}
    assert y.dtype == BF and y.shape == (1024, 608)
    _close(y.float(), kan_fused_v2_ref(x, layer.wt, cfg.spec,
                                       layer.kb).float(), BF16_ULP)


@pytest.mark.parametrize("n_in,n_out", [(896, 608), (608, 896)])
def test_mixed_kernel_every_knob_and_batched_equals_single(cuda, n_in,
                                                           n_out):
    """At the LM train step's layers: every candidate knob bitwise the
    default's at M = 1024, and the first M rows of a batch, M = 1, 8 and
    1024, bitwise the batch's, under their own default knobs."""
    spec, kb = SplineSpec(4, 3), KAN_KB
    _, _, wt = _mixed_layer(cuda, n_in, n_out, seed=n_in)
    x = (torch.randn((1024, n_in), generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda) * 1.5).to(BF)
    got = kan_fused_v2(x, wt, spec, kb)
    cands = autotune.candidates_kan_fused(1024, n_in, n_out, len(kb), BF, 2,
                                          torch.float32)
    assert len(cands) > 10
    for c in cands:
        assert torch.equal(kan_fused_v2(x, wt, spec, kb,
                                        blocks=_kan_knob(c)), got), c
    for M in (1, 8, 1024):
        assert torch.equal(kan_fused_v2(x[:M].contiguous(), wt, spec, kb),
                           got[:M]), M
    for i in (5, 511, 1023):
        assert torch.equal(kan_fused_v2(x[i:i + 1].contiguous(), wt, spec,
                                        kb), got[i:i + 1]), i

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


# ------------------------------------------------------- Fig. 8's grids
# KAN-3 (72 -> 32 -> 96) at batch 512, the paper scripts' training batch,
# at grid sizes the served stacks never use: 5, 11 and 19 bases a feature.

from repro_torch.benchmarks.table1_models import (  # noqa: E402
    apply_model,
    init_model,
    to_device,
)
from repro_torch.configs.vikin_models import KAN3  # noqa: E402
from repro_torch.kernels.kan_fused.ops import fuse_wt  # noqa: E402


@pytest.mark.parametrize("G", [2, 8, 16])
def test_kan3_kernel_and_grad_at_fig8_grids(cuda, G):
    """Each layer's kernel forward against its plain version, and each
    leaf's gradient through the kernels (one step: kan_fused_v2 x2,
    spline_basis x3) against autograd through the plain versions."""
    cfg = dataclasses.replace(KAN3, grid=G)
    spec = cfg.spec
    gen = torch.Generator().manual_seed(G)
    params = to_device(init_model(cfg, gen), cuda)
    x = torch.rand((512, 72), generator=gen).to(cuda)
    y = torch.rand((512, 96), generator=gen).to(cuda)
    h = 2.0 * x - 1.0
    kb = tuple(range(spec.n_bases))
    with torch.no_grad():
        for p in params:
            wt = fuse_wt(p["w_b"], p["t"].reshape(-1, p["t"].shape[-1]),
                         len(kb))
            ref = kan_fused_v2_ref(h, wt, spec, kb)
            _close(kan_fused_v2(h, wt, spec, kb), ref)
            h = ref
    leaves = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
              for p in params]
    _build.reset_launches()
    pred, _ = apply_model(leaves, x, cfg)
    loss = torch.mean(torch.square(pred - y))
    paths = leaf_paths(leaves)
    got = dict(zip((k for k, _ in paths),
                   torch.autograd.grad(loss, [v for _, v in paths])))
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == \
        {"kan_fused_v2": 2, "spline_basis": 3}
    ref = plain_grads(params, cfg, 2.0 * x - 1.0, y)[1]
    assert sorted(got) == sorted(ref)
    for k in ref:
        err = float((got[k] - ref[k]).abs().max())
        assert err <= TOL * float(ref[k].abs().max()), (k, err)


# ------------------------------------------------- KAN-FFN transformers
# One KAN-FFN layer (the fused-KAN up-projection and the pattern-matmul
# down-projection of models/ffn.KanFFN) at a reduced width, and the
# kanffn-ci transformer served through TransformerBackend on the card.

from repro_torch.benchmarks.kernel_ab import layer_calls  # noqa: E402
from repro_torch.configs.registry import KANFFN_ARCHS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.ffn import FFNConfig, KanFFN, ffn_init  # noqa: E402
from repro_torch.runtime.backends import TransformerBackend  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("M", [1, 3, 8, 16, 64])
def test_kan_ffn_layer_on_card(cuda, dtype, masked, M):
    """One fused-KAN and one pattern-matmul launch a call; each kernel
    within its tolerance of its plain version on the same input (f32
    ``TOL``, bf16 one ulp), the layer bitwise its two kernels.  A bf16
    draw's KAN rows are f32 (its ``t`` is, as the reference's), so its
    up-projection is the mixed kernel."""
    dt = getattr(torch, dtype)
    cfg = FFNConfig(d_model=96, d_ff=608, kind="kanffn")
    if masked:
        cfg = dataclasses.replace(
            cfg, basis_keep=(0, 2, 4, 5, 6),
            hidden_keep=tuple(range(0, cfg.kanffn_hidden, 2)))
    params = ffn_init(torch.Generator().manual_seed(0), cfg, dt)
    f = KanFFN(cfg, {k: (v.to(cuda) if torch.is_tensor(v)
                         else {a: b.to(cuda) for a, b in v.items()})
                     for k, v in params.items()})
    x = (torch.randn((M, 96), generator=torch.Generator().manual_seed(M))
         .to(cuda, dt))
    sfx = "_bf16" if dt == BF else ""
    kan = "kan_fused_v2_mixed" if dt == BF else "kan_fused_v2"
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        y = f(x)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == {k: int(k in (kan, "pattern_matmul" + sfx))
                        for k in launched}
    tol = 2.0 ** -8 if dt == BF else TOL
    _, _, up_k, up_p = layer_calls(f.up, x)
    h = up_k()
    _close(h.float(), up_p().float(), tol)
    _, _, down_k, down_p = layer_calls(f.down, h)
    assert torch.equal(y, down_k())
    _close(y.float(), down_p().float(), tol)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_kanffn_ci_served_on_card(cuda, precision):
    """kanffn-ci on the card: 1 + 1 kernel launches a prefill and a decode
    step, batched == single token-exact, the simulated cycles a CPU
    engine's."""
    cfg = KANFFN_ARCHS["kanffn-ci"]
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    be = TransformerBackend(cfg, params, device=cuda, precision=precision)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(3, 9)))
               .astype(np.int32) for _ in range(5)]
    before = dict(_build.LAUNCHES)
    eng = Engine(be, n_slots=4, max_len=32)
    rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
    out = eng.run_until_done()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    n = len(prompts) + int(eng.stats["ticks"])
    sfx = "_bf16" if precision == "bf16" else ""
    assert launched == {k: n * int(k in ("kan_fused_v2" + sfx,
                                         "pattern_matmul" + sfx))
                        for k in launched}
    for i, p in enumerate(prompts):
        one = Engine(be, n_slots=4, max_len=32)
        rid = one.submit(p, max_new_tokens=4)
        assert one.run_until_done()[rid] == out[rids[i]]
    cpu = Engine(TransformerBackend(cfg, params, device="cpu",
                                    precision=precision), n_slots=4,
                 max_len=32)
    for p in prompts:
        cpu.submit(p, max_new_tokens=4)
    cpu.run_until_done()
    assert cpu.stats["sim_cycles"] == eng.stats["sim_cycles"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [8, 64])
def test_kan_experts_on_card(cuda, dtype, C):
    """qwen3-moe's KAN experts at their widths (4096 -> 192 -> 4096), a
    few of them: two fused-KAN launches an expert a call, each within its
    tolerance of its plain version on the same input.  A bf16 draw's
    experts hold f32 rows (f32 ``t``): the mixed kernel."""
    from repro_torch.kernels.kan_fused.ref import kan_fused_v2_ref
    from repro_torch.models.moe import KanExperts, MoEConfig, moe_init

    dt = getattr(torch, dtype)
    cfg = MoEConfig(d_model=4096, d_ff=1536, n_experts=3, top_k=2,
                    ffn_kind="kan")
    params = moe_init(torch.Generator(device=cuda).manual_seed(0), cfg, dt)
    ex = KanExperts(cfg, params["experts"])
    assert ex.wt_up.shape[1:] == (4096 * 8, 192)
    h = torch.randn((3, C, 4096), generator=torch.Generator(
        device=cuda).manual_seed(C), device=cuda).to(dt)
    kan = "kan_fused_v2_mixed" if dt == BF else "kan_fused_v2"
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        y = ex(h)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    assert launched == {k: 6 * int(k == kan) for k in launched}
    tol = 2.0 ** -8 if dt == BF else TOL
    for e in range(3):
        mid = kan_fused_v2(h[e], ex.wt_up[e], ex.spec, ex.kb, ex.slot_of)
        _close(mid.float(), kan_fused_v2_ref(h[e], ex.wt_up[e], ex.spec,
                                             ex.kb).float(), tol)
        _close(y[e].float(), kan_fused_v2_ref(mid, ex.wt_down[e], ex.spec,
                                              ex.kb).float(), tol)
        assert torch.equal(y[e], kan_fused_v2(mid, ex.wt_down[e], ex.spec,
                                              ex.kb, ex.slot_of))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["whisper-medium", "paligemma-3b"])
def test_kan_drop_in_serve_steps_on_card(cuda, name, dtype):
    """The reference's KAN drop-in (``ffn_kind="kan"``), reduced, through
    ``launch/steps`` on the card: two fused-KAN launches an FFN (whisper's
    encoder too) a prefill and a decode step, and the card's logits
    within the launches in series of the CPU's (each one launch's
    tolerance: 1e-5 at f32, a bf16 ulp, of 1 + max|cpu|)."""
    from repro_torch.configs.registry import ARCHS as ZOO
    from repro_torch.launch import steps as TS
    from repro_torch.utils import tree_map

    dt = getattr(torch, dtype)
    cfg = dataclasses.replace(ZOO[name].reduce(), ffn_kind="kan",
                              pattern_rate=0.5, dtype=dtype)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    on_card = tree_map(lambda a: a.to(cuda), params)
    stub = (0.1 * torch.randn((2, cfg.n_frontend_tokens, cfg.d_model),
                              generator=torch.Generator().manual_seed(1)))
    kw = {"frames" if cfg.enc_dec else "patches": stub.to(dt)}
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32))
    n_enc = cfg.n_enc_layers if cfg.enc_dec else 0
    in_series = 2 * (cfg.n_layers + n_enc)
    tol = in_series * (BF16_ULP if dt == BF else TOL)
    ffns = TT.ffn_modules(on_card, cfg)
    enc = TT.encoder_ffn_modules(on_card, cfg) if cfg.enc_dec else None
    # a bf16 draw's KAN rows are f32 (the reference's f32 t): mixed kernel
    kname = "kan_fused_v2" + ("_mixed" if dt == BF else "")
    before = dict(_build.LAUNCHES)
    tok, caches = TS.make_prefill_step(cfg, ffns=ffns, enc_ffns=enc)(
        on_card, {"tokens": toks.to(cuda),
                  **{k: v.to(cuda) for k, v in kw.items()}})
    dec = TS.make_decode_step(cfg, ffns=ffns)
    for _ in range(2):
        tok, caches = dec(on_card, {"token": tok, "caches": caches})
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    want = 2 * (cfg.n_layers + n_enc) + 2 * 2 * cfg.n_layers
    assert launched == {k: want * int(k == kname) for k in launched}
    with torch.no_grad():
        lc, cc = TT.prefill(params, cfg, toks, **kw)
        lg, cg = TT.prefill(on_card, cfg, toks.to(cuda), ffns=ffns,
                            enc_ffns=enc,
                            **{k: v.to(cuda) for k, v in kw.items()})
        _close(lg.float().cpu(), lc.float(), tol)
        step = TT.greedy_token(lc)
        lc, _ = TT.decode_step(params, cfg, step, cc)
        lg, _ = TT.decode_step(on_card, cfg, step.to(cuda), cg, ffns=ffns)
        _close(lg.float().cpu(), lc.float(), tol)


# ------------------------------------------------------------ LM training
# The bf16 KAN gradient (the bf16 fused-KAN kernel forward; the
# spline-basis kernel's bases for d wt, the de Boor recursion reversed
# in bf16 torch ops for dx) on the card against the same layer on the
# CPU, in units of 2**-8 * (1 + max|cpu|), which is half an ulp of the
# largest entries: the products' f32 sums run in other orders, so a
# rounded product may land an ulp apart (d wt: 2 units), and dx adds
# two branches that each carry such an ulp of g wt^T (4 units; 2.56
# measured at 256 x 608 -> 896 on an H100).
LM_GRAD_ULPS = {"y": 1, "dx": 4, "dwt": 2}
LM_STEP_GRAD_ULPS = 4


@pytest.mark.parametrize("B,n_in,n_out", [(64, 96, 40), (256, 896, 608),
                                          (256, 608, 896)])
def test_bf16_kan_grad_on_card_matches_cpu(cuda, B, n_in, n_out):
    spec = SplineSpec(4, 3)
    kb = (0, 2, 4, 5, 6)
    gen = torch.Generator().manual_seed(n_in)
    x = torch.randn((B, n_in), generator=gen)
    x[0, :4] = torch.tensor([spec.x0, 1.0, 1.5, -1.5])
    x = x.to(BF)
    wt = (torch.randn((n_in * (len(kb) + 1), n_out), generator=gen)
          * 0.05).to(BF)
    g = torch.randn((B, n_out), generator=gen).to(BF)
    out = {}
    for dev in ("cpu", cuda):
        xd = x.to(dev).clone().requires_grad_(True)
        wd = wt.to(dev).clone().requires_grad_(True)
        before = dict(_build.LAUNCHES)
        y = kan_fused_v2(xd, wd, spec, kb)
        y.backward(g.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                        if v != before[k]}
            assert launched == {"kan_fused_v2_bf16": 1,
                                "spline_basis_bf16": 1}
        out[str(dev)] = (y.detach().cpu(), xd.grad.cpu(), wd.grad.cpu())
    for got, ref, name in zip(out["cuda"], out["cpu"], ("y", "dx", "dwt")):
        assert got.dtype == BF, name
        err = float((got.float() - ref.float()).abs().max())
        scale = 1.0 + float(ref.float().abs().max())
        print(f"{name}: {err / scale / BF16_ULP:.3f} units of 2**-8 (1+max)")
        _close(got.float(), ref.float(), LM_GRAD_ULPS[name] * BF16_ULP)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lm_train_step_on_card(cuda, dtype):
    """One ``make_train_step`` of the reduced qwen2-0.5b with the KAN
    drop-in on the card: its launches (a fused-KAN launch a KAN layer
    forward -- at bf16 the mixed kernel, the params holding the
    reference's f32 ``t`` -- a spline-basis launch a KAN layer for d wt,
    and at f32 one more for dx), and its loss and gradients against the
    same step on the CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps as TS
    from repro_torch.utils import tree_map

    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduce(),
                              ffn_kind="kan", pattern_rate=0.5, dtype=dtype)
    opts = TS.StepOptions(lr=1e-2, total_steps=2, warmup=0)
    state = TS.init_train_state(cfg, opts, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 33)).astype(np.int32))
    seen = {}
    orig = TS.adamw_update

    def adamw(grads, *a, **k):
        seen[grads["embed"]["table"].device.type] = grads
        return orig(grads, *a, **k)

    TS.adamw_update = adamw
    try:
        cpu_state, cpu_m = TS.make_train_step(cfg, opts)(state,
                                                         {"tokens": toks})
        on_card = tree_map(lambda a: a.to(cuda), state)
        before = dict(_build.LAUNCHES)
        new, m = TS.make_train_step(cfg, opts)(on_card,
                                               {"tokens": toks.to(cuda)})
        torch.cuda.synchronize()
    finally:
        TS.adamw_update = orig
    launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                if v != before[k]}
    n = 2 * cfg.n_layers
    suffix = "_bf16" if dtype == "bfloat16" else ""
    kan = "kan_fused_v2" + ("_mixed" if suffix else "")
    assert launched == {kan: n,
                        "spline_basis" + suffix: n * (1 if suffix else 2)}
    assert int(new["step"]) == 1
    rtol = 1e-3 if suffix else 1e-5
    assert abs(float(m["loss"]) - float(cpu_m["loss"])) <= rtol * float(
        cpu_m["loss"])
    tol = LM_STEP_GRAD_ULPS * BF16_ULP if suffix else 1e-4
    got, ref = dict(leaf_paths(seen["cuda"])), dict(leaf_paths(seen["cpu"]))
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        _close(got[k].float().cpu(), ref[k].float(), tol)


# ---------------------------------------------------------------------------
# The VIKIN array plans (runtime/sharded) on logical chips of one card.
# ---------------------------------------------------------------------------

from repro_torch.launch.mesh import require_devices  # noqa: E402
from repro_torch.launch.serve import make_vikin_backend  # noqa: E402
from repro_torch.runtime.sharded import ShardedVikinBackend  # noqa: E402

ARRAY_KERNELS = {"f32": ("kan_fused_v2", "pattern_matmul"),
                 "bf16": ("kan_fused_v2_bf16", "pattern_matmul_bf16"),
                 "int8": ("kan_fused_v2_q8", "pattern_matmul_q8")}


@pytest.mark.parametrize("plan,n_chips,precision", [
    ("data", 4, "f32"), ("data", 4, "bf16"), ("data", 4, "int8"),
    ("pipeline", 3, "f32"), ("pipeline", 3, "bf16"),
    ("hetero", 4, "f32"), ("hetero", 4, "bf16")])
def test_array_plans_on_the_card_are_bitwise_single(cuda, plan, n_chips,
                                                    precision):
    """Every plan over logical chips of one card serves bitwise the
    single-device answers, one launch a layer a shard (data) or a tick
    (staged), from one stack per distinct device."""
    model = VIKIN_ARCHS["vikin-mixed"]
    rng = np.random.default_rng(3)
    xs = [rng.random(model.sizes[0], dtype=np.float32) for _ in range(21)]

    def serve(backend):
        eng = Engine(backend, n_slots=8)
        rids = [eng.submit(x) for x in xs]
        before = dict(_build.LAUNCHES)
        out = eng.run_until_done()
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in _build.LAUNCHES.items()
               if v != before[k]}
        return np.stack([out[r] for r in rids]), eng.stats, got

    y1, _, _ = serve(make_vikin_backend(model, "cuda", precision=precision))
    be = make_vikin_backend(model, "cuda", precision=precision,
                            devices=["cuda:0"] * n_chips, plan=plan)
    yn, s, got = serve(be)
    assert np.array_equal(y1, yn)
    shards = n_chips if plan == "data" else 1
    kan_k, mm_k = ARRAY_KERNELS[precision]
    assert got == {kan_k: shards * int(s["ticks"]),
                   mm_k: 2 * shards * int(s["ticks"])}
    assert len(be.stacks()) == (1 if plan == "data" else len(be._stages))


def test_array_refuses_more_cards_than_visible(cuda):
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="visible"):
        require_devices(n)
    model = VIKIN_ARCHS["vikin-small"]
    params = vikin_stack_init(model, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="logical chips on one card"):
        ShardedVikinBackend(model, params, devices=n)
    assert require_devices(["cuda:0"] * n) == [torch.device("cuda:0")] * n


# ---------------------------------------------------------------------------
# The process mesh on the card: 2 ranks share cuda:0 over gloo
# ---------------------------------------------------------------------------

MESH_WORKER = r'''
import os, sys, json
import numpy as np, torch
from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build
from repro_torch.launch import mesh as M, steps as ST
from repro_torch.models import transformer as T
from repro_torch.models.moe import MoEConfig, moe_apply, local_experts
import dataclasses

mode, shape, out = sys.argv[1:4]
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda:0")
mesh = M.init_from_env(M.parse_mesh(shape), device=dev)
res = {"backend": mesh.backend}
if mode == "ep":
    rng = np.random.default_rng(0)
    f = lambda *s: torch.as_tensor(
        (rng.standard_normal(s) * 0.25).astype(np.float32), device=dev)
    cfg = MoEConfig(d_model=64, d_ff=128, n_experts=8, top_k=2)
    x, router = f(2, 16, 64), f(64, 8)
    ex = {"gate": f(8, 64, 128), "up": f(8, 64, 128), "down": f(8, 128, 64)}
    params = {"router": {"kernel": router}, "experts": ex}
    one = moe_apply(params, x, cfg)["out"]
    with M.set_mesh(mesh):
        ep = moe_apply(params, x, cfg)["out"]
    err = float((ep - one).abs().max())
    res["err"], res["scale"] = err, float(one.abs().max())
elif mode == "tp":
    # tensor parallelism over 2 model ranks, both activation modes,
    # against one process
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduce(),
                              ffn_kind="kan", pattern_rate=0.5,
                              dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 17)).astype(np.int32), device=dev)
    one = ST.make_train_step(cfg, ST.StepOptions(lr=1e-3, warmup=0))(
        ST.init_train_state(cfg, ST.StepOptions(), params=params),
        {"tokens": tokens})[1]
    res["loss1"] = float(one["loss"])
    for am in ("replicated", "sp"):
        opts = ST.StepOptions(lr=1e-3, warmup=0, activation_mode=am)
        step = ST.make_train_step(cfg, opts, mesh)
        state = ST.init_train_state(cfg, opts, params=params, mesh=mesh)
        batch = ST.local_batch({"tokens": tokens}, mesh)
        before = dict(_build.LAUNCHES)
        s, m = step(state, batch)
        launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                    if v != before[k]}
        s2, m2 = step(state, batch)
        res[am] = {"loss": float(m["loss"]), "n_tp": len(step.tp),
                   "bitwise": float(m["loss"]) == float(m2["loss"]),
                   "launches": launched}
else:
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduce(),
                              ffn_kind="kan", pattern_rate=0.5)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opts = ST.StepOptions(lr=1e-3, total_steps=10, warmup=0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 17)).astype(np.int32), device=dev)
    step = ST.make_train_step(cfg, opts, mesh)
    state = ST.init_train_state(cfg, opts, params=params, mesh=mesh)
    batch = ST.local_batch({"tokens": tokens}, mesh)
    before = dict(_build.LAUNCHES)
    s, m = step(state, batch)
    res["launches"] = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                       if v != before[k]}
    with ST.deterministic(dev):
        g = step.gather_grads(step.grads(state, batch)[2])
        g1 = ST.value_and_grad(cfg, opts, params, {"tokens": tokens})[2]
    whole = ST.gather_state(s, cfg, mesh)["params"]
    s1, m1 = ST.make_train_step(cfg, opts)(
        ST.init_train_state(cfg, opts, params=params), {"tokens": tokens})
    from repro_torch.utils import leaf_paths
    res["loss"], res["loss1"] = float(m["loss"]), float(m1["loss"])
    res["grad_err"] = [
        (float((a - b).abs().max()), float(b.abs().max()))
        for (_, a), (_, b) in zip(leaf_paths(g), leaf_paths(g1))]
    res["param_err"] = max(
        float((a.float() - b.float()).abs().max())
        for (_, a), (_, b) in zip(leaf_paths(whole),
                                  leaf_paths(s1["params"])))
    res["moved"] = max(
        float((a.float() - b.float()).abs().max())
        for (_, a), (_, b) in zip(leaf_paths(whole), leaf_paths(params)))
if mesh.rank == 0:
    json.dump(res, open(out, "w"))
M.destroy_process_mesh(mesh)
'''


def _mesh_run(tmp_path, mode, shape):
    from repro_torch.launch.mesh import spawn_ranks
    out = tmp_path / f"{mode}.json"
    src = str(Path(__file__).resolve().parents[1] / "src")
    spawn_ranks(["-c", MESH_WORKER, mode, shape, str(out)], 2,
                str(tmp_path / f"rv_{mode}"), timeout_s=300,
                env={"PYTHONPATH": src, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    return json.loads(out.read_text())


def test_mesh_expert_parallel_layer_on_the_card(cuda, tmp_path):
    """A SwiGLU MoE layer over 2 expert ranks on cuda:0 (gloo) against
    the 1-device layer."""
    res = _mesh_run(tmp_path, "ep", "1x2")
    assert res["backend"] == "gloo"
    assert res["err"] <= TOL * (1 + res["scale"])


def test_mesh_tensor_parallel_step_on_the_card(cuda, tmp_path):
    """One step of the reduced qwen2-0.5b with the KAN drop-in at bf16
    (its t f32) over 2 model ranks on cuda:0 (gloo), tensor-parallel in
    both activation modes: the loss within the phase-15 bound of one
    process's, two steps from one state bitwise, two launches a KAN
    layer (the mixed kernel, kan_down's partial in f32, and the bf16
    spline basis)."""
    res = _mesh_run(tmp_path, "tp", "1x2")
    assert res["backend"] == "gloo"
    for am in ("replicated", "sp"):
        r = res[am]
        assert r["n_tp"] > 0 and r["bitwise"], am
        assert abs(r["loss"] - res["loss1"]) <= 1e-3 * (1 + abs(res["loss1"]))
        assert r["launches"] == {"kan_fused_v2_mixed": 4,
                                 "spline_basis_bf16": 4}, r["launches"]


def test_xlstm_train_steps_on_the_card_are_deterministic(cuda):
    """Two train steps of the reduced xlstm-125m on the card under the
    train step's deterministic mode (the chunkwise mLSTM's scan is the
    f64 triangular product, ``xlstm.inclusive_scan``), twice: finite
    losses, the two runs bitwise, and the first loss within 1e-4 of the
    same step on the CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps as TS

    cfg = get_config("xlstm-125m").reduce()
    opts = TS.StepOptions(lr=1e-3, total_steps=4, warmup=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32))
    runs = []
    for dev in ("cuda", "cuda", "cpu"):
        state = TS.init_train_state(cfg, opts, torch.Generator().manual_seed(0),
                                    dev)
        step, losses = TS.make_train_step(cfg, opts), []
        for _ in range(2):
            state, m = step(state, {"tokens": toks.to(dev)})
            losses.append(float(m["loss"]))
        runs.append((losses, [a.cpu() for _, a in leaf_paths(state)]))
    (l1, s1), (l2, s2), (lc, _) = runs
    assert all(np.isfinite(l1)) and l1 == l2
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert abs(l1[0] - lc[0]) <= 1e-4 * (1 + abs(lc[0]))


def test_mesh_data_parallel_step_on_the_card(cuda, tmp_path):
    """One step of the reduced qwen2-0.5b with the KAN drop-in over 2
    data ranks on cuda:0 (gloo) against one process, at lr 1e-3 with no
    warmup: the loss within 1e-5, the mean gradient within 1e-5 * (1 +
    max|g|) leaf by leaf, the params within a tenth of the lr (and moved
    past half of it), and each rank's step through the fused-KAN and
    spline-basis kernels."""
    res = _mesh_run(tmp_path, "dp", "2x1")
    assert res["backend"] == "gloo"
    assert abs(res["loss"] - res["loss1"]) <= 1e-5 * (1 + abs(res["loss1"]))
    for err, scale in res["grad_err"]:
        assert err <= TOL * (1 + scale), (err, scale)
    assert res["moved"] > 0.5e-3
    assert res["param_err"] < 1e-4
    assert res["launches"].get("kan_fused_v2", 0) > 0
    assert res["launches"].get("spline_basis", 0) > 0
