"""The port's CUDA kernels on the card, each against its plain version.

These need an NVIDIA GPU (and ``nvcc`` to build the kernels); elsewhere
they skip.  Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance ``1e-5 * (1 + max|plain|)``: kernel and plain version sum in
different orders (and the kernel's FMAs round once where the plain
matmul may round twice).  The int8 matmul is held bitwise: its
accumulator is an exact integer in both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.vikin_models import VIKIN_ARCHS  # noqa: E402
from repro_torch.core.sparsity import (  # noqa: E402
    sparsity_to_pattern,
    tiled_mask,
)
from repro_torch.core.splines import SplineSpec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.kan_fused.ops import (  # noqa: E402
    kan_fused_v2,
    kan_fused_v2_q8,
    slot_table,
)
from repro_torch.kernels.kan_fused.ref import (  # noqa: E402
    kan_fused_v2_q8_ref,
    kan_fused_v2_ref,
)
from repro_torch.kernels.pattern_matmul.ops import (  # noqa: E402
    matmul_compact,
    matmul_q8,
)
from repro_torch.kernels.pattern_matmul.ref import (  # noqa: E402
    matmul_compact_ref,
    matmul_q8_ref,
)
from repro_torch.models.ffn import vikin_stack_init  # noqa: E402
from repro_torch.runtime.backends import VikinBackend  # noqa: E402

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
    assert moved == {"kan_fused_v2": 0, "pattern_matmul": 0,
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
