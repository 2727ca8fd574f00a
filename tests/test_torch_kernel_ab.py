"""CPU tests of ``repro_torch.benchmarks.kernel_ab``: the per-layer kernel
calls ``chip_smoke.py`` and the parent/change A/B share, the output
comparison, and the swap of each side's knob rules.  The kernels' plain
versions run here (CPU tensors); the A/B itself needs the card."""
import numpy as np
import pytest
import torch

from repro_torch.benchmarks import kernel_ab
from repro_torch.configs.vikin_models import VIKIN_ARCHS
from repro_torch.kernels import autotune
from repro_torch.kernels.epilogue import scale_bias_act
from repro_torch.kernels.kan_fused import ops as kan_ops
from repro_torch.kernels.pattern_matmul import ops as pm_ops
from repro_torch.launch.serve import make_vikin_backend

BF, F32 = torch.bfloat16, torch.float32
LAYER_KERNELS = {
    "f32": ["pattern_matmul", "kan_fused_v2", "pattern_matmul"],
    "bf16": ["pattern_matmul_bf16", "kan_fused_v2_bf16",
             "pattern_matmul_bf16"],
    "int8": ["pattern_matmul_q8", "kan_fused_v2_q8", "pattern_matmul_q8"],
}


@pytest.fixture(autouse=True)
def fresh_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    autotune.reset_cache()
    yield
    autotune.reset_cache()


@pytest.mark.parametrize("dtype", [BF, F32])
def test_compare_reports_bitwise_and_holds_the_tolerance(dtype):
    p = torch.linspace(-2, 2, 64).to(dtype).reshape(8, 8)
    assert kernel_ab.compare("k", "w", p, p.clone()) == {
        "bitwise": True, "max_abs_diff": 0.0}
    # one ulp of the largest value: within the tolerance, not bitwise
    ulp = 2.0 ** -7 if dtype == BF else 2.0 ** -22
    c = p.clone()
    c[0, 0] = (p[0, 0].float() + ulp).to(dtype)
    got = kernel_ab.compare("k", "w", p, c)
    assert got["bitwise"] is False and 0 < got["max_abs_diff"] <= ulp
    tol = kernel_ab.BF16_ULP if dtype == BF else kernel_ab.F32_TOL
    far = p.clone()
    far[1, 1] = (p[1, 1].float() + 2 * tol * 3).to(dtype)   # 3 = 1 + max|p|
    with pytest.raises(AssertionError, match="differ by"):
        kernel_ab.compare("k", "w", p, far)
    # a stack of three layers is held to three tolerances
    assert kernel_ab.compare("k", "w", p, far, layers=3)["bitwise"] is False
    nan = p.clone()
    nan[2, 2] = float("nan")
    with pytest.raises(AssertionError):
        kernel_ab.compare("k", "w", p, nan)
    with pytest.raises(AssertionError, match="parent"):
        kernel_ab.compare("k", "w", p, p[:4])
    with pytest.raises(AssertionError, match="parent"):
        kernel_ab.compare("k", "w", p, p.to(F32 if dtype == BF else BF))


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_stack_calls_chain_to_the_stack(precision):
    """Each layer's call, fed by the calls before it, ends where the
    stack's forward does, bitwise; the names are the kernels the stack
    launches on the card."""
    be = make_vikin_backend(VIKIN_ARCHS["vikin-mixed"], "cpu",
                            precision=precision)
    x = torch.from_numpy(np.random.default_rng(2).random(
        (4, be.n_in), dtype=np.float32)).to(BF if precision == "bf16"
                                            else F32)
    calls = kernel_ab.stack_calls(precision, be.stack, x)
    assert [n for n, _, _ in calls] == LAYER_KERNELS[precision]
    assert all(xin.shape[0] == 4 for _, xin, _ in calls)
    out = calls[-1][2]()
    if precision == "int8":
        last = be.stack.layers[-1]
        out = scale_bias_act(out, last.col_scale, last.b, last.act)
        assert calls[0][1].dtype == torch.int8
    assert torch.equal(out, be.stack(x))


@pytest.mark.parametrize("dtype", [BF, F32])
def test_layer_calls_give_the_plain_version_and_the_output_dtype(dtype):
    be = make_vikin_backend(VIKIN_ARCHS["vikin-mixed"], "cpu",
                            precision="bf16" if dtype == BF else "f32")
    x = torch.from_numpy(np.random.default_rng(1).random(
        (3, be.n_in), dtype=np.float32)).to(dtype)
    for layer in be.stack.layers:
        name, xin, kernel, plain = kernel_ab.layer_calls(layer, x)
        assert name.endswith("_bf16") == (dtype == BF)
        assert torch.equal(kernel(), plain())
        assert kernel(F32).dtype == F32 and kernel().dtype == dtype
        x = kernel()
    names = [n for n, _, _ in kernel_ab.tooling_calls(
        be.stack, torch.zeros(3, be.n_in, dtype=dtype))]
    sfx = "_bf16" if dtype == BF else ""
    assert names == ["kan_fused_v1" + sfx, "spline_basis" + sfx]


def test_a_side_brings_its_knob_rules_and_they_are_put_back():
    rules = kernel_ab.knob_rules(kernel_ab.ROOT)
    # loaded from this tree's sources: the same answers as the modules
    assert rules["pattern_matmul"]["default_blocks"](8192, 72, BF) == \
        pm_ops.default_blocks(8192, 72, BF)
    assert rules["kan_fused"]["default_blocks"](8192, 72, 96, 5, BF) == \
        kan_ops.default_blocks(8192, 72, 96, 5, BF)
    own_pm = pm_ops.resolve_blocks(8192, 72, 304, BF, device="cpu")
    own_kan = kan_ops.resolve_blocks(8192, 72, 96, 5, BF, device="cpu")
    side_pm = {"bm": 32, "bk": 16, "bn": 16}
    side_kan = {"bm": 16, "bi": 32, "bn": 16}
    rules["pattern_matmul"]["default_blocks"] = lambda M, K, dt: side_pm
    rules["kan_fused"]["default_blocks"] = (
        lambda B, i, o, nbk, dt, version=2: side_kan)
    sentinel = object()
    with kernel_ab.use({"entries": {}, "rules": rules}):
        assert kernel_ab._build._entry.__self__ == {}
        assert pm_ops.resolve_blocks(8192, 72, 304, BF,
                                     device="cpu") == side_pm
        assert kan_ops.resolve_blocks(8192, 72, 96, 5, BF,
                                      device="cpu") == side_kan
        autotune.RESOLVED["x"] = sentinel
    assert "x" not in autotune.RESOLVED
    assert kernel_ab._build._entry is not None and not hasattr(
        kernel_ab._build._entry, "__self__")
    assert pm_ops.resolve_blocks(8192, 72, 304, BF, device="cpu") == own_pm
    assert kan_ops.resolve_blocks(8192, 72, 96, 5, BF,
                                  device="cpu") == own_kan
    # a side's knob is what the A/B records for it
    x = torch.zeros(16, 72, dtype=BF)
    w = torch.zeros(72, 304, dtype=BF)
    _, knobs = kernel_ab.knobs_of(
        lambda: pm_ops.matmul_compact(x, w), None)
    assert knobs == []      # the CPU path resolves no knob


def test_mixed_calls_are_the_mixed_kernel_at_its_shapes():
    """The mixed kernel's A/B calls: a bf16 x against f32 fused rows at
    vikin-mixed's KAN layer (8 and 8192 rows) and at the LM train step's
    two KAN layers (M = 1024); on the CPU each is its plain version."""
    f32 = make_vikin_backend(VIKIN_ARCHS["vikin-mixed"], "cpu",
                             precision="f32")
    bf = make_vikin_backend(VIKIN_ARCHS["vikin-mixed"], "cpu",
                            precision="bf16")
    calls = kernel_ab.mixed_calls(f32.stack, bf.stack, f32.n_in, "cpu")
    assert [tuple(xin.shape) for _, xin, _, _ in calls] == [
        (8, 304), (8192, 304), (1024, 896), (1024, 608)]
    for what, xin, kernel, plain in calls:
        assert xin.dtype == BF, what
        y = kernel()
        assert y.dtype == BF and torch.equal(y, plain()), what
