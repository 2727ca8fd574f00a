"""Port parity: the dtypes a bf16 model's params are drawn in, and the
layer the reference runs on them, against the JAX package.

The reference's ``kan_init`` scales a bf16 draw by ``0.1 * scale_b``, a
numpy float64, which JAX (without x64) takes as f32: the spline
coefficients ``t`` of a bf16 model are f32, its fused ``[w_b ; t]`` rows
f32, and ``_kan_linear_jnp`` contracts the bf16 activations against them
in a promoted f32 product.  The port draws the same dtypes
(``core/kan.kan_init``), and ``kan_fused_v2`` takes a bf16 x against an
f32 ``wt`` (the plain version here, the mixed kernel on the card).
Also: the bf16 spline basis's plain version bitwise the reference's jnp
bases on every finite bf16 input around the grid, and the knob rules of
the kernels moved onto the tensor-core body (bf16 version 1, and the
mixed kernel with its f32 rows split into bf16 planes) against their
candidates.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import ARCHS as J_ZOO  # noqa: E402
from repro.core import kan as jkan  # noqa: E402
from repro.core import splines as jsl  # noqa: E402
from repro.kernels.kan_fused import ops as jkf  # noqa: E402
from repro.kernels.spline_basis import ops as jsb  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs.registry import ARCHS as T_ZOO  # noqa: E402
from repro_torch.core import kan as tkan  # noqa: E402
from repro_torch.core import splines as tsl  # noqa: E402
from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels.kan_fused import ops as tkf  # noqa: E402
from repro_torch.kernels.spline_basis.ref import (  # noqa: E402
    spline_basis_plain,
)
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.utils import leaf_paths  # noqa: E402

BF16_ULP = 2.0 ** -8
KAN = {"ffn_kind": "kan", "pattern_rate": 0.5}


def _variants():
    """(arch, overrides) of every zoo arch reduced at bf16: as registered
    (the KAN-FFN archs' ``"kan"`` layers among them) and, where the arch
    has an FFN, with the KAN drop-in (KAN experts in a MoE arch)."""
    out = []
    for arch in sorted(T_ZOO):
        out.append((arch, "registered"))
        if T_ZOO[arch].d_ff > 0 and T_ZOO[arch].ffn_kinds is None:
            out.append((arch, "kan"))
    return out


def _dtypes(tree):
    """[(path, dtype name)] of a reference or port tree."""
    return [(p, str(a.dtype).split(".")[-1]) for p, a in leaf_paths(tree)]


@pytest.mark.parametrize("arch,variant", _variants())
def test_bf16_init_leaf_dtypes_equal_the_reference(arch, variant):
    over = dict(dtype="bfloat16", **(KAN if variant == "kan" else {}))
    tcfg = dataclasses.replace(T_ZOO[arch].reduce(), **over)
    jcfg = dataclasses.replace(J_ZOO[arch].reduce(), **over)
    got = _dtypes(TT.init_params(tcfg, torch.Generator().manual_seed(0)))
    want = _dtypes(JT.param_shapes(jcfg))
    assert got == want
    # every spline coefficient is f32, and a KAN drop-in has some
    ts = [dt for path, dt in got if path.endswith("['t']")]
    assert all(dt == "float32" for dt in ts)
    assert ts or variant == "registered"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kan_init_draws_t_in_f32(dtype):
    cfg = tkan.KANConfig(64, 32)
    p = tkan.kan_init(cfg, torch.Generator().manual_seed(0), dtype)
    assert p["w_b"].dtype == dtype and p["t"].dtype == torch.float32
    j = jkan.kan_init(__import__("jax").random.PRNGKey(0),
                      jkan.KANConfig(64, 32),
                      jnp.bfloat16 if dtype == torch.bfloat16
                      else jnp.float32)
    assert str(j["t"].dtype) == "float32"
    assert abs(float(p["t"].std()) - 0.1 / 8) < 0.1 / 8 * 0.1


def _mixed_inputs(seed, B, n_in, n_out, n_bases):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, n_in)) * 1.5).astype(np.float32)
    w_b = rng.uniform(-0.3, 0.3, (n_in, n_out)).astype(np.float32)
    t = (rng.standard_normal((n_in, n_bases, n_out)) * 0.05).astype(
        np.float32)
    # x and w_b in bf16 (a bf16 model's), t in f32 (its spline rows)
    return (x.astype(jnp.bfloat16).astype(np.float32),
            w_b.astype(jnp.bfloat16).astype(np.float32), t)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("G,K,kb", [(4, 3, (0, 2, 4, 5, 6)),
                                    (16, 4, None)],
                         ids=["drop-in", "G16K4"])
@pytest.mark.parametrize("B,n_in,n_out", [(2, 24, 12), (33, 45, 13),
                                          (64, 96, 40)])
def test_mixed_layer_matches_the_reference_jnp(G, K, kb, B, n_in, n_out):
    """A bf16 x against a bf16 w_b and an f32 t_flat: bf16 out within one
    bf16 ulp of the reference's jnp layer (two f32 sums in other orders
    may round apart), f32 out within 1e-5, both of 1 + max|ref|."""
    js, ts = jsl.SplineSpec(G, K), tsl.SplineSpec(G, K)
    x, w_b, t = _mixed_inputs(B * n_in, B, n_in, n_out, ts.n_bases)
    jt_flat = jkf.flatten_t(jnp.asarray(t), kb)
    tt_flat = tkf.flatten_t(torch.from_numpy(t), kb)
    kbt = tuple(range(ts.n_bases)) if kb is None else kb
    wt = tkf.fuse_wt(_bf16(w_b), tt_flat, len(kbt))
    assert wt.dtype == torch.float32
    before = dict(_build.LAUNCHES)
    for out_dtype, jout, tol in ((None, None, BF16_ULP),
                                 (torch.float32, jnp.float32, 1e-5)):
        ref = np.asarray(jkf.kan_linear(
            jnp.asarray(x).astype(jnp.bfloat16),
            jnp.asarray(w_b).astype(jnp.bfloat16), jt_flat, js, kb,
            impl="jnp", out_dtype=jout), np.float32)
        got = tkf.kan_fused_v2(_bf16(x), wt, ts, kbt, out_dtype=out_dtype)
        assert got.dtype == (out_dtype or torch.bfloat16)
        got = got.float().numpy()
        err = float(np.abs(got - ref).max())
        assert err <= tol * (1.0 + float(np.abs(ref).max())), err
        # the layer's functional form fuses the same way
        lin = tkf.kan_linear(_bf16(x), _bf16(w_b), tt_flat, ts, kb,
                             out_dtype=out_dtype)
        assert np.array_equal(lin.float().numpy(), got)
    assert dict(_build.LAUNCHES) == before


def test_a_bf16_kan_layer_holds_f32_fused_rows():
    """``KANLayer`` on a bf16 model's params fuses to f32 rows and runs
    the mixed layer: its output is the functional form's."""
    cfg = tkan.KANConfig(40, 24, basis_keep=(0, 2, 4, 5, 6))
    p = tkan.kan_init(cfg, torch.Generator().manual_seed(3),
                      torch.bfloat16)
    layer = tkan.KANLayer(cfg, p)
    assert layer.wt.dtype == torch.float32
    x = (torch.randn((5, 40), generator=torch.Generator().manual_seed(4))
         * 1.5).to(torch.bfloat16)
    y = layer(x)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, tkan.kan_apply(p, x, cfg))


@pytest.mark.parametrize("G,K", [(g, k) for g in tsl.VALID_G
                                 for k in tsl.VALID_K])
def test_bf16_plain_basis_bitwise_on_every_bf16_input(G, K):
    """Every finite bf16 value in [x0 - 2, x1 + 2], through the port's
    plain version and the reference's jnp bases: bitwise (both round
    every op of the recursion to bf16)."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    vals = (bits << 16).view(np.float32)
    ts, js = tsl.SplineSpec(G, K), jsl.SplineSpec(G, K)
    keep = (np.isfinite(vals) & (vals >= ts.x0 - 2.0)
            & (vals <= ts.x1 + 2.0))
    x = torch.from_numpy(bits[keep].astype(np.int16)).view(torch.bfloat16)
    got = spline_basis_plain(x, ts).view(torch.int16).numpy()
    ref = np.asarray(jsb.spline_basis(
        jnp.asarray(vals[keep]).astype(jnp.bfloat16), js, impl="jnp"))
    assert int(keep.sum()) > 30000
    np.testing.assert_array_equal(got, ref.view(np.int16))


@pytest.mark.parametrize("B,n_in,n_out,nbk", [
    (1, 1, 1, 1), (8, 304, 32, 5), (8, 72, 96, 5), (16, 37, 13, 20),
    (8192, 304, 32, 5), (1024, 896, 608, 5), (1024, 608, 896, 5),
    (300, 300, 33, 2), (64, 1000, 200, 20), (4, 64, 8, 0)])
def test_bf16_v1_knob_rules_match_the_candidates(B, n_in, n_out, nbk):
    """bf16 version 1 runs the tensor-core body: the v2 bf16 tile limit
    (bm * bn up to 8192, not the f32 v1 kernel's 4096), 256 threads at a
    full tile, two partial sets a cluster member; its grid is the bf16
    v2 grid less the knobs whose second partial set does not fit, and
    its default is one of them."""
    bf = torch.bfloat16
    cands = autotune.candidates_kan_fused(B, n_in, n_out, nbk, bf, 1)
    v2 = autotune.candidates_kan_fused(B, n_in, n_out, nbk, bf, 2)
    assert cands and all(c in v2 for c in cands)
    for c in v2:
        bm, bi, bn = c["bm"], c["bi"], c["bn"]
        nsplit = tkf.split(n_in, bi)[2]
        smem1 = tkf.kernel_smem(bm, bi, bn, n_in, nbk, bf, 1)
        smem2 = tkf.kernel_smem(bm, bi, bn, n_in, nbk, bf, 2)
        cpb = tkf.split(n_in, bi)[1]
        assert smem1 - smem2 == (4 * cpb * max(16, bm) * bn
                                 if nsplit > 1 else 0)
        fits = smem1 <= autotune.MAX_SMEM_BYTES and not (
            nsplit > tkf.PORTABLE_SPLIT
            and 2 * smem1 > autotune.MAX_SMEM_BYTES)
        assert (c in cands) == fits, c
        if fits:
            tkf.check_blocks(c, n_in, n_out, nbk, bf, 1)
            threads = tkf.kernel_threads(bm, bn, bf, 1)
            assert threads == (256 if max(16, bm) * bn == 8192 else
                               tkf.kernel_threads(bm, bn, bf, 2))
    default = tkf.default_blocks(B, n_in, n_out, nbk, bf, 1)
    assert default in cands
    assert tkf.max_tile(1, bf) == tkf.max_tile(2, bf) == 8192
    assert tkf.max_tile(1) == 4096
    if B >= 64 and n_out >= 128 and nbk <= 5:     # a full tile fits
        assert any(c["bm"] * c["bn"] == 8192 for c in cands)


@pytest.mark.parametrize("B,n_in,n_out,nbk", [
    (8, 304, 32, 5), (1024, 896, 608, 5), (1024, 608, 896, 5),
    (77, 37, 13, 20), (4, 64, 8, 0)])
def test_mixed_knob_rules_are_the_cuda_core_bodys(B, n_in, n_out, nbk):
    """The mixed kernel, once on the CUDA-core body, now takes the
    tensor-core body's rules (kan_mma.cuh with f32 rows): the bf16
    kernel's tiles and threads (256 at a full 8192 tile), its shared
    memory an f32 row buffer a stage in place of the raw bf16 rows, and
    one plane tile and one A tile in place of `stages` A tiles; a default
    among the candidates."""
    bf, f32 = torch.bfloat16, torch.float32
    cands = autotune.candidates_kan_fused(B, n_in, n_out, nbk, bf, 2, f32)
    assert cands
    rows = tkf.PC * (nbk + 1)
    for c in cands:
        bm, bi, bn = c["bm"], c["bi"], c["bn"]
        tkf.check_blocks(c, n_in, n_out, nbk, bf, wt_dtype=f32)
        full = max(16, bm) * bn == tkf.MAX_TILE
        assert tkf.kernel_threads(bm, bn, bf, 2, f32) == \
            (256 if full else tkf.kernel_threads(bm, bn, bf))
        stages = 2 if tkf.split(n_in, bi)[1] > 1 else 1
        planes = 3 * bn + (0 if bn == 8 else 8)
        raw = bn + (16 if bn == 8 else 8)
        a_tile = 2 * max(16, bm) * (rows + 8)
        assert tkf.kernel_smem(bm, bi, bn, n_in, nbk, bf, 2, f32) - \
            tkf.kernel_smem(bm, bi, bn, n_in, nbk, bf) == \
            stages * (4 * rows * bn - 2 * rows * raw - a_tile) \
            + 2 * rows * planes + a_tile
    default = tkf.default_blocks(B, n_in, n_out, nbk, bf, 2, f32)
    assert default in cands


def test_mixed_knobs_cache_under_their_own_kernel(tmp_path, monkeypatch):
    """A knob stored for the mixed kernel is its own: the bf16 kernel's
    entry of the same shape does not answer for it, nor it for that."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "cache.json"))
    autotune.reset_cache()
    try:
        dims = (1024, 896, 608, 5)
        bf, f32 = torch.bfloat16, torch.float32
        # a knob the tensor-core body takes (bi 64 would split the
        # features over 14 blocks, two of which an SM cannot hold)
        hit = {"bm": 16, "bi": 128, "bn": 32}
        autotune.get_cache().store(autotune.cache_key(
            "kan_fused_v2_mixed", dims, bf, "cpu"), hit)
        assert tkf.resolve_blocks(*dims, bf, device="cpu",
                                  wt_dtype=f32) == hit
        assert tkf.resolve_blocks(*dims, bf, device="cpu") == \
            tkf.default_blocks(*dims, bf)
        assert tkf.cache_kernel(2, bf, f32) == "kan_fused_v2_mixed"
        assert tkf.cache_kernel(2, bf, bf) == "kan_fused_v2"
        assert tkf.cache_kernel(1, bf) == "kan_fused_v1"
    finally:
        autotune.reset_cache()
