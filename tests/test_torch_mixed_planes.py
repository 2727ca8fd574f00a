"""The mixed KAN kernel's arithmetic and knob rules, on the CPU.

A bf16 x against f32 fused rows (a bf16 model's: its ``t`` is f32, as the
reference's) launches ``kan_fused_v2_mixed`` on the card, which splits
each f32 weight into three bf16 planes and contracts the bf16 activation
tile with each on tensor cores (``csrc/kan_mma.cuh``).  Here:
``split_bf16_planes`` reconstructs every finite weight exactly (its
underflow edge and non-finite weights stated), the three-plane product
(``kan_fused_v2_planes``) against the plain version and the reference's
jnp layer at nbk 5 and 20, the knob rules of the tensor-core body with f32
rows (``kernel_smem``, ``kernel_threads``, ``check_blocks``,
``default_blocks``, the candidates), and a cached knob the body refuses,
which is a miss until it is searched again.  The kernel itself is held on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import splines as jsl  # noqa: E402
from repro.kernels.kan_fused import ops as jkf  # noqa: E402
from repro_torch.core import splines as tsl  # noqa: E402
from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels.kan_fused import ops as tkf  # noqa: E402
from repro_torch.kernels.kan_fused.ref import (  # noqa: E402
    kan_fused_v2_planes,
    kan_fused_v2_ref,
    split_bf16_planes,
)

BF, F32 = torch.bfloat16, torch.float32
BF16_ULP = 2.0 ** -8
TOL = 1e-5
KB = (0, 2, 4, 5, 6)


def _f32(values) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.float32))


def _sum(planes) -> torch.Tensor:
    hi, mid, lo = planes
    return hi.double() + mid.double() + lo.double()


def _weights():
    """Seeded draws at several scales, signed zeros, powers of two, bf16
    rounding ties (a half ulp of bf16 above a bf16 value, odd and even
    mantissas), values near 1e30 and the largest finite f32."""
    rng = np.random.default_rng(0)
    draws = [rng.standard_normal(1 << 14) * s
             for s in (0.05, 1.0, 1e-20, 1e20, 1e-25)]
    pows = [s * 2.0 ** e for e in range(-100, 100, 7) for s in (1, -1)]
    base = rng.standard_normal(512).astype(np.float32).astype(jnp.bfloat16)
    ulp = np.abs(base.astype(np.float32)) * 2.0 ** -8
    ties = base.astype(np.float32) + ulp / 2          # a bf16 half-ulp tie
    big = [1e30, -1e30, 1.0000001e30, 3.4028235e38, -3.4028235e38,
           3.3961e38, 3.39e38]
    return _f32(np.concatenate([np.concatenate(draws), [0.0, -0.0], pows,
                                ties, big]))


def test_planes_reconstruct_every_weight_bitwise():
    w = _weights()
    assert torch.isfinite(w).all()
    planes = split_bf16_planes(w)
    assert all(p.dtype == BF and p.shape == w.shape for p in planes)
    # the sum of the three bf16 values is w, exactly (a -0 sums to +0)
    assert torch.equal(_sum(planes), w.double())
    assert torch.equal(_sum(planes).float().view(torch.int32),
                       torch.where(w == 0, torch.zeros_like(w), w)
                       .view(torch.int32))
    # hi is w rounded toward zero to bf16: never above |w|, never inf
    hi = planes[0].float()
    assert (hi.abs() <= w.abs()).all() and torch.isfinite(hi).all()


def test_planes_underflow_edge():
    """Below about 2^-110, w - hi - mid may need bits under bf16's
    subnormal step 2^-133, which lo drops: the error stays under 2^-133
    a weight.  From 2^-110 up every weight is exact."""
    rng = np.random.default_rng(1)
    mant = 1.0 + rng.integers(0, 1 << 23, 4096) * 2.0 ** -23
    for e in (-110, -105, -100):
        w = _f32(mant * 2.0 ** e)
        assert torch.equal(_sum(split_bf16_planes(w)), w.double()), e
    lost = 0
    for e in (-111, -115, -120, -126, -130, -140, -149):
        w = _f32(mant * 2.0 ** e)
        err = (_sum(split_bf16_planes(w)) - w.double()).abs()
        assert float(err.max()) < 2.0 ** -133, e
        lost += int((err > 0).sum())
    assert lost > 0               # the edge is real: some bits are dropped


def test_non_finite_weights_give_nan_where_the_plain_version_is_not_finite():
    """An inf weight makes mid = inf - inf = NaN, a NaN one NaN planes, so
    the three-plane product is NaN in that column, where the plain
    version's is inf or NaN too."""
    hi, mid, lo = split_bf16_planes(_f32([np.inf, -np.inf, np.nan]))
    assert torch.isinf(hi[:2]).all() and torch.isnan(mid).all()
    assert torch.isnan(lo).all()
    spec = tsl.SplineSpec(4, 3)
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn((6, 9), generator=gen) * 1.5).to(BF)
    wt = torch.randn((9 * (len(KB) + 1), 5), generator=gen) * 0.05
    wt[7, 1], wt[20, 3] = float("inf"), float("nan")
    got = kan_fused_v2_planes(x, wt, spec, KB, F32)
    ref = kan_fused_v2_ref(x, wt, spec, KB, F32)
    bad = ~torch.isfinite(ref)
    assert bad[:, 1].all() and bad[:, 3].all()
    assert torch.isnan(got[bad]).all()
    assert torch.equal(torch.isfinite(got), ~bad)


def _inputs(seed, B, n_in, n_out, nbk):
    """x and w_b of a bf16 model (bf16 values, held in f32) and its f32
    kept-basis rows t_flat (n_in * nbk, n_out)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, n_in)) * 1.5).astype(np.float32)
    w_b = rng.uniform(-0.3, 0.3, (n_in, n_out)).astype(np.float32)
    t_flat = (rng.standard_normal((n_in * nbk, n_out)) * 0.05).astype(
        np.float32)
    return (x.astype(jnp.bfloat16).astype(np.float32),
            w_b.astype(jnp.bfloat16).astype(np.float32), t_flat)


def _fused(w_b, t_flat, nbk):
    """The port's f32 fused rows of a bf16 w_b and an f32 t_flat."""
    return tkf.fuse_wt(torch.from_numpy(w_b).to(BF),
                       torch.from_numpy(t_flat), nbk)


@pytest.mark.parametrize("G,K,kb", [(4, 3, KB), (16, 4, tuple(range(20)))],
                         ids=["nbk5", "nbk20"])
@pytest.mark.parametrize("B,n_in,n_out", [(2, 24, 12), (33, 45, 13),
                                          (64, 256, 96)])
def test_three_plane_product_matches_the_plain_version(G, K, kb, B, n_in,
                                                       n_out):
    """The three planes' f32 products of the bf16 activations, added lo,
    mid, hi, are the plain version's products summed in another order:
    within 1e-5 * (1 + max) of ``kan_fused_v2_ref`` and of the reference's
    jnp layer (bf16 x, f32 fused rows) at f32 out, one bf16 ulp at bf16
    out; the output rounds the f32 total once."""
    ts, js = tsl.SplineSpec(G, K), jsl.SplineSpec(G, K)
    x, w_b, t_flat = _inputs(B * n_in + len(kb), B, n_in, n_out, len(kb))
    xt, wtt = torch.from_numpy(x).to(BF), _fused(w_b, t_flat, len(kb))
    assert wtt.dtype == F32
    before = dict(_build.LAUNCHES)
    got32 = kan_fused_v2_planes(xt, wtt, ts, kb, F32)
    ref32 = kan_fused_v2_ref(xt, wtt, ts, kb, F32)
    jref = np.asarray(jkf.kan_linear(
        jnp.asarray(x).astype(jnp.bfloat16),
        jnp.asarray(w_b).astype(jnp.bfloat16), jnp.asarray(t_flat), js, kb,
        impl="jnp", out_dtype=jnp.float32), np.float32)
    for ref in (ref32.numpy(), jref):
        err = float(np.abs(got32.numpy() - ref).max())
        assert err <= TOL * (1.0 + float(np.abs(ref).max())), err
    got = kan_fused_v2_planes(xt, wtt, ts, kb)
    assert got.dtype == BF and torch.equal(got, got32.to(BF))
    ref = kan_fused_v2_ref(xt, wtt, ts, kb).float()
    err = float((got.float() - ref).abs().max())
    assert err <= BF16_ULP * (1.0 + float(ref.abs().max())), err
    assert dict(_build.LAUNCHES) == before


# (B, n_in, n_out, nbk): vikin-mixed's KAN layer at 8 and 8192, the LM
# train step's two layers, whisper's encoder FFN, ragged and nbk 20 / 0
SHAPES = [(8, 304, 32, 5), (8192, 304, 32, 5), (1024, 896, 608, 5),
          (1024, 608, 896, 5), (12000, 1024, 512, 5), (77, 37, 13, 5),
          (33, 301, 33, 20), (4, 64, 8, 0)]


def _smem(bm, bi, bn, n_in, nbk):
    """kan_mma.cuh's smem_bytes with f32 rows: the slot table, a cluster
    member's f32 partials, per stage an f32 row buffer and the bf16 x
    rows (40), and one plane tile (hi | mid | lo, 3 bn + 8 a row, 3 bn at
    bn = 8) and one A tile (max(16, bm) rows of 32 (nbk + 1) + 8)."""
    nchunks = -(-n_in // 32)
    cpb = max(1, nchunks) if bi >= n_in else bi // 32
    nsplit = -(-nchunks // cpb)
    rows, arows = 32 * (nbk + 1), max(16, bm)
    stage = 4 * rows * bn + 2 * bm * 40
    single = (2 * rows * (3 * bn + (0 if bn == 8 else 8))
              + 2 * arows * (rows + 8))
    return (128 + (4 * cpb * arows * bn if nsplit > 1 else 0)
            + (2 if cpb > 1 else 1) * stage + single), nsplit


@pytest.mark.parametrize("B,n_in,n_out,nbk", SHAPES)
def test_mixed_knob_rules_are_the_tensor_core_bodys(B, n_in, n_out, nbk):
    """Every candidate of the mixed kernel fits 227 KB (two blocks an SM
    where its cluster is past the portable 8), its shared memory and
    threads are kan_mma.cuh's with f32 rows, and the default is one of
    them; a tile that fits the CUDA-core body but not the planes is
    refused."""
    cands = autotune.candidates_kan_fused(B, n_in, n_out, nbk, BF, 2, F32)
    assert cands
    for c in cands:
        bm, bi, bn = c["bm"], c["bi"], c["bn"]
        smem, nsplit = _smem(bm, bi, bn, n_in, nbk)
        assert tkf.kernel_smem(bm, bi, bn, n_in, nbk, BF, 2, F32) == smem
        assert smem <= autotune.MAX_SMEM_BYTES
        assert nsplit <= 8 or 2 * smem <= autotune.MAX_SMEM_BYTES
        tiles = max(16, bm) // 16 * (bn // 8)
        want = 256 if tiles == 64 else 512 if bm * bn >= 1024 else 256
        assert tkf.kernel_threads(bm, bn, BF, 2, F32) == want
    default = tkf.default_blocks(B, n_in, n_out, nbk, BF, 2, F32)
    assert default in cands
    if B == 8192:                 # 64 rows a block, where bf16 rows take 32
        assert default == {"bm": 64, "bi": 512, "bn": 32}
        assert tkf.default_blocks(B, n_in, n_out, nbk, BF)["bm"] == 32
    if (n_in, n_out) in ((896, 608), (608, 896)):
        assert default == {"bm": 64, "bi": 1024, "bn": 64}
        with pytest.raises(ValueError, match="shared memory"):
            tkf.check_blocks({"bm": 16, "bi": 1024, "bn": 128}, n_in, n_out,
                             nbk, BF, wt_dtype=F32)
        # the f32 kernel (CUDA cores) takes that tile
        tkf.check_blocks({"bm": 16, "bi": 1024, "bn": 128}, n_in, n_out,
                         nbk, F32)


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    autotune.reset_cache()
    yield
    autotune.reset_cache()


def test_a_cached_mixed_knob_the_body_refuses_is_searched_again(cache):
    """An entry under ``kan_fused_v2_mixed`` from the CUDA-core body that
    the tensor-core body refuses is a miss: the default serves, nothing
    raises, and ``tune_kan_fused`` searches the shape again and replaces
    it with a knob the body takes."""
    dims = (64, 64, 128, 5)
    stale = {"bm": 16, "bi": 64, "bn": 128}
    tkf.check_blocks(stale, 64, 128, 5, F32)      # the CUDA-core body's
    with pytest.raises(ValueError, match="shared memory"):
        tkf.check_blocks(stale, 64, 128, 5, BF, wt_dtype=F32)
    key = autotune.cache_key("kan_fused_v2_mixed", dims, BF, "cpu")
    autotune.get_cache().store(key, stale)
    default = tkf.default_blocks(*dims, BF, wt_dtype=F32)
    assert tkf.resolve_blocks(*dims, BF, device="cpu",
                              wt_dtype=F32) == default
    spec = tsl.SplineSpec(4, 3)
    x, w_b, t_flat = _inputs(3, 64, 64, 128, len(KB))
    xt, wtt = torch.from_numpy(x).to(BF), _fused(w_b, t_flat, len(KB))
    assert torch.equal(tkf.kan_fused_v2(xt, wtt, spec, KB),
                       kan_fused_v2_ref(xt, wtt, spec, KB))
    best = autotune.tune_kan_fused(xt, wtt, spec, KB, reps=1)
    assert best != stale
    tkf.check_blocks(best, 64, 128, 5, BF, wt_dtype=F32)
    assert autotune.get_cache().lookup(key) == best
    assert tkf.resolve_blocks(*dims, BF, device="cpu", wt_dtype=F32) == best
    # the other kernels' refused entries still raise (test_torch_kan_knobs)
    autotune.get_cache().store(autotune.cache_key(
        "kan_fused_v2", dims, BF, "cpu"), {"bm": 8, "bi": 40, "bn": 8})
    with pytest.raises(ValueError, match="multiple of 32"):
        tkf.resolve_blocks(*dims, BF, device="cpu")
