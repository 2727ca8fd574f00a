"""Launch-time knobs of the KAN kernels (version 2, f32 and int8, and
version 1), on the CPU.

``resolve_blocks`` against the JAX one on temporary caches (explicit >
cache hit > default, under ``kan_fused_v{version}``), the candidate grid
and its pruning, knob checks that raise on the CPU too, the
once-per-process cache resolution, the serving launcher's tuning step,
``tune_kan_fused`` at both versions, and ``kan_linear``,
``kan_linear_q8`` and ``KANLayer`` with ``blocks`` against the JAX
functions run through the Pallas kernels in interpret mode with the same
``(bm, bi, bn)``.  On the CPU the port runs its plain versions, whatever
the knobs; the CUDA kernels are held bitwise across every knob on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).  Tolerance
``1e-5 * (1 + max|ref|)``: the two sum in different orders (B >= 2, see
ROADMAP section 3 on M = 1).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kan as jkan  # noqa: E402
from repro.core import splines as jsl  # noqa: E402
from repro.kernels import autotune as jax_autotune  # noqa: E402
from repro.kernels.kan_fused import ops as jkf  # noqa: E402
from repro_torch.core import kan as tkan  # noqa: E402
from repro_torch.core import splines as tsl  # noqa: E402
from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels.kan_fused import ops as tkf  # noqa: E402
from repro_torch.utils import next_pow2  # noqa: E402

TOL = 1e-5
CARD = "NVIDIA H100 80GB HBM3"
KB = (0, 2, 4, 5, 6)
BLOCKS = [(8, 32, 8), (16, 64, 32), (32, 32, 16), (8, 128, 64)]


@pytest.fixture()
def caches(tmp_path, monkeypatch):
    """Both packages' caches on throwaway files, search off."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "torch.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.reset_cache()
    jax_autotune._GLOBAL_CACHE = None
    yield
    autotune.reset_cache()
    jax_autotune._GLOBAL_CACHE = None


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert not np.isnan(got).any()
    err = float(np.abs(got - ref).max())
    assert err <= tol * (1.0 + float(np.abs(ref).max())), err


def _kan_inputs(seed, B, n_in, n_out, n_bases):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, n_in)) * 1.5).astype(np.float32)
    w_b = rng.uniform(-0.3, 0.3, (n_in, n_out)).astype(np.float32)
    t = (rng.standard_normal((n_in, n_bases, n_out)) * 0.05).astype(
        np.float32)
    return x, w_b, t


def _q8_inputs(seed, B, n_in, n_out, nbk):
    """int8 codes and slot scales that differ per slot."""
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, (B, n_in)).astype(np.int8)
    wt_q = rng.integers(-127, 128, (n_in * (nbk + 1), n_out)).astype(np.int8)
    ss = tuple(float(v) for v in
               (rng.uniform(0.5, 2.0, nbk + 1) * 2e-3).astype(np.float32))
    return x_q, wt_q, ss


@pytest.mark.parametrize("dtype,version", [("float32", 2), ("int8", 2),
                                           ("float32", 1)],
                         ids=["float32", "int8", "float32-v1"])
def test_resolve_blocks_precedence_matches_jax(caches, dtype, version):
    """explicit > cache hit > default, in both packages: f32 and int8
    under kernel "kan_fused_v2" keyed by the dtype, version 1 under
    "kan_fused_v1"."""
    B, n_in, n_out, nbk = 48, 304, 32, 5
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    kernel = f"kan_fused_v{version}"
    explicit = (16, 64, 32)
    want_explicit = {"bm": 16, "bi": 64, "bn": 32}
    # nothing cached: each package's own default
    assert jkf.resolve_blocks(B, n_in, n_out, nbk, jdt, version=version,
                              backend="cpu") == {
        "bm": 128, "bi": 64, "bn": 128}
    assert tkf.resolve_blocks(B, n_in, n_out, nbk, tdt, version=version,
                              device="cpu") == \
        tkf.default_blocks(B, n_in, n_out, nbk, tdt, version)
    for got in (jkf.resolve_blocks(B, n_in, n_out, nbk, jdt, explicit,
                                   version, backend="cpu"),
                tkf.resolve_blocks(B, n_in, n_out, nbk, tdt, explicit,
                                   version, device="cpu")):
        assert got == want_explicit
    hit = {"bm": 32, "bi": 128, "bn": 16}
    dims = (B, n_in, n_out, nbk)
    jax_autotune.get_cache().store(jax_autotune.cache_key(
        kernel, dims, jdt, "cpu"), hit)
    autotune.get_cache().store(autotune.cache_key(
        kernel, dims, tdt, "cpu"), hit)
    assert jkf.resolve_blocks(*dims, jdt, version=version,
                              backend="cpu") == hit
    assert tkf.resolve_blocks(*dims, tdt, version=version,
                              device="cpu") == hit
    # the same bucket is served the same entry; explicit still wins
    assert tkf.resolve_blocks(B + 10, n_in + 100, n_out - 3, nbk + 1, tdt,
                              version=version, device="cpu") == hit
    assert jkf.resolve_blocks(*dims, jdt, explicit, version,
                              backend="cpu") == want_explicit
    assert tkf.resolve_blocks(*dims, tdt, explicit, version,
                              device="cpu") == want_explicit
    # the other dtype's and the other version's entries are not this one's
    other = torch.int8 if dtype == "float32" else torch.float32
    assert tkf.resolve_blocks(*dims, other, version=version,
                              device="cpu") == \
        tkf.default_blocks(*dims, other, version)
    assert tkf.resolve_blocks(*dims, tdt, version=3 - version,
                              device="cpu") == \
        tkf.default_blocks(*dims, tdt, 3 - version)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8,
                                   torch.bfloat16])
@pytest.mark.parametrize("B,n_in,n_out,nbk", [
    (1, 1, 1, 1), (8, 304, 32, 5), (8, 72, 96, 5), (16, 37, 13, 20),
    (8192, 304, 32, 5), (8192, 72, 96, 5), (300, 300, 33, 2),
    (4, 0, 8, 3), (64, 1000, 200, 20)])
def test_candidates_fit_the_card_and_cap_the_tiles(dtype, B, n_in, n_out,
                                                   nbk):
    cands = autotune.candidates_kan_fused(B, n_in, n_out, nbk, dtype)
    assert cands
    assert len({tuple(sorted(c.items())) for c in cands}) == len(cands)
    for c in cands:
        tkf.check_blocks(c, n_in, n_out, nbk, dtype)
        assert c["bm"] <= max(8, next_pow2(B))
        assert c["bn"] <= max(8, next_pow2(n_out))
        assert c["bi"] % tkf.PC == 0
        assert tkf.kernel_threads(c["bm"], c["bn"], dtype) <= \
            autotune.MAX_THREADS_PER_BLOCK
        assert tkf.kernel_smem(c["bm"], c["bi"], c["bn"], n_in, nbk,
                               dtype) <= autotune.MAX_SMEM_BYTES
        assert tkf.split(n_in, c["bi"])[2] <= tkf.MAX_SPLIT
    # the default is a knob the kernel takes, and a candidate
    default = tkf.default_blocks(B, n_in, n_out, nbk, dtype)
    tkf.check_blocks(default, n_in, n_out, nbk, dtype)
    assert default in cands


@pytest.mark.parametrize("B,n_in,n_out,nbk", [
    (1, 1, 1, 1), (8, 304, 32, 5), (8, 72, 96, 5), (16, 37, 13, 20),
    (8192, 304, 32, 5), (8192, 72, 96, 5), (300, 300, 33, 2),
    (4, 0, 8, 3), (64, 1000, 200, 20)])
def test_v1_candidates_fit_the_card_and_the_v1_limits(B, n_in, n_out, nbk):
    """The version-1 grid: every candidate the version-1 kernel takes
    (half the tile, two partial sets a cluster member), a subset of the
    f32 version-2 grid, and the default among them."""
    cands = autotune.candidates_kan_fused(B, n_in, n_out, nbk,
                                          torch.float32, 1)
    assert cands
    v2 = autotune.candidates_kan_fused(B, n_in, n_out, nbk, torch.float32)
    assert all(c in v2 for c in cands)
    for c in cands:
        tkf.check_blocks(c, n_in, n_out, nbk, torch.float32, 1)
        assert c["bm"] * c["bn"] <= tkf.MAX_TILE // 2
        assert tkf.kernel_smem(c["bm"], c["bi"], c["bn"], n_in, nbk,
                               torch.float32, 1) <= autotune.MAX_SMEM_BYTES
    default = tkf.default_blocks(B, n_in, n_out, nbk, torch.float32, 1)
    tkf.check_blocks(default, n_in, n_out, nbk, torch.float32, 1)
    assert default in cands


def test_candidates_are_pruned_to_the_shared_memory_limit(monkeypatch):
    full = autotune.candidates_kan_fused(8192, 304, 96, 5, torch.int8)
    monkeypatch.setattr(autotune, "MAX_SMEM_BYTES", 48 * 1024)
    small = autotune.candidates_kan_fused(8192, 304, 96, 5, torch.int8)
    assert 0 < len(small) < len(full)
    assert all(tkf.kernel_smem(c["bm"], c["bi"], c["bn"], 304, 5,
                               torch.int8) <= 48 * 1024 for c in small)
    with pytest.raises(ValueError, match="shared memory"):
        tkf.check_blocks({"bm": 64, "bi": 64, "bn": 64}, 304, 96, 5,
                         torch.int8)


def test_kernel_models_mirror_the_sources():
    """Threads, the feature split and shared memory as
    csrc/kan_split.cuh computes them."""
    assert [tkf.tile_rows(bm, bn) for bm, bn in
            ((8, 8), (8, 128), (32, 32), (64, 32), (128, 32), (128, 64))] \
        == [1, 1, 1, 2, 4, 8]
    assert tkf.kernel_threads(8, 8) == 128            # the rest stage
    assert tkf.kernel_threads(32, 32) == 256
    assert tkf.kernel_threads(128, 64) == 256
    # chunks of 32 features; bi >= n_in walks them all in one block
    assert tkf.split(304, 32) == (10, 1, 10)
    assert tkf.split(304, 64) == (10, 2, 5)
    assert tkf.split(304, 512) == (10, 10, 1)
    assert tkf.split(37, 37) == (2, 2, 1)
    assert tkf.split(0, 32) == (0, 1, 1)
    # 8x8 at 304 features, bi = 32: one weight and x stage, the values,
    # a cluster member's partial
    words = 64 + (192 * 8 + 8 * 32) + 8 * 260 + 8 * 8
    assert tkf.kernel_smem(8, 32, 8, 304, 5, torch.float32) == 4 * words
    assert tkf.kernel_smem(8, 32, 8, 304, 5, torch.int8) == \
        4 * words + 192 * 8 + 8 * 32
    # all features in one block: two stages, no partials
    words = 64 + 2 * (192 * 32 + 64 * 32) + 64 * 260
    assert tkf.kernel_smem(64, 512, 32, 304, 5, torch.float32) == 4 * words
    # version 1 keeps two partial sets (silu and spline chains) when split
    assert tkf.kernel_smem(64, 512, 32, 304, 5, torch.float32, 1) == \
        4 * words
    words = 64 + (192 * 8 + 8 * 32) + 8 * 260 + 2 * 8 * 8
    assert tkf.kernel_smem(8, 32, 8, 304, 5, torch.float32, 1) == 4 * words
    # 64 x 64 tiles, two chunks a block: fits at version 2, not at 1
    knob = {"bm": 64, "bi": 64, "bn": 64}
    tkf.check_blocks(knob, 304, 64, 5, torch.float32)
    assert tkf.kernel_smem(64, 64, 64, 304, 5, torch.float32, 1) - \
        tkf.kernel_smem(64, 64, 64, 304, 5, torch.float32) == 4 * 2 * 64 * 64
    with pytest.raises(ValueError, match="shared memory"):
        tkf.check_blocks(knob, 304, 64, 5, torch.float32, 1)
    # two chains at 8 rows a thread spill: f32 version 1 stops at half the
    # tile
    assert (tkf.max_tile(1), tkf.max_tile(2)) == (4096, 8192)
    # bf16, both versions (kan_mma.cuh): 256 threads, 512 from 32 x 32 on
    # (version 1 at a full 8192 tile 256); the slot table, a member's f32
    # partials (max(16, bm) rows x bn, a set a chain), and a stage of raw
    # bf16 weight rows (bn + 16 at 8, else bn + 8), x rows (40) and the
    # bf16 A tile (max(16, bm) rows of 32 * (nbk+1) + 8)
    bf = torch.bfloat16
    assert tkf.kernel_threads(8, 8, bf) == tkf.kernel_threads(16, 32, bf) \
        == 256
    assert tkf.kernel_threads(32, 32, bf) == tkf.kernel_threads(128, 64, bf) \
        == 512
    assert tkf.kernel_threads(8, 8, bf, 1) == 256
    assert tkf.kernel_threads(32, 32, bf, 1) == 512
    assert tkf.kernel_threads(128, 64, bf, 1) == 256
    assert tkf.max_tile(1, bf) == 8192
    assert tkf.kernel_smem(8, 32, 8, 304, 5, bf) == \
        128 + 4 * 16 * 8 + 2 * (192 * 24 + 8 * 40) + 2 * 16 * 200
    assert tkf.kernel_smem(8, 32, 8, 304, 5, bf, 1) == \
        128 + 2 * 4 * 16 * 8 + 2 * (192 * 24 + 8 * 40) + 2 * 16 * 200
    assert tkf.kernel_smem(32, 512, 32, 304, 5, bf) == \
        tkf.kernel_smem(32, 512, 32, 304, 5, bf, 1) == \
        128 + 2 * 2 * (192 * 40 + 32 * 40 + 32 * 200)
    # nbk = 0: the silu row alone, a chunk two k16 steps deep
    assert tkf.kernel_smem(16, 64, 16, 64, 0, bf) == \
        128 + 2 * 2 * (32 * 24 + 16 * 40 + 16 * 40)
    # the mixed kernel (bf16 x, f32 weights; kan_mma.cuh, the rows split
    # into three bf16 planes): a stage holds an f32 row buffer (rows x bn)
    # and an x buffer; one plane tile (rows of hi | mid | lo, 3 bn + 8, 3 bn
    # at bn = 8) and one A tile; 256 threads at a full 8192 tile
    f32 = torch.float32
    assert tkf.kernel_smem(64, 512, 32, 304, 5, bf, 2, f32) == \
        128 + 2 * (192 * 4 * 32 + 64 * 80) + 192 * 2 * 104 + 64 * 400
    assert tkf.kernel_smem(8, 32, 8, 304, 5, bf, 2, f32) == \
        128 + 4 * 16 * 8 + 192 * 4 * 8 + 8 * 80 + 192 * 2 * 24 + 16 * 400
    assert tkf.kernel_threads(64, 32, bf, 2, f32) == \
        tkf.kernel_threads(64, 32, bf) == 512
    assert tkf.kernel_threads(8, 8, bf, 2, f32) == 256
    assert tkf.kernel_threads(128, 64, bf, 2, f32) == 256


@pytest.mark.parametrize("blocks,n_in,match", [
    ((0, 32, 32), 304, "positive"), ((8, -32, 8), 304, "positive"),
    ((12, 32, 32), 304, "takes bm"), ((8, 32, 48), 304, "takes bm"),
    ((128, 32, 128), 304, "exceeds 8192"), ((8, 48, 8), 304, "multiple"),
    ((8, 32, 8), 1000, "blocks a cluster"),
    ((128, 512, 64), 2000, "shared memory"),
    ((64, 32, 64), 300, "two blocks an SM"),
])
@pytest.mark.parametrize("precision", ["f32", "int8", "v1", "bf16"])
def test_bad_knobs_raise_on_cpu(blocks, n_in, match, precision):
    nbk = 20 if match == "shared memory" else 5
    spec = tsl.SplineSpec(16, 4) if nbk == 20 else tsl.SplineSpec(4, 3)
    kb = tuple(range(nbk)) if nbk == 20 else KB
    before = dict(_build.LAUNCHES)
    if precision == "int8":
        x_q, wt_q, ss = _q8_inputs(1, 3, n_in, 40, nbk)
        args = (torch.from_numpy(x_q), torch.from_numpy(wt_q))
        with pytest.raises(ValueError, match=match):
            tkf.kan_fused_v2_q8(*args, torch.tensor(ss), spec, kb, 0.01,
                                blocks=blocks)
        with pytest.raises(ValueError, match=match):
            tkf.kan_linear_q8(*args, ss, spec, kb, x_scale=0.01,
                              blocks=blocks)
    elif precision == "v1":
        x, w_b, t = _kan_inputs(2, 3, n_in, 40, spec.n_bases)
        xt, wbt = torch.from_numpy(x), torch.from_numpy(w_b)
        t_flat = tkf.flatten_t(torch.from_numpy(t), kb)
        match = match.replace("8192", "4096")     # half the tile at v1
        if match == "shared memory":              # a tile v1 takes
            blocks = (64, 512, 64)
        with pytest.raises(ValueError, match=match):
            tkf.kan_fused_v1(xt, wbt, t_flat, spec, kb, blocks=blocks)
        with pytest.raises(ValueError, match=match):
            tkf.kan_linear(xt, wbt, t_flat, spec, kb, version=1,
                           blocks=blocks)
        cfg = tkan.KANConfig(n_in, 40, spec, basis_keep=kb, version=1,
                             blocks=blocks)
        layer = tkan.KANLayer(cfg, {"w_b": wbt, "t": torch.from_numpy(t)})
        with pytest.raises(ValueError, match=match):
            layer(xt)
    elif precision == "bf16":
        x, w_b, t = _kan_inputs(2, 3, n_in, 40, spec.n_bases)
        bf = torch.bfloat16
        xt, wbt = torch.from_numpy(x).to(bf), torch.from_numpy(w_b).to(bf)
        t_flat = tkf.flatten_t(torch.from_numpy(t), kb).to(bf)
        if match == "two blocks an SM":   # the bf16 tile that needs them
            blocks = (128, 32, 64)
        with pytest.raises(ValueError, match=match):
            tkf.kan_fused_v2(xt, tkf.fuse_wt(wbt, t_flat, nbk), spec, kb,
                             blocks=blocks)
        with pytest.raises(ValueError, match=match):
            tkf.kan_linear(xt, wbt, t_flat, spec, kb, blocks=blocks)
    else:
        x, w_b, t = _kan_inputs(2, 3, n_in, 40, spec.n_bases)
        t_flat = tkf.flatten_t(torch.from_numpy(t), kb)
        wt = tkf.fuse_wt(torch.from_numpy(w_b), t_flat, nbk)
        with pytest.raises(ValueError, match=match):
            tkf.kan_fused_v2(torch.from_numpy(x), wt, spec, kb,
                             blocks=blocks)
        with pytest.raises(ValueError, match=match):
            tkf.kan_linear(torch.from_numpy(x), torch.from_numpy(w_b),
                           t_flat, spec, kb, blocks=blocks)
    assert dict(_build.LAUNCHES) == before


def test_version_1_tile_limit_is_half_of_version_2():
    """A tile the version-2 kernel takes and the version-1 one does not
    (two chains at 8 rows a thread would spill) raises at version 1
    only."""
    spec = tsl.SplineSpec(4, 3)
    x, w_b, t = _kan_inputs(6, 3, 32, 64, spec.n_bases)
    xt, wbt = torch.from_numpy(x), torch.from_numpy(w_b)
    t_flat = tkf.flatten_t(torch.from_numpy(t), KB)
    ref = tkf.kan_linear(xt, wbt, t_flat, spec, KB, version=1)
    tkf.kan_linear(xt, wbt, t_flat, spec, KB, blocks=(128, 32, 64))
    with pytest.raises(ValueError, match="exceeds 4096"):
        tkf.kan_linear(xt, wbt, t_flat, spec, KB, version=1,
                       blocks=(128, 32, 64))
    got = tkf.kan_linear(xt, wbt, t_flat, spec, KB, version=1,
                         blocks=(64, 32, 64))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("B,n_in,n_out,kb", [(2, 37, 13, KB),
                                             (9, 72, 32, None)])
def test_version_1_takes_knobs_like_jax(B, n_in, n_out, kb, blocks):
    """``KANConfig(version=1, blocks=...)``, ``KANLayer`` on it, and
    ``kan_linear(..., version=1, blocks=...)`` are taken, as the JAX
    package takes them, and match JAX ``kan_linear(impl=
    "pallas_interpret", version=1)`` with the same (bm, bi, bn)."""
    js, ts = jsl.SplineSpec(4, 3), tsl.SplineSpec(4, 3)
    x, w_b, t = _kan_inputs([B, n_in, n_out, 1], B, n_in, n_out, 7)
    ref = jkf.kan_linear(jnp.asarray(x), jnp.asarray(w_b),
                         jkf.flatten_t(jnp.asarray(t), kb), js, kb,
                         impl="pallas_interpret", version=1, blocks=blocks)
    xt, wbt, tt = (torch.from_numpy(a) for a in (x, w_b, t))
    got = tkf.kan_linear(xt, wbt, tkf.flatten_t(tt, kb), ts, kb, version=1,
                         blocks=blocks)
    _close(got.numpy(), ref)
    jcfg = jkan.KANConfig(n_in, n_out, js, basis_keep=kb,
                          impl="pallas_interpret", version=1, blocks=blocks)
    tcfg = tkan.KANConfig(n_in, n_out, ts, basis_keep=kb, version=1,
                          blocks=blocks)
    assert (tcfg.version, tcfg.blocks) == (jcfg.version, jcfg.blocks)
    jref = jkan.kan_apply({"w_b": jnp.asarray(w_b), "t": jnp.asarray(t)},
                          jnp.asarray(x), jcfg)
    params = {"w_b": wbt, "t": tt}
    _close(tkan.KANLayer(tcfg, params)(xt).numpy(), jref)
    _close(tkan.kan_apply(params, xt, tcfg).numpy(), jref)


def test_a_bad_cached_knob_raises(caches):
    autotune.get_cache().store(autotune.cache_key(
        "kan_fused_v2", (8, 304, 32, 5), torch.float32, "cpu"),
        {"bm": 8, "bi": 40, "bn": 8})
    with pytest.raises(ValueError, match="multiple of 32"):
        tkf.resolve_blocks(8, 304, 32, 5, torch.float32, device="cpu")


@pytest.mark.parametrize("knob,match", [
    ({"bm": 8, "bi": 40, "bn": 8}, "multiple of 32"),
    ({"bm": 128, "bi": 32, "bn": 128}, "exceeds 8192"),
    ({"bm": 128, "bi": 640, "bn": 64}, "shared memory")])
def test_a_bad_cached_bf16_knob_raises(caches, knob, match):
    """A cached knob the bf16 tensor-core kernel does not take raises,
    and is not replaced by another (at nbk = 20 the 128 x 64 tile's two
    weight stages and A tile exceed the block's shared memory)."""
    autotune.get_cache().store(autotune.cache_key(
        "kan_fused_v2", (8192, 600, 64, 20), torch.bfloat16, "cpu"), knob)
    with pytest.raises(ValueError, match=match):
        tkf.resolve_blocks(8192, 600, 64, 20, torch.bfloat16, device="cpu")


def test_resolution_reads_the_cache_once_and_sees_store_and_clear(
        caches, monkeypatch):
    """The served path asks the cache (and the card's name) once per
    shape bucket, dtype and device; a store or clear drops the memo."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: CARD)
    reads, names = [], []
    lookup = autotune.AutotuneCache.lookup
    monkeypatch.setattr(autotune.AutotuneCache, "lookup",
                        lambda self, key: reads.append(key) or lookup(
                            self, key))
    monkeypatch.setattr(autotune, "device_tag",
                        lambda d, tag=autotune.device_tag: names.append(d)
                        or tag(d))
    args = (8, 304, 32, 5, torch.float32)
    default = tkf.default_blocks(*args)
    for b in (5, 6, 7, 8):                    # one bucket
        assert tkf.resolve_blocks(b, 304, 32, 5, torch.float32,
                                  device="cuda") == default
    assert len(reads) == 1 and len(names) == 1
    hit = {"bm": 16, "bi": 32, "bn": 16}
    key = autotune.cache_key("kan_fused_v2", (8, 304, 32, 5),
                             torch.float32, "cuda")
    autotune.DISPATCH_LOG.clear()
    autotune.get_cache().store(key, hit)
    for _ in range(3):
        assert tkf.resolve_blocks(*args, device="cuda") == hit
    assert len(reads) == 2
    assert autotune.DISPATCH_LOG == [("kan_fused_v2", key, hit, "cache")]
    # a caller that edits the answer does not edit the memo
    tkf.resolve_blocks(*args, device="cuda")["bm"] = 128
    assert tkf.resolve_blocks(*args, device="cuda") == hit
    autotune.get_cache().clear()
    assert tkf.resolve_blocks(*args, device="cuda") == default
    assert len(reads) == 3


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_serve_tunes_the_kan_layers_first_when_enabled(caches, monkeypatch,
                                                       precision):
    """``REPRO_TORCH_AUTOTUNE=1`` makes the launcher tune every KAN layer
    at every bucket before serving, and the served forwards then read the
    tuned knobs from the cache; without it nothing is tuned."""
    from repro_torch.launch import serve

    dtype = torch.int8 if precision == "int8" else torch.float32
    argv = ["--arch", "vikin-kan2", "--requests", "4", "--slots", "4",
            "--device", "cpu", "--precision", precision]
    layer = serve.main(argv).backend.stack.layers[0]
    shapes = [(m, layer.cfg.n_in, layer.cfg.n_out, len(layer.kb))
              for m in (2, 4)]
    cache = autotune.AutotuneCache(autotune.get_cache().path)
    assert all(cache.lookup(autotune.cache_key(
        "kan_fused_v2", s, dtype, "cpu")) is None for s in shapes)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    serve.main(argv)
    cache = autotune.AutotuneCache(autotune.get_cache().path)
    for s in shapes:
        hit = cache.lookup(autotune.cache_key("kan_fused_v2", s, dtype,
                                              "cpu"))
        assert hit in autotune.candidates_kan_fused(*s, dtype)
        assert tkf.resolve_blocks(*s, dtype, device="cpu") == hit


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_tune_kan_fused_round_trips_on_cpu(caches, dtype):
    """On the CPU the search times the plain version under ``cpu``."""
    spec = tsl.SplineSpec(4, 3)
    if dtype == torch.int8:
        x_q, wt_q, ss = _q8_inputs(4, 8, 40, 24, len(KB))
        x, wt = torch.from_numpy(x_q), torch.from_numpy(wt_q)
        best = autotune.tune_kan_fused(x, wt, spec, KB,
                                       slot_scales=torch.tensor(ss),
                                       x_scale=0.01, reps=1)
        with pytest.raises(ValueError, match="slot_scales"):
            autotune.tune_kan_fused(x, wt, spec, KB, reps=1)
    else:
        xn, w_b, t = _kan_inputs(5, 8, 40, 24, spec.n_bases)
        x = torch.from_numpy(xn)
        wt = tkf.fuse_wt(torch.from_numpy(w_b),
                         tkf.flatten_t(torch.from_numpy(t), KB), len(KB))
        best = autotune.tune_kan_fused(x, wt, spec, KB, reps=1)
    dims = (8, 40, 24, len(KB))
    assert best in autotune.candidates_kan_fused(*dims, dtype)
    key = autotune.cache_key("kan_fused_v2", dims, dtype, "cpu")
    assert autotune.AutotuneCache(autotune.get_cache().path).lookup(key) \
        == best
    assert tkf.resolve_blocks(*dims, dtype, device="cpu") == best


def test_tune_kan_fused_v1_round_trips_on_cpu(caches):
    """A version-1 search is stored under ``kan_fused_v1``, where
    ``resolve_blocks(..., version=1)`` finds it, as the JAX
    ``tune_kan_fused(..., version=1)`` stores it; version 2 does not see
    it."""
    spec = tsl.SplineSpec(4, 3)
    xn, w_b, t = _kan_inputs(9, 8, 40, 24, spec.n_bases)
    x, wbt = torch.from_numpy(xn), torch.from_numpy(w_b)
    t_flat = tkf.flatten_t(torch.from_numpy(t), KB)
    best = autotune.tune_kan_fused(x, wbt, spec, KB, version=1,
                                   t_flat=t_flat, reps=1)
    dims = (8, 40, 24, len(KB))
    assert best in autotune.candidates_kan_fused(*dims, torch.float32, 1)
    key = autotune.cache_key("kan_fused_v1", dims, torch.float32, "cpu")
    assert key.split("|")[0] == jax_autotune.cache_key(
        "kan_fused_v1", dims, jnp.float32, "cpu").split("|")[0]
    assert autotune.AutotuneCache(autotune.get_cache().path).lookup(key) \
        == best
    assert tkf.resolve_blocks(*dims, torch.float32, version=1,
                              device="cpu") == best
    assert tkf.resolve_blocks(*dims, torch.float32, device="cpu") == \
        tkf.default_blocks(*dims, torch.float32)
    # the tuned knob changes no bit of the layer
    assert torch.equal(
        tkf.kan_fused_v1(x, wbt, t_flat, spec, KB),
        tkf.kan_fused_v1(x, wbt, t_flat, spec, KB,
                         blocks=(best["bm"], best["bi"], best["bn"])))
    with pytest.raises(ValueError, match="t_flat"):
        autotune.tune_kan_fused(x, wbt, spec, KB, version=1, reps=1)
    with pytest.raises(ValueError, match="t_flat"):
        autotune.tune_kan_fused(x, wbt, spec, KB, t_flat=t_flat, reps=1)


def _layer_cases():
    cases = []
    for i, (B, n_in, n_out) in enumerate(
            (b, ni, no) for b in (2, 9) for ni in (16, 37, 72)
            for no in (13, 32)):
        cases.append((B, n_in, n_out, i))
    return cases


@pytest.mark.parametrize("B,n_in,n_out,i", _layer_cases())
def test_kan_linear_blocks_match_jax_interpret(B, n_in, n_out, i):
    """f32 with ``blocks=``: the port's plain version against the Pallas
    kernel in interpret mode with the same (bm, bi, bn); masked bases
    every other case."""
    kb = KB if i % 2 else None
    blocks = BLOCKS[i % len(BLOCKS)]
    x, w_b, t = _kan_inputs([B, n_in, n_out], B, n_in, n_out, 7)
    js, ts = jsl.SplineSpec(4, 3), tsl.SplineSpec(4, 3)
    ref = jkf.kan_linear(jnp.asarray(x), jnp.asarray(w_b),
                         jkf.flatten_t(jnp.asarray(t), kb), js, kb,
                         impl="pallas_interpret", blocks=blocks)
    got = tkf.kan_linear(torch.from_numpy(x), torch.from_numpy(w_b),
                         tkf.flatten_t(torch.from_numpy(t), kb), ts, kb,
                         blocks=blocks)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("B,n_in,n_out,i", _layer_cases())
def test_kan_linear_q8_blocks_match_jax_interpret(B, n_in, n_out, i):
    kb = KB if i % 2 == 0 else None
    nbk = 7 if kb is None else len(kb)
    blocks = BLOCKS[(i + 1) % len(BLOCKS)]
    x_q, wt_q, ss = _q8_inputs([B, n_in, n_out, 8], B, n_in, n_out, nbk)
    ref = jkf.kan_linear_q8(jnp.asarray(x_q), jnp.asarray(wt_q), ss,
                            jsl.SplineSpec(4, 3), kb, x_scale=0.02,
                            impl="pallas_interpret", blocks=blocks)
    got = tkf.kan_linear_q8(torch.from_numpy(x_q), torch.from_numpy(wt_q),
                            ss, tsl.SplineSpec(4, 3), kb, x_scale=0.02,
                            blocks=blocks)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("G,K,pattern", [(4, 3, (1, 0, 1, 0)),
                                         (8, 2, None)])
def test_kan_layer_with_config_blocks_matches_jax_interpret(blocks, G, K,
                                                            pattern):
    """``KANConfig.blocks`` reaches ``KANLayer.forward`` and
    ``kan_apply`` as it reaches the JAX ``kan_apply``."""
    n_in, n_out, B = 24, 12, 5
    jcfg = jkan.KANConfig(n_in, n_out, jsl.SplineSpec(G, K), pattern=pattern,
                          impl="pallas_interpret", blocks=blocks)
    tcfg = tkan.KANConfig(n_in, n_out, tsl.SplineSpec(G, K), pattern=pattern,
                          blocks=blocks)
    assert tcfg.blocks == jcfg.blocks
    x, w_b, t = _kan_inputs(G + K, B, n_in, n_out, G + K)
    ref = jkan.kan_apply({"w_b": jnp.asarray(w_b), "t": jnp.asarray(t)},
                         jnp.asarray(x), jcfg)
    params = {"w_b": torch.from_numpy(w_b), "t": torch.from_numpy(t)}
    layer = tkan.KANLayer(tcfg, params)
    _close(layer(torch.from_numpy(x)).numpy(), ref)
    _close(tkan.kan_apply(params, torch.from_numpy(x), tcfg).numpy(), ref)
    # a knob the kernel does not take raises from the layer too
    bad = tkan.KANLayer(dataclasses.replace(tcfg, blocks=(8, 20, 8)),
                        params)
    with pytest.raises(ValueError, match="multiple of 32"):
        bad(torch.from_numpy(x))
