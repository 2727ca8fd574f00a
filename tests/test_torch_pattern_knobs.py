"""Launch-time tiles of the pattern-matmul kernels, on the CPU.

``resolve_blocks`` against the JAX one on temporary caches (explicit >
cache hit > default), the candidate grid and its pruning, knob checks
that raise on the CPU too, the once-per-process cache resolution, and
``pattern_linear``/``pattern_linear_q8`` with ``blocks=`` against the JAX
functions run through the Pallas kernels in interpret mode with the same
tiles.  On the CPU the port runs its plain versions, whatever the tiles;
the CUDA kernels are held bitwise across every tile on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  Tolerances: f32
``1e-5 * (1 + max|ref|)`` (the two sum in different orders; M >= 2, see
ROADMAP section 3 on M = 1), int8 bitwise (exact integer accumulators,
one shared epilogue).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import sparsity as jsp  # noqa: E402
from repro.kernels import autotune as jax_autotune  # noqa: E402
from repro.kernels.pattern_matmul import ops as jpm  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels.pattern_matmul import ops as tpm  # noqa: E402
from repro_torch.utils import next_pow2  # noqa: E402

TOL = 1e-5
CARD = "NVIDIA H100 80GB HBM3"
F32_BLOCKS = [(8, 32, 32), (16, 16, 8), (32, 64, 16)]
Q8_BLOCKS = [(16, 32, 32), (32, 64, 64), (16, 128, 32)]


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


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_resolve_blocks_precedence_matches_jax(caches, dtype):
    """explicit > cache hit > default, in both packages, with int8 under
    kernel "pattern_matmul" keyed by its dtype."""
    M, K, N = 48, 72, 304
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    explicit = (32, 64, 32)
    want_explicit = {"bm": 32, "bk": 64, "bn": 32}
    # nothing cached: each package's own default
    assert jpm.resolve_blocks(M, K, N, jdt, backend="cpu") == {
        "bm": jpm.DEFAULT_BM, "bk": jpm.DEFAULT_BK, "bn": jpm.DEFAULT_BN}
    assert tpm.resolve_blocks(M, K, N, tdt, device="cpu") == \
        tpm.default_blocks(M, K, tdt)
    for got in (jpm.resolve_blocks(M, K, N, jdt, explicit, backend="cpu"),
                tpm.resolve_blocks(M, K, N, tdt, explicit, device="cpu")):
        assert got == want_explicit
    hit = {"bm": 64, "bk": 32, "bn": 64}
    jax_autotune.get_cache().store(jax_autotune.cache_key(
        "pattern_matmul", (M, K, N), jdt, "cpu"), hit)
    autotune.get_cache().store(autotune.cache_key(
        "pattern_matmul", (M, K, N), tdt, "cpu"), hit)
    assert jpm.resolve_blocks(M, K, N, jdt, backend="cpu") == hit
    assert tpm.resolve_blocks(M, K, N, tdt, device="cpu") == hit
    # the same bucket is served the same entry; explicit still wins
    assert tpm.resolve_blocks(M + 10, K + 40, N + 100, tdt,
                              device="cpu") == hit
    assert jpm.resolve_blocks(M, K, N, jdt, explicit,
                              backend="cpu") == want_explicit
    assert tpm.resolve_blocks(M, K, N, tdt, explicit,
                              device="cpu") == want_explicit
    # the other dtype's entry is not this one's
    other = torch.int8 if dtype == "float32" else torch.float32
    assert tpm.resolve_blocks(M, K, N, other, device="cpu") == \
        tpm.default_blocks(M, K, other)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8,
                                   torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (8, 72, 304), (16, 16, 96),
                                   (33, 37, 33), (8192, 228, 96),
                                   (8192, 304, 304)])
def test_candidates_fit_the_card_and_cap_bm(dtype, M, K, N):
    cands = autotune.candidates_pattern_matmul(M, K, N, dtype)
    assert cands
    assert len({tuple(sorted(c.items())) for c in cands}) == len(cands)
    for c in cands:
        tpm.check_blocks(c, K, N, dtype)
        assert c["bm"] <= max(16, next_pow2(M))
        assert tpm.kernel_threads(c["bm"], c["bn"], dtype) <= \
            autotune.MAX_THREADS_PER_BLOCK
        assert tpm.kernel_smem(c["bm"], c["bk"], c["bn"], K, dtype) <= \
            autotune.MAX_SMEM_BYTES
    # the default is a knob the kernel takes, and so is every default
    # bucket's
    tpm.check_blocks(tpm.default_blocks(M, K, dtype), K, N, dtype)


def test_candidates_are_pruned_to_the_shared_memory_limit(monkeypatch):
    full = autotune.candidates_pattern_matmul(8192, 304, 304, torch.float32)
    monkeypatch.setattr(autotune, "MAX_SMEM_BYTES", 20 * 1024)
    small = autotune.candidates_pattern_matmul(8192, 304, 304,
                                               torch.float32)
    assert 0 < len(small) < len(full)
    assert all(tpm.kernel_smem(c["bm"], c["bk"], c["bn"], 304,
                               torch.float32) <= 20 * 1024 for c in small)
    with pytest.raises(ValueError, match="shared memory"):
        tpm.check_blocks({"bm": 128, "bk": 64, "bn": 128}, 304, 304,
                         torch.float32)


def test_kernel_models_mirror_the_sources():
    """Threads and shared memory as csrc/*.cu compute them: an 8x8, 8x4,
    2x4 or 1x4 register tile per f32 thread with at least 128 threads, a
    ring of min(ceil(K/bk), 16, max(2, 32 KB / slab)) slabs; int8 warps
    of 16x16 or 32x32 and max(operands, output tile) bytes."""
    f32, q8 = torch.float32, torch.int8
    assert tpm.kernel_threads(128, 64, f32) == 128
    assert tpm.kernel_threads(128, 128, f32) == 256
    assert tpm.kernel_threads(8, 8, f32) == 128          # helpers stage
    assert tpm.kernel_threads(16, 128, q8) == 8 * 32
    assert tpm.kernel_threads(128, 128, q8) == 16 * 32
    # K = 72, bk = 64, 8 x 8: two slabs of 4 * (8 * 68 + 64 * 8) bytes
    assert tpm.kernel_smem(8, 64, 8, 72, f32) == 2 * 4 * (8 * 68 + 64 * 8)
    # 128 x 64 x 16 slabs (14336 B) at K = 304: two fit the 32 KB ring
    assert tpm.kernel_smem(128, 16, 64, 304, f32) == 2 * 14336
    assert tpm.kernel_smem(8, 16, 8, 0, f32) == 4 * (8 * 20 + 16 * 8)
    assert tpm.kernel_smem(16, 96, 32, 72, q8) == 48 * 112
    assert tpm.kernel_smem(128, 96, 64, 72, q8) == 4 * 128 * 72
    # bf16: warps of 16x8 up to 32x32, at least 128 threads; the output
    # tile (f32-sized, 16 B a row more), its f32 bias, two x slabs of bk +
    # 8, and w_c's column tile of all K rounded up to 16 rows (bn + 8,
    # bn + 16 at 8)
    bf = torch.bfloat16
    assert tpm.kernel_threads(16, 8, bf) == 128
    assert tpm.kernel_threads(128, 64, bf) == 8 * 32
    assert tpm.kernel_threads(128, 128, bf) == 16 * 32
    assert tpm.kernel_smem(128, 80, 64, 72, bf) == \
        128 * (4 * 64 + 16) + 4 * 64 + 2 * 2 * 128 * 88 + 2 * 80 * 72
    assert tpm.kernel_smem(16, 240, 8, 228, bf) == \
        16 * (4 * 8 + 16) + 4 * 8 + 2 * 2 * 16 * 248 + 2 * 240 * 24
    # a column tile too deep for shared memory rides a bk slab a stage
    assert tpm.kernel_smem(128, 16, 128, 4000, bf) == \
        128 * (4 * 128 + 16) + 4 * 128 + 2 * 2 * 128 * 24 + 2 * 2 * 16 * 136
    assert tpm.kernel_smem(128, 16, 128, 304, bf) == \
        128 * (4 * 128 + 16) + 4 * 128 + 2 * 2 * 128 * 24 + 2 * 304 * 136
    # the persistent grid on 132 SMs: two blocks an SM over the column
    # tiles (264 // 5), at most the row tiles; one at a serving bucket
    knob = {"bm": 128, "bk": 80, "bn": 64}
    assert tpm.bf16_grid(8192, 72, 304, knob, 132) == (52, 5)
    assert tpm.bf16_grid(8, 72, 304, {"bm": 16, "bk": 80, "bn": 8},
                         132) == (1, 38)
    # 512 threads at 128 registers fill an SM's registers: one block an SM
    assert tpm.bf16_grid(8192, 16, 96, {"bm": 128, "bk": 16, "bn": 128},
                         132) == (64, 1)
    assert tpm.bf16_grid(4096, 16, 96, {"bm": 128, "bk": 16, "bn": 128},
                         132) == (32, 1)


@pytest.mark.parametrize("blocks,match", [
    ((0, 32, 32), "positive"), ((8, -4, 32), "positive"),
    ((12, 32, 32), "takes bm"), ((8, 32, 48), "takes bm"),
    ((8, 30, 32), "multiple of 4"), ((128, 4096, 128), "shared memory"),
])
def test_bad_f32_knobs_raise_on_cpu(blocks, match):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 37)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((37, 33)).astype(np.float32))
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        tpm.matmul_compact(x, w, blocks=blocks)
    with pytest.raises(ValueError, match=match):
        tpm.pattern_linear(x, w, act="relu", blocks=blocks)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("blocks,match", [
    ((16, 48, 32), "multiple of 32"), ((8, 32, 32), "takes bm"),
    ((16, 32, 16), "takes bm"), ((16, 0, 32), "positive"),
    ((128, 8192, 128), "shared memory"),
])
def test_bad_int8_knobs_raise_on_cpu(blocks, match):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-127, 128, (5, 40)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (40, 33)).astype(np.int8))
    col = torch.full((33,), 1e-4)
    with pytest.raises(ValueError, match=match):
        tpm.matmul_q8(x, w, blocks=blocks)
    with pytest.raises(ValueError, match=match):
        tpm.pattern_linear_q8(x, w, col, blocks=blocks)


def test_a_bad_cached_knob_raises(caches):
    autotune.get_cache().store(autotune.cache_key(
        "pattern_matmul", (8, 72, 304), torch.float32, "cpu"),
        {"bm": 8, "bk": 30, "bn": 32})
    with pytest.raises(ValueError, match="multiple of 4"):
        tpm.resolve_blocks(8, 72, 304, torch.float32, device="cpu")


@pytest.mark.parametrize("knob,match", [
    ({"bm": 8, "bk": 64, "bn": 8}, "takes bm"),
    ({"bm": 16, "bk": 24, "bn": 8}, "multiple of 16"),
    ({"bm": 128, "bk": 256, "bn": 128}, "shared memory")])
def test_a_bad_cached_bf16_knob_raises(caches, knob, match):
    """A cached bf16 tile the kernel does not take raises, and is not
    replaced by another: (128, 256, 128), which the first bf16 kernel took
    at Kc = 228, no longer fits with its output tile staged."""
    autotune.get_cache().store(autotune.cache_key(
        "pattern_matmul", (8192, 228, 96), torch.bfloat16, "cpu"), knob)
    with pytest.raises(ValueError, match=match):
        tpm.resolve_blocks(8192, 228, 96, torch.bfloat16, device="cpu")


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
    args = (8, 72, 304, torch.float32)
    default = tpm.default_blocks(8, 72, torch.float32)
    for m in (5, 6, 7, 8):                    # one bucket
        assert tpm.resolve_blocks(m, 72, 304, torch.float32,
                                  device="cuda") == default
    assert len(reads) == 1 and len(names) == 1
    hit = {"bm": 16, "bk": 32, "bn": 64}
    key = autotune.cache_key("pattern_matmul", (8, 72, 304), torch.float32,
                             "cuda")
    autotune.DISPATCH_LOG.clear()
    autotune.get_cache().store(key, hit)
    for _ in range(3):
        assert tpm.resolve_blocks(*args, device="cuda") == hit
    assert len(reads) == 2
    # the hit is logged on its first resolution only
    assert autotune.DISPATCH_LOG == [
        ("pattern_matmul", key, hit, "cache")]
    # a caller that edits the answer does not edit the memo
    tpm.resolve_blocks(*args, device="cuda")["bm"] = 128
    assert tpm.resolve_blocks(*args, device="cuda") == hit
    autotune.get_cache().clear()
    assert tpm.resolve_blocks(*args, device="cuda") == default
    assert len(reads) == 3
    # a new cache file is a new cache from the next get_cache (any store,
    # search or first lookup of a shape) on
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", "/nonexistent/x.json")
    autotune.get_cache()
    assert tpm.resolve_blocks(*args, device="cuda") == default
    assert len(reads) == 4


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_serve_tunes_the_matmuls_first_when_enabled(caches, monkeypatch,
                                                    precision):
    """The wrappers never search; ``REPRO_TORCH_AUTOTUNE=1`` makes the
    launcher tune every matmul layer at every bucket before serving, and
    the served forwards then read the tuned tiles from the cache."""
    from repro_torch.launch import serve

    dtype = torch.int8 if precision == "int8" else torch.float32
    # vikin-mixed's matmul layers: 72 -> 304 (Kc 72), 32 -> 96 (Kc 16)
    shapes = [(m, k, n) for m in (2, 4) for k, n in ((72, 304), (16, 96))]
    argv = ["--arch", "vikin-mixed", "--requests", "4", "--slots", "4",
            "--device", "cpu", "--precision", precision]
    serve.main(argv)
    cache = autotune.AutotuneCache(autotune.get_cache().path)
    assert all(cache.lookup(autotune.cache_key(
        "pattern_matmul", s, dtype, "cpu")) is None for s in shapes)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    serve.main(argv)
    cache = autotune.AutotuneCache(autotune.get_cache().path)
    for s in shapes:
        hit = cache.lookup(autotune.cache_key("pattern_matmul", s, dtype,
                                              "cpu"))
        assert hit in autotune.candidates_pattern_matmul(*s, dtype)
        assert tpm.resolve_blocks(*s, dtype, device="cpu") == hit


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_tune_pattern_matmul_round_trips_on_cpu(caches, dtype):
    """On the CPU the search times the plain version under ``cpu``; the
    card's key stays empty."""
    rng = np.random.default_rng(2)
    if dtype == torch.int8:
        x = torch.from_numpy(rng.integers(-127, 128, (8, 40)).astype(
            np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (40, 24)).astype(
            np.int8))
        best = autotune.tune_pattern_matmul(x, w, reps=1)
        with pytest.raises(ValueError, match="raw accumulator"):
            autotune.tune_pattern_matmul(x, w, act="relu")
    else:
        x = torch.from_numpy(rng.standard_normal((8, 40)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
        best = autotune.tune_pattern_matmul(x, w, torch.zeros(24),
                                            act="relu", reps=1)
    assert best in autotune.candidates_pattern_matmul(8, 40, 24, dtype)
    key = autotune.cache_key("pattern_matmul", (8, 40, 24), dtype, "cpu")
    assert autotune.AutotuneCache(autotune.get_cache().path).lookup(key) \
        == best
    assert tpm.resolve_blocks(8, 40, 24, dtype, device="cpu") == best


def _linear_cases():
    cases = []
    for i, (M, Kc, N) in enumerate(
            (m, k, n) for m in (2, 8, 33) for k in (16, 37, 72)
            for n in (33, 96)):
        cases.append((M, Kc, N, i))
    return cases


@pytest.mark.parametrize("M,Kc,N,i", _linear_cases())
def test_pattern_linear_blocks_match_jax_interpret(M, Kc, N, i):
    """f32 with ``blocks=``: the port's plain version against the Pallas
    kernel in interpret mode with the same tiles; a masked input dimension
    every third case (Kc kept of 2 * Kc)."""
    rng = np.random.default_rng([M, Kc, N])
    blocks = F32_BLOCKS[i % len(F32_BLOCKS)]
    act = (None, "relu", "gelu", "silu")[i % 4]
    masked = i % 3 == 0
    K = 2 * Kc if masked else Kc
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32) if i % 2 else None
    jmask = jsp.tiled_mask(K, (1, 0, 1, 0)) if masked else None
    tmask = tsp.tiled_mask(K, (1, 0, 1, 0)) if masked else None
    ref = jpm.pattern_linear(jnp.asarray(x), jnp.asarray(w), jmask,
                             None if b is None else jnp.asarray(b), act=act,
                             impl="pallas_interpret", blocks=blocks)
    got = tpm.pattern_linear(torch.from_numpy(x), torch.from_numpy(w), tmask,
                             None if b is None else torch.from_numpy(b),
                             act=act, blocks=blocks)
    _close(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("M,Kc,N,i", _linear_cases())
def test_pattern_linear_q8_blocks_match_jax_interpret_bitwise(M, Kc, N, i):
    rng = np.random.default_rng([M, Kc, N, 8])
    blocks = Q8_BLOCKS[i % len(Q8_BLOCKS)]
    act = (None, "relu")[i % 2]
    masked = i % 3 == 1
    K = 2 * Kc if masked else Kc
    x_q = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w_q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    col = (rng.uniform(0.5, 2.0, N) * 1e-4).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32) if i % 3 == 2 else None
    jmask = jsp.tiled_mask(K, (0, 1, 1, 0)) if masked else None
    tmask = tsp.tiled_mask(K, (0, 1, 1, 0)) if masked else None
    ref = jpm.pattern_linear_q8(jnp.asarray(x_q), jnp.asarray(w_q),
                                jnp.asarray(col), jmask,
                                None if b is None else jnp.asarray(b),
                                act=act, impl="pallas_interpret",
                                blocks=blocks)
    got = tpm.pattern_linear_q8(torch.from_numpy(x_q), torch.from_numpy(w_q),
                                torch.from_numpy(col), tmask,
                                None if b is None else torch.from_numpy(b),
                                act=act, blocks=blocks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
