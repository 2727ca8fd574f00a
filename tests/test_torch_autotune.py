"""The port's autotune cache: keys, persistence, merge, search, dispatch.

The applicable cases of ``tests/test_autotune.py``, on the CPU.  The port
keys its cache by the card's name (``torch.cuda.get_device_name``) or
``cpu``; the card is faked here by patching that function, which is all
the key reads.  Unlike the JAX search, the port's lets a failing
candidate raise.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.kernels import autotune as jax_autotune  # noqa: E402
from repro_torch.core.splines import SplineSpec  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.spline_basis import ops as sb_ops  # noqa: E402

CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture()
def tmp_cache(tmp_path, monkeypatch):
    """Point the global cache at a throwaway file for each test."""
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", path)
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    autotune.reset_cache()
    yield path
    autotune.reset_cache()


@pytest.fixture()
def card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: CARD)


def test_shape_bucket_pow2():
    assert autotune.shape_bucket((100, 72, 96, 8)) == (128, 128, 128, 8)
    assert autotune.shape_bucket((1, 1024)) == (1, 1024)
    assert autotune.shape_bucket((1025,)) == (2048,)
    assert autotune.shape_bucket((0,)) == (1,)


def test_cache_key_namespaces_dtype_and_device(card):
    dims = (4096, 7)
    k32 = autotune.cache_key("spline_basis", dims, torch.float32, "cpu")
    k16 = autotune.cache_key("spline_basis", dims, torch.bfloat16, "cpu")
    kcard = autotune.cache_key("spline_basis", dims, torch.float32, "cuda")
    assert k32 == "spline_basis|4096x8|float32|cpu"
    assert k16 == "spline_basis|4096x8|bfloat16|cpu"
    assert kcard == f"spline_basis|4096x8|float32|{CARD}"
    assert len({k32, k16, kcard}) == 3
    with pytest.raises(ValueError, match="no kernels"):
        autotune.cache_key("spline_basis", dims, torch.float32, "meta")


def test_cache_path_is_the_ports_own(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    path = autotune.default_cache_path()
    assert path == os.path.join(str(tmp_path), ".cache", "repro_torch",
                                "autotune.json")
    assert path != jax_autotune.default_cache_path()
    # the JAX package's variable is not read
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    assert autotune.default_cache_path() == path


def test_cache_round_trip(tmp_cache):
    cache = autotune.get_cache()
    key = autotune.cache_key("spline_basis", (4096, 7), torch.float32, "cpu")
    cache.store(key, {"block_n": 512}, us=12.5)
    with open(tmp_cache) as f:
        raw = json.load(f)
    assert raw["schema"] == autotune.CACHE_SCHEMA_VERSION
    assert raw["entries"][key] == {"blocks": {"block_n": 512}, "us": 12.5}
    fresh = autotune.AutotuneCache(tmp_cache)
    assert fresh.lookup(key) == {"block_n": 512}
    assert not [f for f in os.listdir(os.path.dirname(tmp_cache))
                if f.endswith(".tmp")]


@pytest.mark.parametrize("text", ["not json{", '{"schema": 99, '
                                  '"entries": {"k": {"blocks": {}}}}',
                                  "[1, 2]"])
def test_corrupt_or_foreign_cache_file_ignored(tmp_cache, text):
    os.makedirs(os.path.dirname(tmp_cache), exist_ok=True)
    with open(tmp_cache, "w") as f:
        f.write(text)
    assert autotune.AutotuneCache(tmp_cache).lookup("k") is None


def test_interleaved_saves_merge_disjoint_keys(tmp_cache):
    c1 = autotune.AutotuneCache(tmp_cache)
    c2 = autotune.AutotuneCache(tmp_cache)
    assert c2.lookup("kern|64|float32|cpu") is None   # c2 loads (empty) now
    c1.store("kern|64|float32|cpu", {"block_n": 64}, us=1.0)
    c2.store("kern|128|float32|cpu", {"block_n": 128}, us=2.0)
    c1.store("kern|256|float32|cpu", {"block_n": 256}, us=3.0)
    fresh = autotune.AutotuneCache(tmp_cache)
    for n in (64, 128, 256):
        assert fresh.lookup(f"kern|{n}|float32|cpu") == {"block_n": n}
    # same-key conflict: the saving process's entry wins
    c2.store("kern|64|float32|cpu", {"block_n": 32}, us=0.5)
    assert autotune.AutotuneCache(tmp_cache).lookup(
        "kern|64|float32|cpu") == {"block_n": 32}


def test_clear_overwrites_instead_of_merging(tmp_cache):
    c = autotune.AutotuneCache(tmp_cache)
    c.store("a|1|float32|cpu", {"block_n": 64})
    c.clear()
    assert c.lookup("a|1|float32|cpu") is None
    c.store("b|1|float32|cpu", {"block_n": 128})
    fresh = autotune.AutotuneCache(tmp_cache)
    assert fresh.lookup("a|1|float32|cpu") is None
    assert fresh.lookup("b|1|float32|cpu") == {"block_n": 128}


def test_search_times_candidates_and_persists(tmp_cache):
    calls = []

    def run(block_n):
        calls.append(block_n)

    best = autotune.search("spline_basis", (300, 7), torch.float32, run,
                           [{"block_n": 64}, {"block_n": 128}],
                           device="cpu", reps=2)
    assert best in ({"block_n": 64}, {"block_n": 128})
    assert calls.count(64) == 3 and calls.count(128) == 3   # warm-up + 2
    key = autotune.cache_key("spline_basis", (300, 7), torch.float32, "cpu")
    assert autotune.AutotuneCache(tmp_cache).lookup(key) == best
    assert autotune.DISPATCH_LOG[-1] == ("spline_basis", key, best, "search")


def test_search_lets_a_failing_candidate_raise(tmp_cache):
    def run(block_n):
        if block_n == 128:
            raise RuntimeError("CUDA kernel spline_basis failed to launch")

    with pytest.raises(RuntimeError, match="failed to launch"):
        autotune.search("spline_basis", (300, 7), torch.float32, run,
                        [{"block_n": 64}, {"block_n": 128}], device="cpu",
                        reps=1)
    with pytest.raises(ValueError, match="no candidates"):
        autotune.search("spline_basis", (300, 7), torch.float32, run, [],
                        device="cpu")


def test_candidates_fit_the_card():
    """``block_n`` is inputs a block: powers of two from 256, none above
    n's bucket, and none whose output stretch overflows shared memory."""
    for n in (1, 100, 300, 4096, 10 ** 7):
        for nb in (3, 7, 20):
            cands = autotune.candidates_spline_basis(n, nb)
            assert cands
            for c in cands:
                sb_ops.check_block_n(c["block_n"], nb)
                assert sb_ops.kernel_smem(c["block_n"], nb) <= \
                    autotune.MAX_SMEM_BYTES
    assert autotune.candidates_spline_basis(1, 7) == [{"block_n": 256}]
    assert [c["block_n"] for c in autotune.candidates_spline_basis(300, 7)] \
        == [256, 512]
    # 4096 inputs of 20 bases (320 KB) do not fit; of 7 (112 KB) they do
    assert [c["block_n"] for c in autotune.candidates_spline_basis(
        10 ** 7, 20)] == [256, 512, 1024, 2048]
    assert [c["block_n"] for c in autotune.candidates_spline_basis(
        10 ** 7, 7)] == [256, 512, 1024, 2048, 4096]


def test_cpu_search_is_never_served_to_the_card(tmp_cache, card):
    spec = SplineSpec(4, 3)
    x = torch.linspace(-1.5, 1.5, 2432)
    best = autotune.tune_spline_basis(x, spec, reps=1)
    cpu_key = autotune.cache_key("spline_basis", (2432, 7), torch.float32,
                                 "cpu")
    assert autotune.AutotuneCache(tmp_cache).lookup(cpu_key) == best
    assert autotune.lookup_blocks("spline_basis", (2432, 7), torch.float32,
                                  "cuda") is None
    assert sb_ops.resolve_block_n(2432, 7, torch.float32,
                                  device="cuda") == sb_ops.DEFAULT_BLOCK_N
    assert sb_ops.resolve_block_n(2432, 7, torch.float32,
                                  device="cpu") == best["block_n"]


def test_cache_hit_is_logged_and_served(tmp_cache, card):
    key = autotune.cache_key("spline_basis", (5000, 7), torch.float32,
                             "cuda")
    autotune.get_cache().store(key, {"block_n": 128})
    assert sb_ops.resolve_block_n(5000, 7, torch.float32,
                                  device="cuda") == 128
    assert autotune.DISPATCH_LOG[-1] == ("spline_basis", key,
                                         {"block_n": 128}, "cache")
    # the same bucket is served the same entry
    assert sb_ops.resolve_block_n(8192, 7, torch.float32,
                                  device="cuda") == 128


def test_dispatch_log_is_bounded():
    for i in range(autotune._DISPATCH_LOG_MAX + 10):
        autotune.note_dispatch("k", f"key{i}", {"block_n": 64}, "cache")
    assert len(autotune.DISPATCH_LOG) == autotune._DISPATCH_LOG_MAX
    assert autotune.DISPATCH_LOG[-1][1] == \
        f"key{autotune._DISPATCH_LOG_MAX + 9}"
