"""Port parity: the LM token pipeline (``data/lm``) against the JAX
package's, on the CPU.  Both are numpy: every batch must be byte-equal
(dtype, shape and bytes) for any seed, step, shard count and shard."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import lm as J  # noqa: E402
from repro_torch.data import lm as P  # noqa: E402


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _cfgs(mod, vocab, seq, batch, seed, n_shards):
    return [mod.LMDataConfig(vocab_size=vocab, seq_len=seq,
                             global_batch=batch, seed=seed,
                             n_shards=n_shards, shard_id=s)
            for s in range(n_shards)]


@pytest.mark.parametrize("vocab,seq,batch,seed,n_shards", [
    (64, 16, 4, 0, 1), (151936, 33, 8, 7, 2), (256, 128, 12, 3, 3),
    (1000, 1, 4, 12345, 4)])
def test_synthetic_lm_byte_equal(vocab, seq, batch, seed, n_shards):
    for jc, pc in zip(_cfgs(J, vocab, seq, batch, seed, n_shards),
                      _cfgs(P, vocab, seq, batch, seed, n_shards)):
        js, ps = J.SyntheticLM(jc), P.SyntheticLM(pc)
        assert pc.shard_batch == jc.shard_batch
        for step in (0, 1, 5, 999, 2 ** 31 + 3):
            jb, pb = js.batch_at(step), ps.batch_at(step)
            assert sorted(pb) == sorted(jb) == ["tokens"]
            _same(pb["tokens"], jb["tokens"])
        for jb, pb, _ in zip(iter(js), iter(ps), range(3)):
            _same(pb["tokens"], jb["tokens"])


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_file_lm_byte_equal(tmp_path, n_shards):
    path = tmp_path / "tokens.bin"
    rng = np.random.default_rng(n_shards)
    rng.integers(0, 300, size=5000, dtype=np.uint32).tofile(path)
    for jc, pc in zip(_cfgs(J, 257, 20, 6, 0, n_shards),
                      _cfgs(P, 257, 20, 6, 0, n_shards)):
        jf, pf = J.FileLM(jc, str(path)), P.FileLM(pc, str(path))
        for step in (0, 1, 7, 100, 12345):
            _same(pf.batch_at(step)["tokens"], jf.batch_at(step)["tokens"])
        for jb, pb, _ in zip(iter(jf), iter(pf), range(3)):
            _same(pb["tokens"], jb["tokens"])
    # make_source picks the file source for a path, else the synthetic one
    pc = _cfgs(P, 257, 20, 6, 0, 1)[0]
    assert isinstance(P.make_source(pc, str(path)), P.FileLM)
    assert isinstance(P.make_source(pc), P.SyntheticLM)
    with pytest.raises(AssertionError):
        P.FileLM(P.LMDataConfig(vocab_size=8, seq_len=5000,
                                global_batch=1), str(path))


def test_prefetcher_byte_equal_and_ordered():
    jc, pc = (m.LMDataConfig(vocab_size=50, seq_len=8, global_batch=2,
                             seed=5) for m in (J, P))
    jp = J.Prefetcher(J.SyntheticLM(jc), start_step=3, depth=2)
    pp = P.Prefetcher(P.SyntheticLM(pc), start_step=3, depth=2)
    try:
        for want in range(3, 9):
            (js, jb), (ps, pb) = next(jp), next(pp)
            assert js == ps == want
            _same(pb["tokens"], jb["tokens"])
    finally:
        jp.close()
        pp.close()


def test_shards_are_disjoint_streams():
    a, b = (P.SyntheticLM(c) for c in _cfgs(P, 151936, 64, 8, 0, 2))
    assert not np.array_equal(a.batch_at(0)["tokens"],
                              b.batch_at(0)["tokens"])
    with pytest.raises(AssertionError):
        P.LMDataConfig(vocab_size=8, seq_len=4, global_batch=3,
                       n_shards=2).shard_batch
