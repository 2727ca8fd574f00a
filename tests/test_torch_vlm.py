"""The prefix-VLM and encoder-decoder archs' own behaviour, port against
reference: paligemma's prefix-LM mask and its prefill, cached decode
against the full passes, and token-only serving's refusal.

paligemma's ``forward`` attends over its patches bidirectionally
(``prefix_len`` into every block); its ``prefill`` is causal over them,
because the reference's ``block_prefill`` passes no ``prefix_len`` to
``prefill_cache``.  The port copies that and these tests pin it on both
packages.  So paligemma's decode is held against a longer prefill, and
whisper's against ``forward``, each within the reference's own 2e-3
(``tests/test_arch_smoke.py``).  Weights are the reference's draws
carried across by ``convert.transformer_params_from_jax``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import ARCHS as J_ZOO  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs.registry import ARCHS as T_ZOO  # noqa: E402
from repro_torch.convert import transformer_params_from_jax  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime.backends import TransformerBackend  # noqa: E402
from repro_torch.runtime.server import Server  # noqa: E402

MODEL_TOL = 1e-4
DECODE_TOL = 2e-3
KAN = dict(ffn_kind="kan", pattern_rate=0.5)


def pair(name, **over):
    jc = dataclasses.replace(J_ZOO[name].reduce(), **over)
    tc = dataclasses.replace(T_ZOO[name].reduce(), **over)
    pj = JT.init_params(jax.random.key(0), jc)
    return jc, tc, pj, transformer_params_from_jax(
        jax.tree.map(np.asarray, pj))


def stub(cfg, seed, batch=2):
    return (0.1 * np.random.default_rng(seed).normal(
        size=(batch, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)


def gap(a, b):
    """max |a - b| over 1 + max |b|."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (1.0 + float(np.abs(b).max()))


@pytest.mark.parametrize("over", [{}, KAN], ids=["geglu", "kan"])
def test_prefix_is_bidirectional_in_forward_and_causal_in_prefill(over):
    """Changing the last patch moves the first patch's hidden state in
    ``forward`` and leaves the first position's cached keys in
    ``prefill`` as they were, in both packages; the port's values equal
    the reference's."""
    jc, tc, pj, pt = pair("paligemma-3b", **over)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size,
                                             (2, 5)).astype(np.int32)
    a = stub(jc, 2)
    b = a.copy()
    b[:, -1] += 1.0
    hj = [np.asarray(JT.forward(pj, jc, jnp.asarray(toks),
                                patches=jnp.asarray(p))[0]) for p in (a, b)]
    ht = [TT.forward(pt, tc, torch.from_numpy(toks),
                     patches=torch.from_numpy(p))[0].numpy() for p in (a, b)]
    for h in (hj, ht):
        assert np.abs(h[0][:, 0] - h[1][:, 0]).max() > 1e-4
    assert gap(ht[0], hj[0]) <= MODEL_TOL and gap(ht[1], hj[1]) <= MODEL_TOL
    kj = [np.asarray(JT.prefill(pj, jc, jnp.asarray(toks),
                                patches=jnp.asarray(p))[1]["units"]["slot0"]
                     ["k"]) for p in (a, b)]
    kt = [TT.prefill(pt, tc, torch.from_numpy(toks),
                     patches=torch.from_numpy(p))[1]["units"]["slot0"]["k"]
          .numpy() for p in (a, b)]
    for k in (kj, kt):
        # (unit, batch, position, kv head, hd): position 0 of the last
        # layer saw only itself
        assert np.array_equal(k[0][-1, :, 0], k[1][-1, :, 0])
        assert np.abs(k[0][-1, :, -17] - k[1][-1, :, -17]).max() > 1e-4
    assert gap(kt[0], kj[0]) <= MODEL_TOL


@pytest.mark.parametrize("over", [{}, KAN], ids=["geglu", "kan"])
def test_paligemma_decode_equals_a_longer_prefill(over):
    jc, tc, pj, pt = pair("paligemma-3b", **over)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tc.vocab_size, (2, 9)).astype(np.int32))
    patches = torch.from_numpy(stub(tc, 4))
    _, caches = TT.prefill(pt, tc, toks[:, :4], patches=patches)
    for t in range(4, 9):
        lg, caches = TT.decode_step(pt, tc, toks[:, t:t + 1], caches)
        want, _ = TT.prefill(pt, tc, toks[:, :t + 1], patches=patches)
        assert gap(lg.numpy(), want.numpy()) <= DECODE_TOL


@pytest.mark.parametrize("over", [{}, KAN], ids=["mlp", "kan"])
def test_whisper_decode_equals_forward(over):
    """Cached decode (self caches and the cross-attention keys and values
    of the prefill's memory) against ``forward``'s logits, position by
    position, as the reference's ``test_decode_matches_forward``."""
    jc, tc, pj, pt = pair("whisper-medium", **over)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tc.vocab_size, (2, 10)).astype(np.int32))
    frames = torch.from_numpy(stub(tc, 6))
    h, _ = TT.forward(pt, tc, toks, frames=frames)
    full = TT._logits(pt, tc, h)
    lg, caches = TT.prefill(pt, tc, toks[:, :4], frames=frames, max_len=12)
    assert gap(lg[:, 0].numpy(), full[:, 3].numpy()) <= DECODE_TOL
    for t in range(4, 10):
        lg, caches = TT.decode_step(pt, tc, toks[:, t:t + 1], caches)
        assert gap(lg[:, 0].numpy(), full[:, t].numpy()) <= DECODE_TOL


@pytest.mark.parametrize("name", ["whisper-medium", "paligemma-3b"])
def test_token_only_serving_refuses_the_modality_archs(name):
    """``TransformerBackend`` and ``Server`` refuse them with the
    reference launcher's reason; the model functions build them."""
    cfg = T_ZOO[name].reduce()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    caches = TT.init_caches(cfg, 2, 8)
    assert ("ck" in caches["units"]["slot0"]) == cfg.enc_dec
    for make in (lambda: TransformerBackend(cfg, params, device="cpu"),
                 lambda: Server(cfg, params, device="cpu")):
        with pytest.raises(NotImplementedError,
                           match=r"needs modality inputs \(frames/patches\)"):
            make()


@pytest.mark.parametrize("argv", [
    ["--arch", "whisper-medium", "--ffn", "kan", "--pattern", "0.5"],
    ["--arch", "paligemma-3b"]])
def test_steps_launcher_on_the_cpu(argv, capsys):
    """``python -m repro_torch.launch.steps``: a prefill step then greedy
    decode steps, the same tokens on a rerun; CUDA refused here."""
    from repro_torch.launch import steps as TS

    out = TS.main([*argv, "--device", "cpu"])
    assert np.array(out["tokens"]).shape == (TS.BATCH, 1 + TS.NEW_TOKENS)
    assert out["launches"] == {}
    assert TS.main([*argv, "--device", "cpu"])["tokens"] == out["tokens"]
    text = capsys.readouterr().out
    assert "a prefill step of" in text and "request 0:" in text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TS.main(argv)
