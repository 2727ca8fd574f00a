"""Port parity: the encoder-decoder and prefix-VLM archs against the JAX
package.

Four reduced configs: ``whisper-medium`` (an encoder over stub frames,
cross-attention in every decoder block, LayerNorm, gelu MLP) and
``paligemma-3b`` (stub patches before the text, a prefix-LM mask,
GeGLU, ``embed_scale``, MQA), each as published and with the reference's
KAN drop-in (``ffn_kind="kan", pattern_rate=0.5``: every FFN, the
encoder's too, two KAN layers of kept bases ``(0, 2, 4, 5, 6)``).
Weights are the reference's ``jax.random`` draws carried across by
``convert.transformer_params_from_jax``; tokens and frames or patches
are numpy draws from a seed (``0.1 * N(0, 1)``, as the reference's
tests draw them).  The reference runs its jnp paths; on the CPU the
port's KAN layers run the fused-KAN kernel's plain version.

Tolerances: f32 within ``MODEL_TOL * (1 + max|ref|)``, ``MODEL_TOL =
1e-4`` (the same f32 ops in other summation orders); the loss within
``LOSS_TOL = 1e-5`` relative; bf16 within ``BF16_MODEL_TOL`` = 8 bf16
ulps of 1 + max|ref| for a reduced model and 2 for one module, as the
MoE and recurrent archs are held.  Greedy tokens of the serve steps
equal the reference's exactly at f32.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.configs.registry import ARCHS as J_ZOO  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import ffn as JF  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs.registry import ARCHS as T_ZOO  # noqa: E402
from repro_torch.convert import transformer_params_from_jax  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import ffn as TF  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.utils import leaf_paths  # noqa: E402

MODEL_TOL = 1e-4
LOSS_TOL = 1e-5
BF16_ULP = 2.0 ** -8
BF16_MODEL_TOL = 8 * BF16_ULP
BF16_MODULE_TOL = 2 * BF16_ULP
KAN = dict(ffn_kind="kan", pattern_rate=0.5)
CASES = {"whisper": ("whisper-medium", {}),
         "whisper-kan": ("whisper-medium", KAN),
         "paligemma": ("paligemma-3b", {}),
         "paligemma-kan": ("paligemma-3b", KAN)}


def close(got, ref, tol):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    scale = 1.0 + (float(np.abs(ref).max()) if ref.size else 0.0)
    assert err <= tol * scale, (err, tol * scale)


def cfgs(case, **over):
    name, kan = CASES[case]
    return (dataclasses.replace(J_ZOO[name].reduce(), **kan, **over),
            dataclasses.replace(T_ZOO[name].reduce(), **kan, **over))


def to_t(tree):
    return transformer_params_from_jax(jax.tree.map(np.asarray, tree))


def modality(cfg, batch, seed):
    """The stub a batch carries, as numpy: {"frames"|"patches": ...}."""
    x = 0.1 * np.random.default_rng(seed).normal(
        size=(batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return {"frames" if cfg.frontend == "audio" else "patches": x}


def j_kw(kw, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in kw.items()}


def t_kw(kw, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in kw.items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def model(request):
    jc, tc = cfgs(request.param)
    pj = JT.init_params(jax.random.key(0), jc)
    toks = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 8)).astype(np.int32)
    return request.param, jc, tc, pj, to_t(pj), toks, modality(jc, 2, 2)


def test_init_tree_equals_the_reference(model):
    """The port's own draw has the reference's paths, shapes and dtypes
    (encoder, cross-attention and ``frontend_proj`` leaves included)."""
    case, jc, tc, pj, pt, _, _ = model
    mine = TT.init_params(tc, torch.Generator().manual_seed(0))
    want = [(p, tuple(a.shape), str(a.dtype)) for p, a in leaf_paths(
        jax.tree.map(np.asarray, pj))]
    got = [(p, tuple(a.shape), str(a.dtype).split(".")[-1])
           for p, a in leaf_paths(mine)]
    assert got == want
    keys = set(mine)
    assert ("encoder" in keys) == jc.enc_dec
    assert "frontend_proj" in keys
    if jc.enc_dec:
        assert "cross" in mine["units"]["slot0"]


def test_convert_carries_every_leaf_as_it_is(model):
    case, jc, tc, pj, pt, _, _ = model
    jl = leaf_paths(jax.tree.map(np.asarray, pj))
    tl = leaf_paths(pt)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    assert any("encoder" in p or "cross" in p or "frontend_proj" in p
               for p, _ in tl)
    for (_, a), (_, b) in zip(jl, tl):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("case", ["whisper", "whisper-kan"])
def test_encode(case):
    jc, tc = cfgs(case)
    pj = JT.init_params(jax.random.key(3), jc)
    frames = modality(jc, 2, 4)["frames"]
    ref = JT.encode(pj, jc, jnp.asarray(frames))
    got = TT.encode(to_t(pj), tc, torch.from_numpy(frames))
    close(got, ref, MODEL_TOL)


def test_forward_hidden_and_aux(model):
    case, jc, tc, pj, pt, toks, kw = model
    hj, aj = JT.forward(pj, jc, jnp.asarray(toks), **j_kw(kw))
    ht, at = TT.forward(pt, tc, torch.from_numpy(toks), **t_kw(kw))
    extra = jc.n_frontend_tokens if jc.frontend == "vision" else 0
    assert ht.shape == (2, 8 + extra, tc.d_model)
    close(ht, hj, MODEL_TOL)
    assert float(at) == float(aj) == 0.0


def test_prefill_logits_and_caches(model):
    case, jc, tc, pj, pt, toks, kw = model
    lj, cj = JT.prefill(pj, jc, jnp.asarray(toks), max_len=12, **j_kw(kw))
    lt, ct = TT.prefill(pt, tc, torch.from_numpy(toks), max_len=12,
                        **t_kw(kw))
    close(lt, lj, MODEL_TOL)
    jl = leaf_paths(jax.tree.map(np.asarray, cj))
    tl = leaf_paths(ct)
    assert [(p, a.shape) for p, a in jl] == [(p, tuple(a.shape))
                                            for p, a in tl]
    if jc.enc_dec:
        assert any(p.endswith("['ck']") for p, _ in tl)
    for (p, a), (_, b) in zip(jl, tl):
        close(b, a, MODEL_TOL)


def test_two_decode_steps(model):
    """Teacher-forced on the reference's tokens: the cross-attention keys
    and values ride through, the self caches advance."""
    case, jc, tc, pj, pt, toks, kw = model
    lj, cj = JT.prefill(pj, jc, jnp.asarray(toks), max_len=12, **j_kw(kw))
    lt, ct = TT.prefill(pt, tc, torch.from_numpy(toks), max_len=12,
                        **t_kw(kw))
    for _ in range(2):
        tok = np.asarray(JT.greedy_token(lj))
        lj, cj = JT.decode_step(pj, jc, jnp.asarray(tok), cj)
        lt, ct = TT.decode_step(pt, tc, torch.from_numpy(tok.copy()), ct)
        close(lt, lj, MODEL_TOL)
    for (p, a), (_, b) in zip(leaf_paths(jax.tree.map(np.asarray, cj)),
                              leaf_paths(ct)):
        close(b, a, MODEL_TOL)


@pytest.mark.parametrize("variant", ["plain", "mask", "two_chunks"])
def test_lm_loss(model, variant):
    """The train step's loss, the gradient aside: ``forward`` then
    ``lm_loss`` over the text positions, with a mask and over 2 chunks."""
    case, jc, tc, pj, pt, toks, kw = model
    over = {"loss_chunks": 2} if variant == "two_chunks" else {}
    jc, tc = dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)
    labels = np.random.default_rng(5).integers(
        0, jc.vocab_size, toks.shape).astype(np.int32)
    mask = None
    if variant == "mask":
        mask = (np.random.default_rng(6).random(toks.shape) < 0.6).astype(
            np.float32)
    hj, _ = JT.forward(pj, jc, jnp.asarray(toks), **j_kw(kw))
    ht, _ = TT.forward(pt, tc, torch.from_numpy(toks), **t_kw(kw))
    S = toks.shape[1]
    ref = float(JT.lm_loss(pj, jc, hj[:, -S:], jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask)))
    got = TT.lm_loss(pt, tc, ht[:, -S:], torch.from_numpy(labels),
                     None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - ref) <= LOSS_TOL * abs(ref)


def test_lm_loss_refuses_chunks_that_do_not_tile(model):
    case, jc, tc, pj, pt, toks, kw = model
    jc, tc = (dataclasses.replace(c, loss_chunks=3) for c in (jc, tc))
    h = np.zeros((1, 8, jc.d_model), np.float32)
    lab = np.zeros((1, 8), np.int32)
    with pytest.raises(AssertionError):
        JT.lm_loss(pj, jc, jnp.asarray(h), jnp.asarray(lab))
    with pytest.raises(ValueError, match="chunks"):
        TT.lm_loss(pt, tc, torch.from_numpy(h), torch.from_numpy(lab))


def test_serve_steps_give_the_reference_tokens(model):
    """``make_prefill_step`` then three ``make_decode_step`` steps, each
    fed its own greedy token: the reference's tokens, exactly."""
    case, jc, tc, pj, pt, toks, kw = model
    jpre, jdec = JS.make_prefill_step(jc, None), JS.make_decode_step(jc,
                                                                     None)
    ffns = TT.ffn_modules(pt, tc)
    enc = TT.encoder_ffn_modules(pt, tc) if tc.enc_dec else None
    tpre = TS.make_prefill_step(tc, ffns=ffns, enc_ffns=enc)
    tdec = TS.make_decode_step(tc, ffns=ffns)
    jt, jcache = jpre(pj, {"tokens": jnp.asarray(toks), **j_kw(kw)})
    tt, tcache = tpre(pt, {"tokens": torch.from_numpy(toks), **t_kw(kw)})
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (2, 1)
    for _ in range(3):
        assert np.array_equal(np.asarray(jt), tt.numpy())
        jt, jcache = jdec(pj, {"token": jt, "caches": jcache})
        tt, tcache = tdec(pt, {"token": tt, "caches": tcache})
    assert np.array_equal(np.asarray(jt), tt.numpy())


def test_held_ffns_give_the_functional_bits(model):
    """``ffn_modules`` / ``encoder_ffn_modules`` hold a ``"kan"`` FFN as
    a ``KanPairFFN``: the same bits as ``ffn_apply``, every pass."""
    case, jc, tc, pj, pt, toks, kw = model
    ffns = TT.ffn_modules(pt, tc)
    enc = TT.encoder_ffn_modules(pt, tc) if tc.enc_dec else None
    kan = tc.ffn_kind == "kan"
    assert all(isinstance(f, TF.KanPairFFN) if kan else f is None
               for f in ffns + (enc or []))
    assert len(ffns) == tc.n_layers
    assert enc is None or len(enc) == tc.n_enc_layers
    t, k = torch.from_numpy(toks), t_kw(kw)
    a, _ = TT.forward(pt, tc, t, **k)
    b, _ = TT.forward(pt, tc, t, ffns=ffns, enc_ffns=enc, **k)
    assert torch.equal(a, b)
    la, ca = TT.prefill(pt, tc, t, **k)
    lb, cb = TT.prefill(pt, tc, t, ffns=ffns, enc_ffns=enc, **k)
    assert torch.equal(la, lb)
    tok = TT.greedy_token(la)
    assert torch.equal(TT.decode_step(pt, tc, tok, ca)[0],
                       TT.decode_step(pt, tc, tok, cb, ffns=ffns)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_in,n_out", [(64, 32), (32, 64)])
def test_kan_pair_ffn_against_the_reference(dtype, n_in, n_out):
    """One ``"kan"`` FFN module against the reference's ``ffn_apply``:
    f32 within ``MODEL_TOL``, bf16 within 2 ulps."""
    cfg = dict(d_model=n_in, d_ff=8 * n_out, kind="kan", pattern_rate=0.5)
    jcfg, tcfg = JF.FFNConfig(**cfg), TF.FFNConfig(**cfg)
    assert tcfg.kan_cfgs()[0].kb == (0, 2, 4, 5, 6)
    pj = JF.ffn_init(jax.random.key(7), jcfg, getattr(jnp, dtype))
    x = np.random.default_rng(8).normal(size=(3, 5, n_in)).astype(
        np.float32)
    ref = JF.ffn_apply(pj, jnp.asarray(x, dtype), jcfg)
    mod = TF.KanPairFFN(tcfg, to_t(pj))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = mod(tx)
    assert got.dtype == tx.dtype
    assert torch.equal(got, TF.ffn_apply(to_t(pj), tx, tcfg))
    close(got, ref, BF16_MODULE_TOL if dtype == "bfloat16" else MODEL_TOL)
    with pytest.raises(ValueError, match="kind='kan'"):
        TF.KanPairFFN(dataclasses.replace(tcfg, kind="mlp"), to_t(pj))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_model_against_the_reference(case):
    """bf16 params and stubs: forward, prefill and a decode step within
    ``BF16_MODEL_TOL`` (teacher-forced on the reference's token)."""
    jc, tc = cfgs(case, dtype="bfloat16")
    pj = JT.init_params(jax.random.key(9), jc)
    pt = to_t(pj)
    toks = np.random.default_rng(10).integers(
        0, jc.vocab_size, (2, 6)).astype(np.int32)
    kw = modality(jc, 2, 11)
    jk, tk = j_kw(kw, jnp.bfloat16), t_kw(kw, torch.bfloat16)
    hj, _ = JT.forward(pj, jc, jnp.asarray(toks), **jk)
    ht, _ = TT.forward(pt, tc, torch.from_numpy(toks), **tk)
    assert ht.dtype == torch.bfloat16
    close(ht, hj, BF16_MODEL_TOL)
    lj, cj = JT.prefill(pj, jc, jnp.asarray(toks), **jk)
    lt, ct = TT.prefill(pt, tc, torch.from_numpy(toks), **tk)
    close(lt, lj, BF16_MODEL_TOL)
    assert all(str(b.dtype).endswith(str(np.asarray(a).dtype))
               for (_, a), (_, b) in zip(leaf_paths(cj), leaf_paths(ct)))
    tok = np.asarray(JT.greedy_token(lj))
    lj, _ = JT.decode_step(pj, jc, jnp.asarray(tok), cj)
    lt, _ = TT.decode_step(pt, tc, torch.from_numpy(tok.copy()), ct)
    close(lt, lj, BF16_MODEL_TOL)


def test_whisper_checkpoint_round_trip(tmp_path):
    """Reduced whisper params saved by the port restore in both packages,
    every leaf (encoder and cross-attention too) as it was."""
    jc, tc = cfgs("whisper-kan")
    params = TT.init_params(tc, torch.Generator().manual_seed(12))
    save_checkpoint(str(tmp_path), 3, {"params": params})
    back, step, _ = restore_checkpoint(str(tmp_path), {"params": params})
    assert step == 3
    pairs = list(zip(leaf_paths(back["params"]), leaf_paths(params)))
    assert pairs and all(p == q and torch.equal(a, b)
                         for (p, a), (q, b) in pairs)
    jp = JT.init_params(jax.random.key(0), jc)
    restored, step, _ = j_restore(str(tmp_path), {"params": jp})
    assert step == 3
    for (p, a), (q, b) in zip(leaf_paths(jax.tree.map(
            np.asarray, restored["params"])), leaf_paths(params)):
        assert p == q and np.array_equal(np.asarray(a), b.numpy())
