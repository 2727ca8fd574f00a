"""Port parity: the transformer models against the JAX package.

Layers, attention and whole decoder-only models on the CPU, where the
port's kernels run their plain versions.  Weights are the reference's
``jax.random`` draws carried across by ``convert.transformer_params_
from_jax`` (bf16 leaves bit for bit); inputs are numpy draws from a seed.

Tolerance ``TOL * (1 + max|ref|)`` with ``TOL = 1e-5`` in f32: both
packages compute the same f32 ops (norms, f32-accumulated products,
softmax) and differ only in summation order and in a few ulps of
``exp``/``sin``/``pow``.  Whole models sum more of them, so they are held
to ``MODEL_TOL = 1e-4``.  bf16 results within one bf16 ulp of their
magnitude (``2**-8 * (1 + max|ref|)``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.convert import transformer_params_from_jax  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

TOL = 1e-5
MODEL_TOL = 1e-4
BF16_ULP = 2.0 ** -8


def close(got, ref, tol=TOL):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    scale = 1.0 + (float(np.abs(ref).max()) if ref.size else 0.0)
    assert err <= tol * scale, (err, tol * scale)


def to_t(tree):
    return transformer_params_from_jax(jax.tree.map(np.asarray, tree))


def f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("offset", [0.0, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(offset, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = BF16_ULP if dtype == "bfloat16" else TOL
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)}, tx, offset=offset)
    ref = JL.rmsnorm({"scale": jnp.asarray(scale)}, jx, offset=offset)
    assert got.dtype == tx.dtype
    close(got, f32(ref), tol)
    got = TL.layernorm({"scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)}, tx)
    ref = JL.layernorm({"scale": jnp.asarray(scale),
                        "bias": jnp.asarray(bias)}, jx)
    close(got, f32(ref), tol)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_accumulates_in_f32_and_rounds_once(bias, dtype):
    p = JL.dense_init(jax.random.key(1), 24, 40, bias=bias,
                      dtype=getattr(jnp, dtype))
    if bias:
        p["bias"] = p["bias"] + jnp.asarray(0.3, p["bias"].dtype)
    x = np.random.default_rng(1).normal(size=(2, 7, 24)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    ref = JL.dense(p, jx)
    got = TL.dense(to_t(p), torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    close(got, f32(ref), BF16_ULP if dtype == "bfloat16" else TOL)


def test_embed_unembed_rope_softcap_gelu_acts_count():
    pj = JL.embed_init(jax.random.key(2), 50, 16)
    pt = to_t(pj)
    toks = np.array([[3, 1, 49, 0]], np.int32)
    close(TL.embed(pt, torch.from_numpy(toks)), f32(JL.embed(pj, toks)), 0)
    h = np.random.default_rng(2).normal(size=(1, 4, 16)).astype(np.float32)
    got = TL.unembed(pt, torch.from_numpy(h))
    assert got.dtype == torch.float32
    close(got, f32(JL.unembed(pj, jnp.asarray(h))))
    for hd, base in ((16, 1e4), (64, 1e6)):
        close(TL.rope_freqs(hd, base), f32(JL.rope_freqs(hd, base)))
    x = np.random.default_rng(3).normal(size=(2, 6, 3, 8)).astype(np.float32)
    pos = np.arange(6)[None, :]
    close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
          f32(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)))
    v = np.linspace(-9, 9, 101).astype(np.float32)
    close(TL.softcap(torch.from_numpy(v), 5.0),
          f32(JL.softcap(jnp.asarray(v), 5.0)))
    assert TL.softcap(torch.from_numpy(v), None) is not None
    for name in ("relu", "gelu", "silu"):
        close(TL.ACT_FNS[name](torch.from_numpy(v)),
              f32(JL.ACT_FNS[name](jnp.asarray(v))))
    close(TL.gelu(torch.from_numpy(v)), f32(JL.gelu(jnp.asarray(v))))
    tree = {"a": [pj, {"b": jnp.zeros((3, 2))}]}
    assert TL.count_params(to_t(tree)) == JL.count_params(tree)


# ------------------------------------------------------------- attention
ATTN_CASES = {
    "gqa": dict(d_model=32, n_heads=4, n_kv_heads=2),
    "mha_bias": dict(d_model=32, n_heads=4, n_kv_heads=4, qkv_bias=True),
    "mqa_head_dim": dict(d_model=32, n_heads=4, n_kv_heads=1, head_dim=16),
    "qk_norm_softcap": dict(d_model=32, n_heads=4, n_kv_heads=2,
                            qk_norm=True, logit_softcap=3.0),
    "window": dict(d_model=32, n_heads=4, n_kv_heads=2, window=4),
    "encoder": dict(d_model=32, n_heads=4, n_kv_heads=2, causal=False),
}


def _attn_pair(kw, seed=0):
    jc = JA.AttnConfig(**kw)
    tc = TA.AttnConfig(**kw)
    pj = JA.attn_init(jax.random.key(seed), jc)
    if kw.get("qkv_bias"):
        pj = jax.tree.map(lambda a: a + 0.05, pj)
    return jc, tc, pj, to_t(pj)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("chunked", [False, True])
def test_attention_direct_and_chunked(case, chunked):
    jc, tc, pj, pt = _attn_pair(ATTN_CASES[case])
    x = np.random.default_rng(4).normal(size=(2, 16, 32)).astype(np.float32)
    kw = dict(chunk_threshold=8, q_block=4, k_block=8) if chunked else {}
    ref = JA.attention(pj, jnp.asarray(x), jc, **kw)
    got = TA.attention(pt, torch.from_numpy(x), tc, **kw)
    close(got, f32(ref))


def test_chunked_attention_equals_direct_in_the_port():
    _, tc, _, pt = _attn_pair(ATTN_CASES["gqa"])
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 24, 32)).astype(np.float32))
    close(TA.attention(pt, x, tc, chunk_threshold=4, q_block=8, k_block=6),
          TA.attention(pt, x, tc).numpy())


@pytest.mark.parametrize("case", ["gqa", "qk_norm_softcap", "mha_bias"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_then_decode_against_the_reference(case, kv_quant):
    kw = dict(ATTN_CASES[case], kv_quant=kv_quant)
    jc, tc, pj, pt = _attn_pair(kw)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    yj, cj = JA.prefill_cache(pj, jnp.asarray(x), jc, 12)
    yt, ct = TA.prefill_cache(pt, torch.from_numpy(x), tc, 12)
    close(yt, f32(yj))
    for k in cj:
        close(ct[k], f32(cj[k]), 0 if k in ("len", "k", "v") and kv_quant
              else TOL)
    for _ in range(4):
        x1 = rng.normal(size=(2, 1, 32)).astype(np.float32)
        yj, cj = JA.decode_step(pj, jnp.asarray(x1), jc, cj)
        yt, ct = TA.decode_step(pt, torch.from_numpy(x1), tc, ct)
        close(yt, f32(yj))
    assert ct["len"].tolist() == np.asarray(cj["len"]).tolist()


def test_window_ring_buffer_over_more_than_window_steps():
    """A window of 4 served over 11 decode steps at per-row positions:
    the ring wraps twice, and rows sit at different lengths."""
    jc, tc, pj, pt = _attn_pair(ATTN_CASES["window"])
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 6, 32)).astype(np.float32)     # S > window
    yj, cj = JA.prefill_cache(pj, jnp.asarray(x), jc, 4)
    yt, ct = TA.prefill_cache(pt, torch.from_numpy(x), tc, 4)
    close(yt, f32(yj))
    close(ct["k"], f32(cj["k"]))
    # a second lane at another position
    cj = jax.tree.map(lambda a: jnp.concatenate([a, a[:, ...] * 0], 0)
                      if a.ndim > 1 else jnp.asarray([6, 2], jnp.int32), cj)
    ct = {k: torch.cat([v, v * 0]) if v.dim() > 1
          else torch.tensor([6, 2], dtype=torch.int32) for k, v in ct.items()}
    for _ in range(11):
        x1 = rng.normal(size=(2, 1, 32)).astype(np.float32)
        yj, cj = JA.decode_step(pj, jnp.asarray(x1), jc, cj)
        yt, ct = TA.decode_step(pt, torch.from_numpy(x1), tc, ct)
        close(yt, f32(yj))
    close(ct["k"], f32(cj["k"]))


def test_decode_leaves_its_input_cache_as_it_was():
    _, tc, _, pt = _attn_pair(ATTN_CASES["gqa"])
    x = torch.randn((1, 3, 32), generator=torch.Generator().manual_seed(0))
    _, cache = TA.prefill_cache(pt, x, tc, 8)
    before = {k: v.clone() for k, v in cache.items()}
    TA.decode_step(pt, x[:, :1], tc, cache)
    assert all(torch.equal(before[k], cache[k]) for k in cache)


def test_kv_quant_round_trip_and_reference():
    x = np.random.default_rng(8).normal(size=(2, 3, 2, 8)).astype(np.float32)
    qj, sj = JA._kv_quant(jnp.asarray(x))
    qt, st = TA._kv_quant(torch.from_numpy(x))
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    close(TA._kv_dequant(qt, st, torch.float32),
          f32(JA._kv_dequant(qj, sj, jnp.float32)))


def test_cross_attention():
    kw = ATTN_CASES["gqa"]
    jc, tc = JA.AttnConfig(**kw), TA.AttnConfig(**kw)
    pj = JA.cross_attn_init(jax.random.key(3), dataclasses.replace(
        jc, qk_norm=True))
    assert "q_norm" not in pj
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    mem = rng.normal(size=(2, 7, 32)).astype(np.float32)
    close(TA.cross_attention(to_t(pj), torch.from_numpy(x),
                             torch.from_numpy(mem), tc),
          f32(JA.cross_attention(pj, jnp.asarray(x), jnp.asarray(mem), jc)))
    assert "q_norm" not in TA.cross_attn_init(
        None, dataclasses.replace(tc, qk_norm=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_over_given_keys_and_values(dtype):
    """A prefill caches ``cross_kv`` and attends over the same tensors:
    the same bits as projecting the memory inside ``cross_attention``."""
    tc = TA.AttnConfig(**ATTN_CASES["gqa"])
    dt = getattr(torch, dtype)
    p = {k: {n: a.to(dt) for n, a in v.items()} for k, v in
         TA.cross_attn_init(torch.Generator().manual_seed(4), tc).items()}
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 5, 32), generator=g).to(dt)
    mem = torch.randn((2, 7, 32), generator=g).to(dt)
    k, v = TA.cross_kv(p, mem, tc)
    assert k.shape == v.shape == (2, 7, tc.n_kv_heads, tc.hd)
    assert k.dtype == v.dtype == dt
    assert torch.equal(TA.cross_attention(p, x, mem, tc, kv=(k, v)),
                       TA.cross_attention(p, x, mem, tc))


# ---------------------------------------------------------- whole models
MODEL_ARCHS = ["qwen2-0.5b", "qwen1.5-0.5b", "mistral-nemo-12b",
               "granite-20b", "kanffn-ci", "qwen2-0.5b-kanffn"]


def _cfgs(name, **over):
    if name in jreg.KANFFN_ARCHS:
        jc, tc = jreg.KANFFN_ARCHS[name], treg.KANFFN_ARCHS[name]
    else:
        jc, tc = jreg.ARCHS[name], treg.ARCHS[name]
    if name != "kanffn-ci":
        jc, tc = jc.reduce(**over), tc.reduce(**over)
    return jc, tc


@pytest.fixture(scope="module", params=MODEL_ARCHS)
def model(request):
    jc, tc = _cfgs(request.param)
    pj = JT.init_params(jax.random.key(0), jc)
    return request.param, jc, tc, pj, to_t(pj)


def test_params_layout(model):
    name, jc, tc, pj, pt = model
    assert ("units" in pt) == (jc.ffn_kinds is None)
    assert len(pt["extra"]) == len(pj["extra"])
    assert TL.count_params(pt) == JL.count_params(pj)
    port = TT.init_params(tc, torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), pj)
    mine = jax.tree.map(lambda a: (tuple(a.shape),
                                   str(a.dtype).split(".")[-1]), port)
    assert mine == shapes


def test_forward_prefill_decode_against_the_reference(model):
    name, jc, tc, pj, pt = model
    toks = np.random.default_rng(10).integers(
        0, jc.vocab_size, (2, 7)).astype(np.int32)
    taps_j, taps_t = {}, {}
    hj, _ = JT.forward(pj, jc, jnp.asarray(toks), ffn_taps=taps_j)
    ht, aux = TT.forward(pt, tc, torch.from_numpy(toks), ffn_taps=taps_t)
    close(ht, f32(hj), MODEL_TOL)
    assert float(aux) == 0.0 and sorted(taps_t) == sorted(taps_j)
    for i in taps_j:
        close(taps_t[i], f32(taps_j[i]), MODEL_TOL)
    lj, cj = JT.prefill(pj, jc, jnp.asarray(toks), max_len=24)
    lt, ct = TT.prefill(pt, tc, torch.from_numpy(toks), max_len=24)
    close(lt, f32(lj), MODEL_TOL)
    assert (jax.tree.map(lambda a: a.shape, cj)
            == jax.tree.map(lambda a: tuple(a.shape), ct))
    for _ in range(3):       # teacher-forced: the reference's tokens
        tok = np.asarray(JT.greedy_token(lj))
        lj, cj = JT.decode_step(pj, jc, jnp.asarray(tok), cj)
        lt, ct = TT.decode_step(pt, tc, torch.from_numpy(tok), ct)
        close(lt, f32(lj), MODEL_TOL)


def test_decode_equals_forward_within_the_port(model):
    """Cached decode of each next token == the full forward's logits at
    that position (the same ops on other shapes: within MODEL_TOL)."""
    name, jc, tc, pj, pt = model
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, tc.vocab_size, (2, 9)).astype(np.int32))
    h, _ = TT.forward(pt, tc, toks)
    full = TT._logits(pt, tc, h)
    lg, caches = TT.prefill(pt, tc, toks[:, :4], max_len=16)
    close(lg[:, 0], full[:, 3].numpy(), MODEL_TOL)
    for t in range(4, 9):
        lg, caches = TT.decode_step(pt, tc, toks[:, t:t + 1], caches)
        close(lg[:, 0], full[:, t].numpy(), MODEL_TOL)


def test_prepared_ffns_give_the_functional_bits(model):
    name, jc, tc, pj, pt = model
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, tc.vocab_size, (1, 5)).astype(np.int32))
    ffns = TT.ffn_modules(pt, tc)
    assert sum(f is not None for f in ffns) == (
        0 if tc.ffn_kinds is None else tc.ffn_kinds.count("kan"))
    a, _ = TT.forward(pt, tc, toks)
    b, _ = TT.forward(pt, tc, toks, ffns=ffns)
    assert torch.equal(a, b)


def test_bf16_model_against_the_reference():
    jc, tc = _cfgs("qwen2-0.5b", dtype="bfloat16")
    pj = JT.init_params(jax.random.key(1), jc)
    pt = to_t(pj)
    toks = np.random.default_rng(13).integers(0, jc.vocab_size,
                                              (2, 6)).astype(np.int32)
    hj, _ = JT.forward(pj, jc, jnp.asarray(toks))
    ht, _ = TT.forward(pt, tc, torch.from_numpy(toks))
    assert ht.dtype == torch.bfloat16
    # two layers of bf16 roundings, each one ulp apart at most
    close(ht, f32(hj), 2 * tc.n_layers * BF16_ULP)


def test_bf16_leaves_convert_bitwise():
    jc = jreg.KANFFN_ARCHS["qwen2-0.5b-kanffn"].reduce(dtype="bfloat16")
    pj = JT.init_params(jax.random.key(2), jc)
    pt = to_t(pj)
    leaves_j = jax.tree_util.tree_leaves(pj)
    leaves_t = jax.tree_util.tree_leaves(pt)
    assert len(leaves_j) == len(leaves_t)
    n_bf16 = 0
    for a, b in zip(leaves_j, leaves_t):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            n_bf16 += 1
            assert b.dtype == torch.bfloat16
            assert np.array_equal(a.view(np.int16), b.view(torch.int16)
                                  .numpy())
        else:
            assert np.array_equal(a, b.numpy())
    assert n_bf16 > 0


# --------------------------------------------------------------- configs
def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_registry_names_and_fields_equal_the_reference():
    assert sorted(treg.ARCHS) == sorted(jreg.ARCHS)
    assert sorted(treg.KANFFN_ARCHS) == sorted(jreg.KANFFN_ARCHS)
    for reg_t, reg_j in ((treg.ARCHS, jreg.ARCHS),
                         (treg.KANFFN_ARCHS, jreg.KANFFN_ARCHS)):
        for name in reg_j:
            t, j = reg_t[name], reg_j[name]
            assert _fields(t) == _fields(j), name
            assert _fields(t.reduce()) == _fields(j.reduce()), name
            assert t.param_dtype == getattr(torch, j.dtype)
            for layer in range(j.n_layers):
                assert t.layer_ffn_kind(layer) == j.layer_ffn_kind(layer)
                ft, fj = t.ffn_cfg(layer), j.ffn_cfg(layer)
                assert _fields(ft) == _fields(fj), (name, layer)
            assert _fields(t.attn_cfg()) == _fields(j.attn_cfg())
            assert _fields(t.enc_attn_cfg()) == _fields(j.enc_attn_cfg())
            assert _fields(t.xlstm_cfg()) == _fields(j.xlstm_cfg())
            assert _fields(t.rglru_cfg()) == _fields(j.rglru_cfg())
            if t.is_moe:
                assert _fields(t.moe_cfg()) == _fields(j.moe_cfg())
                assert t.moe_cfg().capacity(100) == j.moe_cfg().capacity(100)
            assert (t.hd, t.pattern, t.subquadratic) == (
                j.hd, j.pattern, j.subquadratic)
    assert treg.runnable_cells() == jreg.runnable_cells()
    assert treg.runnable_cells(True) == jreg.runnable_cells(True)
    assert {k: _fields(v) for k, v in tbase.SHAPES.items()} == {
        k: _fields(v) for k, v in jbase.SHAPES.items()}
    assert _fields(treg.get_shape("decode_32k")) == _fields(
        jreg.get_shape("decode_32k"))
    for name in ["vikin-mixed", "kanffn-ci", "qwen2-0.5b-kanffn",
                 "granite-20b"]:
        ft, ct = treg.get_serving_config(name)
        fj, cj = jreg.get_serving_config(name)
        assert ft == fj and _fields(ct) == _fields(cj)
    for bad in (lambda r: r.get_config("nope"),
                lambda r: r.get_serving_config("nope")):
        with pytest.raises(KeyError):
            bad(treg)
    assert _fields(treg.get_config("qwen2-0.5b")) == _fields(
        jreg.get_config("qwen2-0.5b"))


BAD_CONFIGS = {
    "masks_without_kinds": dict(ffn_masks=(None,)),
    "kinds_length": dict(ffn_kinds=("kan",), scan_layers=False),
    "unknown_kind": dict(ffn_kinds=("kan", "lstm"), scan_layers=False),
    "moe_without_experts": dict(ffn_kinds=("moe", "kan"),
                                scan_layers=False),
    "kan_without_dff": dict(ffn_kinds=("kan", "mlp"), d_ff=0,
                            scan_layers=False),
    "scan_layers": dict(ffn_kinds=("kan", "mlp")),
    "masks_length": dict(ffn_kinds=("kan", "mlp"), scan_layers=False,
                         ffn_masks=(None,)),
    "mask_on_mlp": dict(ffn_kinds=("kan", "mlp"), scan_layers=False,
                        ffn_masks=(None, ((0,), (1,)))),
    "mask_not_pair": dict(ffn_kinds=("kan", "mlp"), scan_layers=False,
                          ffn_masks=(((0,),), None)),
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_arch_config_errors_equal_the_reference(case):
    base = dict(name="bad", family="dense", n_layers=2, d_model=16,
                n_heads=2, n_kv_heads=1, d_ff=32, vocab_size=64)
    kw = {**base, **BAD_CONFIGS[case]}
    with pytest.raises(jbase.ArchConfigError) as ej:
        jbase.ArchConfig(**kw)
    with pytest.raises(tbase.ArchConfigError) as et:
        tbase.ArchConfig(**kw)
    assert str(et.value) == str(ej.value)
    assert issubclass(tbase.ArchConfigError, ValueError)
