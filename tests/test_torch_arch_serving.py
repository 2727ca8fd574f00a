"""Port parity: the MoE, RG-LRU and xLSTM archs served end to end, against
the JAX package.

Five reduced configs: ``qwen3-moe-235b-a22b`` (SwiGLU experts, and with
``ffn_kind="kan"``: KAN experts), ``llama4-scout-17b-a16e`` (top-1 and a
shared expert), ``recurrentgemma-9b`` (``rec, rec, attn``) and
``xlstm-125m`` (``mlstm, slstm``).  Weights are the reference's
``jax.random`` draws carried across by ``convert.transformer_params_
from_jax``; prompts are numpy draws from a seed.  The reference runs its
jnp paths; on the CPU the port's KAN experts run the fused-KAN kernel's
plain version.

Tolerances: f32 forward, prefill and decode within ``MODEL_TOL * (1 +
max|ref|)``, ``MODEL_TOL = 1e-4`` (the same f32 ops in other summation
orders, and the RG-LRU's associative scan against a loop); the aux loss
within ``1e-5 * (1 + |ref|)`` at f32 (at bf16 the router reads a
residual stream already bf16 ulps apart: ``BF16_MODEL_TOL``); cached
decode against the full forward within the reference's own 2e-3
(``tests/test_arch_smoke.py``).  bf16 against the reference's bf16 run
within ``BF16_MODEL_TOL`` = 8 bf16 ulps of 1 + max|ref| (each of a
reduced model's bf16 roundings in series may land an ulp apart, and XLA
may keep a fused bf16 chain in f32).
Greedy ``Server`` tokens equal the reference's exactly at f32; at bf16,
teacher-forced on the reference's tokens, the port's logits are within
``BF16_MODEL_TOL`` and its served tokens equal the reference's up to the
first position where the reference's top-2 margin is within twice that,
or where a MoE router's top-k margin is within ``NEAR_TIE`` of a tie
(past it the two may route a token differently: not a rounding apart).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.configs.registry import ARCHS as J_ZOO  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime.server import Server as JServer  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs.registry import ARCHS as T_ZOO  # noqa: E402
from repro_torch.convert import transformer_params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime.backends import splice_cache  # noqa: E402
from repro_torch.runtime.server import Server  # noqa: E402
from repro_torch.utils import leaf_paths  # noqa: E402

MODEL_TOL = 1e-4
AUX_TOL = 1e-5
DECODE_TOL = 2e-3
BF16_MODEL_TOL = 8 * 2.0 ** -8
# a router's relative top-k margin below two bf16 ulps of a unit logit
NEAR_TIE = 2 * 2.0 ** -7
SLOTS, MAX_LEN, NEW = 4, 32, 6

CASES = {
    "qwen3-moe": ("qwen3-moe-235b-a22b", False),
    "qwen3-moe-kan": ("qwen3-moe-235b-a22b", True),
    "llama4-scout": ("llama4-scout-17b-a16e", False),
    "recurrentgemma": ("recurrentgemma-9b", False),
    "xlstm": ("xlstm-125m", False),
}


def close(got, ref, tol):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    scale = 1.0 + float(np.abs(ref).max())
    assert err <= tol * scale, (err, tol * scale)
    return err / scale


@functools.lru_cache(maxsize=None)
def setup(case, dtype="float32"):
    """(reference cfg, port cfg, reference params, port params)."""
    name, kan = CASES[case]
    over = {"dtype": dtype, **({"ffn_kind": "kan"} if kan else {})}
    jc = dataclasses.replace(J_ZOO[name].reduce(), **over)
    tc = dataclasses.replace(T_ZOO[name].reduce(), **over)
    pj = JT.init_params(jax.random.key(0), jc)
    return jc, tc, pj, transformer_params_from_jax(
        jax.tree.map(np.asarray, pj))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _tol(dtype):
    return BF16_MODEL_TOL if dtype == "bfloat16" else MODEL_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_hidden_and_aux(case, dtype):
    jc, tc, pj, pt = setup(case, dtype)
    tok = _tokens(jc, (2, 10), 1)
    hj, aj = JT.forward(pj, jc, jnp.asarray(tok))
    ht, at = TT.forward(pt, tc, torch.from_numpy(tok))
    assert ht.dtype == getattr(torch, dtype) and at.dtype == torch.float32
    close(ht, hj, _tol(dtype))
    # at bf16 the router reads a residual stream already bf16 ulps apart
    close(at, aj, AUX_TOL if dtype == "float32" else BF16_MODEL_TOL)
    assert (float(at) > 0) == (jc.n_experts > 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_logits(case, dtype):
    """A 5-token prefill, then three decode steps on each package's own
    caches, every logit against the reference's."""
    jc, tc, pj, pt = setup(case, dtype)
    tok = _tokens(jc, (2, 8), 2)
    lj, cj = JT.prefill(pj, jc, jnp.asarray(tok[:, :5]), max_len=16)
    lt, ct = TT.prefill(pt, tc, torch.from_numpy(tok[:, :5]), max_len=16)
    assert [p for p, _ in leaf_paths(ct)] == [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(cj)[0]]
    close(lt, lj, _tol(dtype))
    for t in range(5, 8):
        lj, cj = JT.decode_step(pj, jc, jnp.asarray(tok[:, t:t + 1]), cj)
        lt, ct = TT.decode_step(pt, tc, torch.from_numpy(tok[:, t:t + 1]),
                                ct)
        assert lt.dtype == torch.float32
        close(lt, lj, _tol(dtype))


@pytest.mark.parametrize("name,n_layers", [("recurrentgemma-9b", 5),
                                            ("xlstm-125m", 3)])
def test_remainder_layers_after_the_units(name, n_layers):
    """Layers past the last whole pattern unit sit under ``"extra"``
    (recurrentgemma-9b's 38 layers are 12 units and 2 extra): forward,
    prefill and decode against the reference's at such a depth."""
    jc = dataclasses.replace(J_ZOO[name].reduce(), n_layers=n_layers)
    tc = dataclasses.replace(T_ZOO[name].reduce(), n_layers=n_layers)
    pj = JT.init_params(jax.random.key(5), jc)
    pt = transformer_params_from_jax(jax.tree.map(np.asarray, pj))
    assert len(pt["extra"]) == n_layers % len(tc.pattern) > 0
    tok = _tokens(jc, (2, 7), 6)
    close(TT.forward(pt, tc, torch.from_numpy(tok))[0],
          JT.forward(pj, jc, jnp.asarray(tok))[0], MODEL_TOL)
    lj, cj = JT.prefill(pj, jc, jnp.asarray(tok[:, :5]), max_len=12)
    lt, ct = TT.prefill(pt, tc, torch.from_numpy(tok[:, :5]), max_len=12)
    close(lt, lj, MODEL_TOL)
    for t in (5, 6):
        lj, cj = JT.decode_step(pj, jc, jnp.asarray(tok[:, t:t + 1]), cj)
        lt, ct = TT.decode_step(pt, tc, torch.from_numpy(tok[:, t:t + 1]),
                                ct)
        close(lt, lj, MODEL_TOL)


@pytest.mark.parametrize("case", ["recurrentgemma", "xlstm"])
def test_decode_matches_forward(case):
    """Cached decode reproduces the full forward position by position,
    within the reference's own tolerance for its own model."""
    _, tc, _, pt = setup(case)
    tok = torch.from_numpy(_tokens(tc, (2, 10), 3))
    h, _ = TT.forward(pt, tc, tok)
    full = TT._logits(pt, tc, h)
    _, caches = TT.prefill(pt, tc, tok[:, :4], max_len=12)
    got = []
    for t in range(4, 10):
        lg, caches = TT.decode_step(pt, tc, tok[:, t:t + 1], caches)
        got.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(),
                               full[:, 4:10].numpy(), atol=DECODE_TOL,
                               rtol=DECODE_TOL)


def _prompts(cfg):
    rng = np.random.default_rng(4)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 12)))
            .astype(np.int32) for _ in range(SLOTS)]


def _serve(server, prompts):
    rids = [server.submit(p, max_new_tokens=NEW) for p in prompts]
    out = server.run_until_done()
    return [out[r] for r in rids]


@pytest.mark.parametrize("case", sorted(CASES))
def test_server_tokens_equal_the_reference_at_f32(case):
    jc, tc, pj, pt = setup(case)
    prompts = _prompts(jc)
    want = _serve(JServer(jc, pj, n_slots=SLOTS, max_len=MAX_LEN), prompts)
    srv = Server(tc, pt, n_slots=SLOTS, max_len=MAX_LEN, device="cpu")
    assert _serve(srv, prompts) == want
    assert srv.backend.batch_report(SLOTS) is None


def _teacher_ref(backend, prompts, toks):
    """The reference's logits with its served tokens fed back: each
    prompt prefilled into its lane, then lockstep decode steps, as its
    Server runs them (through the backend's own compiled prefill and
    decode).  [(SLOTS, V) per position]."""
    caches = backend.init_state(SLOTS, MAX_LEN)
    out = []
    for s, p in enumerate(prompts):
        lg, c = backend._prefill_fn(p.shape[0])(backend.params,
                                                jnp.asarray(p[None]))
        out.append(lg[0, -1])

        def put(full, new, s=s):
            for d in range(min(2, full.ndim)):
                if full.shape[d] == SLOTS and new.shape[d] == 1:
                    sl = tuple([slice(None)] * d + [slice(s, s + 1)])
                    return full.at[sl].set(new.astype(full.dtype))
            return full

        caches = jax.tree.map(put, caches, c)
    steps = [jnp.stack(out)]
    for t in range(NEW - 1):
        tok = jnp.asarray([[g[t]] for g in toks], jnp.int32)
        lg, caches = backend._decode(backend.params, tok, caches)
        steps.append(lg[:, -1])
    return [np.asarray(s, np.float32) for s in steps]


def _teacher_port(backend, prompts, toks, margins):
    """The port's logits as ``_teacher_ref`` feeds them, and where each
    request stops being held: the first position at or after a MoE
    router decision within ``NEAR_TIE`` of a tie that reaches it (its
    own prefill, or any decode step: a batched step's capacity is
    shared).  ``margins`` is the list a patched ``moe._route`` appends
    each call's smallest relative top-k margin to."""
    caches = TT.init_caches(backend.cfg, SLOTS, MAX_LEN)
    out, held = [], []
    for s, p in enumerate(prompts):
        margins.clear()
        lg, c = TT.prefill(backend.params, backend.cfg,
                           torch.from_numpy(p[None]), max_len=MAX_LEN,
                           ffns=backend.ffns)
        out.append(lg[0, -1])
        caches = splice_cache(caches, c, s)
        held.append(0 if min(margins, default=1.0) < NEAR_TIE else NEW)
    steps = [torch.stack(out)]
    for t in range(NEW - 1):
        margins.clear()
        tok = torch.tensor([[g[t]] for g in toks], dtype=torch.int32)
        lg, caches = TT.decode_step(backend.params, backend.cfg, tok, caches,
                                    ffns=backend.ffns)
        steps.append(lg[:, -1])
        if min(margins, default=1.0) < NEAR_TIE:
            held = [min(h, t + 1) for h in held]
    return steps, held


@pytest.mark.parametrize("case", sorted(CASES))
def test_server_tokens_at_bf16_against_the_reference_bf16(case,
                                                          monkeypatch):
    """Teacher-forced on the reference's bf16 tokens.  A request is held
    up to the first position a MoE router decision within ``NEAR_TIE``
    of a tie reaches (there a bf16 ulp of the router's input may pick
    another expert or drop another token: a different result rather
    than a rounding apart, which the caches carry on)."""
    jc, tc, pj, pt = setup(case)
    prompts = _prompts(jc)
    jsrv = JServer(jc, pj, n_slots=SLOTS, max_len=MAX_LEN, precision="bf16")
    want = _serve(jsrv, prompts)
    srv = Server(tc, pt, n_slots=SLOTS, max_len=MAX_LEN, precision="bf16",
                 device="cpu")
    got = _serve(srv, prompts)
    assert srv.backend.params["embed"]["table"].dtype == torch.bfloat16
    ref = _teacher_ref(jsrv.backend, prompts, want)
    margins = []
    route = TM._route

    def logged(probs, K):
        v = torch.sort(probs, dim=-1, descending=True).values
        margins.append(float(((v[:, K - 1] - v[:, K]) / v[:, K - 1]).min()))
        return route(probs, K)

    monkeypatch.setattr(TM, "_route", logged)
    port, held = _teacher_port(srv.backend, prompts, want, margins)
    assert sum(held) >= SLOTS * NEW // 2, held
    # served tokens agree before a request's first position whose
    # reference top-2 margin is within twice the tolerance
    clear_until = list(held)
    for t, (lr, lp) in enumerate(zip(ref, port)):
        lp = lp.float().numpy()
        for r in range(SLOTS):
            if t >= held[r]:
                continue
            close(lp[r], lr[r], BF16_MODEL_TOL)
            assert lr[r].argmax() == want[r][t]
            top2 = np.sort(lr[r])[-2:]
            if top2[1] - top2[0] > 2 * BF16_MODEL_TOL * (
                    1.0 + np.abs(lr[r]).max()):
                assert int(lp[r].argmax()) == want[r][t]
            elif clear_until[r] == held[r]:
                clear_until[r] = t
    for r in range(SLOTS):
        n = clear_until[r]
        assert got[r][:n] == want[r][:n], (r, n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_checkpoint_round_trip(tmp_path, case):
    """The port's params tree saved in the reference's layout: restored
    bit for bit by the port and by the reference."""
    _, tc, pj, pt = setup(case)
    save_checkpoint(str(tmp_path), 3, {"params": pt})
    like = TT.init_params(tc, torch.Generator().manual_seed(1))
    back, step, _ = restore_checkpoint(str(tmp_path), {"params": like})
    assert step == 3
    got, want = leaf_paths(back["params"]), leaf_paths(pt)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for (_, a), (_, b) in zip(got, want))
    restored, _, _ = j_restore(str(tmp_path), {"params": pj})
    for a, b in zip(jax.tree_util.tree_leaves(restored["params"]),
                    jax.tree_util.tree_leaves(pj)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-scout-17b-a16e",
                                  "recurrentgemma-9b", "xlstm-125m"])
def test_launcher_serves_the_arch_at_smoke_scale(capsys, tmp_path, arch):
    srv = tserve.main(["--device", "cpu", "--requests", "3",
                       "--new-tokens", "3", "--arch", arch])
    out = capsys.readouterr().out
    assert "3 requests" in out and "simulated VIKIN" not in out
    assert srv.stats["served"] == 3 and srv.backend.plan is None
    cfg = T_ZOO[arch].reduce()
    params = TT.init_params(cfg, torch.Generator().manual_seed(9))
    save_checkpoint(str(tmp_path), 2, {"params": params})
    srv = tserve.main(["--device", "cpu", "--requests", "2",
                       "--new-tokens", "2", "--arch", arch, "--ckpt-dir",
                       str(tmp_path)])
    assert "restored params from step 2" in capsys.readouterr().out
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(leaf_paths(srv.params), leaf_paths(params)))


def test_kan_expert_layers_hold_their_experts_fused_once():
    """A KAN-expert arch's backend holds one ``KanExperts`` a MoE layer,
    each expert's fused rows the ``[w_b ; t]`` of its params."""
    _, tc, _, pt = setup("qwen3-moe-kan")
    srv = Server(tc, pt, n_slots=2, max_len=16, device="cpu")
    mods = srv.backend.ffns
    assert len(mods) == tc.n_layers and all(m is not None for m in mods)
    e = pt["units"]["slot0"]["moe"]["experts"]["up"]
    wt = mods[1].wt_up[3].reshape(tc.d_model, -1, mods[1].wt_up.shape[-1])
    assert torch.equal(wt[:, 0], e["w_b"][1, 3])
    assert torch.equal(wt[:, 1:], e["t"][1, 3])
    _, tc, _, pt = setup("qwen3-moe")
    assert all(m is None for m in Server(tc, pt, n_slots=2, max_len=16,
                                         device="cpu").backend.ffns)
