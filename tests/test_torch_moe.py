"""Port parity: the Mixture-of-Experts layer (``models/moe.py``) against
the JAX package.

Weights are the reference's ``jax.random`` draws carried across by
``convert.transformer_params_from_jax``; inputs are numpy draws from a
seed.  The reference runs its one-device path (no mesh), KAN experts
through its ``impl="jnp"`` KAN layer; on the CPU the port's KAN experts
run the fused-KAN kernel's plain version.  f32 within ``TOL * (1 +
max|ref|)``, ``TOL = 1e-5`` (the same f32 ops, other summation orders);
the aux loss within ``TOL`` of 1 + |ref|.  bf16 against the reference's
bf16 run within ``BF16_TOL`` = two bf16 ulps (each expert's output and
the combine round to bf16 in both; XLA may keep a fused chain in f32).
Routing is exact: the same experts picked, ties to the lower index, and
the same tokens dropped at capacity.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro_torch.convert import transformer_params_from_jax  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.utils import leaf_paths  # noqa: E402

TOL = 1e-5
BF16_TOL = 2 * 2.0 ** -8

SWIGLU = dict(d_model=32, d_ff=48, n_experts=4, top_k=2)
SCOUT = dict(d_model=32, d_ff=48, n_experts=4, top_k=1, shared_expert=True)
KAN = dict(d_model=32, d_ff=64, n_experts=4, top_k=2, ffn_kind="kan")


def close(got, ref, tol=TOL):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    scale = 1.0 + float(np.abs(ref).max())
    assert err <= tol * scale, (err, tol * scale)


def to_t(tree):
    return transformer_params_from_jax(jax.tree.map(np.asarray, tree))


def _run(kw, dtype, T=12, seed=0):
    cj, ct = JM.MoEConfig(**kw), TM.MoEConfig(**kw)
    pj = JM.moe_init_with_shared(jax.random.key(seed), cj,
                                 getattr(jnp, dtype))
    x = np.random.default_rng(seed).normal(size=(2, T // 2, kw["d_model"]))
    x = x.astype(np.float32)
    rj = JM.moe_apply(pj, jnp.asarray(x, dtype), cj)
    rt = TM.moe_apply(to_t(pj), torch.from_numpy(x).to(getattr(torch, dtype)),
                      ct)
    assert rt["out"].dtype == getattr(torch, dtype)
    assert rt["aux_loss"].dtype == torch.float32
    return rj, rt


def _check(rj, rt, dtype):
    close(rt["out"], rj["out"], BF16_TOL if dtype == "bfloat16" else TOL)
    close(rt["aux_loss"], rj["aux_loss"], TOL)
    assert float(rt["aux_loss"]) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [SWIGLU, SCOUT, KAN],
                         ids=["swiglu", "scout_top1_shared", "kan"])
def test_moe_apply(kw, dtype):
    _check(*_run(kw, dtype), dtype)


@pytest.mark.parametrize("kw", [SWIGLU, KAN], ids=["swiglu", "kan"])
def test_kan_expert_module_and_decode_batch(kw):
    """A held ``KanExperts`` gives the functional form's bits; and a
    decode-sized batch (T = 1, under top-k capacity) equals the
    reference's."""
    _check(*_run(kw, "float32", T=2, seed=3), "float32")
    if kw.get("ffn_kind") != "kan":
        return
    cj, ct = JM.MoEConfig(**kw), TM.MoEConfig(**kw)
    pt = to_t(JM.moe_init_with_shared(jax.random.key(1), cj))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 5, 32)).astype(np.float32))
    held = TM.KanExperts(ct, pt["experts"])
    a = TM.moe_apply(pt, x, ct)
    b = TM.moe_apply(pt, x, ct, experts=held)
    assert torch.equal(a["out"], b["out"])


def _drops(out):
    """Tokens whose every pick was dropped (out exactly 0 at top-1)."""
    flat = np.asarray(jnp.asarray(out, jnp.float32)).reshape(-1, 32) \
        if not torch.is_tensor(out) else out.float().reshape(-1, 32).numpy()
    return set(np.nonzero(~flat.any(-1))[0].tolist())


@pytest.mark.parametrize("kind", ["swiglu", "kan"])
def test_capacity_drops_the_reference_tokens(kind):
    """Many tokens, few experts, a small capacity factor: tokens are
    dropped, the same ones in both."""
    kw = dict(d_model=32, d_ff=48 if kind == "swiglu" else 64, n_experts=2,
              top_k=1, capacity_factor=0.25, ffn_kind=kind)
    rj, rt = _run(kw, "float32", T=64, seed=5)
    _check(rj, rt, "float32")
    dj, dt = _drops(rj["out"]), _drops(rt["out"])
    assert dj == dt and len(dj) >= 16


def _tie_router(p):
    """A router whose experts 1 and 2 get bitwise equal logits, above the
    others', for every token with x . v > 0 (v = column 1)."""
    k = p["router"]["kernel"]
    v = jnp.abs(k[:, 1])
    k = jnp.zeros_like(k).at[:, 1].set(v).at[:, 2].set(v)
    return {**p, "router": {**p["router"], "kernel": k}}


@pytest.mark.parametrize("kind", ["swiglu", "kan"])
def test_bf16_router_tie_takes_the_lower_expert(kind):
    kw = dict(d_model=32, d_ff=48 if kind == "swiglu" else 64, n_experts=4,
              top_k=1, ffn_kind=kind)
    cj, ct = JM.MoEConfig(**kw), TM.MoEConfig(**kw)
    pj = _tie_router(JM.moe_init_with_shared(jax.random.key(6), cj,
                                             jnp.bfloat16))
    x = np.abs(np.random.default_rng(6).normal(size=(1, 8, 32))).astype(
        np.float32)
    rj = JM.moe_apply(pj, jnp.asarray(x, jnp.bfloat16), cj)
    rt = TM.moe_apply(to_t(pj), torch.from_numpy(x).to(torch.bfloat16), ct)
    _check(rj, rt, "bfloat16")
    # every token tied 1 against 2 and went to 1: only expert 1's output
    # (or a drop at capacity) appears
    pt = to_t(pj)
    xt = torch.from_numpy(x[0]).to(torch.bfloat16)
    logits = TM.dense(pt["router"], xt).float()
    assert torch.equal(logits[:, 1], logits[:, 2])
    _, top_e = TM._route(torch.softmax(logits, -1), 1)
    assert bool((top_e[:, 0] == 1).all())


def test_route_breaks_ties_as_lax_top_k():
    rng = np.random.default_rng(7)
    probs = rng.integers(0, 4, size=(64, 8)).astype(np.float32) / 4
    for K in (1, 2, 3, 8):
        vj, ej = jax.lax.top_k(jnp.asarray(probs), K)
        pt, et = TM._route(torch.from_numpy(probs), K)
        assert np.array_equal(et.numpy(), np.asarray(ej))
        close(pt, vj / jnp.sum(vj, -1, keepdims=True))


@pytest.mark.parametrize("T", [1, 7, 8, 64, 200])
def test_capacities_equal_the_reference(T):
    for kw in (SWIGLU, KAN, dict(SCOUT, capacity_factor=0.3)):
        cj, ct = JM.MoEConfig(**kw), TM.MoEConfig(**kw)
        assert ct.capacity(T) == cj.capacity(T)


@pytest.mark.parametrize("kw", [SWIGLU, SCOUT, KAN],
                         ids=["swiglu", "scout_top1_shared", "kan"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_equals_the_reference(kw, dtype):
    pt = TM.moe_init_with_shared(torch.Generator().manual_seed(0),
                                 TM.MoEConfig(**kw), getattr(torch, dtype))
    pj = JM.moe_init_with_shared(jax.random.key(0), JM.MoEConfig(**kw),
                                 getattr(jnp, dtype))
    ref = jax.tree_util.tree_flatten_with_path(pj)[0]
    got = leaf_paths(pt)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        assert tuple(a.shape) == b.shape
        # the reference's kan_init scales its bf16 draw of t by a float64
        # numpy scalar, which widens t to f32, and the port's draws t in
        # f32 too; a bf16 server casts it back
        widened = dtype == "bfloat16" and path.endswith("['t']")
        assert jnp.dtype(b.dtype).name == ("float32" if widened else dtype)
        assert str(a.dtype).split(".")[-1] == jnp.dtype(b.dtype).name


def test_widened_bf16_groups_give_the_whole_stack_product(monkeypatch):
    """bf16 experts widen a group at a time: a group of one expert gives
    bitwise the product of the whole stack widened at once."""
    cj = JM.MoEConfig(**SWIGLU)
    pt = to_t(JM.moe_init_with_shared(jax.random.key(8), cj, jnp.bfloat16))
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 6, 32)).astype(np.float32)).to(torch.bfloat16)
    ct = TM.MoEConfig(**SWIGLU)
    whole = TM.moe_apply(pt, x, ct)["out"]
    monkeypatch.setattr(TM, "WIDEN_BYTES", 1)
    assert torch.equal(TM.moe_apply(pt, x, ct)["out"], whole)


def test_expert_widths_equal_the_reference():
    for d_ff in (64, 1536, 8):
        kw = dict(KAN, d_ff=d_ff)
        up, down = TM.MoEConfig(**kw).kan_cfgs()
        pj = JM.moe_init(jax.random.key(0), dataclasses.replace(
            JM.MoEConfig(**kw), d_model=8, n_experts=1))
        assert up.n_out == down.n_in == pj["experts"]["up"]["w_b"].shape[-1]
