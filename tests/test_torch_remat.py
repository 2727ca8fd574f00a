"""Port parity: activation checkpointing (``models/layers.remat``, the
reference's ``jax.checkpoint``) in the LM train step, on the CPU.

The port checkpoints where the reference does: each Q block and each KV
step of the chunked attention and each chunk of ``lm_loss``, always;
each stacked unit of the decoder and each encoder layer when
``cfg.remat``.  Checkpointing changes what the backward keeps, never a
number:

* the chunked attention's gradient (``d x``, ``d params``) within
  ``TOL * (1 + max|ref|)`` (``TOL = 1e-5``, the attention tolerance of
  ``tests/test_torch_transformer.py``) of ``jax.grad`` of the
  reference's at the same knobs, and of the port's direct path;
* ``lm_loss``'s gradient with 4 chunks, dense and tied heads, within
  ``TOL`` of ``jax.grad`` of the reference's;
* ``forward`` + ``lm_loss`` (``steps.value_and_grad``) with ``remat`` on
  and off: the loss and every gradient leaf bitwise, on seven reduced
  archs that cover every block kind, their attention chunked; on three,
  against the reference's ``jax.grad`` with ``remat=True`` within the
  LM-train tolerances of ``tests/test_torch_lm_train.py`` (loss 1e-6
  relative, each leaf ``1e-5 * (1 + max|ref|)``);
* what the backward keeps (``torch.autograd.graph.saved_tensors_hooks``):
  no (q_block, k_block) score block, no chunk's logits, fewer bytes a
  step with ``remat``;
* the serve paths (a prefill and decode steps under ``no_grad``) never
  call ``torch.utils.checkpoint``;
* one 2x2 spawn of gloo ranks, both activation modes: each rank's loss
  and gradient slices bitwise with ``remat`` on and off, and its
  collectives, FLOPs and kernel counts those of the abstract mesh
  (``launch/dryrun``), with the recompute in both.
"""
import dataclasses
import functools
import json
import textwrap

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _mesh_parity import env as _env  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.convert import transformer_params_from_jax  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.utils import leaf_from_numpy, leaf_paths, tree_map  # noqa

TOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
KAN = {"ffn_kind": "kan", "pattern_rate": 0.5}
CHUNKED = dict(chunk_threshold=8, q_block=4, k_block=8)
B, S = 2, 16


def _close(got, ref, tol, what=""):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * (1.0 + float(np.abs(ref).max())), (what, err)


def _jflat(tree):
    return {jtu.keystr(p): v for p, v in jtu.tree_flatten_with_path(tree)[0]}


def _to_t(tree):
    return transformer_params_from_jax(jax.tree.map(np.asarray, tree))


@pytest.fixture
def counted_checkpoints(monkeypatch):
    """The calls of ``torch.utils.checkpoint.checkpoint`` (``remat``'s)."""
    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    return calls


# ------------------------------------------------------ chunked attention

ATTN = {"gqa": dict(d_model=32, n_heads=4, n_kv_heads=2),
        "qk_norm_softcap": dict(d_model=32, n_heads=4, n_kv_heads=2,
                                qk_norm=True, logit_softcap=3.0),
        "window": dict(d_model=32, n_heads=4, n_kv_heads=2, window=4),
        "encoder": dict(d_model=32, n_heads=4, n_kv_heads=2, causal=False)}


@pytest.mark.parametrize("case", sorted(ATTN))
def test_chunked_attention_grad(case, counted_checkpoints):
    """d x and d params of the checkpointed chunked attention (4 Q blocks
    x 2 KV blocks) against ``jax.grad`` of the reference's at the same
    knobs, and against the port's direct path."""
    kw = ATTN[case]
    jc, tc = JA.AttnConfig(**kw), TA.AttnConfig(**kw)
    pj = JA.attn_init(jax.random.key(1), jc)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, 32)).astype(np.float32)
    cot = rng.standard_normal((B, S, 32)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(JA.attention(p, xx, jc, **CHUNKED) * cot)

    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(pj, jnp.asarray(x))

    def port(**knobs):
        pt = _to_t(pj)
        leaves = [v.requires_grad_(True) for _, v in leaf_paths(pt)]
        xt = torch.from_numpy(x).requires_grad_(True)
        y = TA.attention(pt, xt, tc, **knobs)
        (y * torch.from_numpy(cot)).sum().backward()
        return xt.grad, {k: v.grad for (k, _), v in
                         zip(leaf_paths(pt), leaves)}

    gx, gp = port(**CHUNKED)
    # 4 Q blocks and their 2 KV steps each, and the KV steps again in
    # each Q block's recompute
    assert len(counted_checkpoints) == 4 + 4 * 2 + 4 * 2
    _close(gx, gx_j, TOL, "dx")
    jf = _jflat(gp_j)
    assert sorted(gp) == sorted(jf)
    for k, v in jf.items():
        _close(gp[k], v, TOL, k)
    gx_d, gp_d = port()                      # S <= 2048: the direct path
    _close(gx, gx_d.numpy(), TOL, "dx direct")
    for k, v in gp_d.items():
        _close(gp[k], v.numpy(), TOL, f"{k} direct")


# ---------------------------------------------------------------- lm_loss

@pytest.mark.parametrize("tied", [False, True], ids=["dense", "tied"])
def test_lm_loss_grad_matches_reference(tied, counted_checkpoints):
    over = dict(loss_chunks=4, tied_embeddings=tied)
    jcfg = dataclasses.replace(j_get_config("qwen2-0.5b").reduce(), **over)
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduce(), **over)
    pj = JT.init_params(jax.random.key(0), jcfg)
    head = {k: pj[k] for k in (("embed",) if tied else ("lm_head",))}
    rng = np.random.default_rng(3)
    h = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    jl, (gp_j, gh_j) = jax.value_and_grad(
        lambda p, hh: JT.lm_loss(p, jcfg, hh, jnp.asarray(labels),
                                 jnp.asarray(mask)), argnums=(0, 1))(
        head, jnp.asarray(h))
    pt = _to_t(head)
    leaves = [v.requires_grad_(True) for _, v in leaf_paths(pt)]
    ht = torch.from_numpy(h).requires_grad_(True)
    loss = TT.lm_loss(pt, tcfg, ht, torch.from_numpy(labels),
                      torch.from_numpy(mask))
    loss.backward()
    assert len(counted_checkpoints) == 4
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _close(ht.grad, gh_j, TOL, "d hidden")
    jf = _jflat(gp_j)
    got = {k: v.grad for (k, _), v in zip(leaf_paths(pt), leaves)}
    assert sorted(got) == sorted(jf)
    for k, v in jf.items():
        _close(got[k], v, TOL, k)


# ------------------------------------------- forward + lm_loss, on and off

# (name, registry arch, reduce() overrides): every block kind
SEVEN = [("qwen2", "qwen2-0.5b", {}),
         ("qwen3-moe", "qwen3-moe-235b-a22b", {}),
         ("rgemma", "recurrentgemma-9b", {}),
         ("xlstm", "xlstm-125m", {}),
         ("whisper", "whisper-medium", {}),
         ("paligemma", "paligemma-3b", {}),
         ("qwen2-kan", "qwen2-0.5b", KAN)]


def _batch(cfg, seed=0):
    """Tokens (B, S+1) and the arch's frames or patches, 0.1 N(0, 1), as
    numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (B, S + 1)).astype(np.int32)}
    for k, spec in SP.frontend_specs(cfg, B).items():
        out[k] = (0.1 * rng.standard_normal(tuple(spec.shape))).astype(
            np.float32)
    return out


def _bits(tree):
    return [(k, v.dtype, v.reshape(-1).view(torch.uint8).numpy().tobytes())
            for k, v in leaf_paths(tree)]


@pytest.fixture
def chunked(monkeypatch):
    """Every self-attention of the models through the chunked path."""
    monkeypatch.setattr(TA, "attention",
                        functools.partial(TA.attention, **CHUNKED))


@pytest.mark.parametrize("name,arch,over", SEVEN, ids=[a[0] for a in SEVEN])
def test_remat_on_and_off_bitwise(name, arch, over, chunked,
                                  counted_checkpoints):
    base = dataclasses.replace(ARCHS[arch].reduce(), loss_chunks=4, **over)
    params = TT.init_params(base, torch.Generator().manual_seed(0))
    batch = {k: leaf_from_numpy(v) for k, v in _batch(base).items()}
    inputs, labels, kw = ST._split_batch(base, batch)
    got, forward_calls = {}, {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        counted_checkpoints.clear()
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        h, _ = TT.forward(live, cfg, inputs, **kw)
        TT.lm_loss(live, cfg, h[:, -labels.shape[1]:], labels)
        forward_calls[remat] = len(counted_checkpoints)
        got[remat] = ST.value_and_grad(cfg, ST.StepOptions(), params, batch)
    # the forward's extra checkpoints: one a stacked unit and encoder layer
    n_units = TT._unit_counts(base)[0] if "units" in params else 0
    want = n_units + base.n_enc_layers
    assert want > 0 and forward_calls[True] - forward_calls[False] == want
    (t0, c0, g0), (t1, c1, g1) = got[False], got[True]
    assert _bits({"t": t0, "c": c0}) == _bits({"t": t1, "c": c1})
    assert _bits(g0) == _bits(g1)


@pytest.mark.parametrize("name,arch,over",
                         [SEVEN[2], SEVEN[4], SEVEN[6]],
                         ids=["rgemma", "whisper", "qwen2-kan"])
def test_remat_matches_reference_grad(name, arch, over):
    """``jax.grad`` of the reference's ``forward`` + ``lm_loss`` (+ aux)
    with ``remat=True``, every unit and encoder layer under
    ``jax.checkpoint``, against the port's with ``remat=True``."""
    over = dict(over, remat=True, loss_chunks=2)
    jcfg = dataclasses.replace(j_get_config(arch).reduce(), **over)
    tcfg = dataclasses.replace(get_config(arch).reduce(), **over)
    jopts, topts = JS.StepOptions(), ST.StepOptions()
    pj = JS.init_train_state(jax.random.key(0), jcfg, jopts)["params"]
    batch = _batch(tcfg)
    inputs, labels, kw = JS._split_batch(
        jcfg, {k: jnp.asarray(v) for k, v in batch.items()})

    def loss_fn(p):
        h, aux = JT.forward(p, jcfg, inputs, **kw)
        ce = JT.lm_loss(p, jcfg, h[:, -labels.shape[1]:], labels)
        return ce + jopts.aux_weight * aux, ce

    (jtot, jce), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(pj)
    ttot, tce, tg = ST.value_and_grad(
        tcfg, topts, _to_t(pj), {k: leaf_from_numpy(v)
                                 for k, v in batch.items()})
    for got, ref in ((ttot, jtot), (tce, jce)):
        assert abs(float(got) - float(ref)) <= LOSS_RTOL * abs(float(ref))
    jf, gf = _jflat(jg), dict(leaf_paths(tg))
    assert sorted(jf) == sorted(gf)
    for k, v in jf.items():
        _close(gf[k], v, GRAD_TOL, k)


# ------------------------------------------------------- what is saved

def _saved(fn):
    """(shape, bytes) of every tensor autograd saves while ``fn`` runs
    (checkpoints' own inputs; never what a checkpoint recomputes)."""
    seen = []

    def pack(t):
        seen.append((tuple(t.shape), t.numel() * t.element_size()))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return seen


def _direct_remat(fn, *args):
    return fn(*args)


def test_chunked_attention_keeps_no_score_block(monkeypatch):
    kw = dict(ATTN["gqa"], head_dim=16)      # no q block of (qb, hd) = (4, 8)
    tc = TA.AttnConfig(**kw)
    pt = _to_t(JA.attn_init(jax.random.key(1), JA.AttnConfig(**kw)))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, S, 32)).astype(np.float32)).requires_grad_(True)

    def run():
        TA.attention(pt, x, tc, **CHUNKED)

    score = (B, tc.n_kv_heads, tc.q_groups, CHUNKED["q_block"],
             CHUNKED["k_block"])
    assert score not in [s for s, _ in _saved(run)]
    # the same forward without the checkpoints keeps every block's scores
    monkeypatch.setattr(TA, "remat", _direct_remat)
    kept = [s for s, _ in _saved(run) if s == score]
    assert len(kept) >= (S // 4) * (S // 8)


def test_lm_loss_keeps_no_logits(monkeypatch):
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduce(),
                              loss_chunks=4, tied_embeddings=False)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    head = {"lm_head": {"kernel": params["lm_head"]["kernel"]
                        .requires_grad_(True)}}
    h = torch.randn((B, S, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).requires_grad_(True)
    labels = torch.zeros((B, S), dtype=torch.int32)

    def run():
        TT.lm_loss(head, cfg, h, labels)

    chunk = (B, S // 4, cfg.vocab_size)
    assert chunk not in [s for s, _ in _saved(run)]
    monkeypatch.setattr(TT, "remat", _direct_remat)
    assert chunk in [s for s, _ in _saved(run)]


@pytest.mark.parametrize("name,arch,over", [SEVEN[0], SEVEN[4]],
                         ids=["qwen2", "whisper"])
def test_remat_saves_fewer_bytes(name, arch, over):
    base = dataclasses.replace(ARCHS[arch].reduce(), loss_chunks=4, **over)
    params = TT.init_params(base, torch.Generator().manual_seed(0))
    batch = {k: leaf_from_numpy(v) for k, v in _batch(base).items()}
    saved = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        saved[remat] = sum(b for _, b in _saved(
            lambda: ST.value_and_grad(cfg, ST.StepOptions(), params,
                                      batch)))
    assert 0 < saved[True] < saved[False], saved


# ---------------------------------------------------------- the serve path

def test_serve_path_takes_no_checkpoint(chunked, counted_checkpoints):
    cfg = dataclasses.replace(ARCHS["qwen2-0.5b"].reduce(), remat=True,
                              loss_chunks=4)
    assert cfg.remat
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    pre = ST.make_prefill_step(cfg)
    dec = ST.make_decode_step(cfg)
    live = tree_map(lambda p: p.requires_grad_(True), params)
    tok, caches = pre(live, {"tokens": tokens})       # under no_grad
    for _ in range(3):
        tok, caches = dec(live, {"token": tok, "caches": caches})
    with torch.no_grad():
        TT.forward(live, cfg, tokens)
    with torch.inference_mode():
        TT.prefill(params, cfg, tokens)
    assert counted_checkpoints == []
    # the same forward under grad checkpoints (the chunked attention too)
    TT.forward(live, cfg, tokens)
    assert len(counted_checkpoints) > TT._unit_counts(cfg)[0]


# ------------------------------------------------------------- the mesh

MESH = [("qwen2-kan", "qwen2-0.5b", KAN), ("whisper", "whisper-medium", {})]
MODES = ("replicated", "sp")
MSEQ, MBATCH = 16, 4

WORKER = textwrap.dedent("""
    import sys, json, hashlib, dataclasses, functools
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun as D, mesh as M, specs as SP, \\
        steps as ST
    from repro_torch.models import attention as A, transformer as T
    from repro_torch.utils import leaf_paths, tree_map

    out, archs, modes, knobs, seq, batch = sys.argv[1], \\
        json.loads(sys.argv[2]), json.loads(sys.argv[3]), \\
        json.loads(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6])
    A.attention = functools.partial(A.attention, **knobs)
    mesh = M.init_from_env((2, 2), device="cpu")

    def real(specs, cfg, rng):
        def one(a):
            if a.dtype == torch.int32:
                return torch.as_tensor(rng.integers(
                    0, cfg.vocab_size, a.shape).astype(np.int32))
            return (0.1 * torch.as_tensor(rng.standard_normal(
                a.shape).astype(np.float32))).to(a.dtype)
        return tree_map(one, specs)

    def digest(tree):
        h = hashlib.sha256()
        for k, v in leaf_paths(tree):
            h.update(k.encode())
            h.update(v.reshape(-1).view(torch.uint8).numpy().tobytes())
        return h.hexdigest()

    res = {}
    shape = ShapeSpec("train", seq, batch, "train")
    for name, arch, over in archs:
        for mode in modes:
            for remat in (False, True):
                cfg = dataclasses.replace(ARCHS[arch].reduce(), remat=remat,
                                          loss_chunks=2, **over)
                params = T.init_params(cfg, torch.Generator().manual_seed(0))
                b = real(SP.input_specs(cfg, shape), cfg,
                         np.random.default_rng(0))
                step, inputs = D.cell_inputs(
                    cfg, shape, mesh, ST.StepOptions(activation_mode=mode),
                    params=params, batch=b)
                full = D.count_step(step, inputs)
                total, ce, grads, _ = step.grads(*inputs)
                res[f"{name}/{mode}/{int(remat)}"] = {
                    "loss": digest({"t": total, "c": ce}),
                    "grads": digest(grads), "sent": full["sent"],
                    "gathers": full["gathers"], "flops": full["flops"],
                    "kernels": {k: v["launches"]
                                for k, v in full["kernels"].items()}}
    with open(f"{out}/rank{mesh.rank}.json", "w") as f:
        json.dump(res, f)
    M.destroy_process_mesh(mesh)
""")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("remat_mesh")
    spawn_ranks(["-c", WORKER, str(out), json.dumps(MESH), json.dumps(MODES),
                 json.dumps(CHUNKED), str(MSEQ), str(MBATCH)], 4,
                str(out / "rv"), timeout_s=240, env=_env())
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(4)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,arch,over", MESH, ids=[a[0] for a in MESH])
def test_mesh_remat_bitwise_and_counted(mesh_runs, name, arch, over, mode,
                                        chunked):
    shape = ShapeSpec("train", MSEQ, MBATCH, "train")
    for r, real in enumerate(mesh_runs):
        off, on = real[f"{name}/{mode}/0"], real[f"{name}/{mode}/1"]
        assert (on["loss"], on["grads"]) == (off["loss"], off["grads"]), r
        # the recompute re-issues the units' and chunks' collectives
        assert on["sent"]["calls"] > off["sent"]["calls"]
        assert on["flops"] > off["flops"]
        # the checkpointed step counted on the abstract mesh (without
        # remat: tests/test_torch_dryrun.py)
        cfg = dataclasses.replace(ARCHS[arch].reduce(), remat=True,
                                  loss_chunks=2, **over)
        full = D.analyze_cell(cfg, shape, rank=r, mesh_shape=(2, 2),
                              opts=ST.StepOptions(activation_mode=mode)
                              )["full"]
        got = {"sent": full["sent"], "gathers": full["gathers"],
               "flops": full["flops"],
               "kernels": {k: v["launches"]
                           for k, v in full["kernels"].items()}}
        assert got == {k: on[k] for k in got}, (r, got, on)
