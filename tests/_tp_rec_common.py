"""The parity tests of tensor parallelism over ``model`` outside the
decoder's attention, FFN and vocabulary (``launch/sharding.tp_unit``):
the RG-LRU's lanes, the mLSTM's heads, the encoder's attention and FFN,
cross-attention and the shared expert, in the mesh train step and the
serve steps, against one process and against the reference's 2x4 mesh,
on the CPU.  ``tests/test_torch_tp_rec.py`` (recurrentgemma-9b,
xlstm-125m, llama4-scout) and ``tests/test_torch_tp_encdec.py``
(whisper-medium plain and with the KAN drop-in, paligemma-3b) import
these tests and name their archs in ``ARCHS``; ``pytest_generate_tests``
parametrizes the tests by them, and each file runs its own spawn and
JAX subprocess (each file under about 300 s on one core).

Every arch runs at its ``reduce()`` size from the reference's draw
(``init_params(jax.random.key(0))``, carried across by path), f32:
recurrentgemma-9b, xlstm-125m, whisper-medium (1024 frames, so its
``ck``/``cv`` are sequence-sharded) and with the KAN drop-in (8 frames:
``ck``/``cv`` replicated), paligemma-3b and llama4-scout at
``capacity_factor=8.0`` (no token dropped).  One spawn of 4 gloo ranks
runs each of a file's archs on 2x2: the first train step's gradients under both
``activation_mode``s, twice, and a prefill of ``B`` x ``PROMPT`` tokens
with ``NEW`` decode steps fed seeded tokens (teacher-forced), twice; one
JAX subprocess with 8 host devices runs the reference's ``jax.grad`` of
its train-step loss and its ``jitted_serve_step`` on 2x4 (its
``greedy_token`` replaced by the last position's logits); this process
runs one process and the 1x1 mesh; the serve runs, the comparisons and
the bound are ``tests/_mesh_parity.py``'s, shared with
``tests/test_torch_tp_serve.py``.  Tolerances:

* the train step's loss and mean gradient, leaf by leaf, within ``TOL
  * (1 + max|ref|)``, ``TOL = 1e-4``, of one process's and of the
  reference's 2x4, under both modes (llama4-scout's one process is the
  mean of the two data shards' losses and gradients: the mesh's aux
  loss is the shards' mean, the reference's definition);
* serve logits and ``gather_caches`` of the 2x2 caches within the same
  bound of one process's and of the reference's 2x4; greedy tokens
  equal but where the reference side's top two logits lie within it;
* two 2x2 runs bitwise, and a 1x1 mesh bitwise the steps without one
  (on one thread: the CPU's multithreaded products may split a sum
  differently from call to call);
* ``tp_unit``'s leaf set at each arch's ``reduce()`` config on 2x2, and
  each ``model``-sharded leaf that stays gathered, named; no TP leaf
  gathered along ``model`` by the steps (the counter of all-gathers);
* every cache leaf not split over ``model`` -- the recurrent and mLSTM
  state too -- the same bits on both ``model`` ranks after each decode
  step;
* ``collectives.gather_lanes``: forward the blocks in rank order,
  backward the cotangents summed in rank order in f32, the rank's block
  kept (bitwise).
"""
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _mesh_parity import (  # noqa: E402
    REF_HEAD,
    REPO,
    SPAWN_S,
    TOL,
    WORKER_HEAD,
    close as _close,
    env as _env,
    one_serve,
    tokens_match as _tokens_match,
)
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402

BT, SEQ = 4, 16                  # a train batch: 2 rows a data rank
B, PROMPT, NEW = 2, 40, 4        # a prompt past recurrentgemma's window
MODES = ("replicated", "sp")
# name -> (registry arch, reduce() overrides)
ALL_ARCHS = {
    "rgemma": ("recurrentgemma-9b", {}),
    "xlstm": ("xlstm-125m", {}),
    "llama4": ("llama4-scout-17b-a16e", {"capacity_factor": 8.0}),
    "whisper": ("whisper-medium", {"n_frontend_tokens": 1024}),
    "whisper-kan": ("whisper-medium", {"ffn_kind": "kan",
                                       "pattern_rate": 0.5}),
    "pali": ("paligemma-3b", {}),
}


def pytest_generate_tests(metafunc):
    """Each test of a file that imports these, once per arch its
    ``ARCHS`` names (and per activation mode where it takes one)."""
    if "name" in metafunc.fixturenames:
        metafunc.parametrize("name", metafunc.module.ARCHS)
    if "mode" in metafunc.fixturenames:
        metafunc.parametrize("mode", MODES)

# the inputs of every run, drawn from a seed with numpy
INPUTS = textwrap.dedent("""
    import numpy as np

    def _stub(cfg, rng, out, b):
        if cfg.frontend is not None:
            out["frames" if cfg.enc_dec else "patches"] = (
                0.1 * rng.standard_normal(
                    (b, cfg.n_frontend_tokens, cfg.d_model))
            ).astype(np.float32)
        return out

    def train_batch(cfg, seed=0):
        rng = np.random.default_rng(seed)
        return _stub(cfg, rng, {"tokens": rng.integers(
            0, cfg.vocab_size, (BT, SEQ + 1)).astype(np.int32)}, BT)

    def serve_inputs(cfg, seed=1):
        rng = np.random.default_rng(seed)
        out = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT)
                                      ).astype(np.int32),
               "fed": rng.integers(0, cfg.vocab_size, (NEW, B, 1)
                                   ).astype(np.int32)}
        return _stub(cfg, rng, out, B)
""")
CONSTS = json.dumps({"BT": BT, "SEQ": SEQ, "B": B, "PROMPT": PROMPT,
                     "NEW": NEW})

# the reference's draws, its train-step gradients and jitted_serve_step
# on 2x4
REF_SCRIPT = REF_HEAD + textwrap.dedent("""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.sharding import batch_shardings
    from repro.launch.steps import _split_batch

    losses = {}
    for name, arch, over in archs:
        cfg = get_config(arch).reduce(**over)
        params = draw(name, cfg)
        tb = train_batch(cfg)
        for mode in ("replicated", "sp"):
            seq = "model" if mode == "sp" else None
            with jax.set_mesh(mesh):
                b = jax.device_put(tb, batch_shardings(tb, mesh))

                def loss_fn(params):    # the train step's, differentiated
                    inputs, labels, kw = _split_batch(cfg, b)
                    inputs = jax.lax.with_sharding_constraint(
                        inputs, NamedSharding(mesh, P(("data",), None)))
                    h, aux = T.forward(params, cfg, inputs, **kw)
                    h = jax.lax.with_sharding_constraint(
                        h, NamedSharding(mesh, P(("data",), seq, None)))
                    loss = T.lm_loss(params, cfg, h[:, -labels.shape[1]:],
                                     labels)
                    return loss + 0.01 * aux

                loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
            losses[f"{name}_{mode}"] = float(loss)
            np.savez(f"{out}/ref_grads_{name}_{mode}.npz", **flat(g))
        ref_serve(name, cfg, params, serve_inputs(cfg))
    json.dump(losses, open(f"{out}/ref_losses.json", "w"))
""")

# one rank of the 2x2 runs
WORKER = WORKER_HEAD + textwrap.dedent("""
    def train(cfg, params, mode):
        opts = ST.StepOptions(lr=1e-3, total_steps=10, warmup=0,
                              activation_mode=mode)
        step = ST.make_train_step(cfg, opts, mesh)
        state = ST.init_train_state(cfg, opts, params=params, mesh=mesh)
        batch = ST.local_batch({k: torch.from_numpy(v) for k, v in
                                train_batch(cfg).items()}, mesh)
        COLL.reset_sent()
        step.gathered(state["params"])
        res = {"n_tp": len(step.tp),
               "model_gathers": COLL.GATHERS.get(("model",), 0),
               "model_gathers_want": sum(
                   "model" in s.axes() and k not in step.local
                   for k, s in step.pspecs.items())}
        total, _, slices, _ = step.grads(state, batch)
        res["loss"] = float(total)
        return res, step.gather_grads(slices)

    results = {}
    for name, arch, over in archs:
        cfg = get_config(arch).reduce(**over)
        params = load(name, cfg)
        res = {}
        for mode in ("replicated", "sp"):
            r, grads = train(cfg, params, mode)
            r_b, grads_b = train(cfg, params, mode)
            r["bitwise"] = r["loss"] == r_b["loss"] and same_tree(grads,
                                                                 grads_b)
            res[mode] = r
            save(f"grads_{name}_{mode}", grads)
        s, toks, lg, first, last = serve(cfg, params, serve_inputs(cfg))
        _, toks_b, lg_b, first_b, last_b = serve(cfg, params,
                                                 serve_inputs(cfg))
        s["bitwise"] = (torch.equal(toks, toks_b) and torch.equal(lg, lg_b)
                        and same_tree(first, first_b)
                        and same_tree(last, last_b))
        res["serve"] = s
        results[name] = res
        if rank == 0:
            np.savez(f"{out}/mesh_{name}.npz", tokens=toks.numpy(),
                     logits=lg.numpy())
        save(f"mesh_caches_{name}", first)
        save(f"mesh_caches_last_{name}", last)
    # the lane all-gather: forward the blocks in rank order; backward the
    # cotangents summed in rank order in f32, the rank's block kept
    r = mesh.index_over("model")
    g = torch.Generator().manual_seed(11 + rank)
    x = torch.randn((3, 5), generator=g).requires_grad_(True)
    w = torch.randn((3, 10), generator=g)
    y = COLL.gather_lanes(x, mesh)
    xs = COLL.all_gather_shards(x.detach(), mesh, "model")
    (gx,) = torch.autograd.grad(torch.sum(y * w), x)
    ws = COLL.all_gather_shards(w, mesh, "model")
    want = (ws[0] + ws[1])[:, 5 * r:5 * r + 5]
    results["lanes"] = {"forward": torch.equal(y.detach(), torch.cat(xs, 1)),
                        "backward": torch.equal(gx, want)}
    json.dump(results, open(f"{out}/res_rank{rank}.json", "w"))
    M.destroy_process_mesh(mesh)
""")


def _inputs():
    ns = {"BT": BT, "SEQ": SEQ, "B": B, "PROMPT": PROMPT, "NEW": NEW}
    exec(INPUTS, ns)
    return ns


def _cfg(name):
    from repro_torch.configs.registry import get_config
    arch, over = ALL_ARCHS[name]
    return get_config(arch).reduce(**over)


def _params(tmp, name, cfg):
    from repro_torch.models import transformer as T
    from repro_torch.utils import leaf_from_numpy, tree_map_with_path
    with np.load(tmp / f"init_{name}.npz") as z:
        return tree_map_with_path(lambda k, _: leaf_from_numpy(z[k]),
                                  T.param_shapes(cfg))


def _one_train(cfg, params, mesh=None):
    """(total loss, whole gradients) of the first train step in one
    process: the whole batch, or (a MoE) the mean of the two data shards'
    (the mesh's objective).  With ``mesh`` (1x1), through the mesh step,
    the whole batch."""
    from repro_torch.launch import steps as ST
    from repro_torch.utils import leaf_paths

    opts = ST.StepOptions(lr=1e-3, total_steps=10, warmup=0)
    batch = {k: torch.from_numpy(v)
             for k, v in _inputs()["train_batch"](cfg).items()}
    if mesh is not None:
        step = ST.make_train_step(cfg, opts, mesh)
        state = ST.init_train_state(cfg, opts, params=params, mesh=mesh)
        total, _, slices, _ = step.grads(state, batch)
        return float(total), dict(leaf_paths(step.gather_grads(slices)))
    if not cfg.n_experts:
        total, _, grads = ST.value_and_grad(cfg, opts, params, batch)
        return float(total), dict(leaf_paths(grads))
    half = BT // 2
    outs = [ST.value_and_grad(cfg, opts, params, {
        k: v[j * half:(j + 1) * half] for k, v in batch.items()})
        for j in range(2)]
    g0, g1 = (dict(leaf_paths(o[2])) for o in outs)
    return (float((outs[0][0] + outs[1][0]) / 2),
            {k: (g0[k] + g1[k]) / 2 for k in g0})


def _one_serve(cfg, params, mesh=None):
    """One process's serve run (``_mesh_parity.one_serve``) of the serve
    inputs, without a mesh or on ``mesh``."""
    return one_serve(cfg, params, _inputs()["serve_inputs"](cfg), mesh)


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    names = request.module.ARCHS
    tmp = tmp_path_factory.mktemp("tp_rec")
    archs = json.dumps([(n,) + ALL_ARCHS[n] for n in names])
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(tmp), archs,
                        CONSTS, INPUTS], capture_output=True, text=True,
                       cwd=REPO, timeout=SPAWN_S,
                       env={**os.environ, **_env()})
    assert r.returncode == 0, r.stderr[-3000:]
    spawn_ranks(["-c", WORKER, str(tmp), archs, CONSTS, INPUTS], 4,
                str(tmp / "rv"), timeout_s=SPAWN_S, env=_env())
    ranks = []
    for rk in range(4):
        with open(tmp / f"res_rank{rk}.json") as f:
            ranks.append(json.load(f))
    with open(tmp / "ref_losses.json") as f:
        ref_losses = json.load(f)
    out = {"tmp": tmp, "res": ranks[0], "ranks": ranks}
    for name in names:
        cfg = _cfg(name)
        params = _params(tmp, name, cfg)
        out[name] = {
            "one_train": _one_train(cfg, params),
            "one_serve": _one_serve(cfg, params),
            "ref_loss": ref_losses,
            "ref": dict(np.load(tmp / f"ref_{name}.npz")),
            "ref_caches": (dict(np.load(tmp / f"ref_caches_{name}.npz")),
                           dict(np.load(tmp / f"ref_caches_last_{name}.npz"))),
            "mesh": dict(np.load(tmp / f"mesh_{name}.npz")),
            "mesh_caches": (dict(np.load(tmp / f"mesh_caches_{name}.npz")),
                            dict(np.load(tmp / f"mesh_caches_last_{name}.npz"))),
        }
    return out


# ---------------------------------------------------------------------------
# The leaf set, at each arch's reduce() config on 2x2 (no spawn)
# ---------------------------------------------------------------------------

BLOCK = re.compile(r"^(\['units'\]\['slot\d+'\]|\['extra'\]\[\d+\])")
ATTN = {"attn.wq.kernel", "attn.wk.kernel", "attn.wv.kernel",
        "attn.wo.kernel"}
CROSS = {"cross.wq.kernel", "cross.wk.kernel", "cross.wv.kernel",
         "cross.wo.kernel", "cross.wq.bias", "cross.wk.bias",
         "cross.wv.bias"}
REC = {"rec.in_x.kernel", "rec.in_gate.kernel", "rec.conv", "rec.lambda",
       "rec.wa.kernel", "rec.wa.bias", "rec.wx.kernel", "rec.wx.bias",
       "rec.out.kernel"}
GLU = {"ffn.gate.kernel", "ffn.up.kernel", "ffn.down.kernel"}
MLP_BIAS = {"ffn.up.kernel", "ffn.up.bias", "ffn.down.kernel"}
QKV_BIAS = {"attn.wq.bias", "attn.wk.bias", "attn.wv.bias"}
ENC = {"encoder.units." + r for r in ATTN | QKV_BIAS | MLP_BIAS}
# (computed from the model shard, gathered though the rules shard them)
LEAVES = {
    # one kv head: wk/wv gathered, as in the decoder's attention
    "rgemma": (REC | GLU | {"attn.wq.kernel", "attn.wo.kernel",
                            "embed.table"},
               {"attn.wk.kernel", "attn.wv.kernel"}),
    "xlstm": ({"mlstm.wq.kernel", "mlstm.wk.kernel", "mlstm.wv.kernel",
               "mlstm.down.kernel", "embed.table"},
              {"mlstm.up.kernel", "mlstm.conv", "mlstm.wif.kernel",
               "mlstm.wif.bias", "slstm.wx.kernel", "slstm.wx.bias",
               "slstm.up.kernel"}),
    "whisper": (ATTN | QKV_BIAS | MLP_BIAS | CROSS | ENC | {"embed.table"},
                {"frontend_proj.kernel"}),
    "whisper-kan": (ATTN | QKV_BIAS | CROSS | {"embed.table"} | {
        r + "." + leaf for r in ("ffn.kan_up", "ffn.kan_down",
                                 "encoder.units.ffn.kan_up",
                                 "encoder.units.ffn.kan_down")
        for leaf in ("w_b", "t")} | {
        "encoder.units." + r for r in ATTN | QKV_BIAS},
        {"frontend_proj.kernel"}),
    "pali": ({"attn.wq.kernel", "attn.wo.kernel", "embed.table"} | GLU,
             {"attn.wk.kernel", "attn.wv.kernel", "frontend_proj.kernel"}),
    # the routed experts are expert-parallel, their own rule
    "llama4": (ATTN | {"moe.shared.up.kernel", "moe.shared.down.kernel",
                       "embed.table", "lm_head.kernel"},
               {"moe.experts.gate", "moe.experts.up", "moe.experts.down"}),
}


def _role(path):
    return ".".join(re.findall(r"\['([^']+)'\]", BLOCK.sub("", path)))


def test_tp_leaf_set_per_arch(name):
    """Which leaves a 2x2 mesh computes from their ``model`` shard
    (``tp_unit``), and which ``model``-sharded leaves stay gathered."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.utils import leaf_paths

    cfg = _cfg(name)
    mesh = ProcessMesh(("data", "model"), (2, 2), abstract=True)
    specs = ST.train_state_shardings(cfg, mesh)["params"]
    tp = ST._tp_paths(cfg, mesh, specs)
    gathered = {_role(k) for k, s in leaf_paths(specs)
                if "model" in s.axes() and k not in tp}
    want_tp, want_gathered = LEAVES[name]
    assert {_role(k) for k in tp} == want_tp
    assert gathered == want_gathered


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _grads_close(got, ref, what):
    assert got.keys() == ref.keys(), what
    for k in ref:
        _close(got[k], ref[k], (what, k))


def test_train_grads_match_one_process(runs, name, mode):
    loss, grads = runs[name]["one_train"]
    res = runs["res"][name][mode]
    _close(res["loss"], loss, "loss")
    got = dict(np.load(runs["tmp"] / f"grads_{name}_{mode}.npz"))
    _grads_close(got, {k: v.numpy() for k, v in grads.items()}, "one")


def test_train_grads_match_reference(runs, name, mode):
    """The 2x2 mean gradient against ``jax.grad`` of the reference's
    train-step loss on its 2x4 mesh, under the same activation mode."""
    res = runs["res"][name][mode]
    _close(res["loss"], runs[name]["ref_loss"][f"{name}_{mode}"], "loss")
    got = dict(np.load(runs["tmp"] / f"grads_{name}_{mode}.npz"))
    ref = dict(np.load(runs["tmp"] / f"ref_grads_{name}_{mode}.npz"))
    _grads_close(got, ref, "reference")


def test_train_two_runs_bitwise_and_tp_leaves_local(runs, name, mode):
    """Two 2x2 steps give the same bits; the step's gathers run one
    all-gather along ``model`` for each ``model``-sharded leaf it does not
    compute from its shard, none for the others."""
    for r in runs["ranks"]:
        res = r[name][mode]
        assert res["bitwise"]
        assert res["n_tp"] > 0
        assert res["model_gathers"] == res["model_gathers_want"]


def test_train_host_mesh_bitwise_no_mesh(runs, name):
    from repro_torch.launch.mesh import make_host_mesh

    cfg = _cfg(name)
    params = _params(runs["tmp"], name, cfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = _one_train(cfg, params, make_host_mesh())
        if cfg.n_experts:       # the whole batch, as the 1x1 step takes
            from repro_torch.launch import steps as ST
            from repro_torch.utils import leaf_paths
            batch = {k: torch.from_numpy(v) for k, v in
                     _inputs()["train_batch"](cfg).items()}
            total, _, grads = ST.value_and_grad(
                cfg, ST.StepOptions(lr=1e-3, total_steps=10, warmup=0),
                params, batch)
            one = float(total), dict(leaf_paths(grads))
        else:
            one = _one_train(cfg, params)
    finally:
        torch.set_num_threads(threads)
    assert got[0] == one[0]
    assert got[1].keys() == one[1].keys()
    assert all(torch.equal(got[1][k], one[1][k]) for k in got[1])


# ---------------------------------------------------------------------------
# The serve steps
# ---------------------------------------------------------------------------

def test_serve_tokens_and_logits_match(runs, name):
    run = runs[name]
    one_toks, one_lg, _, _ = run["one_serve"]
    got = run["mesh"]
    _close(got["logits"], one_lg, "logits vs one process")
    _close(got["logits"], run["ref"]["logits"], "logits vs reference 2x4")
    _tokens_match(got["tokens"], one_toks, one_lg, "vs one process")
    _tokens_match(got["tokens"], run["ref"]["tokens"], run["ref"]["logits"],
                  "vs reference 2x4")


def test_serve_gathered_caches_match(runs, name):
    """``gather_caches`` of the 2x2 pieces after the prefill and after the
    last decode step -- the recurrent and mLSTM state too -- against one
    process's caches and the reference's 2x4 caches."""
    run = runs[name]
    for i, (mesh_c, one_c, ref_c) in enumerate(zip(
            run["mesh_caches"], run["one_serve"][2:], run["ref_caches"])):
        assert mesh_c.keys() == one_c.keys() == ref_c.keys()
        for k in mesh_c:
            _close(mesh_c[k], one_c[k], (i, k, "one process"))
            _close(mesh_c[k], ref_c[k], (i, k, "reference"))


def test_serve_state_identical_on_model_ranks(runs, name):
    """Every cache leaf not split over ``model`` (the recurrent and mLSTM
    state, replicated caches) holds the same bits on both ``model``
    ranks after each decode step; whisper's 1024 frames are
    sequence-sharded."""
    for r in runs["ranks"]:
        s = r[name]["serve"]
        assert s["model_replicas_equal"] == [True] * NEW
    seq = runs["res"][name]["serve"]["seq_sharded"]
    if name == "whisper":
        assert any(k.endswith("['ck']") for k in seq)
    else:
        assert seq == []


def test_serve_two_runs_bitwise_and_tp_leaves_local(runs, name):
    for r in runs["ranks"]:
        s = r[name]["serve"]
        assert s["bitwise"]
        assert s["model_gathers"] == s["model_gathers_want"]


def test_serve_host_mesh_bitwise_no_mesh(runs, name):
    from repro_torch.launch.mesh import make_host_mesh

    cfg = _cfg(name)
    params = _params(runs["tmp"], name, cfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = _one_serve(cfg, params, make_host_mesh())
        one = _one_serve(cfg, params)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
    for a, b in zip(got[2:], one[2:]):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def lanes_gathered_in_rank_order(runs):
    """``collectives.gather_lanes`` on every rank of the spawn: forward
    the blocks in rank order, backward the cotangents summed in rank
    order in f32 and the rank's block kept, bitwise."""
    return all(r["lanes"] == {"forward": True, "backward": True}
               for r in runs["ranks"])
