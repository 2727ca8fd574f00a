"""Port parity: the serve steps on a (data, model) process mesh
(``launch/steps.make_prefill_step`` / ``make_decode_step`` with
``mesh=``), tensor-parallel over ``model`` with the reference's KV cache
layout, against one process and against the reference's
``jitted_serve_step`` on a 2x4 mesh, on the CPU.

Every arch runs at its ``reduce()`` size from the reference's draw
(``init_params(jax.random.key(0))``, carried across by path), f32:
qwen2-0.5b plain, with the KAN drop-in and with ``kv_quant``;
qwen3-moe at ``capacity_factor=8.0`` (no token dropped); recurrentgemma
with ``window=1024``, so its ring cache is sequence-sharded; whisper-
medium with ``n_frontend_tokens=1024``, so ``ck``/``cv`` are.  A run is
a prefill of ``B`` x 1024 tokens (1040 slots: sequence-sharded on 2x2
and on 2x4) and 4 decode steps fed seeded tokens (teacher-forced, so a
tie cannot change the next input).  One spawn of 4 gloo ranks runs every
arch on 2x2 twice, the short prompts and the collectives' checks; one
JAX subprocess with 8 host devices runs the reference's
``jitted_serve_step`` on 2x4 (its ``greedy_token`` replaced by the last
position's logits, whose argmax the token is); this process runs one
process and the 1x1 mesh.  Tolerances:

* logits and ``gather_caches`` of the 2x2 caches, slot for slot, within
  ``TOL * (1 + max|ref|)``, ``TOL = 1e-4`` (the f32 bound of
  ``tests/test_torch_transformer.py``'s whole models), of one process's
  and of the reference's 2x4; an int8 cache's codes equal but at a
  requantization tie (a code off by one, a scale by one f16 ulp, in
  under one entry of a thousand);
* greedy tokens equal to both, except where the reference side's top
  two logits lie within that bound of each other (a tie: the mesh's
  token must then be one of the two);
* two 2x2 runs bitwise, and a 1x1 mesh bitwise the step without one;
* every rank's cache shapes those ``cache_shardings`` gives, and its
  params ``compute_params`` with each ``tp_unit`` leaf at its ``model``
  shard (the counter of all-gathers along ``model`` shows no gather of
  one);
* a short prompt (under 1024 slots): every cache replicated over
  ``model`` and identical on both ``model`` ranks after each decode
  step; on a sequence-sharded cache a decode step changes only the slot
  ``len`` (``len % window`` on the ring) on the rank that owns it;
* ``collectives.softmax_combine`` bitwise the rank-order f32 merge, and
  ``argmax_over`` the lowest global index of a tie.
"""
import json
import os
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
    WORKER_HEAD,
    close as _close,
    env as _env,
    f64 as _f64,
    one_serve,
    tokens_match as _tokens_match,
)
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402

B, PROMPT, SHORT, NEW = 2, 1024, 40, 4
# (name, registry arch, reduce() overrides)
ARCHS = [
    ("qwen2", "qwen2-0.5b", {}),
    ("qwen2-kan", "qwen2-0.5b", {"ffn_kind": "kan", "pattern_rate": 0.5}),
    ("qwen2-kvq", "qwen2-0.5b", {"kv_quant": True}),
    ("qwen3-moe", "qwen3-moe-235b-a22b", {"capacity_factor": 8.0}),
    ("rgemma", "recurrentgemma-9b", {"window": 1024}),
    ("whisper", "whisper-medium", {"n_frontend_tokens": 1024}),
]
NAMES = [a[0] for a in ARCHS]

# the inputs of every run, drawn from a seed with numpy
INPUTS = textwrap.dedent("""
    import numpy as np

    def inputs(cfg, prompt, seed=0):
        rng = np.random.default_rng(seed)
        out = {"tokens": rng.integers(0, cfg.vocab_size, (B, prompt)
                                      ).astype(np.int32),
               "fed": rng.integers(0, cfg.vocab_size, (NEW, B, 1)
                                   ).astype(np.int32)}
        if cfg.enc_dec:
            out["frames"] = (0.1 * rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
        return out
""")

CONSTS = json.dumps({"B": B, "PROMPT": PROMPT, "SHORT": SHORT, "NEW": NEW})

# the reference's draws and its jitted_serve_step on 2x4
REF_SCRIPT = REF_HEAD + textwrap.dedent("""
    for name, arch, over in archs:
        cfg = get_config(arch).reduce(**over)
        ref_serve(name, cfg, draw(name, cfg), inputs(cfg, PROMPT))
""")

# one rank of the 2x2 runs
WORKER = WORKER_HEAD + textwrap.dedent("""
    results = {}
    for name, arch, over in archs:
        cfg = get_config(arch).reduce(**over)
        params = load(name, cfg)
        res, toks, lg, first, last = serve(cfg, params, inputs(cfg, PROMPT))
        _, toks_b, lg_b, first_b, last_b = serve(cfg, params,
                                                 inputs(cfg, PROMPT))
        res["bitwise"] = (torch.equal(toks, toks_b) and torch.equal(lg, lg_b)
                          and same_tree(first, first_b)
                          and same_tree(last, last_b))
        short, toks_s, lg_s, _, _ = serve(cfg, params, inputs(cfg, SHORT))
        res["short"] = {k: short[k] for k in ("seq_sharded",
                                              "model_replicas_equal")}
        results[name] = res
        if rank == 0:
            np.savez(f"{out}/mesh_{name}.npz", tokens=toks.numpy(),
                     logits=lg.numpy(), tokens_short=toks_s.numpy(),
                     logits_short=lg_s.numpy())
        save(f"mesh_caches_{name}", first)
        save(f"mesh_caches_last_{name}", last)
    # the collectives: softmax partials merged in rank order in f32, and
    # the argmax of a tie over model
    g = torch.Generator().manual_seed(7 + rank)
    m_r = torch.randn((3, 5), generator=g)
    l_r = torch.rand((3, 5), generator=g) + 0.5
    o_r = torch.randn((3, 5, 4), generator=g)
    mx, l, o = COLL.softmax_combine(m_r, l_r, o_r, mesh)
    parts = [COLL.all_gather_shards(a, mesh, "model") for a in (m_r, l_r,
                                                                 o_r)]
    want_m = torch.maximum(parts[0][0], parts[0][1])
    want_l = (parts[1][0] * torch.exp(parts[0][0] - want_m)
              + parts[1][1] * torch.exp(parts[0][1] - want_m))
    want_o = (parts[2][0] * torch.exp(parts[0][0] - want_m)[..., None]
              + parts[2][1] * torch.exp(parts[0][1] - want_m)[..., None])
    results["softmax_combine_bitwise"] = (
        torch.equal(mx, want_m) and torch.equal(l, want_l)
        and torch.equal(o, want_o))
    # rows: a tie inside rank 1's block, a tie across the ranks, a lone max
    n = 6
    x = torch.zeros((3, n))
    r = mesh.index_over("model")
    x[0, 2:4] = 5.0 if r == 1 else 1.0
    x[1, 4] = 3.0
    x[2, 1] = 9.0 if r == 0 else 2.0
    results["argmax"] = COLL.argmax_over(x, mesh).tolist()
    json.dump(results, open(f"{out}/res_rank{rank}.json", "w"))
    M.destroy_process_mesh(mesh)
""")


def _inputs_fn():
    ns = {"B": B, "NEW": NEW}
    exec(INPUTS, ns)
    return ns["inputs"]


def _one_process(name, arch, over, tmp, prompt, mesh=None):
    """(tokens (B, 1 + NEW), logits (1 + NEW, B, V), first caches, last
    caches) of one process, without a mesh or on ``mesh``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T
    from repro_torch.utils import leaf_from_numpy, tree_map_with_path

    cfg = get_config(arch).reduce(**over)
    with np.load(tmp / f"init_{name}.npz") as z:
        params = tree_map_with_path(lambda k, _: leaf_from_numpy(z[k]),
                                    T.param_shapes(cfg))
    return one_serve(cfg, params, _inputs_fn()(cfg, prompt), mesh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serve")
    archs = json.dumps(ARCHS)
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(tmp), archs,
                        CONSTS, INPUTS], capture_output=True, text=True,
                       cwd=REPO, timeout=SPAWN_S,
                       env={**os.environ, **_env()})
    assert r.returncode == 0, r.stderr[-3000:]
    spawn_ranks(["-c", WORKER, str(tmp), archs, CONSTS, INPUTS], 4,
                str(tmp / "rv"), timeout_s=SPAWN_S, env=_env())
    ranks = []
    for r in range(4):
        with open(tmp / f"res_rank{r}.json") as f:
            ranks.append(json.load(f))
    out = {"tmp": tmp, "res": ranks[0], "ranks": ranks}
    for name, arch, over in ARCHS:
        out[name] = {
            "one": _one_process(name, arch, over, tmp, PROMPT),
            "ref": dict(np.load(tmp / f"ref_{name}.npz")),
            "ref_caches": (dict(np.load(tmp / f"ref_caches_{name}.npz")),
                           dict(np.load(tmp / f"ref_caches_last_{name}.npz"))),
            "mesh": dict(np.load(tmp / f"mesh_{name}.npz")),
            "mesh_caches": (dict(np.load(tmp / f"mesh_caches_{name}.npz")),
                            dict(np.load(tmp / f"mesh_caches_last_{name}.npz"))),
        }
    return out


def _int8_close(got, ref, k, what):
    """An int8 cache entry and its f16 scales: equal but at a
    requantization tie, where the f32 value being rounded lies within the
    bound of a rounding boundary -- there a code differs by one, or a
    scale by one f16 ulp (2**-10 of it, at most) -- and such ties rare
    (under one in a thousand entries)."""
    sk = k[:-2] + "_scale']"
    codes = np.abs(_f64(got[k]) - _f64(ref[k]))
    scales = np.abs(_f64(got[sk]) - _f64(ref[sk]))
    assert codes.max() <= 1, (what, codes.max())
    assert (scales <= 2.0 ** -10 * np.abs(_f64(ref[sk]))).all(), what
    assert float((codes > 0).mean()) <= 1e-3, (what, (codes > 0).mean())
    assert float((scales > 0).mean()) <= 1e-3, (what, (scales > 0).mean())


@pytest.mark.parametrize("name", NAMES)
def test_tokens_match_one_process_and_reference(runs, name):
    run = runs[name]
    one_toks, one_lg, _, _ = run["one"]
    _tokens_match(run["mesh"]["tokens"], one_toks, one_lg, "vs one process")
    _tokens_match(run["mesh"]["tokens"], run["ref"]["tokens"],
                  run["ref"]["logits"], "vs reference 2x4")


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_one_process_and_reference(runs, name):
    run = runs[name]
    got = run["mesh"]["logits"]
    _close(got, run["one"][1], "vs one process")
    _close(got, run["ref"]["logits"], "vs reference 2x4")


@pytest.mark.parametrize("name", NAMES)
def test_gathered_caches_match_one_process_and_reference(runs, name):
    """``gather_caches`` of the 2x2 pieces after the prefill and after the
    last decode step, slot for slot, against one process's caches and
    the reference's 2x4 caches (an int8 cache's codes and scales equal but
    at a requantization tie, ``_int8_close``)."""
    run = runs[name]
    for i, (mesh_c, one_c, ref_c) in enumerate(zip(
            run["mesh_caches"], run["one"][2:], run["ref_caches"])):
        assert mesh_c.keys() == one_c.keys() == ref_c.keys()
        for k in mesh_c:
            if mesh_c[k].dtype == np.int8:
                for c, what in ((one_c, "one process"), (ref_c, "reference")):
                    _int8_close(mesh_c, c, k, (i, k, what))
                continue
            _close(mesh_c[k], one_c[k], (i, k, "one process"))
            _close(mesh_c[k], ref_c[k], (i, k, "reference"))


@pytest.mark.parametrize("name", NAMES)
def test_rank_layout_follows_the_reference(runs, name):
    """Each rank's caches have the shapes ``cache_shardings`` gives (and
    ``init_caches(mesh=)``'s empty pieces'); its
    params are ``compute_params`` with every ``tp_unit`` leaf at its
    ``model`` shard, and no tensor-parallel leaf was gathered along
    ``model``."""
    res = runs["res"][name]
    assert res["cache_shapes_bad"] == [] and res["init_shapes_bad"] == []
    # shard_caches cuts the gathered caches back into the rank's pieces
    assert res["shard_roundtrip"]
    assert res["n_tp"] > 0 and res["tp_shapes_bad"] == []
    assert res["model_gathers"] == res["model_gathers_want"]
    # the long prompt's self-attention caches are sequence-sharded
    assert any(k.endswith("['k']") for k in res["seq_sharded"])
    if name == "whisper":
        assert any(k.endswith("['ck']") for k in res["seq_sharded"])


@pytest.mark.parametrize("name", NAMES)
def test_two_mesh_runs_bitwise(runs, name):
    assert runs["res"][name]["bitwise"]


def test_held_kan_ffn_bitwise_functional_on_shards(runs):
    """The KAN drop-in's held FFN (``ffn_modules`` inside ``serve_mesh``,
    holding its ``Shard``) gives the bits of ``ffn_apply`` on the same
    shards, on every rank."""
    assert all(r["qwen2-kan"]["held_ffn_bitwise"] == [True]
               for r in runs["ranks"])


@pytest.mark.parametrize("name", NAMES)
def test_host_mesh_bitwise_no_mesh(runs, name):
    """The steps on a 1x1 mesh: bitwise the steps without a mesh (both on
    one thread: the CPU's multithreaded products may split a sum
    differently from call to call)."""
    from repro_torch.launch.mesh import make_host_mesh

    arch, over = dict((a[0], a[1:]) for a in ARCHS)[name]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = _one_process(name, arch, over, runs["tmp"], PROMPT,
                           make_host_mesh())
        one = _one_process(name, arch, over, runs["tmp"], PROMPT)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
    for a, b in zip(got[2:], one[2:]):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("name", NAMES)
def test_short_prompt_caches_replicated_over_model(runs, name):
    """Under 1024 slots no self-attention cache splits its sequence: every
    rank holds every kv head at every slot, identical on both ``model``
    ranks after each decode step (whisper's 1024 frames still split)."""
    short = runs["res"][name]["short"]
    assert not any(k.endswith(("['k']", "['v']"))
                   for k in short["seq_sharded"])
    assert short["model_replicas_equal"] == [True] * NEW


@pytest.mark.parametrize("name", NAMES)
def test_new_entry_written_by_the_slot_owner_only(runs, name):
    """On the 2x2 sequence-sharded caches (1040 slots, 520 a rank; the
    ring of 1024 slots, 512 a rank) a decode step changes one slot of a
    row: on the rank owning slot ``len`` (``len % window`` on the ring),
    at that slot; on the other rank none.  Ranks 0 and 1 are model
    ranks 0 and 1 of data rank 0 (one row each)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import _unit_counts

    arch, over = dict((a[0], a[1:]) for a in ARCHS)[name]
    n_units = _unit_counts(get_config(arch).reduce(**over))[0]
    window = 1024 if name == "rgemma" else None
    n_slots = window or PROMPT + 16
    for m, res in enumerate(r[name] for r in runs["ranks"][:2]):
        lo = m * n_slots // 2
        for i, writes in enumerate(res["writes"]):
            slot = (PROMPT + i) % n_slots
            want = [[0, slot - lo]] if lo <= slot < lo + n_slots // 2 else []
            for k, entries in writes.items():
                if k in res["seq_sharded"]:
                    units = [[u] + w for u in range(n_units) for w in want]
                    assert entries == (units if "['units']" in k else want), \
                        (m, i, k, entries)
    # the ring wraps to model rank 0's first slots; the append-only
    # cache writes past rank 0's half
    assert any(runs["ranks"][0 if window else 1][name]["writes"][0].values())


def test_softmax_partials_merged_in_rank_order(runs):
    assert all(r["softmax_combine_bitwise"] for r in runs["ranks"])


def test_argmax_over_model_lowest_index_of_a_tie(runs):
    # row 0: model rank 1's block ties at 2, 3 -> 6 + 2; row 1: both
    # ranks hold 3.0 at 4 -> rank 0's; row 2: rank 0's max at 1
    assert all(r["argmax"] == [8, 4, 1] for r in runs["ranks"])
