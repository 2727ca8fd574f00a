"""What the parity tests of the serve steps on a process mesh share
(``tests/test_torch_tp_serve.py`` and ``tests/_tp_rec_common.py``): the
f32 bound and the comparisons held to it, the ranks' environment, one
process's serve run, and the parts of the two scripts each file runs in
subprocesses -- the head of the reference's JAX script with its
``jitted_serve_step`` run on a 2x4 mesh (``REF_HEAD``), and the head of
a rank's script with its serve run on 2x2 (``WORKER_HEAD``).

Both scripts take ``OUT ARCHS CONSTS INPUTS``: the directory they write
to, a JSON list of ``(name, registry arch, reduce() overrides)``, a JSON
object of the sizes (``B``, ``NEW`` and what the file's ``INPUTS``
reads), and the source of the file's ``INPUTS``, which draws every run's
inputs from a seed with numpy.
"""
import os
import textwrap

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
SPAWN_S = 240
TOL = 1e-4


def env():
    """The environment of the ranks and of the reference's subprocess."""
    return {"PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
            "OMP_NUM_THREADS": "1"}


def f64(a):
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.asarray(a, np.float64)


def close(got, ref, what):
    """``got`` within ``TOL * (1 + max|ref|)`` of ``ref``."""
    got, ref = f64(got), f64(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= TOL * (1 + float(np.abs(ref).max())), (what, err)


def tokens_match(got, ref_tokens, ref_logits, what):
    """Greedy tokens equal, but where the reference side's top two logits
    lie within the bound of each other: then one of the two."""
    got, ref_tokens = np.asarray(got), np.asarray(ref_tokens)
    lg = f64(ref_logits)                      # (steps, B, V)
    bound = TOL * (1 + float(np.abs(lg).max()))
    for s in range(lg.shape[0]):
        for b in range(lg.shape[1]):
            g, w = int(got[b, s]), int(ref_tokens[b, s])
            if g == w:
                continue
            top2 = np.argsort(lg[s, b])[-2:]
            tie = lg[s, b, top2[1]] - lg[s, b, top2[0]] <= bound
            assert tie and g in top2, (what, s, b, g, w)


def one_serve(cfg, params, z, mesh=None):
    """(tokens (B, 1 + NEW), logits (1 + NEW, B, V), first caches, last
    caches) of one process, without a mesh or on ``mesh``: a prefill of
    ``z``'s prompt and a decode step for each of ``z["fed"]``."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.utils import leaf_paths

    batch = {k: torch.from_numpy(v) for k, v in z.items() if k != "fed"}
    seen, greedy = [], T.greedy_token

    def hooked(lg, cfg=None):
        seen.append(lg[:, -1])
        return greedy(lg, cfg)

    T.greedy_token = hooked
    try:
        ffns = T.ffn_modules(params, cfg)
        enc = T.encoder_ffn_modules(params, cfg) if cfg.enc_dec else None
        layout = None if mesh is None else ST.cache_layout(cfg, mesh, batch)
        pre = ST.make_prefill_step(cfg, ffns=ffns, enc_ffns=enc, mesh=mesh)
        dec = ST.make_decode_step(cfg, ffns=ffns, mesh=mesh, layout=layout)
        tok, caches = pre(params, batch)
        first = dict(leaf_paths(caches))
        toks = [tok]
        for fed in z["fed"]:
            tok, caches = dec(params, {"token": torch.from_numpy(fed),
                                       "caches": caches})
            toks.append(tok)
    finally:
        T.greedy_token = greedy
    return (torch.cat(toks, 1), torch.stack(seen), first,
            dict(leaf_paths(caches)))


# the reference's draws and its jitted_serve_step on 2x4
REF_HEAD = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys, json
    import jax, jax.numpy as jnp, numpy as np
    import jax.tree_util as jtu
    import repro.jax_compat  # noqa: F401
    from repro.configs.base import ShapeSpec
    from repro.configs.registry import get_config
    from repro.launch.steps import jitted_serve_step
    from repro.models import transformer as T

    out, archs = sys.argv[1], json.loads(sys.argv[2])
    globals().update(json.loads(sys.argv[3]))
    exec(sys.argv[4])
    flat = lambda t: {jtu.keystr(p): np.asarray(v)
                      for p, v in jtu.tree_flatten_with_path(t)[0]}
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def draw(name, cfg):
        params = T.init_params(jax.random.key(0), cfg)
        np.savez(f"{out}/init_{name}.npz", **flat(params))
        return params

    def ref_serve(name, cfg, params, z):
        # a prefill of z and a decode step for each of z["fed"] (decode
        # shapes of S positions: the prompt, and the patches of a VLM);
        # the steps return the last position's logits where they return
        # the greedy token (its argmax: numpy's, like jnp.argmax, takes
        # the first index of a tie)
        batch = {k: v for k, v in z.items() if k != "fed"}
        S = z["tokens"].shape[1] + (cfg.n_frontend_tokens
                                    if "patches" in batch else 0)
        greedy, T.greedy_token = T.greedy_token, lambda lg: lg[:, -1]
        logits = []
        with jax.set_mesh(mesh):
            pre, _ = jitted_serve_step(cfg, mesh, ShapeSpec(
                "p", z["tokens"].shape[1], B, "prefill"))
            dec, _ = jitted_serve_step(cfg, mesh, ShapeSpec(
                "d", S, B, "decode"))
            lg, caches = pre(params, batch)
            logits.append(np.asarray(lg))
            first = flat(caches)
            for fed in z["fed"]:
                lg, caches = dec(params, {"token": fed, "caches": caches})
                logits.append(np.asarray(lg))
        T.greedy_token = greedy
        logits = np.stack(logits)
        np.savez(f"{out}/ref_{name}.npz", logits=logits,
                 tokens=np.argmax(logits, axis=-1).T.astype(np.int32))
        np.savez(f"{out}/ref_caches_{name}.npz", **first)
        np.savez(f"{out}/ref_caches_last_{name}.npz", **flat(caches))
""")

# one rank of the 2x2 runs: the mesh, the logits the steps reduce, and
# serve(cfg, params, z) -> (record, tokens, logits, first and last caches
# gathered), every tensor whole
WORKER_HEAD = textwrap.dedent("""
    import sys, json
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import collectives as COLL, mesh as M, \\
        sharding as SH, steps as ST
    from repro_torch.models import ffn as F, transformer as T
    from repro_torch.utils import leaf_from_numpy, leaf_paths, \\
        tree_map_with_path

    out, archs = sys.argv[1], json.loads(sys.argv[2])
    globals().update(json.loads(sys.argv[3]))
    exec(sys.argv[4])
    mesh = M.init_from_env((2, 2), device="cpu")
    rank = mesh.rank
    greedy, seen = T.greedy_token, []

    def hooked(lg, cfg=None):             # the logits the steps reduce
        seen.append(lg[:, -1])
        return greedy(lg, cfg)

    T.greedy_token = hooked

    def load(name, cfg):
        with np.load(f"{out}/init_{name}.npz") as z:
            return tree_map_with_path(lambda k, _: leaf_from_numpy(z[k]),
                                      T.param_shapes(cfg))

    def save(tag, tree):
        if rank == 0:
            np.savez(f"{out}/{tag}.npz",
                     **{k: v.numpy() for k, v in leaf_paths(tree)})

    def same_tree(a, b):
        return all(torch.equal(x, y) for (_, x), (_, y) in
                   zip(leaf_paths(a), leaf_paths(b)))

    def whole_logits(lg, cfg):
        with ST.serve_mesh(cfg, mesh):
            if T._vocab_shard(cfg) is not None:
                lg = COLL.gather_cat(lg, mesh, "model", -1)
        return COLL.gather_cat(lg, mesh, "data", 0)

    def changed(before, after):
        # per cache leaf k/v: the (row, slot) entries a step changed
        res = {}
        for (k, a), (_, b) in zip(leaf_paths(before), leaf_paths(after)):
            if k.endswith(("['k']", "['v']")):
                d = (a != b).reshape(*a.shape[:-2], -1).any(-1)
                res[k] = [list(map(int, i)) for i in torch.nonzero(d)]
        return res

    def serve(cfg, params, z):
        batch = {k: torch.from_numpy(v) for k, v in z.items() if k != "fed"}
        S = z["tokens"].shape[1] + (cfg.n_frontend_tokens
                                    if "patches" in batch else 0)
        res = {}
        COLL.reset_sent()
        cp = ST.compute_params(ST.shard_params(params, cfg, mesh), cfg, mesh)
        specs = ST.train_state_shardings(cfg, mesh)["params"]
        pspecs = dict(leaf_paths(specs))
        tp = ST._tp_paths(cfg, mesh, specs)
        local = tp | ST._ep_paths(cfg, mesh, specs)
        res["n_tp"] = len(tp)
        res["model_gathers"] = COLL.GATHERS.get(("model",), 0)
        res["model_gathers_want"] = sum(
            "model" in s.axes() and k not in local
            for k, s in pspecs.items())
        res["tp_shapes_bad"] = [
            k for k, a in leaf_paths(cp) if k in tp and tuple(a.shape) !=
            SH.local_shape(dict(leaf_paths(params))[k].shape,
                           SH.P(*(e if e == "model" else None
                                  for e in pspecs[k])), mesh)]
        with ST.serve_mesh(cfg, mesh):
            ffns = T.ffn_modules(cp, cfg)
            enc = T.encoder_ffn_modules(cp, cfg) if cfg.enc_dec else None
            # a held KAN FFN: bitwise the functional FFN on the same shards
            held = [(f, bp["ffn"]) for (_, _, bp, _), f in zip(
                T._layers(cp, cfg), ffns) if f is not None and "ffn" in bp]
            x = torch.randn((B // 2, 3, cfg.d_model),
                            generator=torch.Generator().manual_seed(3))
            res["held_ffn_bitwise"] = [
                torch.equal(f(x), F.ffn_apply(p, x, cfg.ffn_cfg(0), f.shard))
                for f, p in held[:1]]
        layout = ST.cache_layout(cfg, mesh, batch)
        prefill = ST.make_prefill_step(cfg, ffns=ffns, enc_ffns=enc,
                                       mesh=mesh)
        decode = ST.make_decode_step(cfg, ffns=ffns, mesh=mesh,
                                     layout=layout)
        seen.clear()
        COLL.reset_sent()
        tok, caches = prefill(cp, batch)
        res["prefill_sent"] = dict(COLL.SENT)
        whole = T.init_caches(cfg, B, S + cfg.decode_margin, "meta")
        res["cache_shapes_bad"] = [
            k for (k, a), (_, w), (_, s) in zip(
                leaf_paths(caches), leaf_paths(whole), leaf_paths(layout))
            if tuple(a.shape) != SH.local_shape(w.shape, s, mesh)]
        res["seq_sharded"] = sorted(k for k, s in leaf_paths(layout)
                                    if "model" in s.axes())
        empty = T.init_caches(cfg, B, S + cfg.decode_margin, "cpu", mesh)
        res["init_shapes_bad"] = [
            k for (k, a), (_, e) in zip(leaf_paths(caches), leaf_paths(empty))
            if a.shape != e.shape or a.dtype != e.dtype]
        first = SH.gather_caches(caches, layout, mesh)
        res["shard_roundtrip"] = same_tree(
            SH.shard_caches(first, layout, mesh), caches)
        toks = [COLL.gather_cat(tok, mesh, "data", 0)]
        res["writes"], res["model_replicas_equal"] = [], []
        for f in z["fed"]:
            fed = ST.local_batch({"token": torch.from_numpy(f)}, mesh)["token"]
            COLL.reset_sent()
            tok, new = decode(cp, {"token": fed, "caches": caches})
            res.setdefault("decode_sent", dict(COLL.SENT))
            res["writes"].append(changed(caches, new))
            caches = new
            toks.append(COLL.gather_cat(tok, mesh, "data", 0))
            # every leaf not split over model -- the recurrent state too:
            # the same bits on both model ranks
            same = True
            for (k, a), (_, s) in zip(leaf_paths(caches), leaf_paths(layout)):
                if "model" not in s.axes():
                    parts = COLL.all_gather_shards(a.contiguous(), mesh,
                                                   "model")
                    same = same and all(torch.equal(parts[0], p)
                                        for p in parts[1:])
            res["model_replicas_equal"].append(same)
        logits = torch.stack([whole_logits(lg, cfg) for lg in seen])
        last = SH.gather_caches(caches, layout, mesh)
        return res, torch.cat(toks, 1), logits, first, last
""")
