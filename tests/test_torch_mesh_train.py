"""Port parity: training on a process mesh (``launch/mesh``,
``launch/collectives``, ``launch/sharding``, the mesh train step of
``launch/steps``, ``Trainer(mesh=)``) against one process and against
the reference's 2x4 mesh, on the CPU.

The reference's contract is ``tests/test_launch.py``'s
``test_sharded_equals_dense_subprocess``: 2 steps on a 1x1 and a 2x4
mesh agree within 1e-3 in the loss and every parameter, at its
``reduce()`` sizes (qwen3-moe at ``capacity_factor=8.0``, so no token is
dropped).  Here 4 gloo ranks (``mesh.spawn_ranks``) run a 2x2 mesh from
the reference's draw (``init_train_state(jax.random.key(0))``, carried
across by path), one process runs 1x1, and a JAX subprocess with 8 host
devices runs the reference's 2x4.  Every run takes lr 1e-3 with no
warmup, so a parameter moves about 1e-3 a step; the parameter bound is
a tenth of that, and the test checks that the parameters did move past
ten times it.  Tolerances:

* the mesh's mean gradient of the first step within
  ``1e-6 * (1 + max|g|)`` of the reference's 2x4 gradient
  (``jax.grad`` of its train step's loss under the mesh) and of the
  1x1 gradient, leaf by leaf;
* the loss and every parameter after 2 steps within ``PARAM_TOL`` of 1x1
  and of the reference's 2x4 run.

qwen3-moe's aux loss on a mesh is the mean of the data shards' aux, the
reference's definition, which a 1x1 run over the whole batch does not
share: the reference's own 1x1 and 2x4 runs part by 1.96e-3 in the
params after these 2 steps.  So there the 1x1 side is one process on the
mesh's objective, the mean of the two shards' losses and gradients; the
2x4 side is the reference's own.  Also:

* ZeRO-1's update bitwise the replicated AdamW update of the same
  gradients at the same clip scale (the mesh takes the global norm from
  its slices, within 1e-6 relative of the whole gradient's), two mesh
  runs bitwise, and the 1x1 mesh step bitwise the step without a mesh.

The 2x2 mesh computes tensor-parallel over ``model`` (``launch/steps``),
and each 2x2 spawn runs both activation modes, ``"replicated"`` and
``"sp"`` (the reference's ``StepOptions(activation_mode="sp")`` run in
the same JAX subprocess): the ``test_sp_*`` tests hold the sp runs to the
same bounds, and ``test_tp_leaves_not_gathered_along_model`` reads the
collectives' counter (``collectives.GATHERS``) around the step's
gathers: one all-gather along ``model`` for each leaf that has a
``model`` shard and is not computed from it, none for the others.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import spawn_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
SPAWN_S = 120
GRAD_TOL = 1e-6
LR = 1e-3
PARAM_TOL = LR / 10
NORM_RTOL = 1e-6
ARCHS = [("qwen2-0.5b", ""), ("qwen2-0.5b", "kan"),
         ("qwen3-moe-235b-a22b", ""), ("recurrentgemma-9b", "")]
MODES = ("replicated", "sp")

# the reference's 2x4 run of test_launch.py, saving its draw and results
REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys, json, dataclasses
    import jax, jax.numpy as jnp, numpy as np
    import jax.tree_util as jtu
    import repro.jax_compat  # noqa: F401
    from repro.configs.registry import get_config
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.steps import make_train_step, init_train_state, \\
        StepOptions, _split_batch
    from repro.launch.sharding import batch_shardings
    from repro.models import transformer as T

    arch, ffn, out = sys.argv[1], sys.argv[2], sys.argv[3]
    cfg = get_config(arch).reduce(n_layers=2, d_model=32, d_ff=64,
                                  vocab_size=64, n_heads=4, n_kv_heads=2)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, n_experts=4, top_k=2,
                                  capacity_factor=8.0)
    if ffn:
        cfg = dataclasses.replace(cfg, ffn_kind=ffn, pattern_rate=0.5)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, 64, size=(8, 17)).astype(np.int32)}
    flat = lambda t: {jtu.keystr(p): np.asarray(v)
                      for p, v in jtu.tree_flatten_with_path(t)[0]}
    np.savez(out + "/init.npz",
             **flat(init_train_state(jax.random.key(0), cfg)["params"]))
    types = (jax.sharding.AxisType.Auto,) * 2
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=types)
    for mode, sfx in (("replicated", ""), ("sp", "_sp")):
        opts = StepOptions(lr=1e-3, total_steps=10, warmup=0,
                           activation_mode=mode)
        seq = "model" if mode == "sp" else None
        with jax.set_mesh(mesh):
            state = init_train_state(jax.random.key(0), cfg)
            step = make_train_step(cfg, mesh, opts)
            b = jax.device_put(batch, batch_shardings(batch, mesh))

            def loss_fn(params):       # the train step's, as differentiated
                inputs, labels, _ = _split_batch(cfg, b)
                inputs = jax.lax.with_sharding_constraint(
                    inputs, NamedSharding(mesh, P(("data",), None)))
                h, aux = T.forward(params, cfg, inputs)
                h = jax.lax.with_sharding_constraint(
                    h, NamedSharding(mesh, P(("data",), seq, None)))
                loss = T.lm_loss(params, cfg, h[:, -labels.shape[1]:],
                                 labels)
                return loss + opts.aux_weight * aux

            np.savez(out + "/ref_grads_2x4" + sfx + ".npz",
                     **flat(jax.jit(jax.grad(loss_fn))(state["params"])))
            losses = []
            for _ in range(2):
                state, metrics = jax.jit(step)(state, b)
                losses.append(float(metrics["loss"]))
        np.savez(out + "/ref_2x4" + sfx + ".npz", **flat(state["params"]))
        json.dump({"losses": losses}, open(out + "/ref_2x4" + sfx + ".json",
                                           "w"))
""")

# one rank of the port's run: the reference's draw, 2 steps
WORKER = textwrap.dedent("""
    import sys, json, dataclasses
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import collectives as COLL, mesh as M, \\
        sharding as SH, steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init, adamw_update, global_norm
    from repro_torch.utils import leaf_from_numpy, leaf_paths, \\
        tree_map_with_path

    arch, ffn, shape, out = sys.argv[1], sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    cfg = get_config(arch).reduce(n_layers=2, d_model=32, d_ff=64,
                                  vocab_size=64, n_heads=4, n_kv_heads=2)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, n_experts=4, top_k=2,
                                  capacity_factor=8.0)
    if ffn:
        cfg = dataclasses.replace(cfg, ffn_kind=ffn, pattern_rate=0.5)
    mesh = M.init_from_env(M.parse_mesh(shape), device="cpu")
    with np.load(out + "/init.npz") as z:
        params = tree_map_with_path(lambda k, _: leaf_from_numpy(z[k]),
                                    T.param_shapes(cfg))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, 64, size=(8, 17)).astype(np.int32))
    batch = ST.local_batch({"tokens": tokens}, mesh)
    modes = ("replicated", "sp") if mesh.axis_size("model") > 1 else (
        "replicated",)
    for mode in modes:
        opts = ST.StepOptions(lr=1e-3, total_steps=10, warmup=0,
                              activation_mode=mode)
        step = ST.make_train_step(cfg, opts, mesh)
        state = ST.init_train_state(cfg, opts, params=params, mesh=mesh)
        res = {"n_tp": len(step.tp)}
        # one all-gather along model a leaf with a model shard that the
        # step does not compute from it
        COLL.reset_sent()
        step.gathered(state["params"])
        res["model_gathers"] = COLL.GATHERS.get(("model",), 0)
        res["model_gathers_want"] = sum(
            "model" in s.axes() and k not in step.local
            for k, s in step.pspecs.items())
        res["model_leaves"] = sum("model" in s.axes()
                                  for s in step.pspecs.values())
        # the mesh's mean gradient of step 1, whole (every rank's slices,
        # the experts of every model rank)
        _, _, slices, _ = step.grads(state, batch)
        whole_g = step.gather_grads(slices)
        # ZeRO-1 against the replicated update of the same gradients at the
        # same clip scale
        upd, m = step.apply(state, slices)
        norm = global_norm(whole_g)
        res["norm_rel"] = float(abs(m["grad_norm"] - norm) / norm)
        got = ST.gather_state({**upd, "step": state["step"]}, cfg, mesh)
        whole = ST.gather_state(state, cfg, mesh)
        clip = ST.default_opt_cfg(opts).grad_clip_norm
        scale = torch.clamp(clip / (m["grad_norm"] + 1e-9), max=1.0)
        p, o, _ = adamw_update(
            tree_map_with_path(lambda k, g: g * scale, whole_g),
            whole["opt"], whole["params"],
            dataclasses.replace(ST.default_opt_cfg(opts), grad_clip_norm=None))
        res["zero1_bitwise"] = all(
            torch.equal(a, b) for t1, t2 in ((got["params"], p),
                                             (got["opt"].mu, o.mu),
                                             (got["opt"].nu, o.nu))
            for (_, a), (_, b) in zip(leaf_paths(t1), leaf_paths(t2)))
        losses = []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        res["losses"] = losses
        if mesh.size == 1:
            plain = ST.make_train_step(cfg, opts)
            s2 = ST.init_train_state(cfg, opts, params=params)
            for _ in range(2):
                s2, _ = plain(s2, batch)
            res["host_mesh_bitwise"] = all(
                torch.equal(a, b) for (_, a), (_, b) in zip(
                    leaf_paths(s2["params"]), leaf_paths(state["params"])))
            if cfg.n_experts:
                # the mesh's objective on one process: the mean of the two
                # data shards' losses and gradients, 2 steps of it
                p_, o_, sm_losses = params, adamw_init(params), []
                for i in range(2):
                    outs = [ST.value_and_grad(cfg, opts, p_, {
                        "tokens": tokens[4 * j:4 * j + 4]}) for j in range(2)]
                    g1 = dict(leaf_paths(outs[1][2]))
                    shard_mean = tree_map_with_path(
                        lambda k, a: (a + g1[k]) / 2, outs[0][2])
                    sm_losses.append(float((outs[0][1] + outs[1][1]) / 2))
                    if i == 0:
                        np.savez(out + "/grads_shards_" + shape + ".npz",
                                 **{k: v.numpy()
                                    for k, v in leaf_paths(shard_mean)})
                    p_, o_, _ = adamw_update(shard_mean, o_, p_,
                                             ST.default_opt_cfg(opts))
                res["shard_mean_losses"] = sm_losses
                np.savez(out + "/params_shards_" + shape + ".npz",
                         **{k: v.numpy() for k, v in leaf_paths(p_)})
        whole = ST.gather_state(state, cfg, mesh)
        if mesh.rank == 0:
            tag = shape + sys.argv[5] + ("_sp" if mode == "sp" else "")
            np.savez(out + "/params_" + tag + ".npz",
                     **{k: v.numpy() for k, v in leaf_paths(whole["params"])})
            np.savez(out + "/grads_" + tag + ".npz",
                     **{k: v.numpy() for k, v in leaf_paths(whole_g)})
            json.dump(res, open(out + "/res_" + tag + ".json", "w"))
    M.destroy_process_mesh(mesh)
""")


def _env():
    return {"PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
            "OMP_NUM_THREADS": "1"}


def _load(tmp, tag):
    with open(tmp / f"res_{tag}.json") as f:
        res = json.load(f)
    return (res, dict(np.load(tmp / f"params_{tag}.npz")),
            dict(np.load(tmp / f"grads_{tag}.npz")))


def _port(tmp, arch, ffn, shape, tag=""):
    """(res, params, grads) of each mode the run took, by mode."""
    world = int(np.prod([int(n) for n in shape.split("x")]))
    spawn_ranks(["-c", WORKER, arch, ffn, shape, str(tmp), tag], world,
                str(tmp / f"rv_{shape}{tag}"), timeout_s=SPAWN_S,
                env=_env())
    out = {"replicated": _load(tmp, shape + tag)}
    if shape != "1x1":
        out["sp"] = _load(tmp, shape + tag + "_sp")
    return out


def _max_diff(a, b):
    assert a.keys() == b.keys()
    return max(float(np.abs(np.asarray(a[k], np.float64)
                            - np.asarray(b[k], np.float64)).max())
               for k in a)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per arch: the reference's draw and 2x4 runs (both modes), the
    port's 1x1 run and two 2x2 runs (each both modes; ``"2x2_sp"`` the
    first's sp run)."""
    out = {}
    for arch, ffn in ARCHS:
        tmp = tmp_path_factory.mktemp(f"{arch}{ffn}")
        r = subprocess.run([sys.executable, "-c", REF_SCRIPT, arch, ffn,
                            str(tmp)], capture_output=True, text=True,
                           cwd=REPO, timeout=SPAWN_S,
                           env={**os.environ, **_env()})
        assert r.returncode == 0, r.stderr[-3000:]
        run = {"tmp": tmp}
        for mode, sfx in (("replicated", ""), ("sp", "_sp")):
            with open(tmp / f"ref_2x4{sfx}.json") as f:
                run["ref" + sfx] = json.load(f)
            run["ref_params" + sfx] = dict(np.load(tmp / f"ref_2x4{sfx}.npz"))
        run["1x1"] = _port(tmp, arch, ffn, "1x1")["replicated"]
        for tag in ("2x2", "2x2b"):
            both = _port(tmp, arch, ffn, "2x2", tag[3:])
            run[tag], run[tag + "_sp"] = both["replicated"], both["sp"]
        out[(arch, ffn)] = run
    return out


def _grads_match_one_process(run, arch, sfx):
    g1, g4 = run["1x1"][2], run["2x2" + sfx][2]
    if arch.startswith("qwen3-moe"):
        g1 = dict(np.load(run["tmp"] / "grads_shards_1x1.npz"))
    assert g1.keys() == g4.keys()
    for k in g1:
        ref = np.asarray(g1[k], np.float64)
        err = float(np.abs(np.asarray(g4[k], np.float64) - ref).max())
        assert err <= GRAD_TOL * (1 + float(np.abs(ref).max())), (k, err)


def _grads_match_reference(run, sfx):
    ref = dict(np.load(run["tmp"] / f"ref_grads_2x4{sfx}.npz"))
    got = run["2x2" + sfx][2]
    assert ref.keys() == got.keys()
    for k in ref:
        want = np.asarray(ref[k], np.float64)
        err = float(np.abs(np.asarray(got[k], np.float64) - want).max())
        assert err <= GRAD_TOL * (1 + float(np.abs(want).max())), (k, err)


def _steps_match(run, arch, sfx):
    r1, p1, _ = run["1x1"]
    r4, p4, _ = run["2x2" + sfx]
    loss1 = r1["losses"][-1]
    if arch.startswith("qwen3-moe"):
        # the mesh's objective on one process (module docstring)
        loss1 = r1["shard_mean_losses"][-1]
        p1 = dict(np.load(run["tmp"] / "params_shards_1x1.npz"))
    # the bound can fail: two steps moved the parameters past ten times it
    init = dict(np.load(run["tmp"] / "init.npz"))
    assert _max_diff(init, p4) > 10 * PARAM_TOL
    assert abs(loss1 - r4["losses"][-1]) < PARAM_TOL
    assert _max_diff(p1, p4) < PARAM_TOL
    assert abs(run["ref" + sfx]["losses"][-1] - r4["losses"][-1]) < PARAM_TOL
    assert _max_diff(run["ref_params" + sfx], p4) < PARAM_TOL


def _runs_bitwise(run, sfx):
    ra, pa, ga = run["2x2" + sfx]
    rb, pb, gb = run["2x2b" + sfx]
    assert ra["losses"] == rb["losses"]
    for a, b in ((pa, pb), (ga, gb)):
        assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("arch,ffn", ARCHS)
def test_mesh_grads_match_one_process(runs, arch, ffn):
    _grads_match_one_process(runs[(arch, ffn)], arch, "")


@pytest.mark.parametrize("arch,ffn", ARCHS)
def test_mesh_grads_match_reference(runs, arch, ffn):
    """The 2x2 mean gradient against ``jax.grad`` on the reference's 2x4
    mesh (the same two data shards; for qwen3-moe its aux convention)."""
    _grads_match_reference(runs[(arch, ffn)], "")


@pytest.mark.parametrize("arch,ffn", ARCHS)
def test_mesh_steps_match_one_process_and_reference(runs, arch, ffn):
    _steps_match(runs[(arch, ffn)], arch, "")


@pytest.mark.parametrize("arch,ffn", ARCHS)
def test_mesh_runs_bitwise(runs, arch, ffn):
    run = runs[(arch, ffn)]
    _runs_bitwise(run, "")
    assert run["1x1"][0]["host_mesh_bitwise"]


@pytest.mark.parametrize("arch,ffn", ARCHS)
def test_zero1_update_bitwise_replicated(runs, arch, ffn):
    for shape in ("2x2", "1x1"):
        res = runs[(arch, ffn)][shape][0]
        assert res["zero1_bitwise"], shape
        assert res["norm_rel"] <= NORM_RTOL, (shape, res["norm_rel"])


@pytest.mark.parametrize("arch,ffn", ARCHS)
def test_sp_grads_match_one_process(runs, arch, ffn):
    """``activation_mode="sp"`` on 2x2: the first step's mean gradient
    within ``GRAD_TOL * (1 + max|g|)`` of one process's."""
    _grads_match_one_process(runs[(arch, ffn)], arch, "_sp")


@pytest.mark.parametrize("arch,ffn", ARCHS)
def test_sp_grads_match_reference(runs, arch, ffn):
    """The sp run's gradient against ``jax.grad`` of the reference's
    train-step loss with ``StepOptions(activation_mode="sp")`` on 2x4."""
    _grads_match_reference(runs[(arch, ffn)], "_sp")


@pytest.mark.parametrize("arch,ffn", ARCHS)
def test_sp_steps_match_one_process_and_reference(runs, arch, ffn):
    _steps_match(runs[(arch, ffn)], arch, "_sp")


@pytest.mark.parametrize("arch,ffn", ARCHS)
def test_sp_runs_bitwise_and_zero1(runs, arch, ffn):
    run = runs[(arch, ffn)]
    _runs_bitwise(run, "_sp")
    res = run["2x2_sp"][0]
    assert res["zero1_bitwise"]
    assert res["norm_rel"] <= NORM_RTOL, res["norm_rel"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch,ffn", ARCHS)
def test_tp_leaves_not_gathered_along_model(runs, arch, ffn, mode):
    """The 2x2 step computes its tensor-parallel leaves from their model
    shards: the step's gathers run one all-gather along ``model`` for
    each other leaf with a ``model`` shard, none for them."""
    res = runs[(arch, ffn)]["2x2" + ("_sp" if mode == "sp" else "")][0]
    assert res["n_tp"] > 0
    assert res["model_gathers"] == res["model_gathers_want"]
    assert res["model_gathers_want"] <= res["model_leaves"] - res["n_tp"]
