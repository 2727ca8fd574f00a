"""``runtime/trainer.Trainer(mesh=)`` on 4 gloo ranks, on the CPU: a run
killed by an injected failure and restarted from its checkpoint ends
with the bits of one that was not (on 2x2, and on the 1x1 host mesh with
``grad_compression``, whose error-feedback residual is checkpointed and
restored), and a 2x2 mesh's checkpoint (whole
leaves in the reference's layout, written by rank 0) restores on 1x1 and
on 1x2 (the reference's elastic restore) bitwise leaf for leaf, and
trains on.
"""
import json
import os
import shutil
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import latest_step, restore_checkpoint  # noqa
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.utils import leaf_paths, tree_map  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
SPAWN_S = 120
ARCH = "qwen2-0.5b"

WORKER = textwrap.dedent("""
    import sys, json
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm import LMDataConfig, SyntheticLM
    from repro_torch.launch import mesh as M, steps as ST
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.utils import leaf_paths

    arch, shape, ckpt, out, steps, fail, comp = sys.argv[1:8]
    cfg = get_config(arch).reduce(n_layers=2, d_model=32, d_ff=64,
                                  vocab_size=64, n_heads=4, n_kv_heads=2)
    mesh = M.init_from_env(M.parse_mesh(shape), device="cpu")
    data = SyntheticLM(LMDataConfig(vocab_size=64, seq_len=16,
                                    global_batch=8, seed=0))
    tcfg = TrainerConfig(max_steps=int(steps), ckpt_dir=ckpt, ckpt_every=2,
                         log_every=100,
                         failure_at=int(fail) if fail != "-" else None)
    opts = ST.StepOptions(lr=1e-3, total_steps=10, warmup=0,
                          grad_compression=comp == "1")
    tr = Trainer(cfg, tcfg, "cpu", data, opts, mesh=mesh)
    restored = ST.gather_state(tr.state, cfg, mesh)
    res = tr.run_with_restarts()
    whole = ST.gather_state(tr.state, cfg, mesh)
    if opts.grad_compression:
        whole["ef_residual"] = tr.state["ef_residual"]
    if mesh.rank == 0:
        for name, tree in (("restored", restored), ("final", whole)):
            np.savez(out + "_" + name + ".npz",
                     **{k: v.numpy() for k, v in leaf_paths(tree)})
        json.dump({"losses": [m["loss"] for m in res["metrics"]],
                   "final_step": res["final_step"]}, open(out + ".json", "w"))
    M.destroy_process_mesh(mesh)
""")


def _run(tmp, shape, ckpt, tag, steps, fail="-", comp="0"):
    world = int(np.prod([int(n) for n in shape.split("x")]))
    out = str(tmp / tag)
    spawn_ranks(["-c", WORKER, ARCH, shape, str(ckpt), out, str(steps),
                 fail, comp], world, str(tmp / f"rv_{tag}"), timeout_s=SPAWN_S,
                env={"PYTHONPATH": SRC + os.pathsep
                     + os.environ.get("PYTHONPATH", ""),
                     "OMP_NUM_THREADS": "1"})
    with open(out + ".json") as f:
        res = json.load(f)
    return (res, dict(np.load(out + "_restored.npz")),
            dict(np.load(out + "_final.npz")))


def _equal(a, b):
    assert a.keys() == b.keys()
    return [k for k in a if not np.array_equal(a[k], b[k])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_trainer")
    return tmp, {
        "straight": _run(tmp, "2x2", tmp / "ck_straight", "straight", 4),
        "failed": _run(tmp, "2x2", tmp / "ck_failed", "failed", 4, "3"),
        "straight_ef": _run(tmp, "1x1", tmp / "ck_straight_ef",
                            "straight_ef", 4, "-", "1"),
        "failed_ef": _run(tmp, "1x1", tmp / "ck_failed_ef", "failed_ef", 4,
                          "3", "1")}


def test_mesh_restart_bitwise(runs):
    _, r = runs
    (ra, _, fa), (rb, _, fb) = r["straight"], r["failed"]
    assert ra["final_step"] == rb["final_step"] == 4
    # the failed run's log restarts at the checkpoint of step 2
    assert rb["losses"][-2:] == ra["losses"][-2:]
    assert _equal(fa, fb) == []


def test_host_mesh_restart_with_compression_bitwise(runs):
    """The 1x1 mesh checkpoints its error-feedback residual: restored as
    zeros, step 3 would quantize another gradient."""
    _, r = runs
    (ra, _, fa), (rb, _, fb) = r["straight_ef"], r["failed_ef"]
    assert ra["final_step"] == rb["final_step"] == 4
    assert rb["losses"][-2:] == ra["losses"][-2:]
    res = [k for k in fa if k.startswith("['ef_residual']")]
    assert res and any(np.abs(fa[k]).max() > 0 for k in res)
    assert _equal(fa, fb) == []


@pytest.mark.parametrize("shape", ["1x1", "1x2"])
def test_mesh_checkpoint_restores_elastic(runs, shape):
    tmp, r = runs
    src = tmp / "ck_straight"
    assert latest_step(str(src)) == 4
    ck = tmp / f"ck_{shape}"
    shutil.copytree(src, ck)
    cfg = get_config(ARCH).reduce(n_layers=2, d_model=32, d_ff=64,
                                  vocab_size=64, n_heads=4, n_kv_heads=2)
    target = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype),
                      SP.state_specs(cfg))
    saved, step, _ = restore_checkpoint(str(src), target)
    saved = {k: v.numpy() for k, v in leaf_paths(saved)}
    assert saved.keys() == r["straight"][2].keys()
    res, restored, final = _run(tmp, shape, ck, f"restore_{shape}", 5)
    assert _equal(restored, saved) == []
    assert _equal(r["straight"][2], saved) == []
    assert res["final_step"] == 5 and len(res["losses"]) == 1
    assert np.isfinite(res["losses"][0])
    assert not np.array_equal(final["['params']['embed']['table']"],
                              saved["['params']['embed']['table']"])
