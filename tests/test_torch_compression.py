"""``optim/compression.compressed_allreduce(axis_name="data")`` on 4
gloo ranks against the reference's ``shard_map`` + ``psum`` on 4 host
devices, on the CPU: the same per-rank gradients and residuals give
bitwise the same dequantized gradients and new residuals on every rank
(the codes' int32 sum is exact, ``pmax`` of the scales exact, and the
dequantization the same f32 ops in the same order).

The reference's ``shard_map`` runs eagerly (``jax.disable_jit``), op by
op, as its compression functions run in ``tests/test_torch_lm_train.py``:
under ``jit`` XLA rewrites the division by the constant 127 into a
product with its f32 reciprocal, one ulp off the division on some scales,
which the reference's functions do not write.
"""
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
N = 4
SHAPES = {"['a']": (3, 5), "['b']['w']": (64,), "['b']['z']": (2, 3, 4)}

REF = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import sys
    import jax, jax.numpy as jnp, numpy as np
    import repro.jax_compat  # noqa: F401
    from jax.sharding import PartitionSpec as P
    from repro.optim.compression import compressed_allreduce

    d = sys.argv[1]
    z = dict(np.load(d + "/inputs.npz"))
    grads = {"a": z["g_a"], "b": {"w": z["g_w"], "z": z["g_z"]}}
    res = {"a": z["r_a"], "b": {"w": z["r_w"], "z": z["r_z"]}}
    mesh = jax.make_mesh((4,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))

    def body(g, r):
        g = jax.tree.map(lambda x: x[0], g)
        r = jax.tree.map(lambda x: x[0], r)
        deq, nr = compressed_allreduce(g, r, axis_name="data")
        return (jax.tree.map(lambda x: x[None], deq),
                jax.tree.map(lambda x: x[None], nr))

    with jax.disable_jit():
        deq, nr = jax.shard_map(body, mesh=mesh,
                                in_specs=(P("data"), P("data")),
                                out_specs=(P("data"), P("data")),
                                check_vma=False)(grads, res)
    np.savez(d + "/ref.npz", d_a=deq["a"], d_w=deq["b"]["w"],
             d_z=deq["b"]["z"], n_a=nr["a"], n_w=nr["b"]["w"],
             n_z=nr["b"]["z"])
""")

WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch
    from repro_torch.launch import mesh as M
    from repro_torch.optim.compression import compressed_allreduce

    d = sys.argv[1]
    mesh = M.init_from_env((4, 1), device="cpu")
    r = mesh.rank
    z = dict(np.load(d + "/inputs.npz"))
    t = lambda k: torch.from_numpy(z[k][r].copy())
    grads = {"a": t("g_a"), "b": {"w": t("g_w"), "z": t("g_z")}}
    res = {"a": t("r_a"), "b": {"w": t("r_w"), "z": t("r_z")}}
    with M.set_mesh(mesh):
        deq, nr = compressed_allreduce(grads, res, axis_name="data")
    np.savez(d + f"/port_{r}.npz", d_a=deq["a"], d_w=deq["b"]["w"],
             d_z=deq["b"]["z"], n_a=nr["a"], n_w=nr["b"]["w"],
             n_z=nr["b"]["z"])
    M.destroy_process_mesh(mesh)
""")


def test_compressed_allreduce_bitwise_reference(tmp_path):
    rng = np.random.default_rng(0)
    names = {"a": "['a']", "w": "['b']['w']", "z": "['b']['z']"}
    inputs = {}
    for short, path in names.items():
        shape = (N,) + SHAPES[path]
        # per-rank scales that differ, so pmax matters
        scale = np.array([0.5, 2.0, 1.0, 3.0]).reshape(
            (N,) + (1,) * len(SHAPES[path]))
        inputs[f"g_{short}"] = (rng.standard_normal(shape)
                                * scale).astype(np.float32)
        inputs[f"r_{short}"] = (1e-3 * rng.standard_normal(shape)
                                ).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", **inputs)
    r = subprocess.run([sys.executable, "-c", REF, str(tmp_path)],
                       capture_output=True, text=True, cwd=REPO,
                       timeout=SPAWN_S,
                       env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0, r.stderr[-3000:]
    spawn_ranks(["-c", WORKER, str(tmp_path)], N, str(tmp_path / "rv"),
                timeout_s=SPAWN_S,
                env={"PYTHONPATH": SRC + os.pathsep
                     + os.environ.get("PYTHONPATH", "")})
    ref = dict(np.load(tmp_path / "ref.npz"))
    for rank in range(N):
        got = dict(np.load(tmp_path / f"port_{rank}.npz"))
        for k in got:
            assert got[k].dtype == np.float32
            assert np.array_equal(got[k], ref[k][rank]), (rank, k)
    # every rank gets the same gradient, and the residual is its own
    for k in ("d_a", "d_w", "d_z"):
        assert all(np.array_equal(ref[k][0], ref[k][i]) for i in range(N))
    assert not np.array_equal(ref["n_a"][0], ref["n_a"][1])
