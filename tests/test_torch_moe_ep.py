"""Expert parallelism (``models/moe.moe_apply`` under an active mesh with
``model`` > 1) on gloo ranks, on the CPU, against the 1-device path and
the reference's ``shard_map`` branch under ``jax.set_mesh``.

The layer's weights and input are drawn with numpy from a seed (the
reference's shapes), with capacity 1.25 so tokens are dropped.  Over
``model`` in {2, 4}:

* the forward (out and aux) within ``1e-5 * (1 + max|ref|)`` of the
  port's 1-device path and of the reference's EP branch on 1 x m host
  devices;
* the gradients of a fixed scalar of the output (and the aux loss) with
  respect to the router, every expert and x within the same bound of
  the 1-device gradients: the router's and x's need the *enter*
  Function's sum over ``model``;
* the 1-device path bitwise ``_moe_local`` with ``e0 = 0, E_loc = E``,
  and under a 1x1 host mesh.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import make_host_mesh, set_mesh, spawn_ranks  # noqa
from repro_torch.models import moe as TM  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
SPAWN_S = 120
TOL = 1e-5
D, F_, E, K, B, S = 16, 32, 8, 2, 2, 12

REF = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import sys
    import jax, jax.numpy as jnp, numpy as np
    import repro.jax_compat  # noqa: F401
    from repro.models.moe import MoEConfig, moe_apply

    d = sys.argv[1]
    z = dict(np.load(d + "/inputs.npz"))
    cfg = MoEConfig(d_model=16, d_ff=32, n_experts=8, top_k=2)
    params = {"router": {"kernel": z["router"]},
              "experts": {"gate": z["gate"], "up": z["up"],
                          "down": z["down"]}}
    out = {}
    for m in (2, 4):
        mesh = jax.make_mesh((1, m), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        with jax.set_mesh(mesh):
            r = moe_apply(params, z["x"], cfg)
        out[f"out_{m}"], out[f"aux_{m}"] = r["out"], r["aux_loss"]
    np.savez(d + "/ref.npz", **{k: np.asarray(v) for k, v in out.items()})
""")

WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as M, collectives as C
    from repro_torch.models.moe import MoEConfig, moe_apply, local_experts

    d, m = sys.argv[1], int(sys.argv[2])
    mesh = M.init_from_env((1, m), device="cpu")
    z = dict(np.load(d + "/inputs.npz"))
    cfg = MoEConfig(d_model=16, d_ff=32, n_experts=8, top_k=2)
    e0, n = local_experts(cfg, mesh)
    t = lambda a: torch.from_numpy(a.copy()).requires_grad_(True)
    x, router = t(z["x"]), t(z["router"])
    ex = {k: t(z[k][e0:e0 + n]) for k in ("gate", "up", "down")}
    with M.set_mesh(mesh):
        r = moe_apply({"router": {"kernel": router}, "experts": ex}, x, cfg)
    loss = torch.sum(r["out"] * torch.from_numpy(z["w"])) \\
        + 0.01 * r["aux_loss"]
    gx, gr, *ge = torch.autograd.grad(
        loss, [x, router] + [ex[k] for k in ("gate", "up", "down")])
    ge = [C.gather_cat(g, mesh, "model", 0) for g in ge]
    if mesh.rank == 0:
        np.savez(d + f"/port_{m}.npz", out=r["out"].detach().numpy(),
                 aux=r["aux_loss"].detach().numpy(), gx=gx.numpy(),
                 gr=gr.numpy(), gg=ge[0].numpy(), gu=ge[1].numpy(),
                 gd=ge[2].numpy())
    M.destroy_process_mesh(mesh)
""")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    return {"x": f(B, S, D), "router": f(D, E, sc=D ** -0.5),
            "gate": f(E, D, F_, sc=D ** -0.5), "up": f(E, D, F_, sc=D ** -0.5),
            "down": f(E, F_, D, sc=D ** -0.5), "w": f(B, S, D)}


def _local(z):
    """The 1-device forward and gradients."""
    cfg = TM.MoEConfig(d_model=D, d_ff=F_, n_experts=E, top_k=K)
    t = lambda a: torch.from_numpy(a.copy()).requires_grad_(True)
    x, router = t(z["x"]), t(z["router"])
    ex = {k: t(z[k]) for k in ("gate", "up", "down")}
    r = TM.moe_apply({"router": {"kernel": router}, "experts": ex}, x, cfg)
    loss = torch.sum(r["out"] * torch.from_numpy(z["w"])) \
        + 0.01 * r["aux_loss"]
    g = torch.autograd.grad(loss, [x, router, ex["gate"], ex["up"],
                                   ex["down"]])
    return {"out": r["out"].detach().numpy(),
            "aux": r["aux_loss"].detach().numpy(),
            **{k: v.numpy() for k, v in zip(("gx", "gr", "gg", "gu", "gd"),
                                             g)}}


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= TOL * (1 + float(np.abs(ref).max())), (what, err)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    z = _inputs()
    np.savez(tmp / "inputs.npz", **z)
    r = subprocess.run([sys.executable, "-c", REF, str(tmp)],
                       capture_output=True, text=True, cwd=REPO,
                       timeout=SPAWN_S, env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0, r.stderr[-3000:]
    env = {"PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    for m in (2, 4):
        spawn_ranks(["-c", WORKER, str(tmp), str(m)], m,
                    str(tmp / f"rv{m}"), timeout_s=SPAWN_S, env=env)
    return (z, dict(np.load(tmp / "ref.npz")),
            {m: dict(np.load(tmp / f"port_{m}.npz")) for m in (2, 4)})


@pytest.mark.parametrize("m", [2, 4])
def test_ep_forward_matches_local_and_reference(runs, m):
    z, ref, port = runs
    loc = _local(z)
    got = port[m]
    _close(got["out"], loc["out"], "out vs local")
    _close(got["aux"], loc["aux"], "aux vs local")
    _close(got["out"], ref[f"out_{m}"], "out vs reference EP")
    _close(got["aux"], ref[f"aux_{m}"], "aux vs reference EP")
    # some picks were dropped at capacity 1.25, and EP drops the same
    assert np.abs(loc["out"]).max() > 0


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("leaf", ["gx", "gr", "gg", "gu", "gd"])
def test_ep_gradients_match_local(runs, m, leaf):
    z, _, port = runs
    _close(port[m][leaf], _local(z)[leaf], leaf)


def test_one_device_path_unchanged():
    z = _inputs(1)
    cfg = TM.MoEConfig(d_model=D, d_ff=F_, n_experts=E, top_k=K)
    t = {k: torch.from_numpy(v) for k, v in z.items()}
    params = {"router": {"kernel": t["router"]},
              "experts": {k: t[k] for k in ("gate", "up", "down")}}
    a = TM.moe_apply(params, t["x"], cfg)
    xt = t["x"].reshape(B * S, D)
    out, aux = TM._moe_local(xt, t["router"], t["gate"], t["up"], t["down"],
                             cfg, 0, E)
    assert torch.equal(a["out"], out.reshape(B, S, D))
    assert torch.equal(a["aux_loss"], aux)
    with set_mesh(make_host_mesh()):
        b = TM.moe_apply(params, t["x"], cfg)
    assert torch.equal(a["out"], b["out"])
    assert torch.equal(a["aux_loss"], b["aux_loss"])
