"""Port parity: ``launch/sharding`` against ``repro/launch/sharding.py``.

For every zoo arch the port's specs equal the reference's entry for
entry: ``param_shardings`` (with and without ``fsdp``),
``zero1_shardings``, ``batch_shardings`` and ``cache_shardings`` on 1x1
and 2x4 meshes at the reference test's ``reduce()`` sizes, and the same
on the (16, 16) and (2, 16, 16) production shapes at full size over
``param_specs(cfg)`` on the meta device (and the reference's
``param_shapes``).  The reference's rules read only a mesh's axis names
and shape; they run here on a stand-in mesh with its ``NamedSharding``
replaced by the bare spec, so no devices are needed.  ``shard_leaf`` then
``gather_leaf`` on 4 gloo ranks rebuilds every leaf bitwise.
"""
import os
import textwrap
import types

import jax.tree_util as jtu
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.sharding as JSH  # noqa: E402
from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.configs.registry import ARCHS as J_ARCHS  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    POD_AXES,
    ProcessMesh,
    make_production_mesh,
    spawn_ranks,
)
from repro_torch.utils import leaf_paths  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
SMALL = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=64, n_heads=4,
             n_kv_heads=2)
MESHES = {"1x1": (("data", "model"), (1, 1)),
          "2x4": (("data", "model"), (2, 4))}


class _Sharding:
    """The reference's ``NamedSharding`` without devices: its spec."""

    def __init__(self, mesh, spec):
        self.spec = spec


@pytest.fixture(autouse=True)
def bare_specs(monkeypatch):
    monkeypatch.setattr(JSH, "NamedSharding", _Sharding)


def _jmesh(axes, shape):
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


def _jflat(tree):
    return {jtu.keystr(p): tuple(v.spec)
            for p, v in jtu.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    return {k: v.parts for k, v in leaf_paths(tree)}


def _same(port, ref):
    t, j = _tflat(port), _jflat(ref)
    assert t.keys() == j.keys()
    bad = {k: (t[k], j[k]) for k in t if t[k] != j[k]}
    assert not bad, bad


def _both(arch, small):
    jc, tc = J_ARCHS[arch], ARCHS[arch]
    if small:
        jc, tc = jc.reduce(**SMALL), tc.reduce(**SMALL)
    return jc, tc


def _check_params(jc, tc, jmesh, tmesh):
    jp, tp = JT.param_shapes(jc), SP.param_specs(tc)
    for fsdp in (False, True):
        jsh = JSH.param_shardings(jp, jmesh, fsdp=fsdp)
        tsh = SH.param_shardings(tp, tmesh, fsdp=fsdp)
        _same(tsh, jsh)
    jsh = JSH.param_shardings(jp, jmesh, fsdp=jc.fsdp)
    tsh = SH.param_shardings(tp, tmesh, fsdp=tc.fsdp)
    _same(SH.zero1_shardings(tp, tsh, tmesh),
          JSH.zero1_shardings(jp, jsh, jmesh))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_reference_reduced(arch, mesh):
    axes, shape = MESHES[mesh]
    jc, tc = _both(arch, small=True)
    jmesh, tmesh = _jmesh(axes, shape), ProcessMesh(axes, shape,
                                                    abstract=True)
    _check_params(jc, tc, jmesh, tmesh)
    for name, jshape in J_SHAPES.items():
        if name == "long_500k" and not jc.subquadratic:
            continue
        jin, tin = JSP.input_specs(jc, jshape), SP.input_specs(tc,
                                                               SHAPES[name])
        if jshape.kind == "decode":
            _same(SH.cache_shardings(tin["caches"], tmesh),
                  JSH.cache_shardings(jin["caches"], jmesh))
            tin = {"token": tin["token"]}
            jin = {"token": jin["token"]}
        _same(SH.batch_shardings(tin, tmesh), JSH.batch_shardings(jin, jmesh))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_reference_production(arch, multi_pod):
    jc, tc = _both(arch, small=False)
    tmesh = make_production_mesh(multi_pod=multi_pod)
    assert tmesh.axis_names == (POD_AXES if multi_pod else ("data", "model"))
    jmesh = _jmesh(tmesh.axis_names, tmesh.shape)
    _check_params(jc, tc, jmesh, tmesh)
    # every leaf's _spec_for_path/_fit on its own
    for k, leaf in leaf_paths(SP.param_specs(tc)):
        assert leaf.device.type == "meta"
        got = SH._spec_for_path(k, leaf.dim(), tuple(leaf.shape), tmesh)
        ref = JSH._spec_for_path(k, leaf.dim(), tuple(leaf.shape), jmesh)
        assert got.parts == tuple(ref), k


def test_state_specs_match_reference():
    jc, tc = _both("qwen2-0.5b", small=True)
    jst, tst = JSP.state_specs(jc), SP.state_specs(tc)
    j = {jtu.keystr(p): (tuple(v.shape), str(v.dtype))
         for p, v in jtu.tree_flatten_with_path(jst)[0]}
    t = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in leaf_paths(tst)}
    assert t == j
    tree = ST.train_state_shardings(tc, ProcessMesh(("data", "model"), (2, 4),
                                                    abstract=True))
    assert leaf_paths(tree)[-1][1] == () and tree["opt"].count == ()


WORKER = textwrap.dedent("""
    import sys
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import mesh as M, sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.utils import leaf_paths
    import dataclasses

    mesh = M.init_from_env((2, 2), device="cpu")
    ok = True
    for arch, dtype in (("qwen3-moe-235b-a22b", "float32"),
                        ("qwen2-0.5b", "bfloat16")):
        cfg = dataclasses.replace(get_config(arch).reduce(
            n_layers=2, d_model=32, d_ff=64, vocab_size=64, n_heads=4,
            n_kv_heads=2), dtype=dtype)
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        specs = SH.param_shardings(params, mesh, fsdp=True)
        specs = SH.zero1_shardings(params, specs, mesh)
        for (k, x), (_, s) in zip(leaf_paths(params), leaf_paths(specs)):
            sh = SH.shard_leaf(x, s, mesh)
            n = 1
            for a in s.axes():
                n *= mesh.axis_size(a)
            ok &= sh.numel() * n == x.numel()
            ok &= torch.equal(SH.gather_leaf(sh, s, mesh).view(torch.uint8)
                              if x.dtype == torch.bfloat16 else
                              SH.gather_leaf(sh, s, mesh),
                              x.view(torch.uint8)
                              if x.dtype == torch.bfloat16 else x)
    print("OK" if ok else "MISMATCH")
    M.destroy_process_mesh(mesh)
""")


def test_shard_then_gather_bitwise(tmp_path):
    outs = spawn_ranks(["-c", WORKER], 4, str(tmp_path / "rv"),
                       timeout_s=120,
                       env={"PYTHONPATH": SRC + os.pathsep
                            + os.environ.get("PYTHONPATH", ""),
                            "OMP_NUM_THREADS": "1"})
    assert [o.strip().splitlines()[-1] for o, _ in outs] == ["OK"] * 4
