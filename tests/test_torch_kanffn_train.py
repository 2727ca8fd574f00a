"""Port parity: training with the reference's KAN-FFN (``--ffn kanffn``:
a fused-KAN up-projection and a pattern-matmul down-projection) against
the JAX package, on the CPU.

The reference trains it through its jnp path (``jax.grad`` through
``pattern_linear(impl="pallas_interpret")`` does not run), so the
port's matmul gradient (``kernels/pattern_matmul/ops.MatmulCompact``)
follows ``jax.grad`` of ``pattern_linear(impl="jnp")``.  At bf16 the
reference's masked jnp product fails under ``jit`` on this CPU (XLA:
BF16 x BF16 = F32, ``tests/test_torch_bf16.py``), so every reference
run here is under ``jax.disable_jit()``, op by op.  Inputs come from
numpy seeds; weights are the reference's draws carried across
(``convert.transformer_params_from_jax``).  Tolerances, each measured
with margin on this CPU:

* the Function (masked and unmasked, with and without bias, every
  epilogue) against ``jax.grad``: bf16 (bf16 out, and the f32 out of a
  tensor-parallel partial against the reference's jnp product with an
  f32 ``bias_act``) within one bf16 ulp of ``1 + max|ref|`` (largest
  seen 2.1e-5 ulp); f32 within ``1e-5 * (1 + max|ref|)`` (largest seen
  1.1e-6);
* a ``KanFFN`` layer's gradients into its params (the compacted ``w_c``
  rebuilt from ``w`` on each call): within one bf16 ulp (bitwise seen),
  f32 within 1e-5 (largest seen 1.8e-7);
* the whole bf16 train step of a reduced qwen2-0.5b with
  ``ffn_kind="kanffn"``: as ``tests/test_torch_lm_train.py`` holds its
  bf16 step, the loss within ``BF16_STEP_LOSS_RTOL`` and each gradient
  leaf within ``BF16_STEP_GRAD_ULPS`` bf16 ulps (largest seen 0.003);
* 4 gloo ranks on a 2x2 mesh (``kan_up`` tensor-parallel: a rank's
  down-projection is an f32 partial, summed over ``model``) against one
  process, in both activation modes: the loss within ``1e-3 * (1 +
  |loss|)`` (equal seen), each gradient leaf within ``MESH_GRAD_ULPS``
  bf16 ulp of ``1 + max|one|`` (largest seen 0.23, the embedding's);
* the launcher's ``--ffn kanffn``; the dry run's meta count of the
  reduced step equal to the CPU's (FLOPs, bytes, launches, argument
  bytes), with and without ``remat``.
"""
import dataclasses
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.core.sparsity import tiled_mask as j_tiled_mask  # noqa: E402
from repro.kernels.epilogue import bias_act as j_bias_act  # noqa: E402
from repro.kernels.pattern_matmul.ops import (  # noqa: E402
    pattern_linear as j_pattern_linear,
)
from repro.models.ffn import FFNConfig as JFFNConfig  # noqa: E402
from repro.models.ffn import ffn_init as j_ffn_init  # noqa: E402
from repro.models.ffn import kan_ffn_apply as j_kan_ffn_apply  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import transformer_params_from_jax  # noqa: E402
from repro_torch.core.sparsity import tiled_mask  # noqa: E402
from repro_torch.kernels import work as W  # noqa: E402
from repro_torch.kernels.pattern_matmul import ops as PO  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, spawn_ranks  # noqa
from repro_torch.models import ffn as FF  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.utils import leaf_from_numpy, leaf_paths  # noqa: E402

from _mesh_parity import env as _env  # noqa: E402
from test_torch_dryrun import _counts, _real  # noqa: E402
from test_torch_lm_train import (  # noqa: E402
    BF16_STEP_GRAD_ULPS,
    BF16_STEP_LOSS_RTOL,
    BF16_ULP,
    JS,
    TS,
    _batch,
    _carried,
    _hold_grads,
    _opts,
    _port_step,
    _ref_step,
)

F32_TOL = 1e-5
MESH_LOSS_TOL = 1e-3
MESH_GRAD_ULPS = 1
SPAWN_S = 240
KANFFN = {"ffn_kind": "kanffn", "pattern_rate": 0.5}
# the reduced bf16 config of the whole-step parity
REDUCED = {"dtype": "bfloat16", "n_layers": 2, "d_model": 64, "d_ff": 128,
           "vocab_size": 128}
# on the mesh: d_ff 144 makes the KAN-FFN's hidden width 32, 16 lanes a
# model rank, whole groups of 4 under the hidden mask, so ``kan_up`` is
# computed from its shard (``sharding.tp_unit``)
MESH_REDUCED = {**REDUCED, "d_ff": 144}
ACTS = (None, "relu", "gelu", "silu")
# (operand dtype, output dtype)
DTYPES = [("bfloat16", "bfloat16"), ("bfloat16", "float32"),
          ("float32", "float32")]


def _f64(a):
    if torch.is_tensor(a):
        a = a.detach().to(torch.float32).numpy()
    return np.asarray(np.asarray(a, np.float32), np.float64)


def _within(got, ref, tol, what):
    got, ref = _f64(got), _f64(ref)
    assert got.shape == ref.shape, what
    assert np.all(np.isfinite(got)), what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= tol * (1.0 + float(np.abs(ref).max())), (what, err)


# ------------------------------------------------------------ the Function

def _ref_linear(x, w, mask, b, act, out_dtype):
    """The reference's jnp path: ``pattern_linear(impl="jnp")``, or for an
    f32 output its gather, product and ``bias_act`` with f32 out."""
    if out_dtype == x.dtype:
        return j_pattern_linear(x, w, mask, b, act=act, impl="jnp")
    if mask is not None:
        idx = jnp.asarray(mask.indices())
        x, w = jnp.take(x, idx, axis=1), jnp.take(w, idx, axis=0)
    acc = jnp.dot(x, w, preferred_element_type=jnp.float32)
    return j_bias_act(acc, b, act, out_dtype)


@pytest.mark.parametrize("dtype,out", DTYPES, ids=["bf16", "bf16-f32out",
                                                   "f32"])
@pytest.mark.parametrize("act", ACTS, ids=[str(a) for a in ACTS])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_function_matches_jax_grad(dtype, out, act, masked, bias):
    """``pattern_linear``'s gradient (x, w, bias) against ``jax.grad`` of
    the reference's jnp path; pre-activations exactly 0 included (relu's
    kink: 0, as ``jax.nn.relu``)."""
    jdt, jout = jnp.dtype(dtype), jnp.dtype(out)
    rng = np.random.default_rng([ACTS.index(act), int(masked), int(bias),
                                 DTYPES.index((dtype, out))])
    M, K, N = 24, 32, 12
    x = rng.standard_normal((M, K)).astype(jdt)
    w = (rng.standard_normal((K, N)) * 0.3).astype(jdt)
    b = rng.standard_normal(N).astype(jdt)
    x[:3] = 0
    if not bias:
        x[3:6] = 0      # the acc itself exactly 0 without a bias
    cot = rng.standard_normal((M, N)).astype(np.float32)
    jm = j_tiled_mask(K, (1, 0, 1, 0)) if masked else None
    tm = tiled_mask(K, (1, 0, 1, 0)) if masked else None

    def f(xx, ww, bb):
        y = _ref_linear(xx, ww, jm, bb if bias else None, act, jout)
        return jnp.sum(y.astype(jnp.float32) * cot)

    with jax.disable_jit():
        ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    tx, tw, tb = (leaf_from_numpy(a).requires_grad_(True) for a in (x, w, b))
    y = PO.pattern_linear(tx, tw, tm, tb if bias else None, act=act,
                          out_dtype=getattr(torch, out))
    assert y.dtype == getattr(torch, out)
    assert y.grad_fn is not None
    (y.float() * torch.from_numpy(cot)).sum().backward()
    tol = BF16_ULP if dtype == "bfloat16" else F32_TOL
    for t, r, name in ((tx, ref[0], "dx"), (tw, ref[1], "dw"),
                       (tb, ref[2], "db")):
        if name == "db" and not bias:
            assert t.grad is None
            continue
        assert t.grad.dtype == t.dtype, name
        _within(t.grad, r, tol, name)
    if masked:
        # the dropped lanes and rows get exact zeros (the gather's scatter)
        drop = torch.as_tensor(~tm.keep)
        assert torch.all(tx.grad[:, drop] == 0)
        assert torch.all(tw.grad[drop] == 0)


@pytest.mark.parametrize("act,out", [(None, "bfloat16"), (None, "float32"),
                                     ("relu", "bfloat16"),
                                     ("relu", "float32"),
                                     ("gelu", "bfloat16")])
def test_backward_route(act, out, monkeypatch):
    """The backward's launches of the matmul's device branch: with no
    epilogue and a bf16 output (the cotangent is bf16, so ``g'`` is) dx
    and dw are two launches of the bf16 kernel, rounding once to bf16;
    an f32 relu output masks by itself; any other epilogue relaunches the
    forward once for its f32 pre-activation; every other product is an
    IEEE f32 product."""
    calls = []
    inner = PO._matmul_compact

    def spy(x_c, w_c, bias, act_, blocks, out_dtype, dtype):
        calls.append((tuple(x_c.shape), tuple(w_c.shape), act_,
                      out_dtype))
        return inner(x_c, w_c, bias, act_, blocks, out_dtype, dtype)

    monkeypatch.setattr(PO, "_matmul_compact", spy)
    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator().manual_seed(1)
    x = torch.randn((8, 16), generator=g).to(bf16).requires_grad_(True)
    w = torch.randn((16, 4), generator=g).to(bf16).requires_grad_(True)
    b = torch.randn(4, generator=g).to(bf16).requires_grad_(True)
    y = PO.matmul_compact(x, w, b, act, out_dtype=getattr(torch, out))
    assert calls == [((8, 16), (16, 4), act, getattr(torch, out))]
    y.float().sum().backward()
    if act is None and out == "bfloat16":
        want = [((8, 4), (4, 16), None, bf16), ((16, 8), (8, 4), None, bf16)]
    elif act == "relu" and out == "float32" or act is None:
        want = []
    else:
        want = [((8, 16), (16, 4), None, f32)]
    assert calls[1:] == want
    assert (x.grad.dtype, w.grad.dtype, b.grad.dtype) == (bf16,) * 3


def test_serving_takes_no_gradient_path():
    """Under ``no_grad`` the bf16 matmul launches what it did before: no
    autograd node, bitwise the Function's forward."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((6, 8), generator=g).to(torch.bfloat16)
    w = torch.randn((8, 5), generator=g).to(torch.bfloat16)
    with_grad = PO.matmul_compact(x, w.clone().requires_grad_(True),
                                  act="gelu")
    with torch.no_grad():
        y = PO.matmul_compact(x, w.clone().requires_grad_(True), act="gelu")
    assert y.grad_fn is None and with_grad.grad_fn is not None
    assert torch.equal(y, with_grad.detach())


# ------------------------------------------------------------ a KanFFN layer

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kanffn_layer_gradient_reaches_its_params(dtype):
    """A ``KanFFN`` built from leaves that require grad (its compacted
    ``w_c`` a buffer rebuilt from ``w`` on each call) carries the
    gradient to ``w``, ``b`` and ``kan_up``: against ``jax.grad`` of the
    reference's ``kan_ffn_apply``; the rows of ``w`` the hidden mask
    drops get exact zeros."""
    jcfg = JFFNConfig(d_model=32, d_ff=64, kind="kanffn", pattern_rate=0.5)
    tcfg = FF.FFNConfig(d_model=32, d_ff=64, kind="kanffn",
                        pattern_rate=0.5)
    jp = j_ffn_init(jax.random.key(3), jcfg, jnp.dtype(dtype))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 32)).astype(jnp.dtype(dtype))
    cot = rng.standard_normal((2, 5, 32)).astype(np.float32)

    def f(p, xx):
        y = j_kan_ffn_apply(p, xx, jcfg)
        return jnp.sum(y.astype(jnp.float32) * cot)

    with jax.disable_jit():
        ref = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = transformer_params_from_jax(jp)
    for _, v in leaf_paths(tp):
        v.requires_grad_(True)
    tx = leaf_from_numpy(x).requires_grad_(True)
    y = FF.KanFFN(tcfg, tp)(tx)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    tol = BF16_ULP if dtype == "bfloat16" else F32_TOL
    want = dict(leaf_paths(transformer_params_from_jax(ref[0])))
    for k, v in leaf_paths(tp):
        assert v.grad is not None and v.grad.dtype == v.dtype, k
        _within(v.grad, want[k], tol, k)
    _within(tx.grad, np.asarray(ref[1], np.float32), tol, "dx")
    drop = torch.as_tensor(~tcfg.kanffn_hidden_mask().keep)
    assert torch.all(tp["w"].grad[drop] == 0)
    assert torch.count_nonzero(tp["w"].grad[~drop]) > 0


# ------------------------------------------------------------ the train step

def _cfgs(over):
    def one(get):
        return dataclasses.replace(get("qwen2-0.5b").reduce(**over), **KANFFN)
    return one(j_get_config), one(get_config)


def test_bf16_step_matches_reference(monkeypatch):
    """One bf16 train step of the reduced qwen2-0.5b with the KAN-FFN, the
    reference's draw carried across: the gradients into AdamW and the
    loss.  ``kan_up.t`` stays f32 (the reference's ``kan_init``), so the
    up-projection is the mixed layer; every other leaf is bf16, and so
    is its gradient."""
    jcfg, tcfg = _cfgs(REDUCED)
    oj, ot = _opts(JS), _opts(TS)
    jstate, tstate = _carried(jcfg, oj, ot, tcfg)
    dtypes = {k: v.dtype for k, v in leaf_paths(tstate["params"])}
    assert {k for k, d in dtypes.items() if d != torch.bfloat16} == {
        "['units']['slot0']['ffn']['kan_up']['t']"}
    batch = _batch(tcfg)
    with jax.disable_jit():
        _, jm, jg, _ = _ref_step(jcfg, oj, jstate, batch, monkeypatch)
    _, tm, tg, _ = _port_step(tcfg, ot, tstate, batch, monkeypatch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        BF16_STEP_LOSS_RTOL * abs(float(jm["loss"]))
    _hold_grads(tg, jg, BF16_STEP_GRAD_ULPS * BF16_ULP, "bf16 kanffn grad")
    g = dict(leaf_paths(tg))
    assert torch.count_nonzero(g["['units']['slot0']['ffn']['w']"]) > 0


# ------------------------------------------------------------ the 2x2 mesh

WORKER = textwrap.dedent("""
    import sys, json, dataclasses
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import mesh as M, steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.utils import leaf_from_numpy, leaf_paths, \\
        tree_map_with_path

    out, over = sys.argv[1], json.loads(sys.argv[2])
    cfg = dataclasses.replace(
        get_config("qwen2-0.5b").reduce(**over["reduce"]), **over["cfg"])
    mesh = M.init_from_env((2, 2), device="cpu")
    with np.load(out + "/init.npz") as z:
        params = tree_map_with_path(
            lambda k, s: leaf_from_numpy(z[k]).to(s.dtype),
            T.param_shapes(cfg))
    tokens = torch.as_tensor(np.load(out + "/tokens.npy"))
    batch = ST.local_batch({"tokens": tokens}, mesh)
    res = {}
    for mode in ("replicated", "sp"):
        opts = ST.StepOptions(lr=1e-3, total_steps=10, warmup=0,
                              activation_mode=mode)
        step = ST.make_train_step(cfg, opts, mesh)
        state = ST.init_train_state(cfg, opts, params=params, mesh=mesh)
        total, ce, slices, _ = step.grads(state, batch)
        whole = step.gather_grads(slices)
        res[mode] = {"loss": float(ce), "tp": sorted(step.tp)}
        if mesh.rank == 0:
            np.savez(out + "/grads_" + mode + ".npz",
                     **{k: v.float().numpy() for k, v in leaf_paths(whole)})
    if mesh.rank == 0:
        json.dump(res, open(out + "/res.json", "w"))
    M.destroy_process_mesh(mesh)
""")


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The reduced bf16 KAN-FFN step's gradients on 4 gloo ranks (2x2,
    both activation modes, rank 0's gathered gradients) and in one
    process, from the same params (the port's draw) and tokens."""
    tmp = tmp_path_factory.mktemp("kanffn_mesh")
    _, cfg = _cfgs(MESH_REDUCED)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    # saved as f32 (exact for bf16), cast back to each leaf's dtype
    np.savez(tmp / "init.npz", **{k: v.float().numpy()
                                  for k, v in leaf_paths(params)})
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (8, 17)).astype(np.int32)
    np.save(tmp / "tokens.npy", tokens)
    spawn_ranks(["-c", WORKER, str(tmp), json.dumps(
        {"reduce": MESH_REDUCED, "cfg": KANFFN})], 4, str(tmp / "rv"),
        timeout_s=SPAWN_S, env=_env())
    total, ce, grads = ST.value_and_grad(
        cfg, _opts(TS), params, {"tokens": torch.as_tensor(tokens)})
    res = json.loads((tmp / "res.json").read_text())
    return {"res": res, "loss": float(ce), "grads": dict(leaf_paths(grads)),
            "mesh": {m: dict(np.load(tmp / f"grads_{m}.npz"))
                     for m in ("replicated", "sp")}}


@pytest.mark.parametrize("mode", ["replicated", "sp"])
def test_mesh_step_equals_one_process(mesh_run, mode):
    res = mesh_run["res"][mode]
    # the KAN-FFN's up-projection is computed from its model shard
    assert "['units']['slot0']['ffn']['kan_up']['w_b']" in res["tp"]
    loss = mesh_run["loss"]
    assert abs(res["loss"] - loss) <= MESH_LOSS_TOL * (1 + abs(loss))
    got = mesh_run["mesh"][mode]
    assert sorted(got) == sorted(mesh_run["grads"])
    for k, v in mesh_run["grads"].items():
        _within(got[k], v, MESH_GRAD_ULPS * BF16_ULP, k)


# ------------------------------------------------------------ entry points

def test_launcher_trains_kanffn_on_cpu(tmp_path, capsys):
    out = ttrain.main(["--arch", "qwen2-0.5b", "--steps", "3", "--seq", "8",
                       "--batch", "2", "--ffn", "kanffn", "--pattern", "0.5",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 3 and len(out["metrics"]) == 3
    assert np.isfinite([m["loss"] for m in out["metrics"]]).all()
    text = capsys.readouterr().out
    assert "ffn kanffn, pattern 0.5" in text and "final step 3, loss" in text
    assert (tmp_path / "step_3" / "manifest.json").exists()


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_meta_count_equals_the_cpu_step(remat):
    """The dry run's count of the reduced bf16 KAN-FFN step on meta equals
    the same step counted on the CPU: FLOPs, bytes, argument bytes and
    each kernel's launches -- the bf16 matmul's three a layer (forward,
    dx, dw), four under ``remat`` (the recompute's forward)."""
    _, cfg = _cfgs(REDUCED)
    cfg = dataclasses.replace(cfg, remat=remat)
    shape = ShapeSpec("train", 8, 2, "train")
    opts = ST.StepOptions()
    meta = D.analyze_cell(cfg, shape, opts=opts, mesh_shape=(1, 1))
    assert meta["ok"] and meta["counted_by"] == "torch meta"
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _real(SP.input_specs(cfg, shape), cfg, shape,
                  np.random.default_rng(0))
    step, inputs = D.cell_inputs(cfg, shape, make_host_mesh(), opts,
                                 params=params, batch=batch)
    cpu = D.count_step(step, inputs)
    assert _counts(cpu) == _counts(meta["full"])
    fwd = 2 if remat else 1
    assert _counts(cpu)["kernels"] == {
        "kan_fused_v2_mixed": fwd * cfg.n_layers,
        "pattern_matmul_bf16": (fwd + 2) * cfg.n_layers,
        "spline_basis_bf16": cfg.n_layers}
    assert not W.COUNTERS
