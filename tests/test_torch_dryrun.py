"""The dry run on the meta device (``repro_torch.launch.dryrun``): its
counts held against the same steps run for real, on the CPU.

* Meta against the CPU, one process (the 1x1 mesh): the train, prefill
  and decode steps of reduced qwen3-moe, recurrentgemma, xlstm, whisper,
  paligemma, qwen2-0.5b with the KAN drop-in and qwen2-0.5b-kanffn (a
  KAN-FFN's pattern matmul), on real tensors from a numpy seed and on
  meta: FLOPs, bytes, each kernel's counted calls and the argument bytes
  equal.
* The abstract 2x2 mesh against 4 real gloo ranks (one spawn for every
  arch): the reduced KAN drop-in, the MoE (expert parallel) and
  recurrentgemma, a train step under ``activation_mode`` "replicated"
  and "sp", a prefill and a decode step: each rank's ``SENT``,
  ``GATHERS``, argument bytes, FLOPs and bytes equal.
* Each kernel entry point's meta branch: the output's shape and dtype
  those of its plain version, the card's refusals (a wrong dtype, a
  refused gradient, a knob), its work the formula of ``kernels/work``.
* The live-bytes tracker on toy functions whose peak is known; the
  collectives on an abstract mesh; two production decode cells at full
  width on 16 x 16, their argument bytes the sum over leaves of
  ``sharding.local_shape`` x itemsize.
"""
import dataclasses
import json
import os
import textwrap
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _mesh_parity import REPO, env as _env  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.configs.registry import ARCHS, KANFFN_ARCHS  # noqa: E402
from repro_torch.core.splines import SplineSpec  # noqa: E402
from repro_torch.kernels import work as W  # noqa: E402
from repro_torch.kernels.kan_fused import ops as KO  # noqa: E402
from repro_torch.kernels.pattern_matmul import ops as PO  # noqa: E402
from repro_torch.kernels.spline_basis.ops import spline_basis  # noqa: E402
from repro_torch.launch import collectives as C  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, spawn_ranks  # noqa
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.utils import leaf_paths, tree_map  # noqa: E402

META = torch.device("meta")
KAN = {"ffn_kind": "kan", "pattern_rate": 0.5}
# (name, registry arch, reduce() overrides)
ONE = [("qwen3-moe", "qwen3-moe-235b-a22b", {}),
       ("rgemma", "recurrentgemma-9b", {}),
       ("xlstm", "xlstm-125m", {}),
       ("whisper", "whisper-medium", {}),
       ("paligemma", "paligemma-3b", {}),
       ("qwen2-kan", "qwen2-0.5b", KAN),
       ("qwen2-kanffn", "qwen2-0.5b-kanffn", {})]
KINDS = ("train", "prefill", "decode")
SEQ, BATCH = 16, 2


def _cfg(arch, over):
    return dataclasses.replace({**ARCHS, **KANFFN_ARCHS}[arch].reduce(),
                               **over)


def _real(specs, cfg, shape, rng):
    """Real inputs shaped as ``specs.input_specs`` lays them out: tokens
    from the vocab, frames / patches ``0.1 * N(0, 1)``, zero caches."""
    def one(a):
        if a.dtype == torch.int32:
            return torch.as_tensor(rng.integers(0, cfg.vocab_size, a.shape)
                                   .astype(np.int32))
        return (0.1 * torch.as_tensor(rng.standard_normal(a.shape)
                                      .astype(np.float32))).to(a.dtype)
    if shape.kind != "decode":
        return tree_map(one, specs)
    return {"token": one(specs["token"]),
            "caches": T.init_caches(cfg, shape.global_batch,
                                    shape.seq_len + cfg.decode_margin)}


def _counts(full):
    return {"flops": full["flops"], "bytes": full["bytes_accessed"],
            "argument": full["memory"]["argument_size_in_bytes"],
            "kernels": {k: v["launches"] for k, v in full["kernels"].items()}}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,arch,over", ONE, ids=[a[0] for a in ONE])
def test_meta_counts_equal_the_cpu_step(name, arch, over, kind):
    cfg = _cfg(arch, over)
    shape = ShapeSpec(kind, SEQ, BATCH, kind)
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
    want = {"qwen2-kan": {"kan_fused_v2"}, "qwen2-kanffn": {
        "kan_fused_v2", "pattern_matmul"}}.get(name, set())
    assert set(cpu["kernels"]) == want | ({"spline_basis"} if want and
                                          kind == "train" else set())


# --------------------------------------------------------------------------
# the abstract 2x2 mesh against real gloo ranks
# --------------------------------------------------------------------------

MESH = [("qwen2-kan", "qwen2-0.5b", KAN),
        ("qwen3-moe", "qwen3-moe-235b-a22b", {}),
        ("rgemma", "recurrentgemma-9b", {})]
# (tag, kind, activation mode)
CELLS = [("train", "train", "replicated"), ("train_sp", "train", "sp"),
         ("prefill", "prefill", "replicated"),
         ("decode", "decode", "replicated")]
MSEQ, MBATCH = 16, 4

WORKER = textwrap.dedent("""
    import sys, json, dataclasses
    import numpy as np, torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[4])
    from test_torch_dryrun import _cfg, _counts, _real
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as D, mesh as M, specs as SP, \\
        steps as ST
    from repro_torch.models import transformer as T

    out, archs, cells = sys.argv[1], json.loads(sys.argv[2]), \\
        json.loads(sys.argv[3])
    mesh = M.init_from_env((2, 2), device="cpu")
    res = {}
    for name, arch, over in archs:
        cfg = _cfg(arch, over)
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        for tag, kind, mode, seq, batch in cells:
            shape = ShapeSpec(tag, seq, batch, kind)
            b = _real(SP.input_specs(cfg, shape), cfg, shape,
                      np.random.default_rng(0))
            step, inputs = D.cell_inputs(
                cfg, shape, mesh, ST.StepOptions(activation_mode=mode),
                params=params, batch=b)
            full = D.count_step(step, inputs)
            res[f"{name}/{tag}"] = {**_counts(full), "sent": full["sent"],
                                    "gathers": full["gathers"]}
    with open(f"{out}/rank{mesh.rank}.json", "w") as f:
        json.dump(res, f)
    M.destroy_process_mesh(mesh)
""")


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Every rank's counts of every (arch, cell) from one spawn of 4 gloo
    ranks on the CPU."""
    out = tmp_path_factory.mktemp("dryrun_mesh")
    cells = [(t, k, m, MSEQ, MBATCH) for t, k, m in CELLS]
    spawn_ranks(["-c", WORKER, str(out), json.dumps(MESH), json.dumps(cells),
                 os.path.join(REPO, "tests")], 4, str(out / "rv"),
                timeout_s=240, env=_env())
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(4)]


@pytest.mark.parametrize("tag,kind,mode", CELLS, ids=[c[0] for c in CELLS])
@pytest.mark.parametrize("name,arch,over", MESH, ids=[a[0] for a in MESH])
def test_abstract_mesh_counts_equal_gloo_ranks(gloo_runs, name, arch, over,
                                               tag, kind, mode):
    cfg = _cfg(arch, over)
    for r, real in enumerate(gloo_runs):
        rec = D.analyze_cell(cfg, ShapeSpec(tag, MSEQ, MBATCH, kind),
                             opts=ST.StepOptions(activation_mode=mode),
                             rank=r, mesh_shape=(2, 2))
        got = {**_counts(rec["full"]), "sent": rec["full"]["sent"],
               "gathers": rec["full"]["gathers"]}
        assert got == real[f"{name}/{tag}"], (r, got, real[f"{name}/{tag}"])
        assert rec["full"]["sent"]["calls"] > 0
        kinds = rec["full"]["collectives"]
        assert sum(d["count"] for d in kinds.values()) == got["sent"]["calls"]


# --------------------------------------------------------------------------
# the kernels' meta branches
# --------------------------------------------------------------------------

SPEC = SplineSpec(4, 3)
KB = (0, 2, 4, 5, 6)
B, N_IN, N_OUT, NBK = 6, 8, 5, len(KB)


def _kernel_calls():
    """(name, counted kernel, call(device, dtype), the dtype its operands
    take, one the card refuses, the kernel's work) of each entry point:
    ``call`` casts the operands the dtype rule reads to ``dtype`` and
    returns the entry point bound to them."""
    g = torch.Generator().manual_seed(0)
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=i8)

    x, wt = rnd(B, N_IN), rnd(N_IN * (NBK + 1), N_OUT)
    w_b, t_flat = rnd(N_IN, N_OUT), rnd(N_IN * NBK, N_OUT)
    xq, wq = codes(B, N_IN), codes(N_IN * (NBK + 1), N_OUT)
    ss = torch.rand((NBK + 1,), generator=g)
    xc, wc, bias = rnd(B, 7), rnd(7, N_OUT), rnd(N_OUT)
    xm, wm = codes(B, 32), codes(32, N_OUT)
    return [
        ("kan_fused_v2", "kan_fused_v2",
         lambda d, dt: partial(KO.kan_fused_v2, x.to(d, dt), wt.to(d, dt),
                               SPEC, KB),
         f32, torch.float64,
         W.kan_fused(B, N_IN, N_OUT, SPEC, NBK, f32, f32, f32)),
        ("kan_fused_v2_mixed", "kan_fused_v2_mixed",
         lambda d, dt: partial(KO.kan_fused_v2, x.to(d, bf16), wt.to(d, dt),
                               SPEC, KB, out_dtype=f32),
         f32, torch.float16,
         W.kan_fused(B, N_IN, N_OUT, SPEC, NBK, bf16, f32, f32)),
        ("kan_fused_v1", "kan_fused_v1_bf16",
         lambda d, dt: partial(KO.kan_fused_v1, x.to(d, bf16), w_b.to(d, dt),
                               t_flat.to(d, dt), SPEC, KB),
         bf16, f32,
         W.kan_fused(B, N_IN, N_OUT, SPEC, NBK, bf16, bf16, bf16)),
        ("kan_fused_v2_q8", "kan_fused_v2_q8",
         lambda d, dt: partial(KO.kan_fused_v2_q8, xq.to(d, dt),
                               wq.to(d, dt), ss.to(d), SPEC, KB, 0.02),
         i8, torch.int16, W.kan_fused_q8(B, N_IN, N_OUT, SPEC, NBK)),
        ("matmul_compact", "pattern_matmul",
         lambda d, dt: partial(PO.matmul_compact, xc.to(d, dt),
                               wc.to(d, dt), bias.to(d, dt), "relu"),
         f32, torch.float64, W.matmul(B, 7, N_OUT, f32, f32, f32)),
        ("matmul_q8", "pattern_matmul_q8",
         lambda d, dt: partial(PO.matmul_q8, xm.to(d, dt), wm.to(d, dt)),
         i8, torch.int16, W.matmul(B, 32, N_OUT, i8, f32)),
        ("spline_basis", "spline_basis",
         lambda d, dt: partial(spline_basis, x.to(d, dt), SPEC),
         f32, torch.float64, W.spline_basis(B * N_IN, SPEC, f32)),
    ]


CALLS = _kernel_calls()


@pytest.mark.parametrize("name,kernel,call,good,bad,work", CALLS,
                         ids=[c[0] for c in CALLS])
def test_kernel_meta_branch(name, kernel, call, good, bad, work):
    plain = call(torch.device("cpu"), good)()
    fn = call(META, good)
    with D.count() as c:
        out = fn()
    assert out.is_meta and out.shape == plain.shape
    assert out.dtype == plain.dtype
    assert c.kernels == {kernel: {"launches": 1, "flops": work[0],
                                  "bytes": work[1]}}
    assert (c.flops, c.bytes) == work          # nothing else counted
    # an operand dtype the card refuses, meta refuses too
    with pytest.raises(TypeError):
        call(META, bad)()


def test_meta_refuses_what_the_card_refuses():
    x = torch.empty((B, N_IN), device=META)
    wt = torch.empty((N_IN * (NBK + 1), N_OUT), device=META)
    # a refused gradient raises before the device is looked at
    with pytest.raises(NotImplementedError):
        KO.kan_fused_v1(x.clone().requires_grad_(True), wt[:N_IN],
                        wt[N_IN:], SPEC, KB)
    # a knob the kernel does not take; a shape that does not contract
    with pytest.raises(ValueError, match="blocks"):
        KO.kan_fused_v2(x, wt, SPEC, KB, blocks=(3, 32, 8))
    with pytest.raises(ValueError, match="contract"):
        PO.matmul_compact(x, wt)
    with pytest.raises(ValueError, match="block_n"):
        spline_basis(x, SPEC, block_n=48)
    assert not W.COUNTERS


# --------------------------------------------------------------------------
# the live-bytes tracker, the collectives on an abstract mesh
# --------------------------------------------------------------------------

def _peak(fn, *args):
    with D.count(args) as c:
        fn(*args)
    return c.peak, c.argument_bytes


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_live_bytes_tracker_peak_is_exact(device):
    n = 1024 * 4                           # bytes of a (1024,) f32 vector
    x = torch.ones(1024, device=device)

    def chain(x):                           # b beside a, a freed, c beside b
        a = x * 2.0
        b = a + 1.0
        del a
        return b * 3.0

    def views(x):                           # a leaf read through views
        y = x.view(32, 32).t()
        return (y + 0.0).sum()              # one vector beside a scalar

    def inplace(x):                         # in place: no new storage
        a = x * 1.0
        a.add_(1.0).mul_(2.0)
        return a

    assert _peak(chain, x) == (2 * n, n)
    assert _peak(views, x) == (n + 4, n)
    assert _peak(inplace, x) == (n, n)
    big = torch.ones(2048, device=device)   # two halves of one storage
    assert _peak(lambda a, b: torch.cat([a, b]), big[:1024],
                 big[1024:]) == (2 * n, 2 * n)


def test_collectives_on_an_abstract_mesh():
    mesh = D.abstract_mesh(shape=(2, 2), rank=3)
    C.reset_sent()
    x = torch.empty((3, 5), dtype=torch.bfloat16, device=META)
    parts = C.all_gather_shards(x, mesh, "model")
    assert [(p.shape, p.dtype, p.device.type) for p in parts] == \
        [((3, 5), torch.bfloat16, "meta")] * 2
    s = C.reduce_over(x, mesh, ("data", "model"), torch.float32)
    assert s.shape == (3, 5) and s.dtype == torch.float32 and s.is_meta
    i = C.psum_int32(torch.empty((4,), dtype=torch.int32, device=META),
                     mesh, "data")
    a2a = C.all_to_all([x, x], mesh, "data")
    assert i.is_meta and [p.shape for p in a2a] == [(3, 5)] * 2
    assert C.SENT == {"calls": 4, "bytes": 30 + 30 + 16 + 30}
    assert C.GATHERS == {("model",): 1, ("data", "model"): 1}
    assert C.TALLY == {("all-gather", ("model",)): [1, 30],
                       ("all-gather", ("data", "model")): [1, 30],
                       ("all-reduce", ("data",)): [1, 16],
                       ("all-to-all", ("data",)): [1, 60]}
    # a real tensor on an abstract mesh launches nothing: it raises
    with pytest.raises(RuntimeError, match="abstract"):
        C.all_gather_shards(torch.zeros(3), mesh, "model")
    C.reset_sent()


# --------------------------------------------------------------------------
# production decode cells at full width
# --------------------------------------------------------------------------

def _local_bytes(leaf, spec, mesh):
    return (int(np.prod(SH.local_shape(leaf.shape, spec, mesh)))
            * leaf.element_size())


@pytest.mark.parametrize("arch,shape", [("qwen2-0.5b", "decode_32k"),
                                        ("xlstm-125m", "long_500k")])
def test_production_decode_cell_argument_bytes(arch, shape):
    """The argument of a decode cell on 16 x 16: the rank's compute
    params (its ``model`` shard of each tensor-parallel leaf, every other
    leaf whole), its rows of the token and its pieces of the caches, each
    leaf ``sharding.local_shape`` x itemsize."""
    cfg = ARCHS[arch]
    rec = D.analyze_cell(cfg, shape)
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["fits"]
    mesh = D.abstract_mesh()
    tree = ST.train_state_shardings(cfg, mesh)["params"]
    local = ST._tp_paths(cfg, mesh, tree) | ST._ep_paths(cfg, mesh, tree)
    specs = dict(leaf_paths(tree))
    want = sum(_local_bytes(leaf, SH.P(*(
        e if e == "model" and k in local else None for e in specs[k])), mesh)
        for k, leaf in leaf_paths(T.param_shapes(cfg)))
    inputs = SP.input_specs(cfg, D.SHAPES[shape])
    want += _local_bytes(inputs["token"], SH.batch_shardings(
        {"t": inputs["token"]}, mesh)["t"], mesh)
    want += sum(_local_bytes(leaf, spec, mesh) for (_, leaf), (_, spec) in
                zip(leaf_paths(inputs["caches"]), leaf_paths(
                    SH.cache_shardings(inputs["caches"], mesh))))
    assert rec["full"]["memory"]["argument_size_in_bytes"] == want
