"""Parent/change A/B of the port's CUDA kernels on the card, in one process,
and the per-layer kernel calls and device timers ``chip_smoke.py`` uses.

Run from the repository root, on a machine with an NVIDIA GPU::

    git archive <parent> | tar -x -C build/base
    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_ab \\
        --parent build/base [--out chiprun_out/kernel_ab.json] [--served]

Every kernel source of the parent checkout is built with ``nvcc`` beside
this tree's (``-Xcompiler -fno-gnu-unique``: the launch helpers' function-
local statics then stay apart in the two libraries).  Each side runs as
it ships: its own C entries and its own default knobs (the parent's
``default_blocks`` and ``check_blocks`` of both ops modules; the knob
each side ran is recorded).  Each kernel call of the vikin-mixed stack
(``stack_calls``) in f32, int8 and bf16 at buckets 2, 4, 8, 16 and batch
8192, and the version-1 and spline-basis kernels on its KAN layer's input
at 8 and 8192, runs under both on the same inputs: the outputs must agree
within one bf16 ulp (bf16 out) or ``1e-5 * (1 + max|parent|)`` (f32 out),
and whether they are bitwise equal is recorded beside.  Device times are
CUDA-graph replays taken in turns parent, change, change, parent, each
side's two turns averaged.  The kernel calls of the vikin-kan2 and
vikin-mlp3 stacks at batch 8192 too; the mixed kernel (a bf16 x against
f32 fused rows, ``mixed_calls``) at vikin-mixed's KAN layer at 8 and 8192
and at the LM train step's two KAN layers (qwen2-0.5b's drop-in, M =
1024); and then the three archs' stacks at bucket 8 in each precision, as
whole forwards, the same way (one tolerance a layer).
It fails on the first output outside its tolerance.

With ``--served`` it instead holds the served path of the two trees
whole, Python wrappers included: each side's package, in a child process
of its own (``dump_served``), serves every bucket (2, 4, 8, 16) of the
three archs at f32, int8 and bf16 through ``make_vikin_backend`` on
seeded batches, and every answer and every batch's launch counts must be
bitwise the parent's.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import inspect
import itertools
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.vikin_models import VIKIN_ARCHS
from repro_torch.core.kan import KANConfig, KANLayer, kan_init
from repro_torch.core.quant import QuantKANLayer, quantize_static
from repro_torch.core.splines import SplineSpec
from repro_torch.kernels import _build, autotune
from repro_torch.kernels.epilogue import scale_bias_act
from repro_torch.kernels.kan_fused import ops as kan_ops
from repro_torch.kernels.kan_fused.ops import (
    flatten_t,
    fuse_wt,
    kan_fused_v1,
    kan_fused_v2,
    kan_fused_v2_q8,
    slot_table,
)
from repro_torch.kernels.kan_fused.ref import (
    kan_fused_v2_q8_ref,
    kan_fused_v2_ref,
)
from repro_torch.kernels.pattern_matmul import ops as pm_ops
from repro_torch.kernels.pattern_matmul.ops import matmul_compact, matmul_q8
from repro_torch.kernels.pattern_matmul.ref import (
    matmul_compact_ref,
    matmul_q8_ref,
)
from repro_torch.kernels.spline_basis.ops import spline_basis
from repro_torch.models.ffn import stack_layer_cfgs
from repro_torch.utils import leaf_paths

ROOT = _build.KERNELS_DIR.parents[2]
ARCHS = ("vikin-kan2", "vikin-mlp3", "vikin-mixed")
PRECISIONS = ("f32", "int8", "bf16")
BATCHES = (2, 4, 8, 16, 8192)
BF16_ULP = 2.0 ** -8
F32_TOL = 1e-5
MIXED = "kan_fused_v2_mixed"
# The LM train step's KAN layers (qwen2-0.5b's drop-in at pattern 0.5:
# (M, n_in, n_out), kept bases), each a launch of the mixed kernel.
LM_MIXED = ((1024, 896, 608), (1024, 608, 896))
LM_KB = (0, 2, 4, 5, 6)
# The ops modules whose knob rules each side brings, and those rules.
KNOB_MODULES = {"pattern_matmul": pm_ops, "kan_fused": kan_ops}
KNOB_FUNCS = ("default_blocks", "check_blocks")


# ------------------------------------------------------------ kernel calls
def layer_calls(layer, x: torch.Tensor) -> tuple:
    """(kernel name, kernel input, kernel call, plain call) of one f32 or
    bf16 stack layer on its input ``x``, the kernel the one for x's dtype;
    both calls take an output dtype (None: x's).  An MLP layer's mask
    gather is done here, once, as ``PatternLinear.forward`` does it."""
    sfx = "_bf16" if x.dtype == torch.bfloat16 else ""
    if isinstance(layer, KANLayer):
        spec = layer.cfg.spec
        return ("kan_fused_v2" + sfx, x,
                lambda od=None: kan_fused_v2(x, layer.wt, spec, layer.kb,
                                             layer.slot_of, out_dtype=od),
                lambda od=None: kan_fused_v2_ref(x, layer.wt, spec,
                                                 layer.kb, od))
    xc = (x if layer.idx is None
          else x.index_select(1, layer.idx)).contiguous()
    return ("pattern_matmul" + sfx, xc,
            lambda od=None: matmul_compact(xc, layer.w_c, layer.b,
                                           layer.act, out_dtype=od),
            lambda od=None: matmul_compact_ref(xc, layer.w_c, layer.b,
                                               layer.act, od))


def q8_layer_calls(layer, h_q: torch.Tensor) -> tuple:
    """(kernel name, kernel input, kernel call, plain call, finish) of one
    int8 stack layer on its int8 input; ``finish`` turns the kernel's
    output into the layer's (the int8 matmul's epilogue)."""
    if isinstance(layer, QuantKANLayer):
        spec = layer.cfg.spec
        return ("kan_fused_v2_q8", h_q,
                lambda: kan_fused_v2_q8(h_q, layer.wt_q, layer.slot_scales,
                                        spec, layer.kb, layer.x_scale,
                                        layer.slot_of),
                lambda: kan_fused_v2_q8_ref(h_q, layer.wt_q,
                                            layer.slot_scales, spec,
                                            layer.kb, layer.x_scale),
                lambda y: y)
    xc = (h_q if layer.idx is None
          else h_q.index_select(1, layer.idx)).contiguous()
    return ("pattern_matmul_q8", xc,
            lambda: matmul_q8(xc, layer.w_q_c),
            lambda: matmul_q8_ref(xc, layer.w_q_c),
            lambda acc: scale_bias_act(acc, layer.col_scale, layer.b,
                                       layer.act))


def stack_calls(precision: str, stack, x: torch.Tensor
                ) -> List[Tuple[str, torch.Tensor, Callable]]:
    """(kernel name, kernel input, kernel call) of each layer of one
    forward of ``stack`` (f32, bf16 or int8) on ``x``, each layer's input
    made by the kernels before it."""
    calls = []
    if precision == "int8":
        h = quantize_static(x, stack.x_scales[0])
        for i, layer in enumerate(stack.layers):
            name, xin, kernel, _, finish = q8_layer_calls(layer, h)
            calls.append((name, xin, kernel))
            if i + 1 < len(stack.layers):
                h = quantize_static(finish(kernel()), stack.x_scales[i + 1])
        return calls
    for layer in stack.layers:
        name, xin, kernel, _ = layer_calls(layer, x)
        calls.append((name, xin, kernel))
        x = kernel()
    return calls


def tooling_calls(stack, x: torch.Tensor
                  ) -> List[Tuple[str, torch.Tensor, Callable]]:
    """The version-1 and spline-basis kernels on the input of ``stack``'s
    (f32 or bf16) KAN layer."""
    sfx = "_bf16" if x.dtype == torch.bfloat16 else ""
    for layer in stack.layers:
        if isinstance(layer, KANLayer):
            t_flat = flatten_t(layer.t, layer.cfg.kb).contiguous()
            flat = x.reshape(-1)
            return [
                ("kan_fused_v1" + sfx, x,
                 lambda h=x, layer=layer, t_flat=t_flat: kan_fused_v1(
                     h, layer.w_b, t_flat, layer.cfg.spec, layer.kb,
                     layer.slot_of)),
                ("spline_basis" + sfx, flat,
                 lambda flat=flat, layer=layer: spline_basis(
                     flat, layer.cfg.spec))]
        x = layer(x)
    return []


def mixed_calls(stack_f32, stack_bf16, n_in: int,
                device: torch.device | str
                ) -> List[Tuple[str, torch.Tensor, Callable, Callable]]:
    """(shape, kernel input, kernel call, plain call) of the mixed kernel,
    a bf16 x against f32 fused rows: vikin-mixed's KAN layer at batches 8
    and 8192 (the bf16 stack's KAN input on seeded batches of ``n_in``
    features against the f32 stack's rows), and the LM train step's KAN
    layers (``LM_MIXED``: a seeded bf16 ``kan_init``, whose ``t`` is f32,
    and x of 1.5 N(0, 1) rounded to bf16)."""
    out = []
    f_layer = next(lay for lay in stack_f32.layers
                   if isinstance(lay, KANLayer))
    spec, kb = f_layer.cfg.spec, f_layer.kb
    for batch in (8, 8192):
        x = torch.from_numpy(np.random.default_rng(2).random(
            (batch, n_in), dtype=np.float32)).to(device, torch.bfloat16)
        xin = next(xi for n, xi, _ in stack_calls("bf16", stack_bf16, x)
                   if n.startswith("kan_fused"))
        out.append((f"{tuple(xin.shape)} vikin-mixed KAN", xin,
                    lambda xin=xin: kan_fused_v2(xin, f_layer.wt, spec, kb,
                                                 f_layer.slot_of),
                    lambda xin=xin: kan_fused_v2_ref(xin, f_layer.wt, spec,
                                                     kb)))
    lm_spec = SplineSpec(4, 3)
    slot_of = slot_table(LM_KB, lm_spec.n_bases, device)
    for M, n_in, n_out in LM_MIXED:
        gen = torch.Generator(device=device).manual_seed(n_in)
        p = kan_init(KANConfig(n_in, n_out, lm_spec, basis_keep=LM_KB), gen,
                     torch.bfloat16)
        wt = fuse_wt(p["w_b"], flatten_t(p["t"], LM_KB), len(LM_KB))
        x = (torch.randn((M, n_in), generator=gen, device=device)
             * 1.5).to(torch.bfloat16)
        out.append((f"{(M, n_in)} -> {n_out} LM train step", x,
                    lambda x=x, wt=wt: kan_fused_v2(x, wt, lm_spec, LM_KB,
                                                    slot_of),
                    lambda x=x, wt=wt: kan_fused_v2_ref(x, wt, lm_spec,
                                                        LM_KB)))
    return out


def plain_stack(params, x: torch.Tensor, model) -> torch.Tensor:
    """The dense stack through the kernels' plain versions, built from the
    raw ``params`` so that autograd flows back to them: the reference the
    training gradients through the kernels are held to."""
    h = x
    for p, (kind, cfg) in zip(params, stack_layer_cfgs(model)):
        if kind == "kan":
            kb = tuple(range(cfg.spec.n_bases))
            h = kan_fused_v2_ref(
                h, fuse_wt(p["w_b"], flatten_t(p["t"]), len(kb)), cfg.spec,
                kb)
        else:
            h = matmul_compact_ref(h, p["w"], p["b"], cfg["act"])
    return h


def plain_grads(params, model, x: torch.Tensor, y: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {leaf path: gradient}) of the mean squared error of
    ``plain_stack`` on (x, y), at copies of ``params``."""
    leaves = [{k: v.detach().clone().requires_grad_(True)
               for k, v in p.items()} for p in params]
    loss = torch.mean(torch.square(plain_stack(leaves, x, model) - y))
    paths = leaf_paths(leaves)
    grads = torch.autograd.grad(loss, [p for _, p in paths])
    return loss.detach(), dict(zip((k for k, _ in paths), grads))


# ------------------------------------------------------------------ timers
def time_ms(fn: Callable[[], object], iters: int = 100,
            reps: int = 7) -> float:
    """Median over ``reps`` of the mean per-call time of ``iters``
    back-to-back calls, by CUDA events, after warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn: Callable[[], object], iters: int = 20,
             reps: int = 7) -> float:
    """Per-call device time of ``fn``: ``iters`` calls captured in one
    CUDA graph, its replays timed as ``time_ms`` does.  The host's launch
    overhead, which paces back-to-back calls of a small kernel, drops
    out.  ``fn`` must have run eagerly before (lazy set-up)."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=5, reps=reps) / iters


# -------------------------------------------------------------- the sides
def compare(name: str, what: str, p: torch.Tensor, c: torch.Tensor,
            layers: int = 1) -> Dict:
    """Parent's output ``p`` against the change's ``c``: within ``layers``
    bf16 ulps (bf16 out) or ``layers * 1e-5`` (f32 out) of (1 + max|p|),
    compared in f32; raises outside it.  Reports whether they are bitwise
    equal and the largest difference."""
    if p.shape != c.shape or p.dtype != c.dtype:
        raise AssertionError(f"kernel_ab: {name} {what}: parent "
                             f"{tuple(p.shape)} {p.dtype}, change "
                             f"{tuple(c.shape)} {c.dtype}")
    same = torch.equal(p, c)
    pf, cf = p.float(), c.float()
    err = float((pf - cf).abs().max()) if p.numel() else 0.0
    scale = 1.0 + (float(pf.abs().max()) if p.numel() else 0.0)
    tol = layers * (BF16_ULP if p.dtype == torch.bfloat16 else F32_TOL)
    if not same and not err <= tol * scale:      # NaN fails too
        raise AssertionError(f"kernel_ab: {name} {what}: parent and change "
                             f"differ by {err:.3e} > {tol:g} * {scale:.4g}")
    return {"bitwise": same, "max_abs_diff": err}


def knob_rules(checkout: Path) -> Dict[str, Dict[str, Callable]]:
    """The knob rules (``KNOB_FUNCS``) of each ops module in
    ``KNOB_MODULES``, loaded from ``checkout``'s sources."""
    rules = {}
    for kernel, mod in KNOB_MODULES.items():
        path = (Path(checkout) / "src" / "repro_torch" / "kernels" / kernel
                / "ops.py")
        spec = importlib.util.spec_from_file_location(
            f"kernel_ab_side_{kernel}_ops", path)
        side = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(side)
        rules[kernel] = {f: getattr(side, f) for f in KNOB_FUNCS}
    return rules


def _takes_wt_dtype(fn: Callable) -> Callable:
    """``fn``, or where a side's rule predates the mixed KAN kernel (no
    ``wt_dtype``), ``fn`` with that keyword dropped: such a side has only
    kernels whose weights are x's dtype."""
    if "wt_dtype" in inspect.signature(fn).parameters:
        return fn

    def rule(*args, wt_dtype=None, **kwargs):
        return fn(*args, **kwargs)
    return rule


@contextlib.contextmanager
def use(side: Optional[Dict]) -> Iterator[None]:
    """Run the wrappers as ``side`` ships (``{"entries": C entries by
    kernel, "rules": knob_rules(...)}``); None keeps this tree's.  The
    per-process knob memo is dropped on the way in and out."""
    if side is None:
        yield
        return
    own_entry = _build._entry
    own_rules = {k: {f: getattr(m, f) for f in KNOB_FUNCS}
                 for k, m in KNOB_MODULES.items()}
    autotune.RESOLVED.clear()
    _build._entry = side["entries"].__getitem__
    for kernel, funcs in side["rules"].items():
        for f, fn in funcs.items():
            setattr(KNOB_MODULES[kernel], f, _takes_wt_dtype(fn))
    try:
        yield
    finally:
        _build._entry = own_entry
        for kernel, funcs in own_rules.items():
            for f, fn in funcs.items():
                setattr(KNOB_MODULES[kernel], f, fn)
        autotune.RESOLVED.clear()


def knobs_of(call: Callable[[], object], side: Optional[Dict]):
    """(output of ``call`` under ``side``, the knobs the wrappers
    resolved for it; ``RESOLVED`` also memoizes cache lookups, which are
    left out)."""
    with use(side):
        autotune.RESOLVED.clear()
        out = call()
        knobs = sorted(v for v in autotune.RESOLVED.values()
                       if isinstance(v, tuple))
    return out, knobs


def build_parent(parent: Path, out_dir: Path) -> Dict[str, Callable]:
    """The parent's C entry of every kernel in ``_build.KERNELS`` that its
    sources hold, built from them (one ``nvcc`` each, all started
    together) and loaded with ``ctypes``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, (src, _, _) in _build.KERNELS.items():
        if not (parent / src.relative_to(ROOT)).exists():
            continue
        lib = out_dir / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xcompiler",
               "-fno-gnu-unique", "-o", str(lib),
               str(parent / src.relative_to(ROOT))]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    entries = {}
    for name, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"parent {name}: nvcc exit {proc.returncode}"
                               f"\n{text}")
        _, symbol, argtypes = _build.KERNELS[name]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def turns(fn: Callable[[], object], parent: Dict) -> Dict:
    """Device ms of ``fn`` as the parent ships and as this tree does, in
    turns P, C, C, P; each side's mean of its two turns."""
    t = {"P": [], "C": []}
    for side in ("P", "C", "C", "P"):
        with use(parent if side == "P" else None):
            fn()
            t[side].append(graph_ms(fn))
    return {"parent_ms": sum(t["P"]) / 2, "change_ms": sum(t["C"]) / 2,
            "turns": t}


def ab_row(name: str, what: str, call: Callable[[], object], parent: Dict,
           layers: int = 1, **fields) -> Dict:
    """One A/B row: both sides' outputs compared, knobs and times."""
    p_out, p_knobs = knobs_of(call, parent)
    c_out, c_knobs = knobs_of(call, None)
    torch.cuda.synchronize()
    row = {"kernel": name, **fields, "shape": what,
           "parent_knobs": p_knobs, "change_knobs": c_knobs,
           **compare(name, what, p_out, c_out, layers), **turns(call, parent)}
    print(json.dumps(row))
    return row


def run(parent_dir: str | Path, out: str | Path | None = None) -> Dict:
    from repro_torch.launch.serve import make_vikin_backend

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    parent_dir = Path(parent_dir).resolve()
    parent = {"entries": build_parent(parent_dir,
                                      ROOT / "build" / "kernel_ab_parent"),
              "rules": knob_rules(parent_dir)}
    _build.build()
    rows: List[Dict] = []
    backends = {(a, p): make_vikin_backend(VIKIN_ARCHS[a], "cuda",
                                           precision=p)
                for a in ARCHS for p in PRECISIONS}
    for precision, arch in itertools.product(PRECISIONS, ARCHS):
        be = backends[arch, precision]
        dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        mixed = arch == "vikin-mixed"
        for batch in BATCHES if mixed else BATCHES[-1:]:
            x = torch.from_numpy(np.random.default_rng(2).random(
                (batch, be.n_in), dtype=np.float32)).to(dev, dtype)
            calls = [(n, f"{tuple(xin.shape)} layer {i}", k) for i, (n, xin, k)
                     in enumerate(stack_calls(precision, be.stack, x))]
            if mixed and precision != "int8" and batch in (8, 8192):
                calls += [(n, f"{tuple(xin.shape)}", k)
                          for n, xin, k in tooling_calls(be.stack, x)]
            for name, what, call in calls:
                rows.append(ab_row(name, what, call, parent, arch=arch,
                                   precision=precision, batch=batch))
    for what, _, call, _ in mixed_calls(
            backends["vikin-mixed", "f32"].stack,
            backends["vikin-mixed", "bf16"].stack,
            backends["vikin-mixed", "f32"].n_in, dev):
        rows.append(ab_row(MIXED, what, call, parent,
                           precision="bf16 x, f32 rows"))
    for precision in PRECISIONS:
        for arch in ARCHS:
            be = backends[arch, precision]
            x = torch.from_numpy(np.random.default_rng(3).random(
                (8, be.n_in), dtype=np.float32)).to(
                    dev, torch.bfloat16 if precision == "bf16"
                    else torch.float32)
            _build.reset_launches()
            be.stack(x)
            ran = sorted(k for k, v in _build.LAUNCHES.items() if v)
            rows.append(ab_row(arch, precision, lambda: be.stack(x), parent,
                               layers=len(be.stack.layers), stack=True,
                               precision=precision, batch=8, kernels=ran))
    result = {"device": torch.cuda.get_device_name(0), "rows": rows}
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(result, indent=1))
    return result


def dump_served(out: str) -> None:
    """Serve every bucket of the three archs at each precision through
    ``make_vikin_backend`` (seed-0 weights) on seeded batches, on the
    card; write the answers to ``out``.npz and each batch's launch counts
    to ``out``.json.  ``served_ab`` runs this function's source in a child
    process against one side's package, so it imports inside and uses only
    what both sides have."""
    import json
    from pathlib import Path

    import numpy as np

    from repro_torch.configs.vikin_models import VIKIN_ARCHS
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import make_vikin_backend

    answers, launches = {}, {}
    for arch in ("vikin-kan2", "vikin-mlp3", "vikin-mixed"):
        for precision in ("f32", "int8", "bf16"):
            be = make_vikin_backend(VIKIN_ARCHS[arch], "cuda",
                                    precision=precision)
            for bucket in (2, 4, 8, 16):
                xb = np.random.default_rng(bucket).random(
                    (bucket, be.n_in), dtype=np.float32)
                _build.reset_launches()
                key = f"{arch}|{precision}|{bucket}"
                answers[key] = be.forward(xb)
                launches[key] = {k: v for k, v in _build.LAUNCHES.items()
                                 if v}
    np.savez(out + ".npz", **answers)
    Path(out + ".json").write_text(json.dumps(launches))


def served_ab(parent_dir: str | Path, out: str | Path | None = None
              ) -> Dict:
    """``dump_served`` under the parent's package and under this tree's,
    each in its own process with its own kernel builds and a fresh knob
    cache; every answer and every batch's launches must be bitwise equal
    (raises otherwise)."""
    code = ("import sys\n" + inspect.getsource(dump_served)
            + "\ndump_served(sys.argv[1])\n")
    sides = {}
    for side, root in (("parent", Path(parent_dir).resolve()),
                       ("change", ROOT)):
        dump = ROOT / "build" / f"served_ab_{side}"
        cache = ROOT / "build" / f"served_ab_{side}_autotune.json"
        dump.parent.mkdir(parents=True, exist_ok=True)
        cache.unlink(missing_ok=True)
        run = subprocess.run(
            [sys.executable, "-c", code, str(dump)], cwd=root,
            capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=str(root / "src"),
                     REPRO_TORCH_AUTOTUNE_CACHE=str(cache)))
        if run.returncode != 0:
            raise RuntimeError(f"kernel_ab --served: the {side}'s serving "
                               f"exited {run.returncode}\n{run.stderr}")
        with np.load(f"{dump}.npz") as z:
            answers = {k: z[k] for k in z.files}
        sides[side] = (answers, json.loads(Path(f"{dump}.json").read_text()))
    (p_ans, p_launch), (c_ans, c_launch) = sides["parent"], sides["change"]
    if sorted(p_ans) != sorted(c_ans):
        raise AssertionError(f"kernel_ab --served: parent served "
                             f"{sorted(p_ans)}, change {sorted(c_ans)}")
    rows = [{"batch": k, "bitwise": bool(np.array_equal(p_ans[k], c_ans[k])),
             "launches_equal": p_launch[k] == c_launch[k],
             "launches": c_launch[k]} for k in sorted(c_ans)]
    for row in rows:
        print(json.dumps(row))
    bad = [r["batch"] for r in rows
           if not (r["bitwise"] and r["launches_equal"])]
    result = {"device": torch.cuda.get_device_name(0), "served": rows}
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(result, indent=1))
    if bad:
        raise AssertionError(f"kernel_ab --served: {len(bad)} of "
                             f"{len(rows)} served batches differ from the "
                             f"parent's in answers or launches: {bad}")
    print(f"kernel_ab --served: {len(rows)} served batches, answers and "
          f"launches bitwise the parent's")
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout of the commit to compare with")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "kernel_ab.json"))
    ap.add_argument("--served", action="store_true",
                    help="compare the two trees' served answers and "
                         "launches bitwise instead (dump_served)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    if args.served:
        served_ab(args.parent, args.out)
        return
    os.environ.setdefault("REPRO_TORCH_AUTOTUNE_CACHE",
                          str(ROOT / "build" / "kernel_ab_autotune.json"))
    run(args.parent, args.out)


if __name__ == "__main__":
    main()
