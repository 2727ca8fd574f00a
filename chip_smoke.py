#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from anywhere on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any fault:

1. device and build -- print the card (nvidia-smi name and power limit)
   and the torch/CUDA versions, then build all four kernels from
   ``src/repro_torch/kernels/*/csrc/*.cu`` with nvcc for sm_90a, one
   compiler per source, in parallel;
2. kernels vs plain -- each kernel against its plain PyTorch version on
   the card, at every shape the vikin-mixed, vikin-kan2 and vikin-mlp3
   stacks give it at buckets 2/4/8/16 (f32, and int8 with scales
   calibrated as the launcher does), at ragged shapes and at one batch
   of 8192: within ``1e-5 * (1 + max|plain|)``, and the int8 matmul
   bitwise;
3. serve -- 48 requests of vikin-kan2, vikin-mlp3 and vikin-mixed through
   the port's Engine + MultiWorkloadBackend on 8 slots, once in f32 and
   once in int8: every answer against the same stack run through the
   plain versions on the card (``1e-4 * (1 + max|ref|)``; an int8 code
   that a requantization rounds across a half-step must sit at a
   rounding tie), the launch counts against the layer applications the
   served batches imply (and none of the other precision's kernels),
   and vikin-mixed batched == single, bitwise, in both precisions;
4. times -- per kernel at the vikin-mixed shapes, bucket 8 and batch
   8192: median ms of back-to-back calls (CUDA events) and of the same
   calls replayed from a CUDA graph (device time alone), the plain
   version's ms, one PyTorch call's ms where one computes the same
   function (``addmm``; ``torch._int_mm`` where its shape rules allow),
   and the bound max(bytes / 3.35 TB/s, operations / peak rate: 67
   TFLOP/s f32, 1979 TOP/s int8 for the int8 matmul); then, per arch at
   bucket 8 and per precision, where one served batch's time goes (host
   wall of a backend forward, the stack on the card, the kernels alone).

It prints the ``{"kernels": [...]}`` record, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  It imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 on CUDA cores (no tensor cores)
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core rate
KERNEL_TOL = 1e-5
SERVE_TOL = 1e-4
ARCHS = ("vikin-kan2", "vikin-mlp3", "vikin-mixed")
BUCKETS = (2, 4, 8, 16)
BIG = 8192
DEVICE = "cuda"

KERNEL_INFO = {
    "kan_fused_v2": {
        "source": "src/repro_torch/kernels/kan_fused/csrc/kan_fused.cu",
        "replaces": "src/repro/kernels/kan_fused/kan_fused.py:284",
    },
    "pattern_matmul": {
        "source": ("src/repro_torch/kernels/pattern_matmul/csrc/"
                   "pattern_matmul.cu"),
        "replaces": "src/repro/kernels/pattern_matmul/pattern_matmul.py:119",
    },
    "kan_fused_v2_q8": {
        "source": "src/repro_torch/kernels/kan_fused/csrc/kan_fused_q8.cu",
        "replaces": "src/repro/kernels/kan_fused/kan_fused.py:338",
    },
    "pattern_matmul_q8": {
        "source": ("src/repro_torch/kernels/pattern_matmul/csrc/"
                   "pattern_matmul_q8.cu"),
        "replaces": "src/repro/kernels/pattern_matmul/pattern_matmul.py:79",
    },
}
F32_KERNELS = ("kan_fused_v2", "pattern_matmul")
Q8_KERNELS = ("kan_fused_v2_q8", "pattern_matmul_q8")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max abs error, allowed-scale 1 + max|ref|, any NaN)."""
    nan = bool(torch.isnan(got).any() or torch.isnan(ref).any())
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    scale = 1.0 + (float(ref.abs().max()) if ref.numel() else 0.0)
    return err, scale, nan


def time_ms(fn, iters: int = 100, reps: int = 7) -> float:
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


def graph_ms(fn, iters: int = 20, reps: int = 7) -> float:
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


def host_ms(fn, iters: int = 50, reps: int = 7) -> float:
    """Median over ``reps`` of the mean host wall time of ``iters`` calls
    of ``fn``, which must end in a synchronising copy to the host."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    from repro_torch.configs.vikin_models import VIKIN_ARCHS
    from repro_torch.core.kan import KANLayer
    from repro_torch.core.quant import (
        QuantKANLayer,
        quantize_static,
        static_reciprocal,
    )
    from repro_torch.core.splines import SplineSpec, locate_cell, spu_op_count
    from repro_torch.kernels import _build
    from repro_torch.kernels.epilogue import scale_bias_act
    from repro_torch.kernels.kan_fused.ops import (
        kan_fused_v2,
        kan_fused_v2_q8,
        slot_table,
    )
    from repro_torch.kernels.kan_fused.ref import (
        kan_fused_v2_q8_ref,
        kan_fused_v2_ref,
    )
    from repro_torch.kernels.pattern_matmul.ops import (
        matmul_compact,
        matmul_q8,
    )
    from repro_torch.kernels.pattern_matmul.ref import (
        matmul_compact_ref,
        matmul_q8_ref,
    )
    from repro_torch.launch.serve import (
        make_engine,
        make_vikin_backend,
        print_report,
        submit_burst,
    )
    from repro_torch.runtime.server import Engine

    # Plain versions run torch.matmul on the card: hold them to IEEE f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    # ---------------------------------------------------------------- 1
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    torch.cuda.synchronize()

    # ---------------------------------------------------------------- 2
    max_err = {name: 0.0 for name in KERNEL_INFO}
    n_checks = {name: 0 for name in KERNEL_INFO}

    def compare(name: str, got: torch.Tensor, ref: torch.Tensor,
                what: str, exact: bool = False) -> None:
        err, scale, nan = rel_err(got, ref)
        check(not nan, f"{name} {what}: NaN in kernel or plain output")
        check(got.shape == ref.shape,
              f"{name} {what}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
        if exact:
            check(torch.equal(got, ref), f"{name} {what}: kernel != plain "
                  f"(max abs err {err:.3e}), bitwise expected")
        check(err <= KERNEL_TOL * scale,
              f"{name} {what}: max|kernel - plain| = {err:.3e} > "
              f"{KERNEL_TOL:g} * {scale:.4g}")
        max_err[name] = max(max_err[name], err)
        n_checks[name] += 1

    def layer_calls(layer, x: torch.Tensor):
        """(kernel name, kernel input, kernel call, plain call) of one stack
        layer on its input ``x``; an MLP layer's mask gather is done here,
        once, as ``PatternLinear.forward`` does it."""
        if isinstance(layer, KANLayer):
            spec = layer.cfg.spec
            return ("kan_fused_v2", x,
                    lambda: kan_fused_v2(x, layer.wt, spec, layer.kb,
                                         layer.slot_of),
                    lambda: kan_fused_v2_ref(x, layer.wt, spec, layer.kb))
        xc = (x if layer.idx is None
              else x.index_select(1, layer.idx)).contiguous()
        return ("pattern_matmul", xc,
                lambda: matmul_compact(xc, layer.w_c, layer.b, layer.act),
                lambda: matmul_compact_ref(xc, layer.w_c, layer.b,
                                           layer.act))

    def check_stack(stack, x: torch.Tensor, what: str) -> None:
        for i, layer in enumerate(stack.layers):
            name, _, kernel, plain = layer_calls(layer, x)
            x = plain()
            compare(name, kernel(), x, f"{what} layer {i}")

    backends = {name: make_vikin_backend(VIKIN_ARCHS[name], DEVICE)
                for name in ARCHS}
    rng = np.random.default_rng(0)
    for name in ARCHS:
        for b in BUCKETS:
            x = torch.from_numpy(rng.random(
                (b, VIKIN_ARCHS[name].sizes[0]), dtype=np.float32)).to(dev)
            check_stack(backends[name].stack, x, f"{name} B={b}")
    torch.cuda.synchronize()

    # ragged: kan 1000x304->96 and matmul 1000x152->304 relu
    gen = torch.Generator().manual_seed(1)
    spec = SplineSpec(4, 3)
    kb = (0, 2, 4, 5, 6)
    wt = (torch.randn((304 * (len(kb) + 1), 96), generator=gen) * 0.05).to(dev)
    x = (torch.randn((1000, 304), generator=gen) * 1.5).to(dev)
    slot = slot_table(kb, spec.n_bases, dev)
    compare("kan_fused_v2", kan_fused_v2(x, wt, spec, kb, slot),
            kan_fused_v2_ref(x, wt, spec, kb), "ragged 1000x304->96")
    xm = torch.randn((1000, 152), generator=gen).to(dev)
    wm = (torch.randn((152, 304), generator=gen) * 0.1).to(dev)
    bm = torch.randn((304,), generator=gen).to(dev)
    compare("pattern_matmul", matmul_compact(xm, wm, bm, "relu"),
            matmul_compact_ref(xm, wm, bm, "relu"), "ragged 1000x152->304")
    # the other epilogues on the ragged shape
    for act in (None, "gelu", "silu"):
        compare("pattern_matmul", matmul_compact(xm, wm, bm, act),
                matmul_compact_ref(xm, wm, bm, act),
                f"ragged 1000x152->304 act={act}")
    compare("pattern_matmul", matmul_compact(xm, wm, None, None),
            matmul_compact_ref(xm, wm, None, None), "ragged no bias")
    # one large batch through the vikin-mixed stack
    x_big = torch.from_numpy(rng.random(
        (BIG, VIKIN_ARCHS["vikin-mixed"].sizes[0]),
        dtype=np.float32)).to(dev)
    check_stack(backends["vikin-mixed"].stack, x_big, f"vikin-mixed B={BIG}")
    torch.cuda.synchronize()

    # int8: the stacks the launcher serves at --precision int8 (scales
    # calibrated on the CPU from the seed-0 batch), so the kernels see
    # the codes real quantization gives
    def q8_layer_calls(layer, h_q: torch.Tensor):
        """(kernel name, kernel input, kernel call, plain call, finish) of
        one int8 stack layer on its int8 input; ``finish`` turns the
        kernel's output into the layer's (the int8 matmul's epilogue)."""
        if isinstance(layer, QuantKANLayer):
            spec = layer.cfg.spec
            return ("kan_fused_v2_q8", h_q,
                    lambda: kan_fused_v2_q8(h_q, layer.wt_q,
                                            layer.slot_scales, spec,
                                            layer.kb, layer.x_scale,
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

    def q8_chain(stack, x: torch.Tensor, use: int, feed=None):
        """The int8 stack layer by layer through the kernels (``use=2``)
        or the plain versions (``use=3``): (output, each hidden layer's
        pre-quantization output, the codes each layer was given).  With
        ``feed``, layer i takes ``feed[i]`` instead of its own codes."""
        h = quantize_static(x, stack.x_scales[0])
        pre, codes = [], [h]
        for i, layer in enumerate(stack.layers):
            calls = q8_layer_calls(layer, h if feed is None else feed[i])
            y = calls[4](calls[use]())
            if i + 1 < len(stack.layers):
                pre.append(y)
                h = quantize_static(y, stack.x_scales[i + 1])
                codes.append(h)
        return y, pre, codes

    def check_stack_q8(stack, x: torch.Tensor, what: str) -> None:
        h = quantize_static(x, stack.x_scales[0])
        for i, layer in enumerate(stack.layers):
            name, _, kernel, plain, finish = q8_layer_calls(layer, h)
            ref = plain()
            compare(name, kernel(), ref, f"{what} int8 layer {i}",
                    exact=name == "pattern_matmul_q8")
            if i + 1 < len(stack.layers):
                h = quantize_static(finish(ref), stack.x_scales[i + 1])

    q8_backends = {name: make_vikin_backend(VIKIN_ARCHS[name], DEVICE,
                                            precision="int8")
                   for name in ARCHS}
    for name in ARCHS:
        for b in BUCKETS:
            x = torch.from_numpy(rng.random(
                (b, VIKIN_ARCHS[name].sizes[0]), dtype=np.float32)).to(dev)
            check_stack_q8(q8_backends[name].stack, x, f"{name} B={b}")
    torch.cuda.synchronize()
    # ragged: kan q8 1000x304->96, matmul q8 1000x152->304 and 999x147->301
    xq = torch.randint(-127, 128, (1000, 304), generator=gen,
                       dtype=torch.int8).to(dev)
    wtq = torch.randint(-127, 128, (304 * (len(kb) + 1), 96), generator=gen,
                        dtype=torch.int8).to(dev)
    ssq = (torch.rand((len(kb) + 1,), generator=gen) * 2e-3 + 1e-4).to(dev)
    compare("kan_fused_v2_q8",
            kan_fused_v2_q8(xq, wtq, ssq, spec, kb, 0.01, slot),
            kan_fused_v2_q8_ref(xq, wtq, ssq, spec, kb, 0.01),
            "ragged 1000x304->96")
    for m, k, n in ((1000, 152, 304), (999, 147, 301)):
        a = torch.randint(-127, 128, (m, k), generator=gen,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (k, n), generator=gen,
                          dtype=torch.int8).to(dev)
        compare("pattern_matmul_q8", matmul_q8(a, w), matmul_q8_ref(a, w),
                f"ragged {m}x{k}->{n}", exact=True)
    check_stack_q8(q8_backends["vikin-mixed"].stack, x_big,
                   f"vikin-mixed B={BIG}")
    torch.cuda.synchronize()
    for name in KERNEL_INFO:
        how = ("bitwise" if name == "pattern_matmul_q8"
               else f"within {KERNEL_TOL:g}*(1+max|plain|)")
        print(f"phase 2: {name}: {n_checks[name]} shapes {how}, max abs "
              f"err {max_err[name]:.3e}")

    # ---------------------------------------------------------------- 3
    models = [VIKIN_ARCHS[n] for n in ARCHS]
    eng = make_engine(models, slots=8, policy="mode-affinity",
                      device=DEVICE)
    rids = submit_burst(eng, models, 48)
    _build.reset_launches()
    t0 = time.perf_counter()
    out = eng.run_until_done()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print_report(eng, out, rids)
    check(sorted(out) == sorted(rids), "served set != submitted set")

    ws = eng.per_workload_stats()
    want = {"kan_fused_v2": 0, "pattern_matmul": 0}
    for name in ARCHS:
        kinds = VIKIN_ARCHS[name].layer_kinds
        batches = int(ws[name]["batches"])
        want["kan_fused_v2"] += batches * kinds.count("kan")
        want["pattern_matmul"] += batches * kinds.count("mlp")
    print(f"phase 3: launches {launches}, implied by the served batches "
          f"{want}")
    for k in want:
        check(launches[k] == want[k] and want[k] > 0,
              f"{k}: {launches[k]} launches, served batches imply {want[k]}")
    for k in Q8_KERNELS:
        check(launches[k] == 0, f"{k}: {launches[k]} launches in f32 serving")

    sub = eng.backend.backends
    for name in ARCHS:
        rs = [r for r in sorted(rids) if rids[r][0] == name]
        xs = torch.from_numpy(np.stack([rids[r][1] for r in rs])).to(dev)
        h = xs
        for layer in sub[name].stack.layers:
            h = layer_calls(layer, h)[3]()
        ref = h.cpu()
        got = torch.from_numpy(np.stack([out[r] for r in rs]))
        err, scale, nan = rel_err(got, ref)
        check(not nan and err <= SERVE_TOL * scale,
              f"served {name}: max|served - plain| = {err:.3e} vs "
              f"{SERVE_TOL:g} * {scale:.4g} (NaN: {nan})")
        print(f"phase 3: {name}: {len(rs)} answers within {SERVE_TOL:g}*"
              f"(1+max|ref|) of the plain stack, max abs err {err:.3e}")

    mixed = VIKIN_ARCHS["vikin-mixed"]
    batched_eng = Engine(make_vikin_backend(mixed, DEVICE), n_slots=4)
    prompts = [rng.random(mixed.sizes[0], dtype=np.float32)
               for _ in range(6)]
    brids = [batched_eng.submit(p) for p in prompts]
    batched = batched_eng.run_until_done()
    solo_eng = Engine(make_vikin_backend(mixed, DEVICE), n_slots=4)
    for p, rid in zip(prompts, brids):
        srid = solo_eng.submit(p)
        solo = solo_eng.run_until_done()
        check(np.array_equal(batched[rid], solo[srid]),
              f"vikin-mixed batched != single for request {rid}")
    print("phase 3: vikin-mixed batched == single, bitwise, on 6 requests "
          "(buckets 4/2 vs 2)")
    s = eng.stats
    print(f"phase 3: served sim_cycles {s['sim_cycles']:.1f}, mode_switches "
          f"{s['mode_switches']:.0f}, reconfig_cycles "
          f"{s['reconfig_cycles']:.0f}, wall {serve_s * 1e3:.2f} ms "
          f"({len(out) / serve_s:.1f} req/s)")

    # the same burst at int8
    q_eng = make_engine(models, slots=8, policy="mode-affinity",
                        device=DEVICE, precision="int8")
    q_rids = submit_burst(q_eng, models, 48)
    _build.reset_launches()
    t0 = time.perf_counter()
    q_out = q_eng.run_until_done()
    torch.cuda.synchronize()
    q_serve_s = time.perf_counter() - t0
    q_launches = dict(_build.LAUNCHES)
    print_report(q_eng, q_out, q_rids)
    check(sorted(q_out) == sorted(q_rids), "int8: served set != submitted set")
    q_ws = q_eng.per_workload_stats()
    q_want = {k: 0 for k in KERNEL_INFO}
    for name in ARCHS:
        kinds = VIKIN_ARCHS[name].layer_kinds
        batches = int(q_ws[name]["batches"])
        q_want["kan_fused_v2_q8"] += batches * kinds.count("kan")
        q_want["pattern_matmul_q8"] += batches * kinds.count("mlp")
    print(f"phase 3 int8: launches {q_launches}, implied by the served "
          f"batches {q_want}")
    for k in KERNEL_INFO:
        check(q_launches[k] == q_want[k] and (q_want[k] > 0 or
                                              k in F32_KERNELS),
              f"int8 {k}: {q_launches[k]} launches, served batches imply "
              f"{q_want[k]}")

    q_sub = q_eng.backend.backends
    for name in ARCHS:
        rs = [r for r in sorted(q_rids) if q_rids[r][0] == name]
        xs = torch.from_numpy(np.stack([q_rids[r][1] for r in rs])).to(dev)
        stack = q_sub[name].stack
        served = torch.from_numpy(np.stack([q_out[r] for r in rs]))
        y_k, _, codes_k = q8_chain(stack, xs, 2)
        check(torch.equal(served, y_k.cpu()),
              f"int8 {name}: served answers != the kernels run layer by "
              f"layer on the same rows")
        y_p, pre_p, codes_p = q8_chain(stack, xs, 3)
        flips = 0
        for i in range(1, len(codes_k)):
            diff = codes_k[i] != codes_p[i]
            if not bool(diff.any()):
                continue
            step = (codes_k[i].int() - codes_p[i].int())[diff].abs()
            u = (pre_p[i - 1] * static_reciprocal(stack.x_scales[i]))[diff]
            tie = ((u.abs() % 1.0) - 0.5).abs()
            check(int(step.max()) == 1 and float(tie.max()) < 1e-3,
                  f"int8 {name}: layer {i} codes differ from the plain "
                  f"stack's by up to {int(step.max())}, "
                  f"{float(tie.max()):.2e} code units from a rounding tie")
            flips += int(diff.sum())
        if flips:
            # compare like with like past the ties: the plain versions on
            # the kernels' codes
            y_p = q8_chain(stack, xs, 3, feed=codes_k)[0]
        err, scale, nan = rel_err(served, y_p.cpu())
        check(not nan and err <= SERVE_TOL * scale,
              f"int8 served {name}: max|served - plain| = {err:.3e} vs "
              f"{SERVE_TOL:g} * {scale:.4g} (NaN: {nan})")
        print(f"phase 3 int8: {name}: {len(rs)} answers within "
              f"{SERVE_TOL:g}*(1+max|ref|) of the plain int8 stack, max abs "
              f"err {err:.3e}; {flips} requantized codes rounded across a "
              f"tie")

    batched_eng = Engine(make_vikin_backend(mixed, DEVICE, precision="int8"),
                         n_slots=4)
    brids = [batched_eng.submit(p) for p in prompts]
    batched = batched_eng.run_until_done()
    solo_eng = Engine(make_vikin_backend(mixed, DEVICE, precision="int8"),
                      n_slots=4)
    for p, rid in zip(prompts, brids):
        srid = solo_eng.submit(p)
        solo = solo_eng.run_until_done()
        check(np.array_equal(batched[rid], solo[srid]),
              f"int8 vikin-mixed batched != single for request {rid}")
    print("phase 3 int8: vikin-mixed batched == single, bitwise, on 6 "
          "requests (buckets 4/2 vs 2)")
    qs = q_eng.stats
    print(f"phase 3 int8: served sim_cycles {qs['sim_cycles']:.1f}, "
          f"dma_bytes {qs['dma_bytes']:.0f} (f32: {s['dma_bytes']:.0f}), "
          f"wall {q_serve_s * 1e3:.2f} ms ({len(q_out) / q_serve_s:.1f} "
          f"req/s)")

    # ---------------------------------------------------------------- 4
    stack = backends["vikin-mixed"].stack
    records = {}
    per_batch_launches = {
        "kan_fused_v2": mixed.layer_kinds.count("kan"),
        "pattern_matmul": mixed.layer_kinds.count("mlp")}
    for batch in (8, BIG):
        x = torch.from_numpy(np.random.default_rng(2).random(
            (batch, mixed.sizes[0]), dtype=np.float32)).to(dev)
        acc = {k: {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0,
                   "library_ms": 0.0, "library_graph_ms": 0.0,
                   "bytes": 0.0, "flops": 0.0, "shapes": []}
               for k in F32_KERNELS}
        for layer in stack.layers:
            name, xin, kernel, plain = layer_calls(layer, x)
            a = acc[name]
            a["ms"] += time_ms(kernel)
            a["graph_ms"] += graph_ms(kernel)
            a["plain_ms"] += time_ms(plain, iters=20)
            if isinstance(layer, KANLayer):
                kan_spec = layer.cfg.spec
                n_in, n_out = layer.cfg.n_in, layer.cfg.n_out
                a["library_ms"] = a["library_graph_ms"] = None
                # multiply-adds this input needs: the silu term, plus one
                # per local basis value whose basis the mask keeps
                cell, _ = locate_cell(kan_spec.clip(xin), kan_spec)
                slots = layer.slot_of.long()
                hits = sum(int((slots[(cell + j).long()] >= 0).sum())
                           for j in range(kan_spec.n_active))
                a["flops"] += (2.0 * n_out * (batch * n_in + hits)
                               + batch * n_in * (spu_op_count(kan_spec) + 4))
                a["bytes"] += 4.0 * (xin.numel() + layer.wt.numel()
                                     + layer.slot_of.numel()
                                     + batch * n_out)
                a["shapes"].append(f"{batch}x{n_in}->{n_out} "
                                   f"kb={list(layer.kb)}")
            else:
                kc, n = layer.w_c.shape

                def library(xc=xin, layer=layer):
                    y = torch.addmm(layer.b, xc, layer.w_c)
                    return torch.relu_(y) if layer.act == "relu" else y
                a["library_ms"] += time_ms(library)
                a["library_graph_ms"] += graph_ms(library)
                a["flops"] += 2.0 * batch * kc * n + batch * n
                a["bytes"] += 4.0 * (xin.numel() + layer.w_c.numel() + n
                                     + batch * n)
                a["shapes"].append(f"{batch}x{kc}->{n} act={layer.act}")
            x = kernel()
        torch.cuda.synchronize()
        for k, a in acc.items():
            t_bytes = a["bytes"] / HBM_BYTES_PER_S * 1e3
            t_ops = a["flops"] / F32_FLOPS_PER_S * 1e3
            rec = {
                "kernel": k, "model": "vikin-mixed", "batch": batch,
                "shapes": a["shapes"], "ms": a["ms"],
                "graph_ms": a["graph_ms"], "plain_ms": a["plain_ms"],
                "library_ms": a["library_ms"],
                "library_graph_ms": a["library_graph_ms"],
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": a["bytes"], "flops": a["flops"],
                "launches_per_batch": per_batch_launches[k],
                "card": card,
            }
            records[(k, batch)] = rec
            print(json.dumps(rec))
    # the int8 kernels at the int8 vikin-mixed stack's shapes
    q_stack = q8_backends["vikin-mixed"].stack
    for batch in (8, BIG):
        x = torch.from_numpy(np.random.default_rng(2).random(
            (batch, mixed.sizes[0]), dtype=np.float32)).to(dev)
        h = quantize_static(x, q_stack.x_scales[0])
        acc = {k: {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0,
                   "library_ms": 0.0, "library_graph_ms": 0.0,
                   "bytes": 0.0, "ops": 0.0, "shapes": []}
               for k in Q8_KERNELS}
        for i, layer in enumerate(q_stack.layers):
            name, xin, kernel, plain, finish = q8_layer_calls(layer, h)
            a = acc[name]
            a["ms"] += time_ms(kernel)
            a["graph_ms"] += graph_ms(kernel)
            a["plain_ms"] += time_ms(plain, iters=20)
            if isinstance(layer, QuantKANLayer):
                kan_spec = layer.cfg.spec
                n_in, n_out = layer.cfg.n_in, layer.cfg.n_out
                a["library_ms"] = a["library_graph_ms"] = None
                xf = xin.to(torch.float32) * layer.x_scale
                cell, _ = locate_cell(kan_spec.clip(xf), kan_spec)
                slots = layer.slot_of.long()
                hits = sum(int((slots[(cell + j).long()] >= 0).sum())
                           for j in range(kan_spec.n_active))
                # multiply-adds, the spline work and the x dequantization
                # per (row, feature), each weight dequantized once
                a["ops"] += (2.0 * n_out * (batch * n_in + hits)
                             + batch * n_in * (spu_op_count(kan_spec) + 5)
                             + layer.wt_q.numel())
                a["bytes"] += (xin.numel() + layer.wt_q.numel()
                               + 4.0 * (layer.slot_scales.numel()
                                        + layer.slot_of.numel()
                                        + batch * n_out))
                a["shapes"].append(f"{batch}x{n_in}->{n_out} "
                                   f"kb={list(layer.kb)} int8")
            else:
                kc, n = layer.w_q_c.shape
                # torch._int_mm takes M > 16 and K, N multiples of 8
                if a["library_ms"] is not None and (
                        batch <= 16 or kc % 8 or n % 8):
                    a["library_ms"] = a["library_graph_ms"] = None
                if a["library_ms"] is not None:
                    def library(xc=xin, w=layer.w_q_c):
                        return torch._int_mm(xc, w)
                    try:
                        a["library_ms"] += time_ms(library)
                        a["library_graph_ms"] += graph_ms(library)
                    except RuntimeError as e:
                        print(f"phase 4: torch._int_mm on {batch}x{kc}->{n} "
                              f"refused: {e}")
                        a["library_ms"] = a["library_graph_ms"] = None
                a["ops"] += 2.0 * batch * kc * n
                a["bytes"] += xin.numel() + layer.w_q_c.numel() + 4.0 * (
                    batch * n)
                a["shapes"].append(f"{batch}x{kc}->{n} int8")
            y = finish(kernel())
            if i + 1 < len(q_stack.layers):
                h = quantize_static(y, q_stack.x_scales[i + 1])
        torch.cuda.synchronize()
        for k, a in acc.items():
            rate = F32_FLOPS_PER_S if k == "kan_fused_v2_q8" else \
                INT8_OPS_PER_S
            t_bytes = a["bytes"] / HBM_BYTES_PER_S * 1e3
            t_ops = a["ops"] / rate * 1e3
            rec = {
                "kernel": k, "model": "vikin-mixed", "precision": "int8",
                "batch": batch, "shapes": a["shapes"], "ms": a["ms"],
                "graph_ms": a["graph_ms"], "plain_ms": a["plain_ms"],
                "library_ms": a["library_ms"],
                "library_graph_ms": a["library_graph_ms"],
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": a["bytes"], "ops": a["ops"],
                "launches_per_batch": per_batch_launches[
                    k.replace("_q8", "")],
                "card": card,
            }
            records[(k, batch)] = rec
            print(json.dumps(rec))
    # Where one served batch's time goes, per arch at bucket 8: the host
    # wall of a backend forward (copy in, every layer, copy out and sync),
    # the stack alone on the card (gathers + kernels, CUDA events), and
    # the kernels alone; each "graph" time is the same work replayed from
    # a CUDA graph, i.e. device time alone.  1 - stack_graph_ms /
    # forward_ms is the share of a served forward the device sits idle.
    breakdown = []
    for name in ARCHS:
        be = backends[name]
        xb = rng.random((8, be.n_in), dtype=np.float32)
        x_dev = torch.from_numpy(xb).to(dev)
        h, kernel_ms, kernel_graph_ms = x_dev, 0.0, 0.0
        for layer in be.stack.layers:
            kernel = layer_calls(layer, h)[2]
            kernel_ms += time_ms(kernel)
            kernel_graph_ms += graph_ms(kernel)
            h = kernel()
        rec = {"arch": name, "bucket": 8,
               "forward_ms": host_ms(lambda: be.forward(xb)),
               "stack_ms": time_ms(lambda: be.stack(x_dev)),
               "stack_graph_ms": graph_ms(lambda: be.stack(x_dev)),
               "kernel_ms": kernel_ms, "kernel_graph_ms": kernel_graph_ms,
               "card": card}
        breakdown.append(rec)
        print(json.dumps({"breakdown": rec}))
    for name in ARCHS:
        be = q8_backends[name]
        xb = rng.random((8, be.n_in), dtype=np.float32)
        x_dev = torch.from_numpy(xb).to(dev)
        h, kernel_ms, kernel_graph_ms = (
            quantize_static(x_dev, be.stack.x_scales[0]), 0.0, 0.0)
        for i, layer in enumerate(be.stack.layers):
            _, _, kernel, _, finish = q8_layer_calls(layer, h)
            kernel_ms += time_ms(kernel)
            kernel_graph_ms += graph_ms(kernel)
            if i + 1 < len(be.stack.layers):
                h = quantize_static(finish(kernel()),
                                    be.stack.x_scales[i + 1])
        rec = {"arch": name, "precision": "int8", "bucket": 8,
               "forward_ms": host_ms(lambda: be.forward(xb)),
               "stack_ms": time_ms(lambda: be.stack(x_dev)),
               "stack_graph_ms": graph_ms(lambda: be.stack(x_dev)),
               "kernel_ms": kernel_ms, "kernel_graph_ms": kernel_graph_ms,
               "card": card}
        breakdown.append(rec)
        print(json.dumps({"breakdown": rec}))
    print(json.dumps({"serve": {"archs": list(ARCHS), "requests": len(out),
                                "slots": 8, "wall_s": serve_s,
                                "wall_rps": len(out) / serve_s,
                                "card": card}}))
    print(json.dumps({"serve": {"archs": list(ARCHS), "precision": "int8",
                                "requests": len(q_out), "slots": 8,
                                "wall_s": q_serve_s,
                                "wall_rps": len(q_out) / q_serve_s,
                                "card": card}}))

    kernels = []
    for k, info in KERNEL_INFO.items():
        rec = records[(k, 8)]
        kernels.append({
            "name": k, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"],
            "launches": (q_launches if k in Q8_KERNELS else launches)[k],
            "max_abs_err": max_err[k], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    summary = {"kernels": kernels}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "kernels": kernels,
         "records": [records[key] for key in sorted(records)],
         "breakdown": breakdown,
         "serve": {"wall_s": serve_s, "wall_rps": len(out) / serve_s,
                   "stats": {k: v for k, v in eng.stats.items()}},
         "serve_int8": {"wall_s": q_serve_s,
                        "wall_rps": len(q_out) / q_serve_s,
                        "stats": {k: v for k, v in q_eng.stats.items()}}},
        indent=1, default=str))
    print(json.dumps(summary))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
