#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from anywhere on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any fault:

1. device and build -- print the card (nvidia-smi name and power limit)
   and the torch/CUDA versions, then build both kernels from
   ``src/repro_torch/kernels/*/csrc/*.cu`` with nvcc for sm_90a, one
   compiler per source, in parallel;
2. kernels vs plain -- each kernel against its plain PyTorch version on
   the card, at every shape the vikin-mixed, vikin-kan2 and vikin-mlp3
   stacks give it at buckets 2/4/8/16, at one ragged shape and at one
   batch of 8192, within ``1e-5 * (1 + max|plain|)``;
3. serve -- 48 requests of vikin-kan2, vikin-mlp3 and vikin-mixed through
   the port's Engine + MultiWorkloadBackend on 8 slots: every answer
   against the same stack run through the plain versions on the card
   (``1e-4 * (1 + max|ref|)``), the launch counts against the layer
   applications the served batches imply, and vikin-mixed batched ==
   single, bitwise;
4. times -- per kernel at the vikin-mixed shapes, bucket 8 and batch
   8192: median ms of back-to-back calls (CUDA events) and of the same
   calls replayed from a CUDA graph (device time alone), the plain
   version's ms, one PyTorch call's ms where one computes the same
   function, and the bound max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s
   f32); then, per arch at bucket 8, where one served batch's time goes
   (host wall of a backend forward, the stack on the card, the kernels
   alone).

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
}


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
    from repro_torch.core.splines import SplineSpec, locate_cell, spu_op_count
    from repro_torch.kernels import _build
    from repro_torch.kernels.kan_fused.ops import kan_fused_v2, slot_table
    from repro_torch.kernels.kan_fused.ref import kan_fused_v2_ref
    from repro_torch.kernels.pattern_matmul.ops import matmul_compact
    from repro_torch.kernels.pattern_matmul.ref import matmul_compact_ref
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
                what: str) -> None:
        err, scale, nan = rel_err(got, ref)
        check(not nan, f"{name} {what}: NaN in kernel or plain output")
        check(got.shape == ref.shape,
              f"{name} {what}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
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
    for name in KERNEL_INFO:
        print(f"phase 2: {name}: {n_checks[name]} shapes within "
              f"{KERNEL_TOL:g}*(1+max|plain|), max abs err "
              f"{max_err[name]:.3e}")

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
               for k in KERNEL_INFO}
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
    print(json.dumps({"serve": {"archs": list(ARCHS), "requests": len(out),
                                "slots": 8, "wall_s": serve_s,
                                "wall_rps": len(out) / serve_s,
                                "card": card}}))

    kernels = []
    for k, info in KERNEL_INFO.items():
        rec = records[(k, 8)]
        kernels.append({
            "name": k, "route": "cuda", "source": info["source"],
            "replaces": info["replaces"], "launches": launches[k],
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
                   "stats": {k: v for k, v in eng.stats.items()}}},
        indent=1, default=str))
    print(json.dumps(summary))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
