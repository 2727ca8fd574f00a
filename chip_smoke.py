#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from anywhere on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any fault:

1. device and build -- print the card (nvidia-smi name and power limit)
   and the torch/CUDA versions, then build all ten kernels (six f32 and
   int8, four bf16) from ``src/repro_torch/kernels/*/csrc/*.cu`` with
   nvcc for sm_90a, one compiler per source, in parallel, and print what
   ptxas gives every kernel instance (registers, spills); no instance
   may spill;
2. kernels vs plain -- each kernel against its plain PyTorch version on
   the card, at every shape the vikin-mixed, vikin-kan2 and vikin-mlp3
   stacks give it at buckets 2/4/8/16 (f32, and int8 with scales
   calibrated as the launcher does), at ragged shapes and at one batch
   of 8192: within ``1e-5 * (1 + max|plain|)``, and the int8 matmul
   bitwise.  The kernel-tooling kernels too: the spline-basis kernel
   bitwise for every G x K, on the flattened KAN-layer inputs of
   vikin-mixed and vikin-kan2 at the same batches, at ragged n, on
   inputs outside [-1, 1], at every ``block_n`` candidate (inputs a
   block) and into outputs 4, 8 and 12 bytes past a 16-byte boundary;
   the v1 KAN kernel at the same KAN layers and at a ragged shape, within
   the tolerance of its plain version and of the v2 kernel, and batched
   == single, bitwise.  Both matmul kernels at every candidate tile
   (``autotune.candidates_pattern_matmul``) of vikin-mixed's and
   vikin-mlp3's matmul layers at bucket 8 and batch 8192: bitwise the
   output of the default tile.  Both KAN kernels at every candidate knob
   (``autotune.candidates_kan_fused``) of vikin-mixed's and vikin-kan2's
   KAN layers at bucket 8 and batch 8192: bitwise the default knob's
   output; at ragged widths (37->13, 300->33) within tolerance; and a row
   alone under one knob bitwise equal to it in a batch under another, in
   both precisions.  The v1 kernel the same way, at every candidate of
   its own grid (``candidates_kan_fused(..., version=1)``).
   bf16: the four bf16 kernels against their plain versions on the card
   at the bf16 stacks' shapes (buckets 2/4/8/16 and 8192), at ragged
   shapes (odd n_in and n_out: 77x37->13, 77x301->33, 999x147->301; the
   tensor-core KAN body at 21 fused rows a feature, G16K4 77x37->33, and
   at the silu row alone, nbk = 0) and at every candidate knob: KAN v2
   and v1 within ``1e-5 * (1 + max|plain|)`` at f32 out and one bf16 ulp
   (``2**-8 * (1 + max|plain|)``) at bf16 out, the matmul within one
   bf16 ulp (f32 out within 1e-5), the spline basis bitwise (every G x
   K, in and out of range, every ``block_n``, outputs 2..14 bytes past a
   16-byte boundary); every knob bitwise the default's; batched == single
   bitwise at buckets 2/4/8/16 and 8192;
3. serve -- 48 requests of vikin-kan2, vikin-mlp3 and vikin-mixed through
   the port's Engine + MultiWorkloadBackend on 8 slots, once in f32 and
   once in int8: every answer against the same stack run through the
   plain versions on the card (``1e-4 * (1 + max|ref|)``; an int8 code
   that a requantization rounds across a half-step must sit at a
   rounding tie), the launch counts against the layer applications the
   served batches imply (and none of the other precision's kernels),
   and vikin-mixed batched == single, bitwise, in both precisions; then
   the same at bf16 through ``make_vikin_backend(precision="bf16")``:
   every answer within ``SERVE_TOL_BF16`` of the bf16 stack through the
   plain versions on the card and only bf16 kernels launched; in each
   precision the served simulated fields equal a CPU engine's on the
   same burst;
4. times -- per kernel at the vikin-mixed shapes, bucket 8 and batch
   8192: median ms of back-to-back calls (CUDA events) and of the same
   calls replayed from a CUDA graph (device time alone), the plain
   version's ms, one PyTorch call's ms where one computes the same
   function (``addmm``; ``torch._int_mm`` where its shape rules allow),
   and the bound max(bytes / 3.35 TB/s, the operations each over the
   peak rate for its type: 67 TFLOP/s f32 on CUDA cores, 989 TFLOP/s
   for products of bf16 operands, 1979 TOP/s for the int8 matmul); the
   spline-basis
   kernel on the vikin-mixed KAN layer's input, flattened, and the v1
   KAN kernel at that layer beside the v2 one; each matmul record names
   the tiles (bm, bk, bn) each launch took, each KAN record (v1 too) the
   knob (bm, bi, bn), the spline-basis record its ``block_n``, and the
   bf16 records their kernels' design (``design``): the matmul's
   persistent grid and the row tiles a block walks, the KAN kernel's
   shared memory a block, its cluster and the multiply-adds its dense
   MMA tile issues beside the useful ones the bound counts; then, per
   arch at bucket
   8 and per precision, where one served batch's time goes (host wall of
   a backend forward, the stack on the card, the kernels alone); the same
   rows for the four bf16 kernels (their multiply-adds at the bf16
   rate, the SPU and spline work at the f32 rate; library ``addmm`` in
   bf16 with f32 accumulation) and the per-arch breakdown at bf16;
5. the v1 path -- a ``KANLayer`` at ``version=1`` built from the
   vikin-kan2 stack's weights runs forward on the card at buckets
   2/4/8/16, 8192 and 65535 * 16 + 1 (more 16-row tiles than grid.y
   holds: row tiles sit on grid.x), and once more at bucket 8 with
   explicit knobs
   (``KANConfig(version=1, blocks=...)``): exactly one v1 launch per call
   and no other launch, answers within tolerance of the v2 layer and of
   the plain version (and of the layer on the CPU below the big batch);
   and a bf16 v1 layer on the same weights cast to bf16 at buckets
   2/4/8/16 and 8192: one bf16 v1 launch per call, within one bf16 ulp of
   the bf16 v2 layer and of the plain version;
6. the kernel bench -- ``repro_torch.benchmarks.kernel_bench.run`` on
   the card with its own asserts (spline-basis, v1 and v2 KAN and
   matmul kernels against plain versions and oracles, one
   ``tune_spline_basis``, one ``tune_pattern_matmul`` (8192x72->304 relu)
   and two ``tune_kan_fused`` searches (8x304->32, the v2 and the v1
   kernel), each round-tripped through a temporary cache and shown to
   change no bit), with its bf16 rows (v1, v2 and the spline basis), its
   JSON in ``chiprun_out/kernel_bench.json``;
7. open-loop on the card (``runtime/loadgen``), vikin-mlp3 on 8 slots in
   f32 and int8:
   (a) the committed ``openloop:burst:vikin-mlp3`` trace of
   ``BENCH_serving.json`` (its sha256 checked) replayed on the simulated
   clock, unbounded and with ``max_queue=16, admission="shed",
   drop_expired=True``: every report field equal to the committed row at
   f32, and to the same replay on a CPU backend at int8 and at bf16
   (both move other modelled DMA bytes);
   (b) the same backends, and the three-arch multi-workload engine under
   a workload-mixed trace, on the wall clock at rates sized from the
   card: the closed-burst rate C after ``warmup`` (15 bursts of 64, each
   submitted and served in the timed region), Poisson traces of 2000
   arrivals at 0.5, 0.9 and 1.5 C, and for vikin-mlp3 a bursty deadline
   trace (calm 0.5 C, bursts 5 C, deadline four batch times) unbounded
   and shed; offered, achieved and goodput req/s, p50/p95/p99 latency,
   the queue high-water mark and sheds are printed, and the bound, the
   drain, every request's fate and that no kernel is built and no knob
   resolved inside a replay are checked;
   in both, every served answer is held to ``SERVE_TOL`` against the
   plain versions on the card (int8 as in phase 3), and the launches to
   what the served batches imply;
   (c) the port's serving and load benches on the card
   (``chiprun_out/serving_bench.json``): every simulated field equal to
   the committed rows, batched == single bitwise under both policies;
8. training on the card, f32 with TF32 off (asserted):
   (a) one step of vikin-mixed and of vikin-kan2 at batch 64 through
   ``StackTrainer.loss_fn``: every gradient through the kernels'
   autograd Functions within ``1e-5 * (1 + max|plain|)`` a leaf of
   autograd through the plain versions on the card, and the launches
   of the forward and backward exactly ``kan_fused_v2`` x1,
   ``pattern_matmul`` x2, ``spline_basis`` x2 (vikin-kan2: x1, x0, x1);
   (b) ``StackTrainer`` 200 steps of each, twice from one init: the
   validation MSE falls, the two runs are bitwise equal, the launches
   are 200 times one step's, the first 10 losses within 1e-4 relative
   of a CPU run's from the same init; ms a step: host wall, and CUDA
   event spans of the forward, backward and update beside the
   spline-basis launches of one backward (graph-replayed);
   (c) ``python -m repro_torch.launch.train --arch vikin-mixed --steps
   200 --batch 64 --pattern 0.5 --precision int8`` in a subprocess on
   the card, its checkpoint served through ``make_vikin_backend(...,
   ckpt=...)`` at f32 and int8 (answers held as in phase 3), the served
   masks equal to the saved ones and to a calibration of the saved
   params;
   (d) an ``AsyncCheckpointer`` save overlapped with 20 training steps:
   the restored params bitwise the snapshot.

No served path launches the spline-basis or v1 kernels, so their
``launches`` in the record are those of phases 6 and 5.  The served rows
also carry ``launches_openloop``, their launches in phase 7's replays,
and every row ``launches_train``, its launches in phase 8 (b)'s first
run of each arch.

It prints the ``{"kernels": [...]}`` record, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  It imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 on CUDA cores (no tensor cores)
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core rate
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
KERNEL_TOL = 1e-5
SERVE_TOL = 1e-4
BF16_ULP = 2.0 ** -8          # one bf16 ulp of (1 + max|ref|)
# A served bf16 answer against the bf16 stack through the plain versions
# on the card: each layer's bf16 output may round one ulp apart, and the
# deepest served stack has three layers.
SERVE_TOL_BF16 = 3 * BF16_ULP
# phase 8: a gradient through the kernels' autograd Functions against
# autograd through the plain versions, a leaf at a time, within
# TRAIN_GRAD_TOL of the leaf's own max|plain| (the loss within it of its
# value); the first CPU_STEPS losses of a card run against a CPU run from
# the same params
TRAIN_GRAD_TOL = 1e-5
TRAIN_LOSS_TOL = 1e-4
TRAIN_STEPS = 200
CPU_STEPS = 10
ARCHS = ("vikin-kan2", "vikin-mlp3", "vikin-mixed")
BUCKETS = (2, 4, 8, 16)
BIG = 8192
DEVICE = "cuda"

KERNEL_INFO = {
    "kan_fused_v2": {
        "source": "src/repro_torch/kernels/kan_fused/csrc/kan_fused.cu",
        "headers": ["src/repro_torch/kernels/kan_fused/csrc/kan_split.cuh"],
        "replaces": "src/repro/kernels/kan_fused/kan_fused.py:284",
    },
    "pattern_matmul": {
        "source": ("src/repro_torch/kernels/pattern_matmul/csrc/"
                   "pattern_matmul.cu"),
        "replaces": "src/repro/kernels/pattern_matmul/pattern_matmul.py:119",
    },
    "kan_fused_v2_q8": {
        "source": "src/repro_torch/kernels/kan_fused/csrc/kan_fused_q8.cu",
        "headers": ["src/repro_torch/kernels/kan_fused/csrc/kan_split.cuh"],
        "replaces": "src/repro/kernels/kan_fused/kan_fused.py:338",
    },
    "pattern_matmul_q8": {
        "source": ("src/repro_torch/kernels/pattern_matmul/csrc/"
                   "pattern_matmul_q8.cu"),
        "replaces": "src/repro/kernels/pattern_matmul/pattern_matmul.py:79",
    },
    "spline_basis": {
        "source": ("src/repro_torch/kernels/spline_basis/csrc/"
                   "spline_basis.cu"),
        "headers": ["src/repro_torch/kernels/spline_basis/csrc/"
                    "spline_basis.cuh"],
        "replaces": "src/repro/kernels/spline_basis/spline_basis.py:68",
    },
    "kan_fused_v1": {
        "source": "src/repro_torch/kernels/kan_fused/csrc/kan_fused_v1.cu",
        "headers": ["src/repro_torch/kernels/kan_fused/csrc/kan_split.cuh"],
        "replaces": "src/repro/kernels/kan_fused/kan_fused.py:227",
    },
    "kan_fused_v2_bf16": {
        "source": "src/repro_torch/kernels/kan_fused/csrc/kan_fused_bf16.cu",
        "headers": ["src/repro_torch/kernels/kan_fused/csrc/kan_mma.cuh",
                    "src/repro_torch/kernels/kan_fused/csrc/kan_split.cuh",
                    "src/repro_torch/kernels/pattern_matmul/csrc/"
                    "mma_bf16.cuh"],
        "replaces": "src/repro/kernels/kan_fused/kan_fused.py:284",
    },
    "pattern_matmul_bf16": {
        "source": ("src/repro_torch/kernels/pattern_matmul/csrc/"
                   "pattern_matmul_bf16.cu"),
        "headers": ["src/repro_torch/kernels/pattern_matmul/csrc/"
                    "mma_bf16.cuh"],
        "replaces": "src/repro/kernels/pattern_matmul/pattern_matmul.py:119",
    },
    "spline_basis_bf16": {
        "source": ("src/repro_torch/kernels/spline_basis/csrc/"
                   "spline_basis_bf16.cu"),
        "headers": ["src/repro_torch/kernels/spline_basis/csrc/"
                    "spline_basis.cuh"],
        "replaces": "src/repro/kernels/spline_basis/spline_basis.py:68",
    },
    "kan_fused_v1_bf16": {
        "source": ("src/repro_torch/kernels/kan_fused/csrc/"
                   "kan_fused_v1_bf16.cu"),
        "headers": ["src/repro_torch/kernels/kan_fused/csrc/kan_split.cuh"],
        "replaces": "src/repro/kernels/kan_fused/kan_fused.py:227",
    },
}
F32_KERNELS = ("kan_fused_v2", "pattern_matmul")
Q8_KERNELS = ("kan_fused_v2_q8", "pattern_matmul_q8")
TOOLING_KERNELS = ("spline_basis", "kan_fused_v1")
BF16_KERNELS = ("kan_fused_v2_bf16", "pattern_matmul_bf16")
BF16_TOOLING_KERNELS = ("spline_basis_bf16", "kan_fused_v1_bf16")
PRECISIONS = ("f32", "int8", "bf16")
SERVED_KERNELS = {"f32": F32_KERNELS, "int8": Q8_KERNELS,
                  "bf16": BF16_KERNELS}    # (KAN, matmul) per precision
DTYPE = {k: "bfloat16" if k.endswith("_bf16") else
         "int8" if k.endswith("_q8") else "float32" for k in KERNEL_INFO}
BF, F32 = torch.bfloat16, torch.float32
SUFFIX = {F32: "", BF: "_bf16"}            # kernel name by operand dtype


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
    got, ref = got.float(), ref.float()       # bf16: the error in f32
    nan = bool(torch.isnan(got).any() or torch.isnan(ref).any())
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    scale = 1.0 + (float(ref.abs().max()) if ref.numel() else 0.0)
    return err, scale, nan


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

    from repro_torch.benchmarks import (
        kernel_bench,
        loadgen_bench,
        serving_bench,
    )
    from repro_torch.benchmarks.kernel_ab import (
        graph_ms,
        layer_calls,
        plain_grads,
        q8_layer_calls,
        stack_calls,
        time_ms,
    )
    from repro_torch.configs.vikin_models import VIKIN_ARCHS
    from repro_torch.core.kan import KANLayer
    from repro_torch.core.quant import (
        QuantKANLayer,
        quantize_static,
        static_reciprocal,
    )
    from repro_torch.core.splines import (
        VALID_G,
        VALID_K,
        SplineSpec,
        locate_cell,
        spu_op_count,
    )
    from repro_torch.kernels import _build, autotune
    from repro_torch.kernels.kan_fused.ops import (
        flatten_t,
        kan_fused_v1,
        kan_fused_v2,
        kan_fused_v2_q8,
        kernel_smem,
        slot_table,
        split,
    )
    from repro_torch.kernels.kan_fused.ops import (
        resolve_blocks as kan_blocks,
    )
    from repro_torch.kernels.kan_fused.ref import (
        kan_fused_v1_ref,
        kan_fused_v2_q8_ref,
        kan_fused_v2_ref,
    )
    from repro_torch.kernels.pattern_matmul.ops import (
        bf16_grid,
        matmul_compact,
        matmul_q8,
        resolve_blocks,
    )
    from repro_torch.kernels.pattern_matmul.ref import (
        matmul_compact_ref,
        matmul_q8_ref,
    )
    from repro_torch.kernels.spline_basis.ops import (
        resolve_block_n,
        spline_basis,
    )
    from repro_torch.kernels.spline_basis.ref import spline_basis_plain
    from repro_torch.launch.serve import (
        make_engine,
        make_vikin_backend,
        print_report,
        submit_burst,
    )
    from repro_torch.runtime.backends import MultiWorkloadBackend
    from repro_torch.runtime.loadgen import (
        bursty_trace,
        poisson_trace,
        replay,
    )
    from repro_torch.runtime.server import Engine
    from repro_torch.checkpoint import (
        AsyncCheckpointer,
        restore_checkpoint,
        restore_masks,
    )
    from repro_torch.core.calibrate import stack_saliencies
    from repro_torch.core.sparsity import magnitude_mask
    from repro_torch.data.stack_task import task_for_model
    from repro_torch.models.ffn import vikin_stack_init
    from repro_torch.runtime.trainer import StackTrainer, StackTrainerConfig
    from repro_torch.utils import leaf_paths, tree_map

    # Plain versions run torch.matmul on the card: hold them to IEEE f32,
    # and the bf16 library call (addmm) to f32 accumulation.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    usage = _build.resource_usage()
    for name, entries in usage.items():
        for e in entries:
            print(f"ptxas {name} {e['entry']}: {e.get('registers')} "
                  f"registers, {e.get('stack')} B stack, "
                  f"{e.get('spill_stores')} B spill stores, "
                  f"{e.get('spill_loads')} B spill loads")
    spills = [f"{name} {e['entry']}" for name in KERNEL_INFO
              for e in usage.get(name, [])
              if e.get("spill_stores") != 0 or e.get("spill_loads") != 0]
    check(all(usage.get(name) for name in KERNEL_INFO) and not spills,
          f"ptxas found no instance of a kernel, or instances spill: "
          f"{spills}")
    torch.cuda.synchronize()

    # ---------------------------------------------------------------- 2
    max_err = {name: 0.0 for name in KERNEL_INFO}
    n_checks = {name: 0 for name in KERNEL_INFO}

    def compare(name: str, got: torch.Tensor, ref: torch.Tensor,
                what: str, exact: bool = False,
                tol: float = KERNEL_TOL) -> None:
        err, scale, nan = rel_err(got, ref)
        check(not nan, f"{name} {what}: NaN in kernel or plain output")
        check(got.shape == ref.shape,
              f"{name} {what}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
        if exact:
            check(torch.equal(got, ref), f"{name} {what}: kernel != plain "
                  f"(max abs err {err:.3e}), bitwise expected")
        check(err <= tol * scale,
              f"{name} {what}: max|kernel - plain| = {err:.3e} > "
              f"{tol:g} * {scale:.4g}")
        max_err[name] = max(max_err[name], err)
        n_checks[name] += 1

    def compare_calls(name: str, run, plain, what: str) -> torch.Tensor:
        """The kernel call ``run`` against the plain call ``plain``, both
        taking an output dtype (None: the input's).  An f32 output within
        ``KERNEL_TOL``; a bf16 one within one bf16 ulp, its f32 output
        within ``KERNEL_TOL`` and the bf16 output the f32 one rounded
        once.  Returns the kernel's output."""
        got = run(None)
        if got.dtype != BF:
            compare(name, got, plain(None), what)
            return got
        got32 = run(F32)
        check(got32.dtype == F32, f"{name} {what}: f32 out is {got32.dtype}")
        compare(name, got, plain(None), f"{what} bf16 out", tol=BF16_ULP)
        compare(name, got32, plain(F32), f"{what} f32 out")
        check(torch.equal(got, got32.to(BF)), f"{name} {what}: the bf16 "
              f"output is not the f32 output rounded once")
        return got

    def check_stack(stack, x: torch.Tensor, what: str) -> None:
        for i, layer in enumerate(stack.layers):
            name, _, kernel, plain = layer_calls(layer, x)
            compare_calls(name, kernel, plain, f"{what} layer {i}")
            x = plain()

    def rand(rng, batch: int, name: str, dtype=F32) -> torch.Tensor:
        """A seeded (batch, n_in) input of arch ``name`` on the card."""
        return torch.from_numpy(rng.random(
            (batch, VIKIN_ARCHS[name].sizes[0]), dtype=np.float32)).to(
                dev, dtype)

    backends = {name: make_vikin_backend(VIKIN_ARCHS[name], DEVICE)
                for name in ARCHS}
    # the stacks the launcher serves at --precision bf16: the seed-0 f32
    # weights cast once
    bf_backends = {name: make_vikin_backend(VIKIN_ARCHS[name], DEVICE,
                                            precision="bf16")
                   for name in ARCHS}
    by_dtype = {F32: backends, BF: bf_backends}
    rng = np.random.default_rng(0)
    x_big = rand(rng, BIG, "vikin-mixed")
    for dtype, bes in by_dtype.items():
        for name in ARCHS:
            for b in BUCKETS:
                check_stack(bes[name].stack, rand(rng, b, name, dtype),
                            f"{name} {dtype} B={b}")
        check_stack(bes["vikin-mixed"].stack, x_big.to(dtype),
                    f"vikin-mixed {dtype} B={BIG}")
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
    torch.cuda.synchronize()

    # int8: the stacks the launcher serves at --precision int8 (scales
    # calibrated on the CPU from the seed-0 batch), so the kernels see
    # the codes real quantization gives
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
            check_stack_q8(q8_backends[name].stack, rand(rng, b, name),
                           f"{name} B={b}")
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

    # the kernel-tooling kernels, f32 and bf16: spline_basis bitwise at
    # every block_n candidate; kan_fused_v1 against its plain version (f32:
    # and the v2 kernel on the same weights), and itself one row at a time
    def kan_inputs(stack, x: torch.Tensor):
        """(layer, input) of each KAN layer of ``stack`` on ``x``, the
        stack run layer by layer through the plain versions."""
        out = []
        for layer in stack.layers:
            if isinstance(layer, KANLayer):
                out.append((layer, x))
            x = layer_calls(layer, x)[3]()
        return out

    def t_flat_of(layer) -> torch.Tensor:
        """The v1 kernel's basis weights of a (v2) KANLayer, unfused."""
        return flatten_t(layer.t, layer.cfg.kb).contiguous()

    def check_spline(x: torch.Tensor, spec, what: str,
                     misaligned: bool = False) -> None:
        name = "spline_basis" + SUFFIX[x.dtype]
        flat = x.reshape(-1)
        plain = spline_basis_plain(flat, spec)
        for cand in autotune.candidates_spline_basis(
                flat.numel(), spec.n_bases, flat.dtype):
            bn = cand["block_n"]
            compare(name, spline_basis(flat, spec, block_n=bn), plain,
                    f"{what} block_n={bn}", exact=True)
        if not misaligned:
            return
        # the kernel into an output each element offset past a 16-byte
        # boundary, up to 16 bytes, with a guard on each side (these
        # launches count in no phase's launches)
        n, nb, esz = flat.numel(), spec.n_bases, flat.element_size()
        for off in range(1, 16 // esz):
            buf = torch.full((n * nb + 32 // esz,), -7.0, device=dev,
                             dtype=flat.dtype)
            _build.launch(name, flat.data_ptr(), buf[off:].data_ptr(), n,
                          spec.grid_size, spec.order, float(spec.x0),
                          float(spec.inv_h), 256,
                          torch.cuda.current_stream().cuda_stream)
            compare(name, buf[off:off + n * nb].reshape(n, nb), plain,
                    f"{what} output +{esz * off} bytes", exact=True)
            check(bool((buf[:off] == -7.0).all()) and bool(
                (buf[off + n * nb:] == -7.0).all()),
                f"{name} {what}: a store outside the output")

    v1_v2 = {"err": 0.0, "n": 0}

    def check_v1(x, w_b, t_flat, wt, spec, kb, slot, what: str) -> None:
        compare_calls("kan_fused_v1" + SUFFIX[x.dtype],
                      lambda od=None: kan_fused_v1(x, w_b, t_flat, spec, kb,
                                                   slot, out_dtype=od),
                      lambda od=None: kan_fused_v1_ref(x, w_b, t_flat, spec,
                                                       kb, od), what)
        if x.dtype != F32:
            return
        got = kan_fused_v1(x, w_b, t_flat, spec, kb, slot)
        err, scale, nan = rel_err(got, kan_fused_v2(x, wt, spec, kb, slot))
        check(not nan and err <= KERNEL_TOL * scale,
              f"kan_fused_v1 {what}: max|v1 - v2| = {err:.3e} > "
              f"{KERNEL_TOL:g} * {scale:.4g} (NaN: {nan})")
        v1_v2["err"] = max(v1_v2["err"], err)
        v1_v2["n"] += 1

    rng_sb = np.random.default_rng(3)
    for dtype, bes in by_dtype.items():
        for g in VALID_G:
            for k in VALID_K:
                x = torch.from_numpy(rng_sb.uniform(-2.5, 2.5, 4096).astype(
                    np.float32)).to(dev, dtype)
                check_spline(x, SplineSpec(g, k), f"G{g}K{k} n=4096 in "
                             f"[-2.5, 2.5]", misaligned=True)
        for name in ("vikin-mixed", "vikin-kan2"):
            for b in BUCKETS + (BIG,):
                x = rand(rng, b, name, dtype)
                for layer, xin in kan_inputs(bes[name].stack, x):
                    check_spline(xin, layer.cfg.spec,
                                 f"{name} KAN input B={b}")
                    check_v1(xin, layer.w_b, t_flat_of(layer), layer.wt,
                             layer.cfg.spec, layer.kb, layer.slot_of,
                             f"{name} B={b}")
        for n in (1, 7, 1025, 1000 * 304):
            x = torch.from_numpy(rng_sb.uniform(-2.5, 2.5, n).astype(
                np.float32)).to(dev, dtype)
            check_spline(x, spec, f"ragged n={n} in [-2.5, 2.5]",
                         misaligned=True)
    # ragged 1000x304->96: the ragged v2 weights, unfused
    xr = (torch.randn((1000, 304), generator=gen) * 1.5).to(dev)
    w3 = wt.reshape(304, len(kb) + 1, 96)
    check_v1(xr, w3[:, 0].contiguous(),
             w3[:, 1:].reshape(304 * len(kb), 96).contiguous(), wt, spec,
             kb, slot, "ragged 1000x304->96")
    # batched == single, bitwise, at vikin-mixed's KAN layer
    layer, xin = kan_inputs(backends["vikin-mixed"].stack, x_big[:16])[0]
    t_flat = t_flat_of(layer)
    full = kan_fused_v1(xin, layer.w_b, t_flat, layer.cfg.spec, layer.kb,
                        layer.slot_of)
    for i in range(6):
        one = kan_fused_v1(xin[i:i + 1].contiguous(), layer.w_b, t_flat,
                           layer.cfg.spec, layer.kb, layer.slot_of)
        check(torch.equal(one, full[i:i + 1]),
              f"kan_fused_v1: row {i} alone != row {i} of a batch of 16")
    torch.cuda.synchronize()

    # every candidate tile of the three matmul kernels at vikin-mixed's
    # and vikin-mlp3's matmul layers: bitwise the default tile's output,
    # which is held to the plain version
    knob_checks = {}

    def check_knobs(name: str, xin, run, what: str) -> None:
        ref = run(None)
        M, kc = xin.shape
        n = ref.shape[1]
        for c in autotune.candidates_pattern_matmul(M, kc, n, xin.dtype):
            knob = (c["bm"], c["bk"], c["bn"])
            check(torch.equal(run(knob), ref), f"{name} {what}: tiles "
                  f"{knob} != the default tiles, bitwise")
            knob_checks[name] = knob_checks.get(name, 0) + 1

    for name in ("vikin-mixed", "vikin-mlp3"):
        for b in (8, BIG):
            x = rand(rng, b, name)
            for dtype, bes in by_dtype.items():
                h = x.to(dtype)
                for i, layer in enumerate(bes[name].stack.layers):
                    lname, xin, kernel, plain = layer_calls(layer, h)
                    if not isinstance(layer, KANLayer):
                        compare_calls(lname, kernel, plain, f"{name} B={b} "
                                      f"layer {i} default tiles")
                        check_knobs(lname, xin,
                                    lambda k, xin=xin, layer=layer:
                                    matmul_compact(xin, layer.w_c, layer.b,
                                                   layer.act, blocks=k),
                                    f"{name} B={b} layer {i}")
                    h = plain()
            stack = q8_backends[name].stack
            h = quantize_static(x, stack.x_scales[0])
            for i, layer in enumerate(stack.layers):
                lname, xin, kernel, plain, finish = q8_layer_calls(layer, h)
                ref = plain()
                if lname == "pattern_matmul_q8":
                    compare(lname, kernel(), ref,
                            f"{name} B={b} int8 layer {i} default tiles",
                            exact=True)
                    check_knobs(lname, xin, lambda k, xin=xin, layer=layer:
                                matmul_q8(xin, layer.w_q_c, blocks=k),
                                f"{name} B={b} int8 layer {i}")
                if i + 1 < len(stack.layers):
                    h = quantize_static(finish(ref), stack.x_scales[i + 1])
    torch.cuda.synchronize()
    print(f"phase 2: every candidate tile bitwise the default's at "
          f"vikin-mixed's and vikin-mlp3's matmul layers, B=8 and {BIG}: "
          f"{knob_checks}")

    # every candidate knob (bm, bi, bn) of both KAN kernels at the served
    # KAN layers (vikin-mixed's 304->32, vikin-kan2's 72->96) at bucket 8
    # and batch 8192: bitwise the default knob's output, which is held to
    # the plain version
    def check_kan_knobs(name: str, run, xin, layer, dtype, what: str,
                        version: int = 2):
        ref = run(None)
        B, n_in = xin.shape
        for c in autotune.candidates_kan_fused(B, n_in, layer.cfg.n_out,
                                               len(layer.kb), dtype,
                                               version):
            knob = (c["bm"], c["bi"], c["bn"])
            check(torch.equal(run(knob), ref), f"{name} {what}: knob "
                  f"{knob} != the default knob, bitwise")
            knob_checks[name] = knob_checks.get(name, 0) + 1

    for name in ("vikin-mixed", "vikin-kan2"):
        for b in (8, BIG):
            x = rand(rng, b, name)
            for dtype, bes in by_dtype.items():
                for layer, xin in kan_inputs(bes[name].stack, x.to(dtype)):
                    lname, _, kernel, plain = layer_calls(layer, xin)
                    compare_calls(lname, kernel, plain,
                                  f"{name} B={b} default knob")
                    check_kan_knobs(
                        lname, lambda k, xin=xin, layer=layer:
                        kan_fused_v2(xin, layer.wt, layer.cfg.spec, layer.kb,
                                     layer.slot_of, blocks=k),
                        xin, layer, dtype, f"{name} B={b}")
                    # v1 on the same weights, unfused: every candidate of
                    # its own grid bitwise its default knob, which holds
                    # to the plain version
                    t_flat = t_flat_of(layer)
                    compare_calls(
                        "kan_fused_v1" + SUFFIX[dtype],
                        lambda od=None, xin=xin, layer=layer, t_flat=t_flat:
                        kan_fused_v1(xin, layer.w_b, t_flat, layer.cfg.spec,
                                     layer.kb, layer.slot_of, out_dtype=od),
                        lambda od=None, xin=xin, layer=layer, t_flat=t_flat:
                        kan_fused_v1_ref(xin, layer.w_b, t_flat,
                                         layer.cfg.spec, layer.kb, od),
                        f"{name} B={b} default knob")
                    check_kan_knobs(
                        "kan_fused_v1" + SUFFIX[dtype],
                        lambda k, xin=xin, layer=layer, t_flat=t_flat:
                        kan_fused_v1(xin, layer.w_b, t_flat, layer.cfg.spec,
                                     layer.kb, layer.slot_of, blocks=k),
                        xin, layer, dtype, f"{name} B={b}", version=1)
            stack = q8_backends[name].stack
            h = quantize_static(x, stack.x_scales[0])
            for i, layer in enumerate(stack.layers):
                lname, xin, kernel, plain, finish = q8_layer_calls(layer, h)
                ref = plain()
                if lname == "kan_fused_v2_q8":
                    compare(lname, kernel(), ref,
                            f"{name} B={b} int8 layer {i} default knob")
                    check_kan_knobs(
                        lname, lambda k, xin=xin, layer=layer:
                        kan_fused_v2_q8(xin, layer.wt_q, layer.slot_scales,
                                        layer.cfg.spec, layer.kb,
                                        layer.x_scale, layer.slot_of,
                                        blocks=k),
                        xin, layer, torch.int8, f"{name} B={b} int8 layer {i}")
                if i + 1 < len(stack.layers):
                    h = quantize_static(finish(ref), stack.x_scales[i + 1])
    # ragged widths (n_in not a multiple of the 32-feature chunk, n_out
    # not one of bn), int8 slot scales that differ per slot
    for n_in, n_out in ((37, 13), (300, 33)):
        xr = (torch.randn((77, n_in), generator=gen) * 1.5).to(dev)
        wr = (torch.randn((n_in * (len(kb) + 1), n_out), generator=gen)
              * 0.05).to(dev)
        compare("kan_fused_v2", kan_fused_v2(xr, wr, spec, kb, slot),
                kan_fused_v2_ref(xr, wr, spec, kb),
                f"ragged 77x{n_in}->{n_out}")
        xqr = torch.randint(-127, 128, (77, n_in), generator=gen,
                            dtype=torch.int8).to(dev)
        wqr = torch.randint(-127, 128, tuple(wr.shape), generator=gen,
                            dtype=torch.int8).to(dev)
        compare("kan_fused_v2_q8",
                kan_fused_v2_q8(xqr, wqr, ssq, spec, kb, 0.02, slot),
                kan_fused_v2_q8_ref(xqr, wqr, ssq, spec, kb, 0.02),
                f"ragged 77x{n_in}->{n_out}")
        # v1 on the same weights, unfused, at every candidate of its grid
        w3 = wr.reshape(n_in, len(kb) + 1, n_out)
        w_br = w3[:, 0].contiguous()
        t_r = w3[:, 1:].reshape(n_in * len(kb), n_out).contiguous()
        v1_r = kan_fused_v1(xr, w_br, t_r, spec, kb, slot)
        compare("kan_fused_v1", v1_r, kan_fused_v1_ref(xr, w_br, t_r, spec,
                                                       kb),
                f"ragged 77x{n_in}->{n_out}")
        for c in autotune.candidates_kan_fused(77, n_in, n_out, len(kb),
                                               torch.float32, 1):
            knob = (c["bm"], c["bi"], c["bn"])
            check(torch.equal(kan_fused_v1(xr, w_br, t_r, spec, kb, slot,
                                           blocks=knob), v1_r),
                  f"kan_fused_v1 ragged 77x{n_in}->{n_out}: knob {knob} != "
                  f"the default knob, bitwise")
            knob_checks["kan_fused_v1"] = knob_checks.get(
                "kan_fused_v1", 0) + 1
    # batched == single, bitwise, with one knob for the batch of 16 and
    # another for each row alone, at vikin-mixed's KAN layer
    layer, xin = kan_inputs(backends["vikin-mixed"].stack, x_big[:16])[0]
    q_layer = q8_backends["vikin-mixed"].stack.layers[1]
    q_in = q8_chain(q8_backends["vikin-mixed"].stack, x_big[:16], 3)[2][1]
    full = kan_fused_v2(xin, layer.wt, layer.cfg.spec, layer.kb,
                        layer.slot_of, blocks=(16, 512, 32))
    q_full = kan_fused_v2_q8(q_in, q_layer.wt_q, q_layer.slot_scales,
                             q_layer.cfg.spec, q_layer.kb, q_layer.x_scale,
                             q_layer.slot_of, blocks=(16, 512, 32))
    t_flat = t_flat_of(layer)
    v1_full = kan_fused_v1(xin, layer.w_b, t_flat, layer.cfg.spec, layer.kb,
                           layer.slot_of, blocks=(16, 512, 32))
    for i in range(6):
        one = kan_fused_v1(xin[i:i + 1].contiguous(), layer.w_b, t_flat,
                           layer.cfg.spec, layer.kb, layer.slot_of,
                           blocks=(8, 64, 16))
        check(torch.equal(one, v1_full[i:i + 1]), f"kan_fused_v1: row {i} "
              f"alone at (8, 64, 16) != row {i} of 16 at (16, 512, 32)")
        one = kan_fused_v2(xin[i:i + 1].contiguous(), layer.wt,
                           layer.cfg.spec, layer.kb, layer.slot_of,
                           blocks=(8, 32, 8))
        check(torch.equal(one, full[i:i + 1]), f"kan_fused_v2: row {i} "
              f"alone at (8, 32, 8) != row {i} of 16 at (16, 512, 32)")
        one = kan_fused_v2_q8(q_in[i:i + 1].contiguous(), q_layer.wt_q,
                              q_layer.slot_scales, q_layer.cfg.spec,
                              q_layer.kb, q_layer.x_scale, q_layer.slot_of,
                              blocks=(8, 64, 16))
        check(torch.equal(one, q_full[i:i + 1]), f"kan_fused_v2_q8: row "
              f"{i} alone at (8, 64, 16) != row {i} of 16 at (16, 512, 32)")
    torch.cuda.synchronize()
    print(f"phase 2: every candidate knob of the three KAN kernels (v2 "
          f"f32, v2 int8, v1) bitwise the default's at vikin-mixed's and "
          f"vikin-kan2's KAN layers, B=8 and {BIG}, and (v1) at ragged "
          f"77x37->13 and 77x300->33; ragged widths within tolerance; "
          f"batched == single under different knobs in all three: "
          f"{knob_checks}")
    # ------------------------------------------------------------ 2 bf16
    # the bf16 kernels at ragged shapes, under every knob there, and
    # batched == single (the served bf16 layers are checked above)
    rng_bf = np.random.default_rng(5)
    gen_bf = torch.Generator().manual_seed(11)
    # ragged: odd n_in (x staged an element at a time) and odd n_out
    # (weight rows and outputs an element at a time), every knob of both
    # versions bitwise the default's
    for rb, n_in, n_out in ((77, 37, 13), (77, 301, 33), (1000, 304, 96)):
        xr = (torch.randn((rb, n_in), generator=gen_bf) * 1.5).to(dev, BF)
        wr = (torch.randn((n_in * (len(kb) + 1), n_out), generator=gen_bf)
              * 0.05).to(dev, BF)
        w3 = wr.reshape(n_in, len(kb) + 1, n_out)
        w_br = w3[:, 0].contiguous()
        t_r = w3[:, 1:].reshape(n_in * len(kb), n_out).contiguous()
        what = f"ragged {rb}x{n_in}->{n_out}"
        v2r = compare_calls(
            "kan_fused_v2_bf16",
            lambda od=None: kan_fused_v2(xr, wr, spec, kb, slot,
                                         out_dtype=od),
            lambda od=None: kan_fused_v2_ref(xr, wr, spec, kb, od), what)
        v1r = compare_calls(
            "kan_fused_v1_bf16",
            lambda od=None: kan_fused_v1(xr, w_br, t_r, spec, kb, slot,
                                         out_dtype=od),
            lambda od=None: kan_fused_v1_ref(xr, w_br, t_r, spec, kb, od),
            what)
        if rb == 1000:
            continue
        for version, ref in ((2, v2r), (1, v1r)):
            k = "kan_fused_v2_bf16" if version == 2 else "kan_fused_v1_bf16"
            for c in autotune.candidates_kan_fused(rb, n_in, n_out, len(kb),
                                                   BF, version):
                knob = (c["bm"], c["bi"], c["bn"])
                got = (kan_fused_v2(xr, wr, spec, kb, slot, blocks=knob)
                       if version == 2 else
                       kan_fused_v1(xr, w_br, t_r, spec, kb, slot,
                                    blocks=knob))
                check(torch.equal(got, ref), f"{k} {what}: knob {knob} != "
                      f"the default knob, bitwise")
                knob_checks[k] = knob_checks.get(k, 0) + 1
    # the tensor-core KAN body's edges: 21 fused rows a feature (G=16,
    # K=4, every basis kept) and the silu row alone (nbk = 0: a chunk is
    # two k16 steps), every knob bitwise the default's
    for (g_e, k_e), kb_e, (rb, n_in, n_out) in (
            ((16, 4), tuple(range(20)), (77, 37, 33)),
            ((4, 3), (), (33, 304, 32))):
        spec_e = SplineSpec(g_e, k_e)
        xr = (torch.randn((rb, n_in), generator=gen_bf) * 1.5).to(dev, BF)
        wr = (torch.randn((n_in * (len(kb_e) + 1), n_out), generator=gen_bf)
              * 0.05).to(dev, BF)
        what = f"ragged {rb}x{n_in}->{n_out} G{g_e}K{k_e} nbk={len(kb_e)}"
        ref = compare_calls(
            "kan_fused_v2_bf16",
            lambda od=None: kan_fused_v2(xr, wr, spec_e, kb_e, out_dtype=od),
            lambda od=None: kan_fused_v2_ref(xr, wr, spec_e, kb_e, od), what)
        for c in autotune.candidates_kan_fused(rb, n_in, n_out, len(kb_e),
                                               BF):
            knob = (c["bm"], c["bi"], c["bn"])
            check(torch.equal(kan_fused_v2(xr, wr, spec_e, kb_e,
                                           blocks=knob), ref),
                  f"kan_fused_v2_bf16 {what}: knob {knob} != the default "
                  f"knob, bitwise")
            knob_checks["kan_fused_v2_bf16"] = knob_checks.get(
                "kan_fused_v2_bf16", 0) + 1
    for m, kk, n in ((999, 147, 301), (1000, 152, 304)):
        xm_bf = torch.randn((m, kk), generator=gen_bf).to(dev, BF)
        wm_bf = (torch.randn((kk, n), generator=gen_bf) * 0.1).to(dev, BF)
        bm_bf = torch.randn((n,), generator=gen_bf).to(dev, BF)
        for act in (None, "relu", "gelu", "silu"):
            for bias in (bm_bf, None):
                compare_calls(
                    "pattern_matmul_bf16",
                    lambda od=None: matmul_compact(xm_bf, wm_bf, bias, act,
                                                   out_dtype=od),
                    lambda od=None: matmul_compact_ref(xm_bf, wm_bf, bias,
                                                       act, od),
                    f"ragged {m}x{kk}->{n} act={act} bias={bias is not None}")
    torch.cuda.synchronize()

    # batched == single, bitwise: each row alone, under another knob, is
    # its row in a batch of 2, 4, 8, 16 and 8192
    x_big_bf = x_big.to(BF)
    layer, xin = kan_inputs(bf_backends["vikin-mixed"].stack, x_big_bf)[0]
    t_flat = t_flat_of(layer)
    mm0 = bf_backends["vikin-mixed"].stack.layers[0]
    n_single = 0
    for b in BUCKETS + (BIG,):
        full2 = kan_fused_v2(xin[:b], layer.wt, layer.cfg.spec, layer.kb,
                             layer.slot_of, blocks=(16, 512, 32))
        full1 = kan_fused_v1(xin[:b], layer.w_b, t_flat, layer.cfg.spec,
                             layer.kb, layer.slot_of, blocks=(16, 512, 32))
        fullm = matmul_compact(x_big_bf[:b], mm0.w_c, mm0.b, mm0.act,
                               blocks=(128, 64, 64))
        for i in sorted({0, b // 2, b - 1}):
            xi = xin[i:i + 1].contiguous()
            check(torch.equal(kan_fused_v2(xi, layer.wt, layer.cfg.spec,
                                           layer.kb, layer.slot_of,
                                           blocks=(8, 32, 8)),
                              full2[i:i + 1]),
                  f"kan_fused_v2_bf16: row {i} alone != row {i} of {b}")
            check(torch.equal(kan_fused_v1(xi, layer.w_b, t_flat,
                                           layer.cfg.spec, layer.kb,
                                           layer.slot_of, blocks=(8, 64, 16)),
                              full1[i:i + 1]),
                  f"kan_fused_v1_bf16: row {i} alone != row {i} of {b}")
            check(torch.equal(matmul_compact(
                x_big_bf[i:i + 1].contiguous(), mm0.w_c, mm0.b, mm0.act,
                blocks=(16, 16, 8)), fullm[i:i + 1]),
                f"pattern_matmul_bf16: row {i} alone != row {i} of {b}")
            n_single += 3
    torch.cuda.synchronize()
    print(f"phase 2 bf16: every candidate knob of the bf16 kernels bitwise "
          f"the default's at the served layers (B=8 and {BIG}) and, for "
          f"KAN, at ragged 77x37->13 and 77x301->33, G16K4 nbk=20 "
          f"77x37->33 and nbk=0 33x304->32: "
          f"{ {k: v for k, v in knob_checks.items() if k.endswith('bf16')} }"
          f"; batched == single, bitwise, at batches {BUCKETS + (BIG,)}: "
          f"{n_single} rows")

    for name in KERNEL_INFO:
        how = ("bitwise" if name in ("pattern_matmul_q8", "spline_basis",
                                     "spline_basis_bf16")
               else f"bf16 out within {BF16_ULP:g}*(1+max|plain|), f32 out "
               f"within {KERNEL_TOL:g}*(1+max|plain|)" if name in
               BF16_KERNELS + BF16_TOOLING_KERNELS
               else f"within {KERNEL_TOL:g}*(1+max|plain|)")
        print(f"phase 2: {name}: {n_checks[name]} shapes {how}, max abs "
              f"err {max_err[name]:.3e}")
    print(f"phase 2: kan_fused_v1 vs kan_fused_v2: {v1_v2['n']} shapes "
          f"within {KERNEL_TOL:g}*(1+max|v2|), max abs err "
          f"{v1_v2['err']:.3e}; v1 batched == single, bitwise, on 6 rows")

    # ---------------------------------------------------------------- 3
    # a 48-request burst of the three archs through the launcher's engine
    # in each precision (bf16 and int8 through make_vikin_backend's
    # precision): the launches against the served batches, every answer
    # against the plain versions, vikin-mixed batched == single, and the
    # simulated fields against a CPU engine's on the same burst
    def hold_int8(stack, xs_np: np.ndarray, served_np: np.ndarray,
                  what: str) -> tuple:
        """Hold the int8 answers ``served_np`` to inputs ``xs_np``: bitwise
        the kernels run layer by layer on the same rows, and within
        ``SERVE_TOL`` of the plain versions on the card, where a
        requantized code may differ only by one step at a rounding tie;
        returns (max abs error, codes rounded across a tie)."""
        xs = torch.from_numpy(xs_np).to(dev)
        served = torch.from_numpy(served_np)
        y_k, _, codes_k = q8_chain(stack, xs, 2)
        check(torch.equal(served, y_k.cpu()),
              f"{what}: served answers != the kernels run layer by "
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
                  f"{what}: layer {i} codes differ from the plain "
                  f"stack's by up to {int(step.max())}, "
                  f"{float(tie.max()):.2e} code units from a rounding tie")
            flips += int(diff.sum())
        if flips:
            # compare like with like past the ties: the plain versions on
            # the kernels' codes
            y_p = q8_chain(stack, xs, 3, feed=codes_k)[0]
        err, scale, nan = rel_err(served, y_p.cpu())
        check(not nan and err <= SERVE_TOL * scale,
              f"{what}: max|served - plain| = {err:.3e} vs "
              f"{SERVE_TOL:g} * {scale:.4g} (NaN: {nan})")
        return err, flips

    def hold(precision: str, stack, xs: np.ndarray, served: np.ndarray,
             what: str) -> tuple:
        """Hold the answers ``served`` to inputs ``xs`` of a stack served
        at ``precision``: f32 within ``SERVE_TOL`` and bf16 (widened to
        f32) within ``SERVE_TOL_BF16`` of the stack run through the plain
        versions on the card; int8 as ``hold_int8``.  Returns (max abs
        error, int8 codes rounded across a tie)."""
        if precision == "int8":
            return hold_int8(stack, xs, served, what)
        dtype, tol = ((BF, SERVE_TOL_BF16) if precision == "bf16"
                      else (F32, SERVE_TOL))
        h = torch.from_numpy(xs).to(dev, dtype)
        for layer in stack.layers:
            h = layer_calls(layer, h)[3]()
        err, scale, nan = rel_err(torch.from_numpy(served), h.cpu())
        check(not nan and err <= tol * scale,
              f"{what}: max|served - plain| = {err:.3e} vs "
              f"{tol:g} * {scale:.4g} (NaN: {nan})")
        return err, 0

    models = [VIKIN_ARCHS[n] for n in ARCHS]
    mixed = VIKIN_ARCHS["vikin-mixed"]
    prompts = [rng.random(mixed.sizes[0], dtype=np.float32)
               for _ in range(6)]
    sim_fields = ("served", "ticks", "sim_cycles", "sim_latency_s",
                  "dma_bytes", "mode_switches", "reconfig_cycles")
    served = {}
    for precision in PRECISIONS:
        tol = {"bf16": SERVE_TOL_BF16}.get(precision, SERVE_TOL)
        eng = make_engine(models, slots=8, policy="mode-affinity",
                          device=DEVICE, precision=precision)
        rids = submit_burst(eng, models, 48)
        _build.reset_launches()
        t0 = time.perf_counter()
        out = eng.run_until_done()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        print_report(eng, out, rids)
        check(sorted(out) == sorted(rids),
              f"{precision}: served set != submitted set")
        kan_k, mm_k = SERVED_KERNELS[precision]
        want = {k: 0 for k in KERNEL_INFO}
        ws = eng.per_workload_stats()
        for name in ARCHS:
            kinds = VIKIN_ARCHS[name].layer_kinds
            batches = int(ws[name]["batches"])
            want[kan_k] += batches * kinds.count("kan")
            want[mm_k] += batches * kinds.count("mlp")
        print(f"phase 3 {precision}: launches {launches}, implied by the "
              f"served batches {want}")
        for k in KERNEL_INFO:
            check(launches[k] == want[k]
                  and (want[k] > 0 or k not in (kan_k, mm_k)),
                  f"{precision} {k}: {launches[k]} launches, served "
                  f"batches imply {want[k]}")
        for name in ARCHS:
            rs = [r for r in sorted(rids) if rids[r][0] == name]
            err, flips = hold(precision, eng.backend.backends[name].stack,
                              np.stack([rids[r][1] for r in rs]),
                              np.stack([out[r] for r in rs]),
                              f"{precision} served {name}")
            print(f"phase 3 {precision}: {name}: {len(rs)} answers within "
                  f"{tol:g}*(1+max|ref|) of the plain stack, max abs err "
                  f"{err:.3e}" + (f"; {flips} requantized codes rounded "
                                  f"across a tie" if precision == "int8"
                                  else ""))
        batched_eng = Engine(make_vikin_backend(mixed, DEVICE,
                                                precision=precision),
                             n_slots=4)
        brids = [batched_eng.submit(p) for p in prompts]
        batched = batched_eng.run_until_done()
        solo_eng = Engine(make_vikin_backend(mixed, DEVICE,
                                             precision=precision),
                          n_slots=4)
        for p, rid in zip(prompts, brids):
            srid = solo_eng.submit(p)
            solo = solo_eng.run_until_done()
            check(np.array_equal(batched[rid], solo[srid]),
                  f"{precision} vikin-mixed batched != single for request "
                  f"{rid}")
        c_eng = make_engine(models, slots=8, policy="mode-affinity",
                            device="cpu", precision=precision)
        submit_burst(c_eng, models, 48)
        c_eng.run_until_done()
        for f in sim_fields:
            check(eng.stats[f] == c_eng.stats[f],
                  f"{precision} served {f} {eng.stats[f]} != the CPU "
                  f"engine's {c_eng.stats[f]}")
        s = eng.stats
        print(f"phase 3 {precision}: vikin-mixed batched == single, "
              f"bitwise, on 6 requests (buckets 4/2 vs 2); served "
              f"sim_cycles {s['sim_cycles']:.1f}, dma_bytes "
              f"{s['dma_bytes']:.0f}, mode_switches "
              f"{s['mode_switches']:.0f}, reconfig_cycles "
              f"{s['reconfig_cycles']:.0f}, {', '.join(sim_fields)} equal "
              f"to the CPU engine's; wall {serve_s * 1e3:.2f} ms "
              f"({len(out) / serve_s:.1f} req/s)")
        served[precision] = {"eng": eng, "launches": launches,
                             "wall_s": serve_s,
                             "wall_rps": len(out) / serve_s}

    # ---------------------------------------------------------------- 4
    # Each served kernel at the vikin-mixed stack's shapes in each
    # precision, and the kernel-tooling kernels (the spline basis of its KAN
    # layer's input, flattened; v1 beside v2 on that layer's weights).
    # Bound: the bytes over HBM_BYTES_PER_S against the operations, each at
    # the card's peak rate for its type: multiply-adds of f32 operands (and
    # of int8 codes dequantized to f32, the int8 KAN kernel) at the f32
    # CUDA-core rate, of bf16 operands at the bf16 rate, of int8 operands at
    # the int8 rate; the SPU work (de Boor, silu, location) and epilogues at
    # the f32 rate.  Library: addmm in f32 or bf16 (f32 accumulation),
    # torch._int_mm where its shape rules allow; no single PyTorch call
    # computes a KAN layer or a spline basis.
    records = {}
    n_kan, n_mlp = (mixed.layer_kinds.count(kind) for kind in ("kan", "mlp"))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def new_acc() -> dict:
        return {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "library_graph_ms": 0.0, "bytes": 0.0,
                "work": [], "shapes": [], "blocks": [], "design": []}

    def time_into(a: dict, kernel, plain, library=None) -> None:
        a["ms"] += time_ms(kernel)
        a["graph_ms"] += graph_ms(kernel)
        a["plain_ms"] += time_ms(plain, iters=20)
        if library is None or a["library_ms"] is None:
            a["library_ms"] = a["library_graph_ms"] = None
        else:
            a["library_ms"] += time_ms(library)
            a["library_graph_ms"] += graph_ms(library)

    def kan_work(layer, x_real: torch.Tensor, mac_rate: float,
                 spu_extra: int) -> list:
        """(operations, rate) of a KAN layer on the real-valued input
        ``x_real``: the multiply-adds this input needs (the silu term,
        plus one per local basis value whose basis the mask keeps) at
        ``mac_rate``, and the SPU work per (row, feature) at the f32
        rate."""
        spec, n_in, n_out = layer.cfg.spec, layer.cfg.n_in, layer.cfg.n_out
        batch = x_real.shape[0]
        cell, _ = locate_cell(spec.clip(x_real), spec)
        slots = layer.slot_of.long()
        hits = sum(int((slots[(cell + j).long()] >= 0).sum())
                   for j in range(spec.n_active))
        return [(2.0 * n_out * (batch * n_in + hits), mac_rate),
                (batch * n_in * (spu_op_count(spec) + spu_extra),
                 F32_FLOPS_PER_S)]

    def record(k: str, precision: str, batch: int, a: dict,
               per_batch=None) -> dict:
        t_bytes = a["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = sum(n / rate for n, rate in a["work"]) * 1e3
        rec = {
            "kernel": k, "model": "vikin-mixed", "precision": precision,
            "batch": batch, "shapes": a["shapes"], "ms": a["ms"],
            "graph_ms": a["graph_ms"], "plain_ms": a["plain_ms"],
            "library_ms": a["library_ms"],
            "library_graph_ms": a["library_graph_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": a["bytes"], "ops": sum(n for n, _ in a["work"]),
            "card": card,
        }
        if per_batch is not None:
            rec["launches_per_batch"] = per_batch
        if a["blocks"]:
            rec["blocks"] = a["blocks"]
        if a["design"]:
            rec["design"] = a["design"]
        records[(k, batch)] = rec
        print(json.dumps(rec))
        return rec

    for precision, bes in (("f32", backends), ("bf16", bf_backends)):
        dtype = BF if precision == "bf16" else F32
        esz = 2.0 if precision == "bf16" else 4.0
        mac_rate = BF16_FLOPS_PER_S if precision == "bf16" else F32_FLOPS_PER_S
        stack = bes["vikin-mixed"].stack
        kan_k, mm_k = SERVED_KERNELS[precision]
        for batch in (8, BIG):
            x = rand(np.random.default_rng(2), batch, "vikin-mixed", dtype)
            acc = {kan_k: new_acc(), mm_k: new_acc()}
            for layer in stack.layers:
                name, xin, kernel, plain = layer_calls(layer, x)
                a = acc[name]
                if isinstance(layer, KANLayer):
                    n_in, n_out = layer.cfg.n_in, layer.cfg.n_out
                    time_into(a, kernel, plain)
                    a["work"] += kan_work(layer, xin, mac_rate, 4)
                    a["bytes"] += (esz * (xin.numel() + layer.wt.numel()
                                          + batch * n_out)
                                   + 4.0 * layer.slot_of.numel())
                    a["shapes"].append(f"{batch}x{n_in}->{n_out} "
                                       f"kb={list(layer.kb)} {precision}")
                    knob = kan_blocks(batch, n_in, n_out, len(layer.kb),
                                      dtype, device=dev)
                    a["blocks"].append(knob)
                    if precision == "bf16":
                        # the tensor-core body's shared memory a block, and
                        # the multiply-adds its dense A tile issues (padded
                        # rows and columns too) beside the useful ones
                        nbk1 = len(layer.kb) + 1
                        outs = (-(-batch // knob["bm"]) * max(16, knob["bm"])
                                * -(-n_out // knob["bn"]) * knob["bn"])
                        a["design"].append({
                            "smem_bytes": kernel_smem(
                                knob["bm"], knob["bi"], knob["bn"], n_in,
                                len(layer.kb), dtype),
                            "cluster": split(n_in, knob["bi"])[2],
                            "mma_flops": 2.0 * outs * split(n_in, 32)[0]
                            * 32 * nbk1,
                            "useful_flops": a["work"][-2][0]})
                else:
                    kc, n = layer.w_c.shape

                    def library(xc=xin, layer=layer):
                        y = torch.addmm(layer.b, xc, layer.w_c)
                        return torch.relu_(y) if layer.act == "relu" else y
                    time_into(a, kernel, plain, library)
                    a["work"] += [(2.0 * batch * kc * n, mac_rate),
                                  (batch * n, F32_FLOPS_PER_S)]
                    a["bytes"] += esz * (xin.numel() + layer.w_c.numel() + n
                                         + batch * n)
                    a["shapes"].append(f"{batch}x{kc}->{n} act={layer.act} "
                                       f"{precision}")
                    tiles = resolve_blocks(batch, kc, n, dtype, device=dev)
                    a["blocks"].append(tiles)
                    if precision == "bf16":
                        # the grid, the row tiles a block walks, and
                        # which kernel: one row tile runs the first
                        # design's, more the persistent one
                        grid = bf16_grid(batch, kc, n, tiles, sms)
                        row_tiles = -(-batch // tiles["bm"])
                        a["design"].append({
                            "kernel": ("one tile" if row_tiles == 1
                                       else "persistent"),
                            "grid": list(grid),
                            "row_tiles_a_block": -(-row_tiles // grid[0])})
                x = kernel()
            torch.cuda.synchronize()
            record(kan_k, precision, batch, acc[kan_k], n_kan)
            record(mm_k, precision, batch, acc[mm_k], n_mlp)

            layer, xin = kan_inputs(stack, rand(np.random.default_rng(2),
                                                batch, "vikin-mixed",
                                                dtype))[0]
            kan_spec = layer.cfg.spec
            n_in, n_out = layer.cfg.n_in, layer.cfg.n_out
            flat = xin.reshape(-1)
            n = flat.numel()
            # each input read once and its G+K values written once; the
            # SPU operations of core/splines.spu_op_count per input
            a = new_acc()
            time_into(a, lambda: spline_basis(flat, kan_spec),
                      lambda: spline_basis_plain(flat, kan_spec))
            a["bytes"] = esz * n * (1 + kan_spec.n_bases)
            a["work"] = [(float(n * spu_op_count(kan_spec)),
                          F32_FLOPS_PER_S)]
            a["shapes"] = [f"n={n} ({batch}x{n_in} flattened) "
                           f"G{kan_spec.grid_size}K{kan_spec.order} "
                           f"{precision}"]
            rec = record("spline_basis" + SUFFIX[dtype], precision, batch, a)
            rec["block_n"] = resolve_block_n(n, kan_spec.n_bases, dtype,
                                             device=dev)
            t_flat = t_flat_of(layer)
            a = new_acc()
            time_into(a, lambda: kan_fused_v1(xin, layer.w_b, t_flat,
                                              kan_spec, layer.kb,
                                              layer.slot_of),
                      lambda: kan_fused_v1_ref(xin, layer.w_b, t_flat,
                                               kan_spec, layer.kb))
            a["bytes"] = (esz * (xin.numel() + layer.w_b.numel()
                                 + t_flat.numel() + batch * n_out)
                          + 4.0 * layer.slot_of.numel())
            a["work"] = kan_work(layer, xin, mac_rate, 4)
            a["shapes"] = [f"{batch}x{n_in}->{n_out} kb={list(layer.kb)} "
                           f"{precision}"]
            a["blocks"] = [kan_blocks(batch, n_in, n_out, len(layer.kb),
                                      dtype, version=1, device=dev)]
            rec = record("kan_fused_v1" + SUFFIX[dtype], precision, batch, a)

            def v2(xin=xin, layer=layer):
                return kan_fused_v2(xin, layer.wt, kan_spec, layer.kb,
                                    layer.slot_of)
            rec["v2_ms"] = time_ms(v2)
            rec["v2_graph_ms"] = graph_ms(v2)
            torch.cuda.synchronize()

    # the int8 kernels at the int8 vikin-mixed stack's shapes
    q_stack = q8_backends["vikin-mixed"].stack
    for batch in (8, BIG):
        x = rand(np.random.default_rng(2), batch, "vikin-mixed")
        h = quantize_static(x, q_stack.x_scales[0])
        acc = {k: new_acc() for k in Q8_KERNELS}
        for i, layer in enumerate(q_stack.layers):
            name, xin, kernel, plain, finish = q8_layer_calls(layer, h)
            a = acc[name]
            if isinstance(layer, QuantKANLayer):
                n_in, n_out = layer.cfg.n_in, layer.cfg.n_out
                time_into(a, kernel, plain)
                # the x dequantization per (row, feature) besides the SPU
                # work, and each weight dequantized once
                a["work"] += kan_work(layer, xin.to(F32) * layer.x_scale,
                                      F32_FLOPS_PER_S, 5)
                a["work"].append((float(layer.wt_q.numel()),
                                  F32_FLOPS_PER_S))
                a["bytes"] += (xin.numel() + layer.wt_q.numel()
                               + 4.0 * (layer.slot_scales.numel()
                                        + layer.slot_of.numel()
                                        + batch * n_out))
                a["shapes"].append(f"{batch}x{n_in}->{n_out} "
                                   f"kb={list(layer.kb)} int8")
                a["blocks"].append(kan_blocks(batch, n_in, n_out,
                                              len(layer.kb), torch.int8,
                                              device=dev))
            else:
                kc, n = layer.w_q_c.shape
                library = None
                # torch._int_mm takes M > 16 and K, N multiples of 8
                if batch > 16 and not kc % 8 and not n % 8:
                    def library(xc=xin, w=layer.w_q_c):
                        return torch._int_mm(xc, w)
                    try:
                        library()
                    except RuntimeError as e:
                        print(f"phase 4: torch._int_mm on {batch}x{kc}->{n} "
                              f"refused: {e}")
                        library = None
                time_into(a, kernel, plain, library)
                a["work"].append((2.0 * batch * kc * n, INT8_OPS_PER_S))
                a["bytes"] += xin.numel() + layer.w_q_c.numel() + 4.0 * (
                    batch * n)
                a["shapes"].append(f"{batch}x{kc}->{n} int8")
                a["blocks"].append(resolve_blocks(batch, kc, n, torch.int8,
                                                  device=dev))
            y = finish(kernel())
            if i + 1 < len(q_stack.layers):
                h = quantize_static(y, q_stack.x_scales[i + 1])
        torch.cuda.synchronize()
        record("kan_fused_v2_q8", "int8", batch, acc["kan_fused_v2_q8"],
               n_kan)
        record("pattern_matmul_q8", "int8", batch, acc["pattern_matmul_q8"],
               n_mlp)

    # Where one served batch's time goes, per precision and arch at bucket
    # 8: the host wall of a backend forward (copy in, every layer, copy out
    # and sync), the stack alone on the card (gathers + kernels, CUDA
    # events), and the kernels alone; each "graph" time is the same work
    # replayed from a CUDA graph, i.e. device time alone.  1 -
    # stack_graph_ms / forward_ms is the share of a served forward the
    # device sits idle.
    breakdown = []
    for precision, bes in (("f32", backends), ("int8", q8_backends),
                           ("bf16", bf_backends)):
        for name in ARCHS:
            be = bes[name]
            xb = rng.random((8, be.n_in), dtype=np.float32)
            x_dev = torch.from_numpy(xb).to(
                dev, BF if precision == "bf16" else F32)
            kernels = [k for _, _, k in
                       stack_calls(precision, be.stack, x_dev)]
            rec = {"arch": name, "precision": precision, "bucket": 8,
                   "forward_ms": host_ms(lambda: be.forward(xb)),
                   "stack_ms": time_ms(lambda: be.stack(x_dev)),
                   "stack_graph_ms": graph_ms(lambda: be.stack(x_dev)),
                   "kernel_ms": sum(time_ms(k) for k in kernels),
                   "kernel_graph_ms": sum(graph_ms(k) for k in kernels),
                   "card": card}
            breakdown.append(rec)
            print(json.dumps({"breakdown": rec}))
    for precision, sv in served.items():
        print(json.dumps({"serve": {"archs": list(ARCHS),
                                    "precision": precision, "requests": 48,
                                    "slots": 8, "wall_s": sv["wall_s"],
                                    "wall_rps": sv["wall_rps"],
                                    "card": card}}))

    # ---------------------------------------------------------------- 5
    # the v1 path: a KAN layer configured at version 1, on vikin-kan2's
    # weights, at the serving buckets, one large batch, a batch of more
    # 16-row tiles than grid.y holds, and once with explicit knobs
    kan2 = VIKIN_ARCHS["vikin-kan2"]
    layer2 = backends["vikin-kan2"].stack.layers[0]
    layer1 = KANLayer(dataclasses.replace(layer2.cfg, version=1),
                      {"w_b": layer2.w_b, "t": layer2.t})
    knob1 = (8, 64, 16)
    layer1k = KANLayer(dataclasses.replace(layer2.cfg, version=1,
                                           blocks=knob1),
                       {"w_b": layer2.w_b, "t": layer2.t})
    huge = 65535 * 16 + 1
    v1_rng = np.random.default_rng(4)
    v1_x = {b: torch.from_numpy(v1_rng.random(
        (b, kan2.sizes[0]), dtype=np.float32)).to(dev)
        for b in BUCKETS + (BIG, huge)}
    _build.reset_launches()
    v1_out = {b: layer1(x) for b, x in v1_x.items()}
    v1_out["knob"] = layer1k(v1_x[8])
    torch.cuda.synchronize()
    v1_launches = dict(_build.LAUNCHES)
    want = {k: 0 for k in v1_launches}
    want["kan_fused_v1"] = len(v1_out)
    check(v1_launches == want, f"v1 path: launches {v1_launches}, the "
          f"{len(v1_out)} layer calls imply {want}")
    cpu_layer = KANLayer(layer1.cfg, {"w_b": layer2.w_b.cpu(),
                                      "t": layer2.t.cpu()})
    v1_err = 0.0
    for b, y in v1_out.items():
        x = v1_x[8 if b == "knob" else b]
        rows = x.shape[0]
        check(y.shape == (rows, kan2.sizes[-1])
              and bool(torch.isfinite(y).all()),
              f"v1 path B={b}: output {tuple(y.shape)} or not finite")
        refs = [("the v2 layer", layer2(x)),
                ("the plain version", kan_fused_v1_ref(
                    x, layer1.w_b, layer1.t_flat, layer1.cfg.spec,
                    layer1.kb))]
        if b != huge:
            refs.append(("the layer on the CPU", cpu_layer(x.cpu()).to(dev)))
        for what, ref in refs:
            err, scale, nan = rel_err(y, ref)
            check(not nan and err <= KERNEL_TOL * scale,
                  f"v1 path B={b}: max|v1 layer - {what}| = {err:.3e} > "
                  f"{KERNEL_TOL:g} * {scale:.4g} (NaN: {nan})")
            v1_err = max(v1_err, err)
        del refs
    check(torch.equal(v1_out["knob"], v1_out[8]),
          f"v1 path: KANConfig(blocks={knob1}) != the default knob, bitwise")
    del v1_x[huge], v1_out[huge]
    torch.cuda.empty_cache()
    print(f"phase 5: v1 KANLayer on vikin-kan2's weights at batches "
          f"{sorted(k for k in v1_out if k != 'knob')} and at B=8 with "
          f"KANConfig(blocks={knob1}) (bitwise the default knob's): "
          f"launches {v1_launches}; within {KERNEL_TOL:g}*(1+max|ref|) of "
          f"the v2 layer, the plain version and (below B={huge}) the layer "
          f"on the CPU, max abs err {v1_err:.3e}")

    # the bf16 v1 path: a version-1 KANLayer on the bf16 vikin-kan2 stack's
    # weights, at the serving buckets and one large batch
    b_layer2 = bf_backends["vikin-kan2"].stack.layers[0]
    b_layer1 = KANLayer(dataclasses.replace(b_layer2.cfg, version=1),
                        {"w_b": b_layer2.w_b, "t": b_layer2.t})
    b_v1_x = {b: v1_x[b].to(BF) for b in BUCKETS + (BIG,)}
    _build.reset_launches()
    b_v1_out = {b: b_layer1(x) for b, x in b_v1_x.items()}
    torch.cuda.synchronize()
    b_v1_launches = dict(_build.LAUNCHES)
    want = {k: 0 for k in b_v1_launches}
    want["kan_fused_v1_bf16"] = len(b_v1_out)
    check(b_v1_launches == want, f"bf16 v1 path: launches {b_v1_launches}, "
          f"the {len(b_v1_out)} layer calls imply {want}")
    b_v1_err = 0.0
    for b, y in b_v1_out.items():
        x = b_v1_x[b]
        check(y.shape == (b, kan2.sizes[-1]) and y.dtype == BF
              and bool(torch.isfinite(y.float()).all()),
              f"bf16 v1 path B={b}: output {tuple(y.shape)} {y.dtype} or "
              f"not finite")
        for what, ref in (("the bf16 v2 layer", b_layer2(x)),
                          ("the plain version", kan_fused_v1_ref(
                              x, b_layer1.w_b, b_layer1.t_flat,
                              b_layer1.cfg.spec, b_layer1.kb))):
            err, scale, nan = rel_err(y, ref)
            check(not nan and err <= BF16_ULP * scale,
                  f"bf16 v1 path B={b}: max|v1 layer - {what}| = {err:.3e} "
                  f"> {BF16_ULP:g} * {scale:.4g} (NaN: {nan})")
            b_v1_err = max(b_v1_err, err)
    print(f"phase 5: bf16 v1 KANLayer on vikin-kan2's bf16 weights at "
          f"batches {sorted(b_v1_out)}: launches {b_v1_launches}; within "
          f"{BF16_ULP:g}*(1+max|ref|) of the bf16 v2 layer and the plain "
          f"version, max abs err {b_v1_err:.3e}")

    # ---------------------------------------------------------------- 6
    _build.reset_launches()
    bench = kernel_bench.run(device=DEVICE,
                             out=ROOT / "chiprun_out" / "kernel_bench.json")
    torch.cuda.synchronize()
    bench_launches = dict(_build.LAUNCHES)
    for k in ("spline_basis", "kan_fused_v1", "kan_fused_v2",
              "pattern_matmul", "spline_basis_bf16", "kan_fused_v1_bf16",
              "kan_fused_v2_bf16"):
        check(bench_launches[k] > 0,
              f"kernel bench: {k} launched {bench_launches[k]} times")
    bf_rows = {f"{sec}.{key}": row for sec in ("spline_basis", "kan_fused")
               for key, row in bench[sec].items() if key.endswith("bfloat16")}
    check(len(bf_rows) == 6, f"kernel bench: bf16 rows {sorted(bf_rows)}")
    for key, row in bf_rows.items():
        print(f"phase 6: bf16 row {key}: "
              + ", ".join(f"{f} {v:.3e}" if isinstance(v, float) else
                          f"{f} {v}" for f, v in row.items()
                          if f.startswith(("max_err", "ms"))
                          or f == "bitwise_plain"))
    check(bench["tuning"]["cache_round_trip"],
          "kernel bench: the tuned block_n did not round-trip")
    tm = bench["tuning"]["pattern_matmul"]
    check(tm["cache_round_trip"],
          "kernel bench: the tuned matmul tiles did not round-trip")
    tk = bench["tuning"]["kan_fused"]
    check(tk["cache_round_trip"],
          "kernel bench: the tuned KAN knobs did not round-trip")
    tk1 = bench["tuning"]["kan_fused_v1"]
    check(tk1["cache_round_trip"] and tk1["cache_key"].startswith(
        "kan_fused_v1|"),
          "kernel bench: the tuned v1 KAN knobs did not round-trip")
    check(bench_launches["kan_fused_v2"] > 0,
          "kernel bench: the KAN tuning launched nothing")
    print(f"phase 6: kernel bench passed its asserts; launches "
          f"{bench_launches}; tuned {bench['tuning']['tuned_blocks']} at "
          f"n={bench['tuning']['n']}; matmul {tm['shape']} relu tuned "
          f"{tm['tuned_blocks']} ({tm['ms_tuned']} ms) vs default "
          f"{tm['default_blocks']} ({tm['ms_default']} ms), bitwise equal; "
          f"KAN {tk['shape']} tuned {tk['tuned_blocks']} ({tk['ms_tuned']} "
          f"ms) vs default {tk['default_blocks']} ({tk['ms_default']} ms), "
          f"bitwise equal; v1 KAN tuned {tk1['tuned_blocks']} "
          f"({tk1['ms_tuned']} ms) vs default {tk1['default_blocks']} "
          f"({tk1['ms_default']} ms), bitwise equal")

    # ---------------------------------------------------------------- 7
    committed = json.loads((ROOT / "BENCH_serving.json").read_text())
    burst_ref = committed["openloop:burst:vikin-mlp3"]
    mlp3 = VIKIN_ARCHS["vikin-mlp3"]
    burst, _, max_queue = loadgen_bench.burst_trace("vikin-mlp3")
    check(burst.sha256() == burst_ref["trace_sha256"],
          f"burst trace sha256 {burst.sha256()} != the committed "
          f"{burst_ref['trace_sha256']}")
    shed_kw = {"max_queue": max_queue, "admission": "shed",
               "drop_expired": True}
    open_launches = {k: 0 for k in KERNEL_INFO}
    openloop = []

    def drive(eng, trace, mode: str, precision: str, what: str) -> dict:
        """Replay ``trace`` through ``eng``; check the drain, the bound,
        every request's fate, that nothing was built or resolved, the
        launches against the served batches and every answer; return the
        report."""
        builds, resolved = dict(_build.BUILDS), set(autotune.RESOLVED)
        _build.reset_launches()
        rep = replay(eng, trace, mode=mode)
        torch.cuda.synchronize()
        got = dict(_build.LAUNCHES)
        check(not rep["incomplete"] and rep["bound_respected"],
              f"{what}: incomplete {rep['incomplete']}, bound respected "
              f"{rep['bound_respected']}")
        check(rep["offered"] == rep["completed"] + rep["rejected"]
              + rep["shed"] + rep["expired"],
              f"{what}: {rep['offered']} offered, {rep['completed']} "
              f"completed + {rep['rejected']} rejected + {rep['shed']} "
              f"shed + {rep['expired']} expired")
        check(dict(_build.BUILDS) == builds
              and set(autotune.RESOLVED) == resolved,
              f"{what}: a kernel was built or a knob resolved inside the "
              f"replay")
        # a fresh engine (and MultiWorkloadBackend) per replay: its
        # batches are this replay's
        batches = ({n: ws["batches"]
                    for n, ws in eng.per_workload_stats().items()}
                   or {eng.backend.model.name: eng.stats["ticks"]})
        want = {k: 0 for k in KERNEL_INFO}
        kan_k, mm_k = SERVED_KERNELS[precision]
        for name, b in batches.items():
            kinds = VIKIN_ARCHS[name].layer_kinds
            want[kan_k] += int(b) * kinds.count("kan")
            want[mm_k] += int(b) * kinds.count("mlp")
        check(got == want and want[mm_k] > 0,
              f"{what}: launches {got}, the served batches imply {want}")
        for k in KERNEL_INFO:
            open_launches[k] += got[k]
        subs = (eng.backend.backends if hasattr(eng.backend, "backends")
                else {eng.backend.model.name: eng.backend})
        done = [r for r in eng._requests.values() if r.done]
        check(len(done) == rep["completed"],
              f"{what}: {len(done)} answers for {rep['completed']} "
              f"completions")
        err = 0.0
        for name, be in subs.items():
            rs = [r for r in done if r.workload in (name, None)]
            if not rs:
                continue
            xs = np.stack([r.prompt for r in rs]).astype(np.float32)
            answers = np.stack([r.output for r in rs])
            err = max(err, hold(precision, be.stack, xs, answers,
                                f"{what} {name}")[0])
        rep["max_abs_err"] = err
        return rep

    def show(rep: dict, what: str) -> None:
        ms = {q: rep[f"p{q}_latency_s"] * 1e3 for q in (50, 95, 99)}
        print(f"phase 7: {what}: offered {rep['offered_rps']:.1f} req/s, "
              f"achieved {rep['achieved_rps']:.1f}, goodput "
              f"{rep['goodput_rps']:.1f}; latency p50/p95/p99 "
              f"{ms[50]:.4f}/{ms[95]:.4f}/{ms[99]:.4f} ms; completed "
              f"{rep['completed']}/{rep['offered']}, shed {rep['shed']}, "
              f"expired {rep['expired']}, deadline met "
              f"{rep['deadline_met']}, queue hwm {rep['queue_depth_hwm']}; "
              f"max abs err {rep['max_abs_err']:.3e} ({card})")

    # the replay loop synthesizes each arrival's payload on the host, in
    # the thread that serves: above 1 / (this time) arrivals a second the
    # loop falls behind the trace (each request still counts from its
    # trace time)
    t0 = time.perf_counter()
    for i in range(2000):
        np.random.default_rng(i).random(mlp3.sizes[0], dtype=np.float32)
    payload_us = (time.perf_counter() - t0) / 2000 * 1e6
    print(f"phase 7: card {card}; a replayed arrival's payload takes "
          f"{payload_us:.2f} us of host time to synthesize")
    mlp3_be = {}
    # (a) also at bf16 (no wall-clock sweep at bf16: the benchmark takes it)
    for precision in ("f32", "int8", "bf16"):
        be = mlp3_be[precision] = make_vikin_backend(
            mlp3, DEVICE, precision=precision)
        loadgen_bench.warm_buckets(be, 8)
        cpu_be = (make_vikin_backend(mlp3, "cpu", precision=precision)
                  if precision != "f32" else None)
        for label, kw in (("unbounded", {}), ("shed", shed_kw)):
            what = f"(a) {precision} burst trace, {label}, sim clock"
            rep = drive(Engine(be, n_slots=8, **kw), burst, "sim",
                        precision, what)
            fields = {k: rep[k] for k in loadgen_bench.BURST_FIELDS}
            if cpu_be is None:
                ref, whose = burst_ref[label], "the committed row"
            else:
                cpu_rep = replay(Engine(cpu_be, n_slots=8, **kw), burst,
                                 mode="sim")
                ref = {k: cpu_rep[k] for k in loadgen_bench.BURST_FIELDS}
                whose = "the CPU replay"
            check(fields == ref, f"{what}: {fields} != {whose} {ref}")
            print(f"phase 7: {what}: every field equals {whose}")
            show(rep, what)
            openloop.append({"part": "a", "precision": precision,
                             "engine": label, "card": card, **rep})

    multi_be = {p: served[p]["eng"].backend.backends for p in PRECISIONS}
    for precision in ("f32", "int8"):
        engines = {
            "vikin-mlp3": lambda **kw: Engine(mlp3_be[precision], n_slots=8,
                                              **kw),
            "multi": lambda **kw: Engine(
                MultiWorkloadBackend(dict(multi_be[precision])), n_slots=8,
                **kw),
        }
        for target, make in engines.items():
            probe = make()
            loadgen_bench.warm_buckets(probe.backend, 8)
            models = ([mlp3] if target == "vikin-mlp3"
                      else [VIKIN_ARCHS[n] for n in ARCHS])
            # C: 960 requests as 15 closed bursts of 64, each submitted
            # and served in the timed region, as a replay submits in the
            # serving thread; one burst of 960 (submitted first) is timed
            # too, for what a deep queue costs the batch policy
            t0 = time.perf_counter()
            for i in range(15):
                submit_burst(probe, models, 64, seed=7 + i)
                probe.run_until_done()
            cap = 960 / (time.perf_counter() - t0)
            submit_burst(probe, models, 960, seed=7)
            t0 = time.perf_counter()
            probe.run_until_done()
            deep = 960 / (time.perf_counter() - t0)
            batch_s = 8 / cap
            print(f"phase 7: (b) {precision} {target}: closed-burst rate C "
                  f"= {cap:.1f} req/s on 8 slots (bursts of 64, submission "
                  f"timed), one full batch {batch_s * 1e3:.4f} ms; "
                  f"{deep:.1f} req/s serving one burst of 960 ({card})")
            mix = (None if target == "vikin-mlp3"
                   else [(n, 1.0) for n in ARCHS])
            runs = [(f"poisson {m}C", {}, poisson_trace(
                m * cap, 2000, seed=11, workloads=mix))
                for m in (0.5, 0.9, 1.5)]
            if target == "vikin-mlp3":
                deadline = 4 * batch_s
                bt = bursty_trace(
                    0.5 * cap, 5.0 * cap, 2000, mean_calm_s=16 * batch_s,
                    mean_burst_s=48 * batch_s, seed=11,
                    priority_classes=[(0, 0.7, deadline),
                                      (2, 0.3, deadline)])
                runs += [("bursty, unbounded", {}, bt),
                         ("bursty, shed", shed_kw, bt)]
            for label, kw, trace in runs:
                what = f"(b) {precision} {target} {label}, wall clock"
                rep = drive(make(**kw), trace, "wall", precision, what)
                show(rep, what)
                openloop.append({"part": "b", "precision": precision,
                                 "target": target, "run": label,
                                 "closed_rps": cap, "closed_rps_960": deep,
                                 "card": card, **rep})

    bench_out = ROOT / "chiprun_out" / "serving_bench.json"
    bench_out.unlink(missing_ok=True)
    rows = serving_bench.run(DEVICE, bench_out)
    rows.update(loadgen_bench.run(DEVICE, bench_out))
    for key, row in json.loads(json.dumps(rows)).items():
        ref = committed[key]
        if key.startswith("openloop:"):
            same = {k: v for k, v in row.items() if k != "device"} == ref
        elif key.startswith("sched:"):
            same = row["bitwise_identical"] and all(
                row["policies"][p][f] == v
                for p, pol in ref["policies"].items()
                for f, v in pol.items() if not f.startswith("wall"))
        else:
            same = all(row[f] == v for f, v in ref.items()
                       if not f.startswith("wall"))
        check(same, f"(c) bench row {key} differs from the committed row "
              f"in a simulated field (or is not bitwise): {row}")
    print(f"phase 7: (c) {sorted(rows)} on the card: every simulated field "
          f"equals the committed row; sched batched == single, bitwise, "
          f"under both policies")
    print(f"phase 7: launches over the replays {open_launches}")

    # ---------------------------------------------------------------- 8
    # training on the card (f32, IEEE products): (a) one vikin-mixed step's
    # gradients through the kernels' autograd Functions against autograd
    # through the plain versions, and its launches; (b) StackTrainer runs of
    # vikin-mixed and vikin-kan2: the validation MSE falls, two runs are
    # bitwise equal, the first losses agree with a CPU run, ms a step;
    # (c) the launcher end to end and its checkpoint served at f32 and int8;
    # (d) an AsyncCheckpointer write overlapped with training steps
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is allowed: the gradient products must be IEEE f32")
    train_cfg = StackTrainerConfig(steps=TRAIN_STEPS, batch_size=64,
                                   device=DEVICE)
    want_step = {"vikin-mixed": {"kan_fused_v2": 1, "pattern_matmul": 2,
                                 "spline_basis": 2},
                 # the first layer's x needs no gradient: no order K-1 basis
                 "vikin-kan2": {"kan_fused_v2": 1, "spline_basis": 1}}
    tasks = {a: task_for_model(VIKIN_ARCHS[a]) for a in want_step}
    inits = {a: vikin_stack_init(VIKIN_ARCHS[a],
                                 torch.Generator().manual_seed(0))
             for a in want_step}

    train = {}
    for arch in want_step:
        model = VIKIN_ARCHS[arch]
        tr = StackTrainer(model, tasks[arch], train_cfg, params=inits[arch])
        x, y = tr.batch(0)
        _build.reset_launches()
        loss_k, g_k = tr.value_and_grad(x, y)
        torch.cuda.synchronize()
        g_k = dict(leaf_paths(g_k))
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        check(got == want_step[arch],
              f"(a) {arch}: one step's forward and backward launched {got}, "
              f"expected {want_step[arch]}")
        loss_p, g_p = plain_grads(tr.params, model, x, y)
        errs = {}
        for k in g_p:
            err, scale, nan = rel_err(g_k[k], g_p[k])
            mag = scale - 1.0
            check(not nan and err <= TRAIN_GRAD_TOL * mag,
                  f"(a) {arch} d{k}: max|kernel - plain| = {err:.3e} vs "
                  f"{TRAIN_GRAD_TOL:g} * max|plain| {mag:.4g}")
            errs[k] = {"max_abs_err": err, "max_abs_plain": mag}
        loss_k, loss_p = float(loss_k), float(loss_p)
        check(abs(loss_k - loss_p) <= TRAIN_GRAD_TOL * abs(loss_p),
              f"(a) {arch}: loss {loss_k} vs plain {loss_p}")
        print(f"phase 8: (a) {arch} batch 64: one forward + backward "
              f"launched {got}; loss {loss_k:.6f} (plain {loss_p:.6f}); "
              f"each leaf's gradient within {TRAIN_GRAD_TOL:g}*max|plain| "
              f"of autograd through the plain versions, max abs err / "
              f"max|plain|: " + ", ".join(
                  f"d{k} {e['max_abs_err']:.3e} / {e['max_abs_plain']:.3e}"
                  for k, e in errs.items()))
        train[arch] = {"grad_err": errs, "step_launches": got}

    # (b) two runs from the same init, bitwise; a CPU run's first losses
    train_launches = {k: 0 for k in KERNEL_INFO}
    for arch in want_step:
        model = VIKIN_ARCHS[arch]
        runs = []
        for rep in range(2):
            tr = StackTrainer(model, tasks[arch], train_cfg,
                              params=inits[arch])
            val0 = tr.evaluate()["val_mse"]
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            losses = [tr.train_step(s)[0] for s in range(TRAIN_STEPS)]
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
            launched = dict(_build.LAUNCHES)
            want = {k: TRAIN_STEPS * want_step[arch].get(k, 0)
                    for k in KERNEL_INFO}
            check(launched == want, f"(b) {arch}: {TRAIN_STEPS} steps "
                  f"launched {launched}, expected {want}")
            if rep == 0:
                for k in KERNEL_INFO:
                    train_launches[k] += launched[k]
            val1 = tr.evaluate()["val_mse"]
            runs.append({"tr": tr, "losses": torch.stack(losses).cpu(),
                         "val0": val0, "val1": val1, "wall_ms": wall_ms})
        a, b = runs
        check(a["val1"] < a["val0"],
              f"(b) {arch}: validation MSE {a['val0']:.6f} -> "
              f"{a['val1']:.6f} after {TRAIN_STEPS} steps")
        same = all(torch.equal(pa, pb) for (_, pa), (_, pb) in zip(
            leaf_paths(a["tr"].params), leaf_paths(b["tr"].params)))
        check(same and torch.equal(a["losses"], b["losses"]),
              f"(b) {arch}: two runs from one seed differ")
        cpu_tr = StackTrainer(model, tasks[arch],
                              dataclasses.replace(train_cfg, device="cpu"),
                              params=inits[arch])
        cpu_losses = torch.stack([cpu_tr.train_step(s)[0]
                                  for s in range(CPU_STEPS)])
        rel = ((a["losses"][:CPU_STEPS] - cpu_losses).abs()
               / cpu_losses.abs())
        check(float(rel.max()) <= TRAIN_LOSS_TOL,
              f"(b) {arch}: the first {CPU_STEPS} losses differ from the "
              f"CPU run's by up to {float(rel.max()):.3e} relative "
              f"(> {TRAIN_LOSS_TOL:g}): card {a['losses'][:CPU_STEPS]}, "
              f"cpu {cpu_losses}")

        # ms a step: host wall (above), and device spans by CUDA events of
        # the forward (run alone, with grad), the forward and backward,
        # and the AdamW update, synchronised between them (a span includes
        # the card's idle gaps waiting on the host), over steps past the
        # measured runs
        tr = a["tr"]
        spans = {"forward": [], "backward": [], "update": []}
        for s in range(TRAIN_STEPS, TRAIN_STEPS + 30):
            x, y = tr.batch(s)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            torch.cuda.synchronize()
            params = tree_map(lambda p: p.detach().requires_grad_(True),
                              tr.params)
            ev[0].record()
            tr.loss_fn(params, x, y)
            ev[1].record()
            torch.cuda.synchronize()
            ev[2].record()
            _, grads = tr.value_and_grad(x, y)
            ev[3].record()
            torch.cuda.synchronize()
            ev[4].record()
            tr.apply(grads)
            ev[5].record()
            torch.cuda.synchronize()
            fwd = ev[0].elapsed_time(ev[1])
            spans["forward"].append(fwd)
            spans["backward"].append(ev[2].elapsed_time(ev[3]) - fwd)
            spans["update"].append(ev[4].elapsed_time(ev[5]))
        span_ms = {k: statistics.median(v) for k, v in spans.items()}
        # the spline-basis launches of one backward alone, device time
        kan_i = model.layer_kinds.index("kan")
        h = torch.from_numpy(tr._batch_at(0)[0]).to(dev)
        with torch.no_grad():
            for layer in range(kan_i):
                p = tr.params[layer]
                h = torch.relu(h @ p["w"] + p["b"])
        spec = model.spec
        hc = spec.clip(h)
        orders = ([spec] + ([SplineSpec(spec.grid_size, spec.order - 1)]
                            if want_step[arch]["spline_basis"] == 2 else []))
        for o in orders:
            spline_basis(hc, o)
        sb_ms = graph_ms(lambda: [spline_basis(hc, o) for o in orders])
        outside = 1.0 - sb_ms / span_ms["backward"]
        train[arch].update({
            "steps": TRAIN_STEPS, "val_mse_before": a["val0"],
            "val_mse_after": a["val1"], "host_ms_per_step": a["wall_ms"],
            "host_ms_per_step_run2": b["wall_ms"],
            "device_span_ms": span_ms,
            "device_span_ms_step": sum(span_ms.values()),
            "spline_basis_backward_ms": sb_ms,
            "backward_share_outside_kernels": outside,
            "first_losses_card": a["losses"][:CPU_STEPS].tolist(),
            "first_losses_cpu": cpu_losses.tolist(),
            "loss_rel_err_vs_cpu": float(rel.max()), "card": card})
        print(f"phase 8: (b) {arch}: {TRAIN_STEPS} steps at batch 64, "
              f"validation MSE {a['val0']:.6f} -> {a['val1']:.6f}; two runs "
              f"bitwise equal; first {CPU_STEPS} losses within "
              f"{float(rel.max()):.3e} relative of the CPU run's; host "
              f"{a['wall_ms']:.4f} ms a step ({b['wall_ms']:.4f} in the "
              f"second run); device spans forward {span_ms['forward']:.4f} "
              f"/ backward {span_ms['backward']:.4f} / update "
              f"{span_ms['update']:.4f} ms; the backward's spline-basis "
              f"launches {sb_ms:.4f} ms alone, {100 * outside:.1f}% of the "
              f"backward span outside them ({card})")

    # (c) the launcher end to end, then its checkpoint served
    mixed_tr = VIKIN_ARCHS["vikin-mixed"]
    val_x = tasks["vikin-mixed"]["val_x"][:24]
    with tempfile.TemporaryDirectory() as ck:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "vikin-mixed", "--steps", str(TRAIN_STEPS), "--batch", "64",
               "--pattern", "0.5", "--precision", "int8", "--device", DEVICE,
               "--ckpt-dir", ck]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600, env=dict(os.environ,
                                                   PYTHONPATH=str(SRC)))
        launcher_s = time.perf_counter() - t0
        print("\n".join(f"phase 8: (c) | {line}"
                        for line in run.stdout.strip().splitlines()[-8:]))
        check(run.returncode == 0,
              f"(c) the launcher exited {run.returncode}: "
              f"{run.stderr[-2000:]}")
        saved = restore_masks(ck)
        params_ck, step_ck, extra = restore_checkpoint(
            ck, vikin_stack_init(mixed_tr))
        check(step_ck == TRAIN_STEPS,
              f"(c) the checkpoint is at step {step_ck}, not {TRAIN_STEPS}")
        # the launcher calibrated on the card, its dense forward through
        # the kernels; a calibration of the saved params on the CPU (the
        # plain versions) must give the same masks, except in a group where
        # two saliencies tie within twice the largest card-vs-CPU saliency
        # difference of their layer (each such basis is named)
        calib_x = tasks["vikin-mixed"]["train_x"][:256]
        sal_cpu = stack_saliencies(params_ck, mixed_tr, calib_x)
        sal_card = stack_saliencies(tree_map(lambda p: p.to(dev), params_ck),
                                    mixed_tr, calib_x)
        ties, sal_diff = [], []
        for i, (m, s_c, s_d) in enumerate(zip(saved, sal_cpu, sal_card)):
            if s_c is None:
                check(m is None, f"(c) layer {i}: a saved mask where the "
                      f"calibration keeps the raw features dense")
                continue
            noise = float(np.abs(s_d - s_c).max())
            sal_diff.append(noise / float(np.abs(s_c).max()))
            cpu_keep = magnitude_mask(s_c, 2).keep
            differ = np.nonzero(m.keep != cpu_keep)[0]
            for g in sorted({int(j) // 4 for j in differ}):
                idx = np.arange(4 * g, 4 * g + 4)
                card_only = idx[m.keep[idx] & ~cpu_keep[idx]]
                cpu_only = idx[cpu_keep[idx] & ~m.keep[idx]]
                for a, b in zip(card_only, cpu_only):
                    gap = abs(float(s_c[a]) - float(s_c[b]))
                    check(gap <= 2 * noise,
                          f"(c) layer {i}: the card kept basis {a}, the CPU "
                          f"basis {b}; their saliencies {s_c[a]!r} and "
                          f"{s_c[b]!r} differ by {gap:.3e}, more than twice "
                          f"the card-vs-CPU difference {noise:.3e}")
                    ties.append({"layer": i, "card_kept": int(a),
                                 "cpu_kept": int(b), "gap": gap,
                                 "noise": noise})
        train["calibration"] = {"ties": ties,
                                "saliency_rel_diff_card_cpu": sal_diff}
        print(f"phase 8: (c) masks calibrated on the card by the launcher "
              f"vs a CPU calibration of the saved params: "
              + (f"{len(ties)} bases differ, each in a tie: {ties}" if ties
                 else "equal")
              + f"; card-vs-CPU saliency difference per masked layer, "
              f"relative to its max: "
              + ", ".join(f"{d:.3e}" for d in sal_diff))
        for precision in ("f32", "int8"):
            be = make_vikin_backend(mixed_tr, DEVICE, precision=precision,
                                    ckpt=ck)
            check(all(np.array_equal(m.keep, s_.keep) if m is not None
                      else s_ is None for m, s_ in zip(be.masks, saved)),
                  f"(c) {precision}: the served masks are not the saved ones")
            eng = Engine(be, n_slots=8)
            rids = [eng.submit(r) for r in val_x]
            out = eng.run_until_done()
            err, flips = hold(precision, be.stack, val_x,
                              np.stack([out[r] for r in rids]),
                              f"(c) {precision} trained checkpoint")
            train.setdefault("launcher", {})[precision] = err
            print(f"phase 8: (c) {precision}: the launcher's checkpoint "
                  f"(step {step_ck}, {extra['task']}, val_dense "
                  f"{extra['val_dense']}, val_sparse {extra['val_sparse']}, "
                  f"keep rates {extra['mask_keep_rates']}) served {len(rids)} "
                  f"validation windows, within "
                  f"{SERVE_TOL:g}*(1+max|ref|) of the plain stack, max abs "
                  f"err {err:.3e}; served masks == saved")
        train["launcher"]["seconds"] = launcher_s

    # (d) an asynchronous save overlapped with the next steps
    tr = StackTrainer(mixed_tr, tasks["vikin-mixed"], train_cfg,
                      params=inits["vikin-mixed"])
    for s in range(20):
        tr.train_step(s)
    with tempfile.TemporaryDirectory() as ck:
        saver = AsyncCheckpointer(ck, keep=2)
        snap = tree_map(lambda p: p.detach().cpu().clone(), tr.params)
        saver.save(20, tr.params)
        for s in range(20, 40):
            tr.train_step(s)
        saver.wait()
        back, step_ck, _ = restore_checkpoint(ck, snap)
        same = all(torch.equal(p, q) for (_, p), (_, q) in zip(
            leaf_paths(back), leaf_paths(snap)))
        check(step_ck == 20 and same,
              "(d) the restored params are not the snapshot's bits")
        moved = not all(torch.equal(p.cpu(), q) for (_, p), (_, q) in zip(
            leaf_paths(tr.params), leaf_paths(snap)))
        check(moved, "(d) training did not move the params past the save")
    print("phase 8: (d) AsyncCheckpointer: a save at step 20 written while "
          "steps 20-39 ran on the card restores bitwise equal to the "
          "snapshot")

    launched = {k: (served[p]["launches"][k], f"phase 3, {p} burst")
                for p in PRECISIONS for k in SERVED_KERNELS[p]}
    launched["kan_fused_v1_bf16"] = (b_v1_launches["kan_fused_v1_bf16"],
                                     "phase 5, bf16 v1 path")
    launched["spline_basis_bf16"] = (bench_launches["spline_basis_bf16"],
                                     "phase 6, kernel bench")
    launched["kan_fused_v1"] = (v1_launches["kan_fused_v1"],
                                "phase 5, v1 path")
    launched["spline_basis"] = (bench_launches["spline_basis"],
                                "phase 6, kernel bench")
    kernels = []
    for k, info in KERNEL_INFO.items():
        rec = records[(k, 8)]
        kernels.append({
            "name": k, "dtype": DTYPE[k], "route": "cuda",
            "source": info["source"],
            "headers": info.get("headers", []),
            "replaces": info["replaces"], "launches": launched[k][0],
            "launches_phase": launched[k][1],
            "launches_openloop": open_launches[k],
            "launches_train": train_launches[k],
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
         "serve": {p: {"wall_s": sv["wall_s"], "wall_rps": sv["wall_rps"],
                       "stats": dict(sv["eng"].stats)}
                   for p, sv in served.items()},
         "v1_path": {"launches": v1_launches, "max_abs_err": v1_err},
         "v1_path_bf16": {"launches": b_v1_launches,
                          "max_abs_err": b_v1_err},
         "openloop": {"payload_us": payload_us, "replays": openloop},
         "train": train,
         "ptxas": usage,
         "knob_checks": knob_checks,
         "kernel_bench_launches": bench_launches},
        indent=1, default=str))
    print(json.dumps(summary))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
