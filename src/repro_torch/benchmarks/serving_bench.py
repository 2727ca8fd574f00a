"""Serving bench of the PyTorch/CUDA port: the VIKIN backend under a burst.

Counterpart of the rows of ``benchmarks/serving_bench.py``:

* ``<arch>`` for ``vikin-kan2``, ``vikin-mlp3`` and ``vikin-mixed`` --
  one closed burst of ``--requests`` through ``runtime/server.Engine`` on
  ``--slots`` slots: host-clock throughput beside the simulated VIKIN
  figures (cycles, latency, mode switches);
* ``sched:vikin-kan2+vikin-mlp3`` -- an interleaved KAN/MLP stream served
  from one multi-workload engine under the ``fifo`` and ``mode-affinity``
  batch policies side by side, with whether batched outputs are bitwise
  the single-request ones for every request under each policy;
* ``kanffn:kanffn-ci`` -- the KAN-FFN transformer against its all-"mlp"
  twin of the same widths through the VIKIN cycle model (batch-1
  simulated cycles, DMA bytes and mode plan a request), and whether
  batched greedy decode equals single-request decode, token for token;
* ``sharded:vikin-mlp3`` and ``sharded:vikin-mixed`` -- the burst served
  by one device and by the data plan over ``--devices`` shards
  (``runtime/sharded.ShardedVikinBackend``): bitwise the same answers,
  and the single-chip and array cycle profiles side by side;
* ``pipe:vikin-small`` -- the data and pipeline plans' cycles over a
  batch sweep (their crossover, the fill/drain bubble against its
  closed-form bound), and the pipeline-served burst bitwise the
  single-device one;
* ``hetero:vikin-kan2+vikin-mlp3`` -- the interleaved stream of the
  ``sched:`` row under mode-affinity on one chip per workload and on a
  mode-pinned array per workload: no reconfiguration, no added queueing,
  bitwise the single-request answers;
* ``trained:vikin-mlp3`` and ``quant:vikin-small`` -- a stack trained on
  its teacher task (``runtime/trainer.StackTrainer``), calibrated, and
  served dense at f32 against two-stage-sparse at f32 (``trained:``) or
  int8 (``quant:``, whose served mse ratio must stay within
  ``QUANT_MSE_RATIO_BOUND``): cycles, DMA bytes, mask keep rates and
  served accuracy.

Weights are random, drawn from ``--seed``, except the trained rows'.  The
array rows run on ``--devices`` chips: on the card ``["cuda:0"] * N``,
N logical chips on one card, and on the CPU N logical chips on the host;
each row records the device list (``device_list``).  The simulated
fields depend on the cycle model and the scheduler alone, so they equal
the JAX package's committed rows exactly (``repro_torch.benchmarks.
check_regression --serving`` holds them); ``wall_*`` fields are host
clock on the device named in each row, and ``val_mse`` depends on the
training run.

Run (from the repository root, with ``PYTHONPATH=src``)::

    python -m repro_torch.benchmarks.serving_bench [--device cpu] [--out PATH]

It writes its rows into ``--out`` (``chiprun_out/serving_bench.json`` at
the repository root by default), read-modify-write: the load bench
(``repro_torch.benchmarks.loadgen_bench``) keeps its rows in the same
file.  It never writes ``BENCH_serving.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.registry import KANFFN_ARCHS
from repro_torch.configs.vikin_models import VIKIN_ARCHS
from repro_torch.core.calibrate import (
    calibrate_scales,
    calibrate_stack,
    keep_per_group_for_rate,
)
from repro_torch.core.engine import VikinArray, VikinHW, serving_report
from repro_torch.data.stack_task import task_for_model
from repro_torch.kernels.autotune import device_tag
from repro_torch.launch.mesh import require_devices
from repro_torch.models import transformer as T
from repro_torch.models.ffn import vikin_stack_init
from repro_torch.runtime.backends import (
    MultiWorkloadBackend,
    TransformerBackend,
    VikinBackend,
)
from repro_torch.runtime.server import Engine
from repro_torch.runtime.sharded import (
    HeteroVikinBackend,
    PipelineVikinBackend,
    ShardedVikinBackend,
)
from repro_torch.runtime.trainer import StackTrainer, StackTrainerConfig
from repro_torch.utils import host_f32, resolve_device

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_OUT = ROOT / "chiprun_out" / "serving_bench.json"
ARCHS = ("vikin-kan2", "vikin-mlp3", "vikin-mixed")
SCHED_ARCHS = ("vikin-kan2", "vikin-mlp3")
KANFFN_ARCH = "kanffn-ci"
SHARDED_ARCHS = ("vikin-mlp3", "vikin-mixed")
PIPE_ARCH = "vikin-small"
TRAINED_ARCH = "vikin-mlp3"
QUANT_ARCH = "vikin-small"
DEVICES = 4
# row families ``run`` emits, in order
FAMILIES = ("burst", "sched", "kanffn", "sharded", "pipe", "hetero",
            "trained", "quant")
# int8-sparse served val mse may not exceed this multiple of the dense
# f32 val mse (the reference's committed bound)
QUANT_MSE_RATIO_BOUND = 2.0


def seeded_params(model, seed: int):
    """The stack's random weights, drawn from ``seed``."""
    return vikin_stack_init(model, torch.Generator().manual_seed(seed))


def array_devices(n: int, device: str) -> list:
    """The chips of the array rows: ``n`` logical chips on the host, or
    on one card (an explicit ``[device] * n``: one card serves them all,
    as on a one-card machine)."""
    dev = resolve_device(device)
    if dev.type != "cpu":
        dev = torch.device(dev.type, dev.index or 0)
    return require_devices(n if dev.type == "cpu" else [dev] * n,
                           "serving_bench", dev)


def _serve_stream(backend, reqs, n_slots: int):
    """Serve the payloads ``reqs`` through an engine over ``backend``;
    returns (answers stacked in submission order, engine stats)."""
    eng = Engine(backend, n_slots=n_slots)
    rids = [eng.submit(r) for r in reqs]
    out = eng.run_until_done()
    return np.stack([out[r] for r in rids]), eng.stats


def _per_req(s: Dict, keys: Sequence[str]) -> Dict[str, float]:
    served = max(s["served"], 1)
    return {f"{k}_per_req": s[k] / served for k in keys if k in s}


def merge_rows(rows: Dict[str, Dict], out: Optional[str | Path]) -> Path:
    """Merge ``rows`` into the JSON at ``out`` (default ``DEFAULT_OUT``),
    keeping every row already there under another key."""
    path = Path(out) if out is not None else DEFAULT_OUT
    try:
        results = json.loads(path.read_text())
    except (OSError, ValueError):
        results = {}
    results.update(rows)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=1))
    return path


def serve_burst(arch: str, *, n_requests: int = 32, n_slots: int = 8,
                device: str = "cuda", seed: int = 0) -> Dict:
    """Serve one burst; returns throughput + simulated-hardware stats."""
    model = VIKIN_ARCHS[arch]
    backend = VikinBackend(model, seeded_params(model, seed), device=device)
    eng = Engine(backend, n_slots=n_slots)

    rng = np.random.default_rng(seed)
    for _ in range(n_requests):
        eng.submit(rng.random(model.sizes[0], dtype=np.float32))
    # build the kernels and resolve their knobs outside the timed run: the
    # full-occupancy bucket and the trailing partial batch's bucket
    backend.warmup(min(n_slots, n_requests))
    if n_requests % n_slots:
        backend.warmup(n_requests % n_slots)
    out = eng.run_until_done()
    if len(out) != n_requests:
        raise AssertionError(f"serve_burst {arch}: {len(out)} answers for "
                             f"{n_requests} requests")

    s = eng.stats
    return {
        "arch": arch,
        "device": device_tag(backend.device),
        "requests": int(s["served"]),
        "batches": int(s["ticks"]),
        "n_slots": n_slots,
        "wall_s": s["wall_s"],
        "wall_rps": s["served"] / s["wall_s"] if s["wall_s"] else 0.0,
        "sim_cycles": s["sim_cycles"],
        "sim_cycles_per_req": s["sim_cycles"] / max(s["served"], 1),
        "sim_latency_s": s["sim_latency_s"],
        "sim_rps": (s["served"] / s["sim_latency_s"]
                    if s["sim_latency_s"] else 0.0),
        "mode_switches": int(s["mode_switches"]),
        "reconfig_cycles": s["reconfig_cycles"],
        "mode_plan": backend.plan.summary()["segments"],
    }


def sched_fifo_vs_affinity(archs: Sequence[str] = SCHED_ARCHS, *,
                           n_requests: int = 32, n_slots: int = 8,
                           device: str = "cuda", seed: int = 0) -> Dict:
    """Serve one interleaved multi-workload stream under both policies.

    The stream alternates the archs request by request: strict FIFO then
    runs singleton same-workload batches and pays a mode flip on nearly
    every tick, while mode-affinity groups same-mode work.  Also records,
    per policy, whether batched outputs are bitwise the single-request
    ones for every workload.
    """
    models = {a: VIKIN_ARCHS[a] for a in archs}
    params = {a: seeded_params(m, seed) for a, m in models.items()}
    rng = np.random.default_rng(seed)
    stream = [(archs[i % len(archs)],
               rng.random(models[archs[i % len(archs)]].sizes[0],
                          dtype=np.float32))
              for i in range(n_requests)]

    # single-request references, one engine per arch, one request at a time
    singles: Dict[int, np.ndarray] = {}
    for a in archs:
        eng = Engine(VikinBackend(models[a], params[a], device=device),
                     n_slots=n_slots)
        for i, (arch, x) in enumerate(stream):
            if arch != a:
                continue
            rid = eng.submit(x)
            singles[i] = eng.run_until_done()[rid]

    def serve(policy: str) -> Dict:
        backend = MultiWorkloadBackend(
            {a: VikinBackend(models[a], params[a], device=device)
             for a in archs})
        eng = Engine(backend, n_slots=n_slots, policy=policy)
        rids = [eng.submit(x, workload=a) for a, x in stream]
        out = eng.run_until_done()
        bitwise = all(np.array_equal(out[rid], singles[i])
                      for i, rid in enumerate(rids))
        s = eng.stats
        served = max(s["served"], 1)
        return {
            "requests": int(s["served"]),
            "batches": int(s["ticks"]),
            "bitwise_identical_to_single": bool(bitwise),
            "sim_cycles_per_req": s["sim_cycles"] / served,
            "reconfig_cycles": s["reconfig_cycles"],
            "reconfig_cycles_per_req": s["reconfig_cycles"] / served,
            "mode_switches": int(s["mode_switches"]),
            "wall_rps": s["served"] / s["wall_s"] if s["wall_s"] else 0.0,
            "p95_queue_wait_sim_s": s.get("p95_queue_wait_sim_s", 0.0),
            "p95_service_sim_s": s.get("p95_service_sim_s", 0.0),
        }

    fifo = serve("fifo")
    affinity = serve("mode-affinity")
    return {
        "archs": list(archs),
        "device": device_tag(resolve_device(device)),
        "requests": n_requests,
        "n_slots": n_slots,
        "policies": {"fifo": fifo, "mode-affinity": affinity},
        "bitwise_identical": (fifo["bitwise_identical_to_single"]
                              and affinity["bitwise_identical_to_single"]),
        "reconfig_reduction": (fifo["reconfig_cycles"]
                               / max(affinity["reconfig_cycles"], 1e-9)),
        "cycle_ratio_affinity_vs_fifo": (
            affinity["sim_cycles_per_req"]
            / max(fifo["sim_cycles_per_req"], 1e-9)),
    }


def kanffn_dense_vs_kan(arch: str = KANFFN_ARCH, *, n_check: int = 6,
                        n_slots: int = 4, device: str = "cuda",
                        seed: int = 0) -> Dict:
    """The ``kanffn:*`` row: a KAN-FFN transformer against its all-"mlp"
    twin of the same widths through the VIKIN cycle model, batch=1 a
    request (simulated cycles, DMA bytes, the mode plan and its flips),
    and whether batched greedy decode through ``Engine`` equals fresh
    single-request engines at the same ``n_slots``, token for token."""
    cfg = KANFFN_ARCHS[arch]
    dense_cfg = dataclasses.replace(
        cfg, name=cfg.name + "-dense",
        ffn_kinds=tuple("mlp" for _ in cfg.ffn_kinds))

    def side(c):
        params = T.init_params(c, torch.Generator().manual_seed(seed))
        b = TransformerBackend(c, params, device=device)
        rep = serving_report(b.layers, b.hw, batch=1, precision=b.precision)
        plan = b.plan.summary()
        return b, {"sim_cycles_per_req": rep["sim_cycles"],
                   "dma_bytes_per_req": rep["dma_bytes"],
                   "mode_plan": plan["segments"],
                   "mode_switches_per_req": plan["n_switches"]}

    backend, kan = side(cfg)
    _, dense = side(dense_cfg)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=int(rng.integers(3, 9))).astype(np.int32)
               for _ in range(n_check)]
    eng = Engine(backend, n_slots=n_slots, max_len=32)
    rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
    batched = eng.run_until_done()
    singles = []
    for p in prompts:
        eng1 = Engine(backend, n_slots=n_slots, max_len=32)
        rid1 = eng1.submit(p, max_new_tokens=4)
        singles.append(eng1.run_until_done()[rid1])
    return {
        "arch": arch,
        "device": device_tag(backend.device),
        "ffn_kinds": list(cfg.ffn_kinds),
        "requests": n_check,
        "n_slots": n_slots,
        "dense_mlp": dense,
        "kanffn": kan,
        "cycle_ratio": (kan["sim_cycles_per_req"]
                        / max(dense["sim_cycles_per_req"], 1e-9)),
        "dma_ratio": (kan["dma_bytes_per_req"]
                      / max(dense["dma_bytes_per_req"], 1e-9)),
        "batched_equals_single": all(batched[rid] == singles[i]
                                     for i, rid in enumerate(rids)),
    }


def sharded_single_vs_multi(arch: str, *, devices: int = DEVICES,
                            n_requests: int = 32, n_slots: int = 8,
                            device: str = "cuda", seed: int = 0) -> Dict:
    """The ``sharded:*`` row: one burst served single-device and by the
    data plan over ``devices`` shards -- bitwise the same answers, and the
    single-chip and array cycle profiles side by side."""
    model = VIKIN_ARCHS[arch]
    params = seeded_params(model, seed)
    devs = array_devices(devices, device)
    rng = np.random.default_rng(seed)
    reqs = [rng.random(model.sizes[0], dtype=np.float32)
            for _ in range(n_requests)]

    def serve(backend):
        y, s = _serve_stream(backend, reqs, n_slots)
        row = {
            "sim_cycles_per_req": s["sim_cycles"] / max(s["served"], 1),
            "sim_rps": (s["served"] / s["sim_latency_s"]
                        if s["sim_latency_s"] else 0.0),
            "wall_rps": s["served"] / s["wall_s"] if s["wall_s"] else 0.0,
            **_per_req(s, ("chip_cycles", "comm_cycles")),
        }
        return y, row

    y1, single = serve(VikinBackend(model, params, device=devs[0]))
    yn, multi = serve(ShardedVikinBackend(model, params, devices=devs))
    return {
        "arch": arch,
        "devices": devices,
        "device": device_tag(devs[0]),
        "device_list": [str(d) for d in devs],
        "requests": n_requests,
        "bitwise_identical": bool(np.array_equal(y1, yn)),
        "single": single,
        "multi": multi,
        "array_cycle_speedup": (single["sim_cycles_per_req"]
                                / max(multi["sim_cycles_per_req"], 1e-9)),
    }


def pipeline_vs_data(arch: str = PIPE_ARCH, *, devices: int = DEVICES,
                     n_requests: int = 32, n_slots: int = 8,
                     device: str = "cuda", seed: int = 0) -> Dict:
    """The ``pipe:*`` row: the data and pipeline plans on the same chips.

    The analytical half sweeps batch sizes through the cycle model of
    both plans and records the crossover (the pipeline pays DMA setup a
    stage, not a chip, so it wins small batches) and the fill/drain
    bubble against its closed form ``(n_stages - 1) * T_max``.  The
    served half runs the burst single-device and pipeline-staged: the
    answers must be bitwise equal.
    """
    model = VIKIN_ARCHS[arch]
    params = seeded_params(model, seed)
    devs = array_devices(devices, device)
    hw = VikinHW()
    layers = model.layer_works()
    data_arr = VikinArray(hw=hw, n_chips=devices)
    pipe_arr = VikinArray(hw=hw, n_chips=devices, plan="pipeline")
    n_stages = len(pipe_arr.stage_sizes(len(layers)))
    sweep, crossover = [], None
    for b in (1, 2, 4, 8, 16, 32, 64):
        d = serving_report(layers, hw, batch=b, array=data_arr)
        p = serving_report(layers, hw, batch=b, array=pipe_arr)
        sweep.append({"batch": b, "data_cycles": d["sim_cycles"],
                      "pipeline_cycles": p["sim_cycles"],
                      "pipeline_over_data": p["sim_cycles"]
                      / d["sim_cycles"]})
        if crossover is None and d["sim_cycles"] <= p["sim_cycles"]:
            crossover = b
    p1 = serving_report(layers, hw, batch=1, array=pipe_arr)
    d8 = serving_report(layers, hw, batch=8, array=data_arr)
    p8 = serving_report(layers, hw, batch=8, array=pipe_arr)
    # batch 1: chip_cycles == sum(T_s) and bubble == sum(T_s) - T_max
    t_max = p1["chip_cycles"] - p1["bubble_cycles"]
    bound = (n_stages - 1) * t_max

    rng = np.random.default_rng(seed)
    reqs = [rng.random(model.sizes[0], dtype=np.float32)
            for _ in range(n_requests)]

    def serve(backend):
        y, s = _serve_stream(backend, reqs, n_slots)
        row = {
            "sim_cycles_per_req": s["sim_cycles"] / max(s["served"], 1),
            "reconfig_cycles": s["reconfig_cycles"],
            "wall_rps": s["served"] / s["wall_s"] if s["wall_s"] else 0.0,
            **_per_req(s, ("chip_cycles", "comm_cycles", "bubble_cycles")),
        }
        return y, row

    y1, single = serve(VikinBackend(model, params, device=devs[0]))
    yp, pipe = serve(PipelineVikinBackend(model, params, devices=devs))
    return {
        "arch": arch,
        "devices": devices,
        "device": device_tag(devs[0]),
        "device_list": [str(d) for d in devs],
        "requests": n_requests,
        "n_stages": n_stages,
        "stage_sizes": list(pipe_arr.stage_sizes(len(layers))),
        "bitwise_identical": bool(np.array_equal(y1, yp)),
        "single": single,
        "pipeline": pipe,
        "sweep": sweep,
        "crossover_batch": crossover,
        "pipeline_wins_at_batch_1": bool(
            sweep[0]["pipeline_cycles"] < sweep[0]["data_cycles"]),
        "bubble_cycles": p1["bubble_cycles"],
        "bubble_bound_cycles": bound,
        "bubble_within_bound": bool(p1["bubble_cycles"] <= bound + 1e-9),
        "data_reconfig_cycles_per_req": d8["reconfig_cycles"] / 8.0,
        "pipeline_reconfig_cycles_per_req": p8["reconfig_cycles"] / 8.0,
    }


def hetero_vs_affinity(archs: Sequence[str] = SCHED_ARCHS, *,
                       devices: int = DEVICES, n_requests: int = 32,
                       n_slots: int = 8, device: str = "cuda",
                       seed: int = 0) -> Dict:
    """The ``hetero:*`` row: a mode-pinned array against one chip.

    The interleaved KAN/MLP stream of the ``sched:`` row, served twice
    under mode-affinity: one reconfigurable chip per workload, which
    groups same-mode work to amortize its flips, and a ``devices``-chip
    hetero array per workload, whose pins (``SchedContext.
    pinned_modes``) stop the grouping and leave no flip to pay --
    reconfiguration exactly 0 and queue wait no longer.  Both bitwise
    the single-request single-device answers.
    """
    models = {a: VIKIN_ARCHS[a] for a in archs}
    params = {a: seeded_params(m, seed) for a, m in models.items()}
    devs = array_devices(devices, device)
    rng = np.random.default_rng(seed)
    stream = [(archs[i % len(archs)],
               rng.random(models[archs[i % len(archs)]].sizes[0],
                          dtype=np.float32))
              for i in range(n_requests)]
    singles: Dict[int, np.ndarray] = {}
    for a in archs:
        eng = Engine(VikinBackend(models[a], params[a], device=devs[0]),
                     n_slots=n_slots)
        for i, (arch, x) in enumerate(stream):
            if arch == a:
                rid = eng.submit(x)
                singles[i] = eng.run_until_done()[rid]

    def serve(make_backend) -> Dict:
        eng = Engine(MultiWorkloadBackend({a: make_backend(a)
                                           for a in archs}),
                     n_slots=n_slots, policy="mode-affinity")
        rids = [eng.submit(x, workload=a) for a, x in stream]
        out = eng.run_until_done()
        s = eng.stats
        return {
            "requests": int(s["served"]),
            "batches": int(s["ticks"]),
            "bitwise_identical_to_single": all(
                np.array_equal(out[rid], singles[i])
                for i, rid in enumerate(rids)),
            "sim_cycles_per_req": s["sim_cycles"] / max(s["served"], 1),
            "reconfig_cycles": s["reconfig_cycles"],
            "mode_switches": int(s["mode_switches"]),
            "p95_queue_wait_sim_s": s.get("p95_queue_wait_sim_s", 0.0),
        }

    affinity = serve(lambda a: VikinBackend(models[a], params[a],
                                            device=devs[0]))
    hetero = serve(lambda a: HeteroVikinBackend(models[a], params[a],
                                                devices=devs))
    pins = VikinArray(hw=VikinHW(), n_chips=devices,
                      plan="hetero").resolved_pins()
    return {
        "archs": list(archs),
        "requests": n_requests,
        "n_slots": n_slots,
        "devices": devices,
        "device": device_tag(devs[0]),
        "device_list": [str(d) for d in devs],
        "mode_pins": [m.value for m in pins],
        "affinity_single_chip": affinity,
        "hetero_pinned": hetero,
        "bitwise_identical": (affinity["bitwise_identical_to_single"]
                              and hetero["bitwise_identical_to_single"]),
        "no_added_batching_delay": bool(
            hetero["p95_queue_wait_sim_s"]
            <= affinity["p95_queue_wait_sim_s"] + 1e-12),
        "reconfig_cycles_affinity": affinity["reconfig_cycles"],
        "reconfig_cycles_hetero": hetero["reconfig_cycles"],
    }


def _served_mse(model, params, masks, val_x, val_y, *, n_slots: int,
                device: str, precision: str = "f32",
                scales=None) -> Dict[str, float]:
    """Accuracy measured through the serving path: the val set submitted
    as requests, the engine's answers against the targets.
    ``dma_bytes_per_req`` is the batch-1 figure of the precision-aware
    cycle model."""
    backend = VikinBackend(model, params, device=device, masks=masks,
                           precision=precision, scales=scales)
    pred, s = _serve_stream(backend, list(val_x), n_slots)
    return {
        "val_mse": float(np.mean((pred - val_y) ** 2)),
        "sim_cycles_per_req": s["sim_cycles"] / max(s["served"], 1),
        "dma_bytes_per_req": serving_report(
            backend.layers, backend.hw, batch=1,
            precision=precision)["dma_bytes"],
    }


def _train_and_calibrate(arch: str, steps: int, device: str, seed: int):
    """Train ``arch`` on its teacher task, then calibrate its masks (and
    int8 scales) from the first 256 training inputs: (model, data,
    trained params on the host, masks, scales)."""
    model = VIKIN_ARCHS[arch]
    data = task_for_model(model, seed=seed)
    trained = StackTrainer(model, data, StackTrainerConfig(
        steps=steps, batch_size=64, seed=seed, log_every=max(1, steps),
        device=device)).run()
    params = [{k: host_f32(v) for k, v in p.items()}
              for p in trained["params"]]
    calib_x = data["train_x"][:256]
    rate = model.pattern_rate or 0.5
    sp = calibrate_stack(params, model, calib_x,
                         keep_per_group=keep_per_group_for_rate(rate))
    scales = calibrate_scales(params, model, calib_x)
    return model, data, params, sp, scales


def trained_dense_vs_sparse(arch: str = TRAINED_ARCH, *, steps: int = 150,
                            n_val: int = 64, n_slots: int = 8,
                            device: str = "cuda", seed: int = 0) -> Dict:
    """The ``trained:*`` row: train, calibrate, then serve the same stack
    dense and two-stage sparse -- the paper's cycle speedup at a small
    accuracy cost, measured through the engine."""
    model, data, params, sp, _ = _train_and_calibrate(arch, steps, device,
                                                      seed)
    dense_model = dataclasses.replace(model, pattern_rate=0.0)
    val_x, val_y = data["val_x"][:n_val], data["val_y"][:n_val]
    dense = _served_mse(dense_model, params, None, val_x, val_y,
                        n_slots=n_slots, device=device)
    sparse = _served_mse(dense_model, params, list(sp.masks), val_x, val_y,
                         n_slots=n_slots, device=device)
    return {
        "arch": arch, "task": data["task"], "train_steps": steps,
        "device": device_tag(resolve_device(device)),
        "pattern_rate": model.pattern_rate or 0.5,
        "mask_keep_rates": sp.summary()["keep_rates"],
        "dense": dense, "sparse": sparse,
        "cycle_speedup": (dense["sim_cycles_per_req"]
                          / max(sparse["sim_cycles_per_req"], 1e-9)),
        "mse_ratio": sparse["val_mse"] / max(dense["val_mse"], 1e-12),
    }


def quant_dense_vs_int8(arch: str = QUANT_ARCH, *, steps: int = 150,
                        n_val: int = 64, n_slots: int = 8,
                        device: str = "cuda", seed: int = 0) -> Dict:
    """The ``quant:*`` row: the trained stack served dense at f32 and
    two-stage sparse at int8 (masks and scales from one calibration
    batch): served mse ratio against ``QUANT_MSE_RATIO_BOUND``, cycles,
    the precision-aware DMA bytes, and int8 batched == single, bitwise."""
    model, data, params, sp, scales = _train_and_calibrate(arch, steps,
                                                           device, seed)
    dense_model = dataclasses.replace(model, pattern_rate=0.0)
    val_x, val_y = data["val_x"][:n_val], data["val_y"][:n_val]
    masks = list(sp.masks)
    dense = _served_mse(dense_model, params, None, val_x, val_y,
                        n_slots=n_slots, device=device)
    int8 = _served_mse(dense_model, params, masks, val_x, val_y,
                       n_slots=n_slots, device=device, precision="int8",
                       scales=scales)

    def backend():
        return VikinBackend(dense_model, params, device=device, masks=masks,
                            precision="int8", scales=scales)

    n_chk = min(8, n_val)
    batched, _ = _serve_stream(backend(), list(val_x[:n_chk]), n_slots)
    singles = [_serve_stream(backend(), [val_x[i]], 1)[0][0]
               for i in range(n_chk)]
    mse_ratio = int8["val_mse"] / max(dense["val_mse"], 1e-12)
    return {
        "arch": arch, "task": data["task"], "train_steps": steps,
        "device": device_tag(resolve_device(device)),
        "pattern_rate": model.pattern_rate or 0.5,
        "mask_keep_rates": sp.summary()["keep_rates"],
        "dense": dense, "int8": int8,
        "cycle_speedup": (dense["sim_cycles_per_req"]
                          / max(int8["sim_cycles_per_req"], 1e-9)),
        "dma_ratio": (int8["dma_bytes_per_req"]
                      / max(dense["dma_bytes_per_req"], 1e-9)),
        "mse_ratio": mse_ratio,
        "mse_ratio_bound": QUANT_MSE_RATIO_BOUND,
        "mse_within_bound": bool(mse_ratio <= QUANT_MSE_RATIO_BOUND),
        "batched_equals_single": all(
            np.array_equal(batched[i], singles[i]) for i in range(n_chk)),
    }


def run(device: str = "cuda", out: Optional[str | Path] = None, *,
        n_requests: int = 32, n_slots: int = 8, seed: int = 0,
        devices: int = DEVICES, train_steps: int = 150,
        families: Sequence[str] = FAMILIES) -> Dict[str, Dict]:
    """Emit the rows of ``families`` (default every one), merged into
    ``out``."""
    unknown = sorted(set(families) - set(FAMILIES))
    if unknown:
        raise ValueError(f"unknown row families {unknown}; choose from "
                         f"{list(FAMILIES)}")
    kw = dict(n_requests=n_requests, n_slots=n_slots, device=device,
              seed=seed)
    rows: Dict[str, Dict] = {}
    if "burst" in families:
        rows.update({a: serve_burst(a, **kw) for a in ARCHS})
    if "sched" in families:
        rows[f"sched:{'+'.join(SCHED_ARCHS)}"] = sched_fifo_vs_affinity(
            SCHED_ARCHS, **kw)
    if "kanffn" in families:
        rows[f"kanffn:{KANFFN_ARCH}"] = kanffn_dense_vs_kan(device=device,
                                                            seed=seed)
    if "sharded" in families:
        for a in SHARDED_ARCHS:
            rows[f"sharded:{a}"] = sharded_single_vs_multi(
                a, devices=devices, **kw)
    if "pipe" in families:
        rows[f"pipe:{PIPE_ARCH}"] = pipeline_vs_data(devices=devices, **kw)
    if "hetero" in families:
        rows[f"hetero:{'+'.join(SCHED_ARCHS)}"] = hetero_vs_affinity(
            devices=devices, **kw)
    tkw = dict(steps=train_steps, n_slots=n_slots, device=device, seed=seed)
    if "trained" in families:
        rows[f"trained:{TRAINED_ARCH}"] = trained_dense_vs_sparse(**tkw)
    if "quant" in families:
        rows[f"quant:{QUANT_ARCH}"] = quant_dense_vs_int8(**tkw)
    path = merge_rows(rows, out)
    for a, r in rows.items():
        if a.startswith("sched:"):
            f, m = r["policies"]["fifo"], r["policies"]["mode-affinity"]
            print(f"{a}: fifo {f['reconfig_cycles']:.0f} reconfig cyc / "
                  f"{f['sim_cycles_per_req']:.0f} cyc/req -> mode-affinity "
                  f"{m['reconfig_cycles']:.0f} / "
                  f"{m['sim_cycles_per_req']:.0f} "
                  f"({r['reconfig_reduction']:.1f}x fewer reconfig cycles, "
                  f"bitwise_identical={r['bitwise_identical']})")
            continue
        if a.startswith("kanffn:"):
            print(f"{a}: {r['kanffn']['sim_cycles_per_req']:.1f} sim cyc/req "
                  f"vs the dense twin's "
                  f"{r['dense_mlp']['sim_cycles_per_req']:.1f} (cycle ratio "
                  f"{r['cycle_ratio']:.4f}, dma ratio {r['dma_ratio']:.4f}), "
                  f"batched_equals_single={r['batched_equals_single']}")
            continue
        if a.startswith("sharded:"):
            print(f"{a}: {r['device_list']}, bitwise_identical="
                  f"{r['bitwise_identical']}, "
                  f"{r['single']['sim_cycles_per_req']:.0f} -> "
                  f"{r['multi']['sim_cycles_per_req']:.0f} cyc/req "
                  f"({r['array_cycle_speedup']:.2f}x, comm "
                  f"{r['multi']['comm_cycles_per_req']:.0f} cyc/req)")
            continue
        if a.startswith("pipe:"):
            s1 = r["sweep"][0]
            print(f"{a}: {r['device_list']} / {r['n_stages']} stages, "
                  f"bitwise_identical={r['bitwise_identical']}; batch 1: "
                  f"data {s1['data_cycles']:.0f} -> pipeline "
                  f"{s1['pipeline_cycles']:.0f} cyc, crossover at batch "
                  f"{r['crossover_batch']}, bubble {r['bubble_cycles']:.0f} "
                  f"<= bound {r['bubble_bound_cycles']:.0f}")
            continue
        if a.startswith("hetero:"):
            print(f"{a}: {r['device_list']} pinned {r['mode_pins']}, "
                  f"bitwise_identical={r['bitwise_identical']}; reconfig "
                  f"{r['reconfig_cycles_affinity']:.0f} cyc (affinity, 1 "
                  f"chip) -> {r['reconfig_cycles_hetero']:.0f} cyc (hetero), "
                  f"no_added_batching_delay={r['no_added_batching_delay']}")
            continue
        if a.startswith("trained:"):
            print(f"{a}: dense mse {r['dense']['val_mse']:.5f} / "
                  f"{r['dense']['sim_cycles_per_req']:.0f} cyc -> sparse mse "
                  f"{r['sparse']['val_mse']:.5f} / "
                  f"{r['sparse']['sim_cycles_per_req']:.0f} cyc "
                  f"({r['cycle_speedup']:.2f}x cycles, "
                  f"{r['mse_ratio']:.3f}x mse)")
            continue
        if a.startswith("quant:"):
            print(f"{a}: dense-f32 mse {r['dense']['val_mse']:.5f} / "
                  f"{r['dense']['dma_bytes_per_req']:.0f} B -> sparse-int8 "
                  f"mse {r['int8']['val_mse']:.5f} / "
                  f"{r['int8']['dma_bytes_per_req']:.0f} B "
                  f"({r['dma_ratio']:.2f}x dma bytes, {r['mse_ratio']:.3f}x "
                  f"mse <= bound {r['mse_ratio_bound']}, "
                  f"batched_equals_single={r['batched_equals_single']})")
            continue
        print(f"{a}: {r['requests']} requests in {r['batches']} batches, "
              f"wall {r['wall_rps']:.1f} req/s, "
              f"{r['sim_cycles_per_req']:.1f} sim cyc/req, sim "
              f"{r['sim_rps']:.0f} req/s, {r['mode_switches']} mode "
              f"switches")
    print(f"wrote {path} ({device_tag(resolve_device(device))})")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    ap.add_argument("--out", default=None,
                    help=f"JSON output path (default {DEFAULT_OUT})")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=DEVICES,
                    help="chips of the sharded:, pipe: and hetero: rows "
                         "(logical chips on one card, or on the host)")
    ap.add_argument("--train-steps", type=int, default=150,
                    help="training steps of the trained: and quant: rows")
    ap.add_argument("--families", default=",".join(FAMILIES),
                    help=f"comma list of row families to emit, of "
                         f"{','.join(FAMILIES)}")
    args = ap.parse_args()
    run(args.device, args.out, n_requests=args.requests,
        n_slots=args.slots, seed=args.seed, devices=args.devices,
        train_steps=args.train_steps,
        families=[f.strip() for f in args.families.split(",") if f.strip()])


if __name__ == "__main__":
    main()
