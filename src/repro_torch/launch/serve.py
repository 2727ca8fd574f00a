"""Serving launcher for ``vikin-*`` KAN/MLP stacks and decoder-only
transformers on a torch device.

Counterpart of ``repro/launch/serve.py``: random weights from a seed,
simulated VIKIN cycles reported next to wall-clock.  Runs on the GPU by
default:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vikin-mixed \
      --requests 8 --slots 4

A comma list of archs serves several workloads from one engine process
(runtime/backends.MultiWorkloadBackend) under a mode-aware batch policy;
requests are submitted round-robin across the archs:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch vikin-kan2,vikin-mlp3,vikin-mixed --requests 12 --slots 4

``--device cpu`` runs the plain PyTorch versions of the kernels instead.
With ``REPRO_TORCH_AUTOTUNE=1`` the launcher first searches the knobs of
every matmul and KAN layer it serves, at every bucket up to ``--slots``,
and caches them (``kernels/autotune.tune_pattern_matmul``,
``tune_kan_fused``); the served forwards then read them from the cache.
``--precision bf16`` serves the stack in bf16 (params cast once, f32
accumulation, f32 answers) through the bf16 kernels; ``--precision int8``
serves the post-training quantized stack through the int8 kernels, with
scales calibrated from a seeded batch, or restored with the weights and
masks by ``--ckpt DIR`` or ``--ckpt-dir DIR`` (a checkpoint in the
reference's layout; at bf16 its f32 params are cast).  ``--scale
smoke|full`` is the reference's flag; the paper models are already
small, so it changes nothing for vikin archs:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vikin-mixed \
      --precision int8 --requests 8

``--trace FILE`` replays an arrival trace (``python -m
repro_torch.runtime.loadgen``) open-loop on the simulated VIKIN clock
instead of serving a closed burst; ``--max-queue N`` bounds each workload
queue, ``--admission reject|shed`` says what a full queue does, and
``--drop-expired`` sheds queued requests whose deadline has passed:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vikin-mlp3 \
      --trace /tmp/t.json --max-queue 16 --admission shed --drop-expired

``--devices N`` serves each vikin workload over an N-chip array
(``runtime/sharded``); ``--array-plan`` picks how the stack maps onto the
chips: ``data`` (default) splits request rows over replicated stacks,
``pipeline`` stages the layers across chips (``--stage-map 2,1`` = layers
per stage), ``hetero`` pins each chip to one interconnect mode
(``--stage-map kan,kan,mlp,mlp``) so reconfiguration cycles drop to 0.
Served answers are bitwise those of ``--devices 1`` under every plan.
``N`` takes the first N cards; with ``--device cpu`` it is N logical
chips on the host; a comma list of devices (``cuda:0,cuda:0,cuda:0,
cuda:0``) serves logical chips on one card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vikin-mixed \
      --devices 4 --array-plan pipeline --device cpu

A transformer arch (``configs/registry``: the eight decoder-only zoo
archs -- MoE, RG-LRU and xLSTM ones included -- and the KAN-FFN hybrids
``qwen2-0.5b-kanffn`` and ``kanffn-ci``; the encoder-decoder and
frontend archs are refused, as the reference refuses them) serves
greedy decode through ``runtime/server.Server``: ``--requests`` seeded
prompts of 3-15 tokens, ``--new-tokens`` each, on ``--slots`` cache
lanes (KV caches and recurrent states) of ``--max-len`` positions.  ``--scale smoke`` (the default, as in the
reference) serves the arch's ``reduce()``d width; ``--scale full`` the
registry's.  A KAN-FFN hybrid's "kan" layers run the fused KAN and
pattern-matmul kernels; ``--precision bf16`` casts its params once
(``f32`` keeps the arch's dtype, bf16 for ``qwen2-0.5b-kanffn`` at full
scale).  ``--ckpt-dir`` restores the params tree.  The weights are drawn
from a ``torch.Generator`` at seed 0, not the reference's ``jax.random``
draws, so the tokens differ from the reference launcher's; the
simulated cycles do not:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen2-0.5b-kanffn --scale full --precision bf16 --requests 8
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import (
    latest_step,
    restore_checkpoint,
    restore_masks,
    restore_scales,
)
from repro_torch.configs.registry import get_serving_config
from repro_torch.core.calibrate import calibrate_scales
from repro_torch.core.kan import KANLayer
from repro_torch.core.quant import QuantKANLayer, QuantPatternLinear
from repro_torch.kernels import autotune
from repro_torch.launch.mesh import DeviceSpec
from repro_torch.models import transformer as T
from repro_torch.models.ffn import PatternLinear, vikin_stack_init
from repro_torch.runtime.backends import (
    MultiWorkloadBackend,
    VikinBackend,
    needs_modality_inputs,
)
from repro_torch.runtime.loadgen import Trace, replay
from repro_torch.runtime.server import Engine, Server
from repro_torch.runtime.sharded import make_array_backend


def make_vikin_backend(model: Any, device: str, seed: int = 0, *,
                       precision: str = "f32",
                       ckpt: Optional[str] = None,
                       devices: DeviceSpec = 1, plan: str = "data",
                       stage_map: Optional[Sequence[int]] = None,
                       mode_pins: Optional[Sequence[str]] = None
                       ) -> VikinBackend:
    """A backend serving ``model`` at ``precision``.

    Weights are drawn from ``seed``, or restored from ``ckpt`` with the
    masks and int8 scales saved beside them (bf16 casts the f32 params and
    needs no scales).  At int8 without a checkpoint, scales are calibrated
    on the CPU from a seed-0 batch like the features ``submit_burst``
    sends.  More than one device (a count, or a device list) serves the
    array backend of ``plan`` (``runtime/sharded.make_array_backend``);
    its refusals are ``SystemExit``s.
    """
    params = vikin_stack_init(model, torch.Generator().manual_seed(seed))
    masks = scales = None
    if ckpt:
        params, step, extra = restore_checkpoint(ckpt, params)
        masks = restore_masks(ckpt)
        scales = restore_scales(ckpt)
        print(f"restored {model.name} from {ckpt} step {step}")
        if extra:
            print(f"  trained on task={extra.get('task')} "
                  f"pattern_rate={extra.get('pattern_rate')} "
                  f"val_dense={extra.get('val_dense')} "
                  f"val_sparse={extra.get('val_sparse')}")
        if masks is not None:
            kept = [None if m is None else f"{m.n_keep}/{m.n}"
                    for m in masks]
            print(f"  restored per-layer masks (kept): {kept}")
        if precision == "int8" and scales is None:
            raise SystemExit(
                f"--precision int8 needs calibrated scales, but {ckpt} has "
                f"no scales.npz; re-export it with `python -m "
                f"repro_torch.launch.train` (scales are saved beside the "
                f"masks)")
    elif precision == "int8":
        rng = np.random.default_rng(0)
        calib_x = rng.random((256, model.sizes[0])).astype(np.float32)
        scales = calibrate_scales(params, model, calib_x)
        print(f"no checkpoint: calibrated int8 scales from a synthetic "
              f"batch (x={scales.summary()['x']})")
    n_dev = devices if isinstance(devices, int) else len(devices)
    if n_dev > 1:
        try:
            backend: VikinBackend = make_array_backend(
                model, params, device=device, devices=devices, plan=plan,
                stage_map=stage_map, mode_pins=mode_pins, masks=masks,
                precision=precision, scales=scales)
        except ValueError as e:
            raise SystemExit(str(e))
        print_array(backend, plan)
    else:
        backend = VikinBackend(model, params, device=device, masks=masks,
                               precision=precision, scales=scales)
    if precision != "f32":
        print(f"serving precision: {precision} "
              f"(f32 accumulation, dtype-aware DMA model)")
    plan = backend.plan.summary()
    print(f"arch {model.name}: layers={list(model.layer_kinds)} "
          f"sizes={list(model.sizes)} pattern_rate={model.pattern_rate}")
    print(f"mode plan: {plan['segments']} "
          f"({plan['n_switches']} switches, "
          f"{plan['reconfig_cycles']} reconfig cycles/inference)")
    return backend


def print_array(backend: Any, plan: str) -> None:
    """One line saying how an array backend maps onto its chips."""
    devs = [str(d) for d in backend.devices]
    if plan == "data":
        print(f"sharded serving: {len(devs)} devices {devs}, per-shard "
              f"bucket >= {backend.shard_bucket(1)}, one stack per distinct "
              f"device ({len(backend.stacks())})")
    elif plan == "pipeline":
        stages = [(lo, hi) for lo, hi, _ in backend._stage_ranges()]
        print(f"pipeline serving: {len(devs)} chips {devs}, {len(stages)} "
              f"layer stages {stages}")
    else:
        pins = [m.value for m in backend.array.resolved_pins()]
        print(f"hetero serving: {len(devs)} chips {devs} pinned {pins} "
              f"(reconfig cycles pinned to 0)")


def tune_layers(backends: Sequence[VikinBackend], slots: int) -> None:
    """Search and cache the knobs of every matmul and KAN layer
    ``backends`` serve, at every bucket a batch of up to ``slots``
    requests pads to, on seeded inputs of the layer's shape.  Run before
    serving: the kernel wrappers never search inside a forward."""
    gen = torch.Generator().manual_seed(0)
    for be in backends:
        # the rows one stack sees: a data plan's per-shard bucket
        bucket = getattr(be, "shard_bucket", be.bucket)
        buckets = []
        b = bucket(1)
        while b <= bucket(slots):
            buckets.append(b)
            b *= 2
        for layer in [la for st in be.stacks() for la in st.layers]:
            for m in buckets:
                if isinstance(layer, (KANLayer, QuantKANLayer)):
                    n_in = layer.cfg.n_in
                    if isinstance(layer, QuantKANLayer):
                        w = layer.wt_q
                        x = torch.randint(-127, 128, (m, n_in),
                                          generator=gen, dtype=torch.int8)
                        best = autotune.tune_kan_fused(
                            x.to(w.device), w, layer.cfg.spec, layer.kb,
                            slot_scales=layer.slot_scales,
                            x_scale=layer.x_scale)
                    else:
                        w = layer.wt
                        x = torch.rand((m, n_in), generator=gen)
                        best = autotune.tune_kan_fused(
                            x.to(w.device, w.dtype), w, layer.cfg.spec,
                            layer.kb)
                    print(f"tuned kan_fused_v2 {m}x{n_in}->{w.shape[1]} "
                          f"{w.dtype}: {best}")
                    continue
                if isinstance(layer, PatternLinear):
                    w = layer.w_c
                elif isinstance(layer, QuantPatternLinear):
                    w = layer.w_q_c
                else:
                    continue
                if w.dtype == torch.int8:
                    x = torch.randint(-127, 128, (m, w.shape[0]),
                                      generator=gen, dtype=torch.int8)
                    best = autotune.tune_pattern_matmul(x.to(w.device), w)
                else:
                    x = torch.rand((m, w.shape[0]), generator=gen)
                    best = autotune.tune_pattern_matmul(
                        x.to(w.device, w.dtype), w, layer.b, act=layer.act)
                print(f"tuned pattern_matmul {m}x{w.shape[0]}->"
                      f"{w.shape[1]} {w.dtype}: {best}")


def make_engine(models: Sequence[Any], *, slots: int, policy: str,
                device: str, seed: int = 0, precision: str = "f32",
                ckpt: Optional[str] = None, max_queue: Optional[int] = None,
                admission: str = "unbounded",
                drop_expired: bool = False, devices: DeviceSpec = 1,
                plan: str = "data",
                stage_map: Optional[Sequence[int]] = None,
                mode_pins: Optional[Sequence[str]] = None) -> Engine:
    """One engine over one backend, or a MultiWorkloadBackend for several;
    with ``REPRO_TORCH_AUTOTUNE=1`` its matmul and KAN knobs are tuned
    first.  ``max_queue``, ``admission`` and ``drop_expired`` are the
    engine's overload controls; ``devices``, ``plan``, ``stage_map`` and
    ``mode_pins`` the array's (``make_vikin_backend``); a bad combination
    is a ``SystemExit``."""
    backends = {m.name: make_vikin_backend(
        m, device, seed, precision=precision, ckpt=ckpt, devices=devices,
        plan=plan, stage_map=stage_map, mode_pins=mode_pins)
        for m in models}
    if autotune.autotune_enabled():
        tune_layers(list(backends.values()), slots)
    if len(models) > 1:
        backend: Any = MultiWorkloadBackend(backends)
        print(f"multi-workload scheduler: {sorted(backends)} "
              f"under policy {policy!r}")
    else:
        backend = next(iter(backends.values()))
    try:
        eng = Engine(backend, n_slots=slots, policy=policy,
                     max_queue=max_queue, admission=admission,
                     drop_expired=drop_expired)
    except ValueError as e:
        raise SystemExit(str(e))
    if eng.max_queue is not None:
        print(f"admission control: policy {eng.admission!r}, "
              f"max_queue {eng.max_queue} per workload"
              + (", expired queued requests dropped" if eng.drop_expired
                 else ""))
    return eng


def submit_burst(eng: Engine, models: Sequence[Any], n: int,
                 seed: int = 0) -> Dict[int, Tuple[str, np.ndarray]]:
    """Submit ``n`` seeded feature vectors, round-robin across the archs
    (the adversarial interleaving for the mode-affinity policy); returns
    rid -> (arch, payload)."""
    rng = np.random.default_rng(seed)
    multi = len(models) > 1
    rids: Dict[int, Tuple[str, np.ndarray]] = {}
    for i in range(n):
        m = models[i % len(models)]
        x = rng.random(m.sizes[0], dtype=np.float32)
        rids[eng.submit(x, workload=m.name if multi else None)] = (m.name, x)
    return rids


def print_report(eng: Engine, out: Dict[int, np.ndarray],
                 rids: Dict[int, Tuple[str, np.ndarray]]) -> None:
    for rid in sorted(out):
        y = out[rid]
        print(f"req {rid} [{rids[rid][0]}]: out[{y.shape[0]}] "
              f"mean={float(y.mean()):+.4f}")
    s, tp = eng.stats, eng.throughput()
    print(f"\n{int(s['served'])} requests in {int(s['ticks'])} batches "
          f"(policy {eng.policy.name}): "
          f"wall {s['wall_s']*1e3:.1f} ms ({tp.get('wall_rps', 0):.1f} req/s)")
    print(f"simulated VIKIN: {s['sim_cycles']:.0f} cycles, "
          f"{s['sim_latency_s']*1e6:.1f} us "
          f"({tp.get('sim_rps', 0):.0f} req/s), "
          f"{int(s['mode_switches'])} mode switches "
          f"({s['reconfig_cycles']:.0f} reconfig cycles)")
    print(f"latency: queue-wait p50 {s.get('p50_queue_wait_wall_s', 0)*1e3:.2f} ms "
          f"/ p95 {s.get('p95_queue_wait_wall_s', 0)*1e3:.2f} ms wall, "
          f"p95 {s.get('p95_queue_wait_sim_s', 0)*1e6:.1f} us sim; "
          f"service p95 {s.get('p95_service_wall_s', 0)*1e3:.2f} ms wall")
    for name, ws in sorted(eng.per_workload_stats().items()):
        print(f"  workload {name}: {int(ws.get('served', 0))} served in "
              f"{int(ws.get('batches', 0))} batches, "
              f"{ws.get('sim_cycles', 0):.0f} sim cycles, "
              f"{ws.get('reconfig_cycles', 0):.0f} reconfig cycles")
    if "chip_cycles" in s:
        print(f"  array: {s['chip_cycles']:.0f} per-chip compute cycles + "
              f"{s['comm_cycles']:.0f} scatter/gather cycles"
              + (f" ({s['bubble_cycles']:.0f} pipeline bubble cycles)"
                 if "bubble_cycles" in s else ""))


def parse_devices(value: str) -> DeviceSpec:
    """``--devices``: a chip count, or a comma list of torch devices
    (repeats allowed: ``cuda:0,cuda:0`` is two logical chips on one
    card)."""
    value = value.strip()
    if value.isdigit():
        return int(value)
    devs = [t.strip() for t in value.split(",") if t.strip()]
    if not devs:
        raise SystemExit(f"--devices {value!r}: pass a count or a comma "
                         f"list of devices")
    return devs


def parse_stage_map(args: argparse.Namespace
                    ) -> Tuple[Optional[List[int]], Optional[List[str]]]:
    """``--stage-map`` as (stage_map, mode_pins): layers per stage under
    ``--array-plan pipeline`` (``2,1``), one mode per chip under hetero
    (``kan,kan,mlp,mlp``; aliases pipeline=kan, parallel=mlp)."""
    toks = [t.strip() for t in (args.stage_map or "").split(",")
            if t.strip()]
    if not toks or args.array_plan == "data":
        return None, None
    if args.array_plan == "hetero":
        return None, toks
    try:
        return [int(t) for t in toks], None
    except ValueError:
        raise SystemExit(
            f"--stage-map {args.stage_map!r}: the pipeline plan takes a "
            f"comma list of per-stage layer counts (e.g. 2,1)")


def check_array_args(args: argparse.Namespace, n_devices: int) -> None:
    """The reference launcher's refusals of the array flags for vikin
    archs, each a ``SystemExit``."""
    if args.array_plan != "data" and n_devices <= 1:
        raise SystemExit(
            f"--array-plan {args.array_plan} needs a multi-chip array; "
            f"pass --devices N (N > 1): with --device cpu, N logical chips "
            f"on the host; on one card, a device list such as "
            f"--devices cuda:0,cuda:0")
    if args.stage_map and args.array_plan == "data":
        raise SystemExit(
            "--stage-map only applies to --array-plan pipeline (layers "
            "per stage) or hetero (mode pins per chip)")


def replay_trace(eng: Engine, path: str) -> Dict[str, object]:
    """Open-loop replay of the trace file ``path`` on the simulated VIKIN
    clock: arrivals land on the trace's schedule whether or not the engine
    keeps up, so this is the overload and load-testing entry point.
    Prints the report and returns it."""
    trace = Trace.load(path)
    print(f"replaying {path}: {len(trace.events)} arrivals over "
          f"{trace.horizon_s*1e3:.3f} ms ({trace.offered_rps():.0f} req/s "
          f"offered), sha256 {trace.sha256()[:16]}...")
    rep = replay(eng, trace, mode="sim")
    print(f"\noffered {rep['offered']} -> submitted {rep['submitted']}, "
          f"completed {rep['completed']} "
          f"(rejected {rep['rejected']}, shed {rep['shed']}, "
          f"expired {rep['expired']})")
    met = rep["deadline_met"]
    print(f"throughput: offered {rep['offered_rps']:.0f} req/s, achieved "
          f"{rep['achieved_rps']:.0f} req/s, goodput "
          f"{rep['goodput_rps']:.0f} req/s"
          + (f" ({met}/{rep['completed']} met deadline, "
             f"{rep['deadline_misses']} misses)" if met is not None else ""))
    print(f"end-to-end latency (sim): p50 {rep['p50_latency_s']*1e6:.1f} / "
          f"p95 {rep['p95_latency_s']*1e6:.1f} / "
          f"p99 {rep['p99_latency_s']*1e6:.1f} us")
    print(f"queue depth high-water mark: {rep['queue_depth_hwm']}"
          + (f" (bound {eng.max_queue} "
             f"{'respected' if rep['bound_respected'] else 'EXCEEDED'})"
             if eng.max_queue is not None else " (unbounded)"))
    ov = eng.overload_stats()
    for kind in ("rejected", "shed", "expired"):
        if eng.stats[kind]:
            print(f"  {kind}: by_workload={ov[kind]['by_workload']} "
                  f"by_priority={ov[kind]['by_priority']}")
    if rep["incomplete"]:
        print("WARNING: replay ended with work still in flight "
              "(max_ticks or stalled admission)")
    return rep


def resolve_archs(arch: str) -> Tuple[str, List[Any]]:
    """(family, configs) of a ``--arch`` value: "vikin" and one or more
    paper-model configs, or "transformer" and one ``ArchConfig``."""
    names = [a.strip() for a in arch.split(",") if a.strip()]
    if not names:
        raise SystemExit("--arch got no arch ids; pass one id or a comma "
                         "list like vikin-kan2,vikin-mlp3")
    try:
        resolved = [get_serving_config(n) for n in names]
    except KeyError as e:
        raise SystemExit(str(e.args[0]))
    families = {fam for fam, _ in resolved}
    if len(names) > 1 and families != {"vikin"}:
        raise SystemExit(
            f"multi-workload serving (--arch a,b,c) is vikin-only "
            f"(runtime/scheduler.py); got families {sorted(families)}. "
            f"Serve one transformer arch at a time")
    return resolved[0][0], [cfg for _, cfg in resolved]


def parse_archs(arch: str) -> List[Any]:
    """The paper-model configs of a ``--arch`` value of ``vikin-*`` ids."""
    family, models = resolve_archs(arch)
    if family != "vikin":
        raise SystemExit(f"{arch!r} is a transformer arch; pass vikin-* ids")
    return models


def check_transformer_args(args: argparse.Namespace, cfg: Any) -> None:
    """The reference launcher's refusals for a transformer arch, each a
    ``SystemExit``."""
    why = needs_modality_inputs(cfg)
    if why is not None:
        raise SystemExit(f"{why}; serve a decoder-only arch or a vikin-* "
                         f"workload")
    if args.trace:
        raise SystemExit(
            f"--trace is vikin-only (runtime/loadgen replays on the "
            f"simulated VIKIN clock); {args.arch!r} has no simulated "
            f"cycle model to replay against")
    if args.max_queue is not None or args.admission != "unbounded":
        raise SystemExit(
            "--max-queue/--admission are vikin-only here; the "
            "transformer Server keeps the unbounded path")
    if parse_devices(args.devices) != 1:
        raise SystemExit(
            f"--devices is vikin-only (runtime/sharded); serving "
            f"{args.arch!r} would silently run single-device. Drop the flag "
            f"or serve a vikin-* workload")
    if args.array_plan != "data" or args.stage_map:
        raise SystemExit(
            "--array-plan/--stage-map are vikin-only (runtime/sharded); "
            "serve a vikin-* workload")
    if args.precision != "f32":
        # kan-ffn transformers serve bf16 through the backend's cast;
        # int8 stays vikin-only (core/quant)
        if cfg.ffn_kinds is None:
            raise SystemExit(
                f"--precision is vikin/kan-ffn-only; plain arch "
                f"{args.arch!r} would silently serve f32 anyway")
        if args.precision == "int8":
            raise SystemExit(
                "--precision int8 is vikin-only (core/quant path); "
                "kan-ffn transformers serve f32 or bf16")


def serve_transformer(args: argparse.Namespace, cfg: Any) -> Server:
    """Serve ``--requests`` seeded prompts of one transformer arch and
    print the tokens, the engine's stats and, for a KAN-FFN hybrid, its
    mode plan and simulated VIKIN cycles."""
    check_transformer_args(args, cfg)
    if args.scale == "smoke":
        cfg = cfg.reduce()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        params, step, _ = restore_checkpoint(args.ckpt_dir,
                                             {"params": params})
        params = params["params"]
        print(f"restored params from step {step}")
    kanffn = cfg.ffn_kinds is not None
    srv = Server(cfg, params, n_slots=args.slots, max_len=args.max_len,
                 precision=args.precision, device=args.device)
    if kanffn:
        plan = srv.backend.plan.summary()
        print(f"arch {cfg.name}: kan-ffn hybrid, ffn_kinds="
              f"{list(cfg.ffn_kinds)} device={srv.backend.device} "
              f"precision={args.precision}")
        print(f"mode plan: {plan['segments']} "
              f"({plan['n_switches']} switches, "
              f"{plan['reconfig_cycles']} reconfig cycles/instance)")
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        n = int(rng.integers(3, 16))
        srv.submit(rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                   max_new_tokens=args.new_tokens)
    out = srv.run_until_done()
    for rid, toks in sorted(out.items()):
        print(f"req {rid}: {toks}")
    s = srv.stats
    print(f"\n{int(s['served'])} requests, {int(s['ticks'])} ticks, "
          f"wall {s['wall_s']:.2f} s")
    if kanffn:
        print(f"simulated VIKIN: {s['sim_cycles']:.0f} cycles, "
              f"{s['sim_latency_s']*1e6:.1f} us, "
              f"{int(s['mode_switches'])} mode switches "
              f"({s['reconfig_cycles']:.0f} reconfig cycles)")
    return srv


def main(argv: Optional[Sequence[str]] = None) -> Engine:
    ap = argparse.ArgumentParser(
        epilog="Weights are drawn from a torch.Generator at seed 0: not "
               "the reference's jax.random draws, so served answers and "
               "tokens differ from its launcher's (simulated cycles do "
               "not).")
    ap.add_argument("--arch", required=True,
                    help="one arch id (vikin-*, a transformer or a kan-ffn "
                         "hybrid), or a comma list of vikin-* ids served "
                         "together by the multi-workload scheduler")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=12,
                    help="transformer archs: tokens generated a request")
    ap.add_argument("--max-len", type=int, default=128,
                    help="transformer archs: KV-cache positions a slot")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--policy", default="mode-affinity",
                    choices=["fifo", "mode-affinity"],
                    help="batch-formation policy (runtime/scheduler.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--precision", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="served numerics: bf16 casts params and "
                         "activations (f32 accumulation; vikin answers "
                         "f32); int8 is the post-training quantized path "
                         "(core/quant.py), vikin archs only; kan-ffn "
                         "transformers take f32 (the arch's dtype) or bf16")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"],
                    help="smoke applies each config's reduce(), as the "
                         "reference does; the paper models are already "
                         "small, so vikin archs serve the same either way")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory of the reference's layout: "
                         "params, masks and int8 scales are restored")
    ap.add_argument("--ckpt-dir", default=None,
                    help="vikin archs: the same as --ckpt (launch/train.py "
                         "writes through this spelling); transformer "
                         "archs: restore the params tree from here")
    ap.add_argument("--trace", default=None,
                    help="replay this arrival-trace JSON (python -m "
                         "repro_torch.runtime.loadgen) open-loop on the "
                         "simulated clock instead of a closed burst")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound each workload queue at N pending requests "
                         "(admission control)")
    ap.add_argument("--admission", default="unbounded",
                    choices=["unbounded", "reject", "shed"],
                    help="full-queue policy: reject the newcomer, or shed "
                         "the lowest-priority queued request (needs "
                         "--max-queue)")
    ap.add_argument("--drop-expired", action="store_true",
                    help="shed queued requests whose deadline already "
                         "passed instead of serving them dead")
    ap.add_argument("--devices", default="1",
                    help="vikin archs: serve over an N-chip array "
                         "(runtime/sharded; answers bitwise those of "
                         "--devices 1 under every --array-plan): N cards, "
                         "N logical chips on the host with --device cpu, "
                         "or a comma list of devices (cuda:0,cuda:0)")
    ap.add_argument("--array-plan", default="data",
                    choices=["data", "pipeline", "hetero"],
                    help="how the array maps the stack onto its chips: "
                         "data = rows split, stacks replicated; pipeline = "
                         "layer stages; hetero = chips pinned per "
                         "interconnect mode (reconfig cycles -> 0)")
    ap.add_argument("--stage-map", default=None,
                    help="pipeline: layers per stage ('2,1'); hetero: one "
                         "mode per chip ('kan,kan,mlp,mlp')")
    args = ap.parse_args(argv)
    family, models = resolve_archs(args.arch)
    if family == "transformer":
        return serve_transformer(args, models[0])
    if args.scale == "smoke":
        models = [m.reduce() for m in models]
    # either spelling restores: serving random weights because train.py's
    # --ckpt-dir was passed would be a silently wrong answer
    ckpt = args.ckpt or args.ckpt_dir
    if ckpt and len(models) > 1:
        raise SystemExit("--ckpt restores one arch; pass a single --arch")
    devices = parse_devices(args.devices)
    check_array_args(args, devices if isinstance(devices, int)
                     else len(devices))
    stage_map, mode_pins = parse_stage_map(args)
    eng = make_engine(models, slots=args.slots, policy=args.policy,
                      device=args.device, precision=args.precision,
                      ckpt=ckpt, max_queue=args.max_queue,
                      admission=args.admission,
                      drop_expired=args.drop_expired, devices=devices,
                      plan=args.array_plan, stage_map=stage_map,
                      mode_pins=mode_pins)
    if args.trace:
        replay_trace(eng, args.trace)
        return eng
    rids = submit_burst(eng, models, args.requests)
    out = eng.run_until_done()
    print_report(eng, out, rids)
    return eng


if __name__ == "__main__":
    main()
