"""Serving launcher for ``vikin-*`` KAN/MLP stacks on a torch device.

Counterpart of the ``vikin-*`` path of ``repro/launch/serve.py``: random
weights from a seed, one inference per request, simulated VIKIN cycles
reported next to wall-clock.  Runs on the GPU by default:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vikin-mixed \
      --requests 8 --slots 4

A comma list of archs serves several workloads from one engine process
(runtime/backends.MultiWorkloadBackend) under a mode-aware batch policy;
requests are submitted round-robin across the archs:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch vikin-kan2,vikin-mlp3,vikin-mixed --requests 12 --slots 4

``--device cpu`` runs the plain PyTorch versions of the kernels instead.
``--precision int8`` serves the post-training quantized stack through the
int8 kernels, with scales calibrated from a seeded batch, or restored
with the weights and masks by ``--ckpt DIR`` (a checkpoint in the
reference's layout):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch vikin-mixed \
      --precision int8 --requests 8
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import (
    restore_checkpoint,
    restore_masks,
    restore_scales,
)
from repro_torch.configs.vikin_models import VIKIN_ARCHS
from repro_torch.core.calibrate import calibrate_scales
from repro_torch.models.ffn import vikin_stack_init
from repro_torch.runtime.backends import MultiWorkloadBackend, VikinBackend
from repro_torch.runtime.server import Engine


def make_vikin_backend(model: Any, device: str, seed: int = 0, *,
                       precision: str = "f32",
                       ckpt: Optional[str] = None) -> VikinBackend:
    """A backend serving ``model`` at ``precision``.

    Weights are drawn from ``seed``, or restored from ``ckpt`` with the
    masks and int8 scales saved beside them.  At int8 without a
    checkpoint, scales are calibrated on the CPU from a seed-0 batch like
    the features ``submit_burst`` sends.
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
                f"no scales.npz; re-export it with the reference's "
                f"launch/train.py (scales are emitted beside the masks)")
    elif precision == "int8":
        rng = np.random.default_rng(0)
        calib_x = rng.random((256, model.sizes[0])).astype(np.float32)
        scales = calibrate_scales(params, model, calib_x)
        print(f"no checkpoint: calibrated int8 scales from a synthetic "
              f"batch (x={scales.summary()['x']})")
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


def make_engine(models: Sequence[Any], *, slots: int, policy: str,
                device: str, seed: int = 0, precision: str = "f32",
                ckpt: Optional[str] = None) -> Engine:
    """One engine over one backend, or a MultiWorkloadBackend for several."""
    backends = {m.name: make_vikin_backend(m, device, seed,
                                           precision=precision, ckpt=ckpt)
                for m in models}
    if len(models) > 1:
        backend: Any = MultiWorkloadBackend(backends)
        print(f"multi-workload scheduler: {sorted(backends)} "
              f"under policy {policy!r}")
    else:
        backend = next(iter(backends.values()))
    return Engine(backend, n_slots=slots, policy=policy)


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


def parse_archs(arch: str) -> List[Any]:
    names = [a.strip() for a in arch.split(",") if a.strip()]
    if not names:
        raise SystemExit("--arch got no arch ids; pass one id or a comma "
                         "list like vikin-kan2,vikin-mlp3")
    unknown = [n for n in names if n not in VIKIN_ARCHS]
    if unknown:
        raise SystemExit(f"unknown arch {unknown[0]!r}; this launcher serves "
                         f"{sorted(VIKIN_ARCHS)}")
    return [VIKIN_ARCHS[n] for n in names]


def main(argv: Optional[Sequence[str]] = None) -> Engine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="one vikin-* id, or a comma list served together "
                         "by the multi-workload scheduler")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--policy", default="mode-affinity",
                    choices=["fifo", "mode-affinity"],
                    help="batch-formation policy (runtime/scheduler.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--precision", default="f32", choices=["f32", "int8"],
                    help="served numerics; int8 is the post-training "
                         "quantized path (core/quant.py)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory of the reference's layout: "
                         "params, masks and int8 scales are restored")
    args = ap.parse_args(argv)
    models = parse_archs(args.arch)
    if args.ckpt and len(models) > 1:
        raise SystemExit("--ckpt restores one arch; pass a single --arch")
    eng = make_engine(models, slots=args.slots, policy=args.policy,
                      device=args.device, precision=args.precision,
                      ckpt=args.ckpt)
    rids = submit_burst(eng, models, args.requests)
    out = eng.run_until_done()
    print_report(eng, out, rids)
    return eng


if __name__ == "__main__":
    main()
