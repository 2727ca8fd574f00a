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
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.vikin_models import VIKIN_ARCHS
from repro_torch.models.ffn import vikin_stack_init
from repro_torch.runtime.backends import MultiWorkloadBackend, VikinBackend
from repro_torch.runtime.server import Engine


def make_vikin_backend(model: Any, device: str, seed: int = 0) -> VikinBackend:
    """A backend serving ``model`` with weights drawn from ``seed``."""
    params = vikin_stack_init(model, torch.Generator().manual_seed(seed))
    backend = VikinBackend(model, params, device=device)
    plan = backend.plan.summary()
    print(f"arch {model.name}: layers={list(model.layer_kinds)} "
          f"sizes={list(model.sizes)} pattern_rate={model.pattern_rate}")
    print(f"mode plan: {plan['segments']} "
          f"({plan['n_switches']} switches, "
          f"{plan['reconfig_cycles']} reconfig cycles/inference)")
    return backend


def make_engine(models: Sequence[Any], *, slots: int, policy: str,
                device: str, seed: int = 0) -> Engine:
    """One engine over one backend, or a MultiWorkloadBackend for several."""
    backends = {m.name: make_vikin_backend(m, device, seed) for m in models}
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
    args = ap.parse_args(argv)
    models = parse_archs(args.arch)
    eng = make_engine(models, slots=args.slots, policy=args.policy,
                      device=args.device)
    rids = submit_burst(eng, models, args.requests)
    out = eng.run_until_done()
    print_report(eng, out, rids)
    return eng


if __name__ == "__main__":
    main()
