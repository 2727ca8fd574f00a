"""Serving bench of the PyTorch/CUDA port: the VIKIN backend under a burst.

Counterpart of the rows of ``benchmarks/serving_bench.py`` that need
nothing unported:

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
  batched greedy decode equals single-request decode, token for token.

All serve f32 from random weights drawn from ``--seed``.  The simulated
fields depend on the cycle model and the scheduler alone, so they equal
the JAX package's committed rows exactly; ``wall_*`` fields are host
clock on the device named in each row.  The JAX package's ``trained:``,
``quant:``, ``sharded:``, ``pipe:`` and ``hetero:`` rows wait for their
modules.

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
from repro_torch.core.engine import serving_report
from repro_torch.kernels.autotune import device_tag
from repro_torch.models import transformer as T
from repro_torch.models.ffn import vikin_stack_init
from repro_torch.runtime.backends import (
    MultiWorkloadBackend,
    TransformerBackend,
    VikinBackend,
)
from repro_torch.runtime.server import Engine
from repro_torch.utils import resolve_device

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_OUT = ROOT / "chiprun_out" / "serving_bench.json"
ARCHS = ("vikin-kan2", "vikin-mlp3", "vikin-mixed")
SCHED_ARCHS = ("vikin-kan2", "vikin-mlp3")
KANFFN_ARCH = "kanffn-ci"


def seeded_params(model, seed: int):
    """The stack's random weights, drawn from ``seed``."""
    return vikin_stack_init(model, torch.Generator().manual_seed(seed))


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


def run(device: str = "cuda", out: Optional[str | Path] = None, *,
        n_requests: int = 32, n_slots: int = 8, seed: int = 0
        ) -> Dict[str, Dict]:
    """Emit the burst rows, the sched row and the kanffn row, merged into
    ``out``."""
    rows: Dict[str, Dict] = {
        a: serve_burst(a, n_requests=n_requests, n_slots=n_slots,
                       device=device, seed=seed)
        for a in ARCHS}
    rows[f"sched:{'+'.join(SCHED_ARCHS)}"] = sched_fifo_vs_affinity(
        SCHED_ARCHS, n_requests=n_requests, n_slots=n_slots, device=device,
        seed=seed)
    rows[f"kanffn:{KANFFN_ARCH}"] = kanffn_dense_vs_kan(device=device,
                                                        seed=seed)
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
    args = ap.parse_args()
    run(args.device, args.out, n_requests=args.requests,
        n_slots=args.slots, seed=args.seed)


if __name__ == "__main__":
    main()
