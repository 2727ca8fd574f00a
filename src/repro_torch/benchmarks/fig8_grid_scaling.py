"""Fig. 8 on the port: accuracy scaling by grid size G (KAN-3, K=3).

Counterpart of ``benchmarks/fig8_grid_scaling.py``.  Two coupled sweeps
over G in {2, 4, 8, 16}:

  algorithm: train KAN-3 [72,32,96] at each G (Table I's ``train_model``,
             through the f32 KAN kernel and the spline-basis kernel in its
             backward on the card, with G + 3 bases a feature) -> test MSE;
  hardware : dense op count against VIKIN latency from the cycle model
             (model outputs, exact on any host).

Headline claim: G=16 costs ~3.3x the operations of G=2 but only ~1.24x
the latency on VIKIN, because zero-free sparsity keeps PE work at K+1
non-zeros per input regardless of G.  Run (with ``PYTHONPATH=src``)::

    python -m repro_torch.benchmarks.fig8_grid_scaling [--epochs N] \\
        [--device cpu] [--out-dir DIR]

It writes ``fig8.json`` into ``--out-dir``, each grid's row with the
run that trained it (``table1_models.run_record``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.benchmarks.table1_models import (
    DEFAULT_OUT_DIR,
    out_path,
    run_record,
    train_model,
)
from repro_torch.configs.vikin_models import KAN3
from repro_torch.core.engine import ModelReport, VikinHW, kan_layers, run_model
from repro_torch.core.splines import SplineSpec
from repro_torch.data.traffic import TrafficConfig, load_traffic

GRIDS = (2, 4, 8, 16)


def hardware(g: int) -> ModelReport:
    """The cycle model's report of KAN-3 at grid size ``g``."""
    return run_model(kan_layers(list(KAN3.sizes), SplineSpec(g, 3)),
                     VikinHW())


def run(epochs: int = 60, seed: int = 0,
        data_cfg: TrafficConfig = TrafficConfig(), *,
        device: str | torch.device = "cuda",
        out_dir: Optional[str | Path] = None) -> Dict:
    data = load_traffic(data_cfg)
    record = run_record(epochs, seed, data_cfg, device)
    out = {}
    base = hardware(GRIDS[0])
    for g in GRIDS:
        cfg = dataclasses.replace(KAN3, grid=g)
        _, metrics = train_model(cfg, data, epochs, seed, device=device)
        rep = hardware(g)
        out[str(g)] = {
            "mse": metrics["mse"],
            "dense_ops": rep.dense_ops,
            "ops_ratio": rep.dense_ops / base.dense_ops,
            "latency_cycles": rep.cycles,
            "latency_ratio": rep.cycles / base.cycles,
            "bound": rep.per_layer[0].bound,
            **record,
        }
        print(f"G={g:2d}: MSE={metrics['mse']:.3e} "
              f"ops {out[str(g)]['ops_ratio']:.2f}x "
              f"lat {out[str(g)]['latency_ratio']:.2f}x "
              f"({out[str(g)]['bound']}-bound; MSE on {metrics['device']})",
              flush=True)
    g16 = out["16"]
    print(f"G=16 vs G=2: {g16['ops_ratio']:.2f}x ops (paper 3.29x) at "
          f"{g16['latency_ratio']:.2f}x latency (paper 1.24x)")
    out["_summary"] = {"ops_ratio_16": g16["ops_ratio"],
                       "latency_ratio_16": g16["latency_ratio"],
                       "paper_ops": 3.29, "paper_latency": 1.24}
    path = out_path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    (path / "fig8.json").write_text(json.dumps(out, indent=1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    ap.add_argument("--out-dir", default=None,
                    help=f"output directory (default {DEFAULT_OUT_DIR})")
    args = ap.parse_args()
    run(args.epochs, args.seed, device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
