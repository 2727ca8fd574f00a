"""Quickstart: the VIKIN paper in miniature, end to end, on the port.

Counterpart of ``examples/quickstart.py``:

1. Generate the synthetic Traffic surrogate (72h -> 96h forecasting).
2. Train the paper's KAN-2 and MLP-3 benchmark models (short schedule),
   on the card by default (the KAN layer through the fused KAN kernel,
   its backward through the spline-basis kernel).
3. Deploy both on the VIKIN cycle model with two-stage sparsity and
   compare latency and energy with the edge-GPU model (Table II style);
   both sides of that comparison are model outputs.

Run::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch.benchmarks.table1_models import train_model
from repro_torch.configs.vikin_models import KAN2, MLP3
from repro_torch.core.engine import (
    EdgeGPU,
    VikinHW,
    kan_layers,
    mlp_layers,
    run_model,
)
from repro_torch.core.splines import SplineSpec
from repro_torch.data.traffic import TrafficConfig, load_traffic


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    args = ap.parse_args()

    print("=== 1. data: synthetic Traffic surrogate ===")
    data = load_traffic(TrafficConfig(n_sensors=48, n_hours=2048))
    print(f"train windows: {data['train_x'].shape}, "
          f"test: {data['test_x'].shape}")

    print("\n=== 2. train the paper's models (20 epochs) ===")
    results = {}
    for cfg in (KAN2, MLP3):
        _, m = train_model(cfg, data, epochs=20, device=args.device)
        results[cfg.name] = m
        print(f"  {cfg.name:12s} params={m['params']:6d} "
              f"MSE={m['mse']:.3e} RSE={m['rse']:.3f} ({m['device']})")

    print("\n=== 3. deploy on VIKIN (cycle model) ===")
    hw, gpu = VikinHW(), EdgeGPU()
    spec = SplineSpec(4, 3)
    kan = kan_layers([72, 96], spec, pattern_rate=0.5)
    nnz = [1.0] + results["mlp-3layer"]["nnz_rates"]
    mlp = mlp_layers([72, 304, 96], nnz, pattern_rate=0.25)
    for name, layers in (("KAN-2 (pipeline mode)", kan),
                         ("MLP-3 (parallel mode)", mlp)):
        r = run_model(layers, hw)
        g = gpu.report(layers)
        print(f"  {name}: {r.latency_s*1e6:6.2f}us on VIKIN "
              f"({r.gops_per_w:5.1f} GOPS/W) | edge GPU "
              f"{g['latency_s']*1e6:6.2f}us ({g['gops_per_w']:4.1f} GOPS/W)"
              f" -> {g['latency_s']/r.latency_s:4.2f}x speed, "
              f"{r.gops_per_w/g['gops_per_w']:4.2f}x energy")
    print("\npaper's Table II points: KAN 1.25x speed / 4.87x energy; "
          "MLP 0.72x / 2.20x")


if __name__ == "__main__":
    main()
