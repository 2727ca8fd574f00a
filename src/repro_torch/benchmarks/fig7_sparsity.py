"""Fig. 7 on the port: the two-stage sparsity speedup sweep.

Counterpart of ``benchmarks/fig7_sparsity.py``.  Pattern-mask sparsity
0/25/50/75% on all four Table I models; speedup relative to the
no-sparsity-support baseline (PE-only dense).  The paper's headline:
2-layer KAN reaches 2.50x, with diminishing returns where the PE/SPU
throughput mismatch bites (the model exposes the bound switch).

Every number is a cycle-model output; given the same ``table1.json`` it
equals the reference's exactly.  Run (with ``PYTHONPATH=src``)::

    python -m repro_torch.benchmarks.fig7_sparsity [--device cpu] \\
        [--out-dir DIR]

It reads (or first trains) Table I from ``--out-dir`` and writes
``fig7.json`` there.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.benchmarks.table1_models import (
    DEFAULT_OUT_DIR,
    ensure_trained,
    out_path,
)
from repro_torch.core.engine import VikinHW, kan_layers, mlp_layers, run_model
from repro_torch.core.splines import SplineSpec
from repro_torch.data.traffic import TrafficConfig

RATES = (0.0, 0.25, 0.5, 0.75)
SIZES = {
    "mlp-3layer": ("mlp", [72, 304, 96]),
    "mlp-4layer": ("mlp", [72, 304, 304, 96]),
    "kan-3layer": ("kan", [72, 32, 96]),
    "kan-2layer": ("kan", [72, 96]),
}


def run(epochs: int = 100,
        data_cfg: TrafficConfig = TrafficConfig(), *,
        device: str | torch.device = "cuda",
        out_dir: Optional[str | Path] = None) -> Dict:
    t1 = ensure_trained(epochs, data_cfg=data_cfg, device=device,
                        out_dir=out_dir)
    hw = VikinHW()
    spec = SplineSpec(4, 3)
    out = {}
    for name, (kind, sizes) in SIZES.items():
        if kind == "mlp":
            nnz = [1.0] + t1[name]["nnz_rates"]
            base = run_model(mlp_layers(sizes, nnz), hw, zero_free=False,
                             pattern=False, spu_as_pe=False)
        else:
            base = run_model(kan_layers(sizes, spec), hw, zero_free=False,
                             pattern=False)
        row = {}
        for rate in RATES:
            if kind == "mlp":
                m = run_model(mlp_layers(sizes, nnz, pattern_rate=rate), hw)
            else:
                m = run_model(kan_layers(sizes, spec, pattern_rate=rate), hw)
            row[str(rate)] = {
                "speedup": base.cycles / m.cycles,
                "bound": m.per_layer[0].bound,
            }
        out[name] = row
        s = "  ".join(f"{r}:{row[str(r)]['speedup']:.2f}x"
                      f"({row[str(r)]['bound']})" for r in RATES)
        print(f"{name:12s} {s}", flush=True)
    kan2_max = max(v["speedup"] for v in out["kan-2layer"].values())
    print(f"KAN-2 max speedup {kan2_max:.2f}x (paper up to 2.50x)")
    out["_summary"] = {"kan2_max": kan2_max, "paper_kan2_max": 2.50}
    path = out_path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    (path / "fig7.json").write_text(json.dumps(out, indent=1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=100,
                    help="Table I epochs, if its weights must be trained")
    ap.add_argument("--device", default="cuda",
                    help="device Table I trains on, if it must")
    ap.add_argument("--out-dir", default=None,
                    help=f"output directory (default {DEFAULT_OUT_DIR})")
    args = ap.parse_args()
    run(args.epochs, device=args.device, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
