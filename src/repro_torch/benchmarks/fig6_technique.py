"""Fig. 6 on the port: the performance contribution of key techniques (MLPs).

Counterpart of ``benchmarks/fig6_technique.py``.  An ablation on the VIKIN
cycle model, fed the MEASURED post-ReLU activation densities of the
trained Table I MLPs:

  baseline     : PE array only, dense (the paper's simplified VIKIN)
  +zero-skip   : TSE skips zero activations       (paper avg: 1.30x)
  +SPU-as-PE   : SPU array in accumulation mode   (paper max: 2.17x)

Every number is a cycle-model output; given the same ``table1.json`` it
equals the reference's exactly.  Run (with ``PYTHONPATH=src``)::

    python -m repro_torch.benchmarks.fig6_technique [--device cpu] \\
        [--out-dir DIR]

It reads (or first trains) Table I from ``--out-dir`` and writes
``fig6.json`` there.
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
from repro_torch.core.engine import VikinHW, mlp_layers, run_model
from repro_torch.data.traffic import TrafficConfig

SIZES = {"mlp-3layer": [72, 304, 96], "mlp-4layer": [72, 304, 304, 96]}


def run(epochs: int = 100,
        data_cfg: TrafficConfig = TrafficConfig(), *,
        device: str | torch.device = "cuda",
        out_dir: Optional[str | Path] = None) -> Dict:
    t1 = ensure_trained(epochs, data_cfg=data_cfg, device=device,
                        out_dir=out_dir)
    hw = VikinHW()
    out = {}
    for name, sizes in SIZES.items():
        nnz = [1.0] + t1[name]["nnz_rates"]      # input layer is dense
        layers = mlp_layers(sizes, nnz_rates=nnz)
        base = run_model(layers, hw, zero_free=False, pattern=False,
                         spu_as_pe=False)
        zskip = run_model(layers, hw, zero_free=True, pattern=False,
                          spu_as_pe=False)
        full = run_model(layers, hw, zero_free=True, pattern=False,
                         spu_as_pe=True)
        out[name] = {
            "baseline_cycles": base.cycles,
            "zero_skip_speedup": base.cycles / zskip.cycles,
            "spu_as_pe_speedup": base.cycles / full.cycles,
            "latency_us": full.latency_s * 1e6,
            "measured_nnz": nnz,
        }
        print(f"{name:12s} zero-skip {out[name]['zero_skip_speedup']:.2f}x  "
              f"+SPU-as-PE {out[name]['spu_as_pe_speedup']:.2f}x", flush=True)
    avg = sum(v["zero_skip_speedup"] for v in out.values()) / len(out)
    mx = max(v["spu_as_pe_speedup"] for v in out.values())
    print(f"avg zero-skip {avg:.2f}x (paper 1.30x); "
          f"max with SPU {mx:.2f}x (paper 2.17x)")
    out["_summary"] = {"avg_zero_skip": avg, "max_spu_as_pe": mx,
                       "paper_avg_zero_skip": 1.30, "paper_max_spu": 2.17}
    path = out_path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    (path / "fig6.json").write_text(json.dumps(out, indent=1))
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
