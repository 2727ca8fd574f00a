"""Roofline of the VIKIN serving path from the engine cycle model.

Counterpart of the ``--engine`` half of ``benchmarks/roofline.py``: for
every servable arch -- the ``vikin-*`` paper workloads and the KAN-FFN
transformer hybrids -- one row from ``core/engine.serving_report``
against the modelled VIKIN hardware's own roofs: its 32-MAC/cycle
datapath and the shared host DMA port (``VikinArray.host_bytes_per_cycle``).
Every number is a cycle-model output (simulated VIKIN FPGA), computed on
the host: no device is measured and no TPU constant enters.  The
reference's dry-run half (HLO FLOPs and bytes against its chip's
constants) waits for the port's dry run, so ``--engine`` is the only
mode.

Run (from the repository root, with ``PYTHONPATH=src``)::

    python -m repro_torch.benchmarks.roofline --engine [--batch 8] \
        [--precision bf16] [--out PATH]

It writes the rows to ``--out`` (``chiprun_out/roofline_engine.json`` by
default) and prints the table.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.registry import KANFFN_ARCHS
from repro_torch.configs.vikin_models import VIKIN_ARCHS
from repro_torch.core.engine import VikinArray, VikinHW, serving_report
from repro_torch.runtime.backends import transformer_layer_works

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_OUT = ROOT / "chiprun_out" / "roofline_engine.json"


def _engine_layer_works(name: str):
    """(family, LayerWork list) of one servable arch."""
    if name in VIKIN_ARCHS:
        return "vikin", VIKIN_ARCHS[name].layer_works()
    return "kanffn", transformer_layer_works(KANFFN_ARCHS[name])


def engine_rows(batch: int = 1, precision: str = "f32") -> List[Dict]:
    """One roofline row per servable arch from the engine cycle model.

    ``compute_t`` is the serving report's cycles (reconfiguration
    included: it blocks the datapath); ``dma_t`` streams ``dma_bytes``
    through the host port.  ``mac_util`` is the MACs a cycle over the
    32-lane peak; the ridge point, peak over port width, is where an
    arch turns from DMA- to compute-bound.
    """
    hw = VikinHW()
    port = VikinArray().host_bytes_per_cycle
    peak = float(hw.kan_macs_per_cycle)          # == mlp_out_nodes == 32
    rows = []
    for name in [*sorted(VIKIN_ARCHS), *sorted(KANFFN_ARCHS)]:
        family, layers = _engine_layer_works(name)
        rep = serving_report(layers, hw, batch=batch, precision=precision)
        compute_t = rep["sim_cycles"] / hw.clock_hz
        dma_t = rep["dma_bytes"] / (port * hw.clock_hz)
        rows.append({
            "arch": name, "family": family, "batch": batch,
            "precision": precision, "n_layers": len(layers),
            "sim_macs": rep["sim_macs"], "sim_cycles": rep["sim_cycles"],
            "dma_bytes": rep["dma_bytes"],
            "mode_switches": rep["mode_switches"],
            "reconfig_frac": rep["reconfig_cycles"] / rep["sim_cycles"],
            "compute_t": compute_t, "dma_t": dma_t,
            "dominant": "compute" if compute_t >= dma_t else "dma",
            "step_t": max(compute_t, dma_t),
            "macs_per_byte": rep["sim_macs"] / rep["dma_bytes"],
            "ridge_macs_per_byte": peak / port,
            "mac_util": rep["sim_macs"] / (rep["sim_cycles"] * peak),
        })
    return rows


def fmt_t(t: float) -> str:
    return f"{t*1e3:9.3f}ms" if t >= 1e-4 else f"{t*1e6:9.1f}us"


def print_table(rows: Sequence[Dict]) -> None:
    hdr = (f"| {'arch':20s} | {'fam':6s} | {'compute':11s} | {'dma':11s} | "
           f"bound   | {'mac/B':6s} | {'util':5s} | {'flips':5s} |")
    print(hdr)
    print("|" + "-" * (len(hdr) - 2) + "|")
    for r in rows:
        print(f"| {r['arch']:20s} | {r['family']:6s} | "
              f"{fmt_t(r['compute_t'])} | {fmt_t(r['dma_t'])} | "
              f"{r['dominant']:7s} | {r['macs_per_byte']:6.2f} | "
              f"{r['mac_util']:5.2f} | {r['mode_switches']:5.0f} |")
    print(f"\nridge point: {rows[0]['ridge_macs_per_byte']:.2f} MACs/byte "
          f"(peak MACs/cycle over the shared host-port width)")
    worst = min(rows, key=lambda r: r["mac_util"])
    print(f"lowest MAC utilization  : {worst['arch']} "
          f"({worst['mac_util']:.2f})")


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--engine", action="store_true", required=True,
                    help="roofline the VIKIN serving path (the only mode)")
    ap.add_argument("--batch", type=int, default=1,
                    help="served batch size of the rows")
    ap.add_argument("--precision", default="f32",
                    choices=["f32", "f16", "bf16", "int8"],
                    help="served dtype of the DMA accounting")
    ap.add_argument("--out", default=None,
                    help=f"JSON output path (default {DEFAULT_OUT})")
    args = ap.parse_args(argv)
    rows = engine_rows(batch=args.batch, precision=args.precision)
    out = Path(args.out) if args.out else DEFAULT_OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    print_table(rows)
    print(f"wrote {out}")
    return rows


if __name__ == "__main__":
    main()
