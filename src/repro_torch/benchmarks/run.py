"""Benchmark aggregator of the port: one entry per paper table and figure.

Counterpart of ``benchmarks/run.py``.  Prints ``name,us_per_call,derived``
CSV: ``us_per_call`` is the modelled VIKIN latency where the artifact is
a cycle-model number, the host wall time of a training step where it is
a training benchmark, and 0 where it is neither; ``derived`` is the
headline ratio the paper claims.  The rows: Table I, Figs. 6-8 and
Table II (``repro_torch.benchmarks.table1_models`` and the rest, their
files under ``--out-dir``, reused only where the same epochs, seed,
data config and device made them), then the port's kernel bench and serving
bench (``chiprun_out/kernel_bench.json`` and ``serving_bench.json``),
and the roofline's worst cell (``roofline_worst_cell``, its step time at
the datasheet constants) when the dry run's single-pod records
(``chiprun_out/dryrun/*__single.json``, ``repro_torch.launch.dryrun``)
exist.  It writes no ``BENCH_*.json`` and nothing under
``experiments/``.

Usage (with ``PYTHONPATH=src``)::

    python -m repro_torch.benchmarks.run [--fast] [--device cpu] \\
        [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.benchmarks import (
    fig6_technique,
    fig7_sparsity,
    fig8_grid_scaling,
    kernel_bench,
    roofline,
    serving_bench,
    table1_models,
    table2_overall,
)
from repro_torch.data.traffic import TrafficConfig


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="fewer training epochs (CI-speed)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions; the kernel bench then times nothing)")
    ap.add_argument("--out-dir", default=None,
                    help=f"directory of the paper scripts' files (default "
                         f"{table1_models.DEFAULT_OUT_DIR})")
    args = ap.parse_args()
    epochs = 30 if args.fast else 100
    fig8_epochs = 20 if args.fast else 60
    dev, out_dir = args.device, args.out_dir

    rows = []

    t1 = table1_models.ensure_trained(epochs, device=dev, out_dir=out_dir)
    k3, m4 = t1["kan-3layer"], t1["mlp-4layer"]
    rows.append(("table1_kan3_mse", k3["us_per_step"],
                 f"mse={k3['mse']:.3e};params_ratio="
                 f"{k3['params']/m4['params']:.2f}"))
    rows.append(("table1_mlp4_mse", m4["us_per_step"],
                 f"mse={m4['mse']:.3e}"))

    f6 = fig6_technique.run(epochs, device=dev, out_dir=out_dir)
    rows.append(("fig6_zero_skip", f6["mlp-3layer"]["latency_us"],
                 f"avg_speedup={f6['_summary']['avg_zero_skip']:.2f}"
                 f"(paper1.30)"))
    rows.append(("fig6_spu_as_pe", f6["mlp-4layer"]["latency_us"],
                 f"max_speedup={f6['_summary']['max_spu_as_pe']:.2f}"
                 f"(paper2.17)"))

    f7 = fig7_sparsity.run(epochs, device=dev, out_dir=out_dir)
    rows.append(("fig7_two_stage", 0.0,
                 f"kan2_max={f7['_summary']['kan2_max']:.2f}(paper2.50)"))

    f8_path = table1_models.out_path(out_dir) / "fig8.json"
    f8 = json.loads(f8_path.read_text()) if f8_path.exists() else {}
    if not table1_models.made_by(
            [f8.get(str(g), {}) for g in fig8_grid_scaling.GRIDS],
            table1_models.run_record(fig8_epochs, 0, TrafficConfig(), dev)):
        f8 = fig8_grid_scaling.run(fig8_epochs, device=dev, out_dir=out_dir)
    rows.append(("fig8_grid_scaling", f8["16"]["latency_cycles"] / 115.0,
                 f"ops={f8['_summary']['ops_ratio_16']:.2f}(paper3.29);"
                 f"lat={f8['_summary']['latency_ratio_16']:.2f}(paper1.24)"))

    t2 = table2_overall.run(epochs, device=dev, out_dir=out_dir)
    k2 = t2["kan-2layer"]
    rows.append(("table2_kan_vs_gpu", k2["latency_us"],
                 f"speedup={k2['speedup_vs_gpu']:.2f}(paper1.25);"
                 f"energy={k2['energy_ratio_vs_gpu']:.2f}(paper4.87)"))
    m3 = t2["mlp-3layer"]
    rows.append(("table2_mlp_vs_gpu", m3["latency_us"],
                 f"speedup={m3['speedup_vs_gpu']:.2f}(paper0.72);"
                 f"energy={m3['energy_ratio_vs_gpu']:.2f}(paper2.20)"))

    kb = kernel_bench.run(dev)
    worst = max(r["max_err"] for section in ("spline_basis", "kan_fused",
                                             "pattern_matmul")
                for r in kb[section].values())
    rows.append(("kernels_vs_oracle", 0.0, f"worst_err={worst:.2e}"))

    # serving: the VIKIN backend under a request burst (host clock beside
    # the simulated cycles), and the fifo-vs-mode-affinity scheduler row
    sv = serving_bench.run(dev, n_requests=16 if args.fast else 32)
    for arch in ("vikin-kan2", "vikin-mixed"):
        r = sv[arch]
        rows.append((
            f"serving_{arch.replace('-', '_')}",
            r["sim_latency_s"] / max(r["requests"], 1) * 1e6,
            f"wall_rps={r['wall_rps']:.1f};"
            f"sim_cycles_per_req={r['sim_cycles_per_req']:.0f};"
            f"switches={r['mode_switches']}"))
    for key, r in sv.items():
        if key.startswith("sched:"):
            fifo = r["policies"]["fifo"]
            aff = r["policies"]["mode-affinity"]
            rows.append((
                "sched_fifo_vs_affinity",
                r["reconfig_reduction"],
                f"fifo_reconfig={fifo['reconfig_cycles']:.0f};"
                f"affinity_reconfig={aff['reconfig_cycles']:.0f};"
                f"bitwise={r['bitwise_identical']}"))

    # the roofline's worst cell, from the dry run's records if any
    if list(roofline.DEFAULT_DIR.glob("*__single.json")):
        rl = [r for r in roofline.main([]) if "error" not in r]
        if rl:
            worst_cell = min(rl, key=lambda r: r["roofline_frac"])
            rows.append((
                "roofline_worst_cell", worst_cell["step_t"] * 1e6,
                f"{worst_cell['arch']}/{worst_cell['shape']}="
                f"{worst_cell['roofline_frac']:.2f}"))

    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
