"""Hillclimb: one (arch x shape) cell of the dry run, with
overrides, beside its recorded baseline.

Counterpart of ``benchmarks/hillclimb.py``: one hypothesis -> change ->
measure iteration a call.  It counts the cell on meta on the single-pod
mesh (``launch/dryrun.analyze_cell``, which takes the config itself) with
``ArchConfig`` overrides (``--set``) and ``StepOptions`` overrides
(``--opt``), prices it (``roofline.analyze``, the NVIDIA H100 80GB HBM3
datasheet constants: counts, not measurements) and prints it next to the
baseline record of the same cell (``--baseline-dir``, the dry run's
``chiprun_out/dryrun`` by default), if there is one::

  PYTHONPATH=src python -m repro_torch.benchmarks.hillclimb \\
      --arch granite-20b --shape train_4k --set pattern_rate=0.5 \\
      --opt activation_mode=sp --tag p50_sp

The row goes to ``chiprun_out/hillclimb/<arch>__<shape>__<tag>.json``,
with the cfg's ``remat``: ``--set remat=false`` counts the step without
the checkpoints (every activation kept for the backward, no
recompute).
An override the port's step refuses raises here as it does on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

from repro_torch.benchmarks.roofline import analyze
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.steps import StepOptions

ROOT = Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "chiprun_out" / "hillclimb"


def fmt(r: Dict[str, Any]) -> str:
    return (f"remat {str(r.get('remat', '-')):5s} | compute "
            f"{r['compute_t']*1e3:8.3f}ms | memory "
            f"{r['memory_t']*1e3:8.3f}ms | coll {r['collective_t']*1e3:8.3f}ms"
            f" | bound {r['dominant']:10s} | step {r['step_t']*1e3:8.3f}ms"
            f" | mem {r['mem_gib']['args']:.1f}+{r['mem_gib']['temp']:.1f}GiB")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="ArchConfig override k=v")
    ap.add_argument("--opt", action="append", default=[],
                    help="StepOptions override k=v")
    ap.add_argument("--tag", default="variant")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--baseline-dir", default=str(DR.OUT_DIR),
                    help="the dry run's records (launch/dryrun --out)")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    cfg_over = DR.parse_kv(getattr(args, "set"))
    opt_over = DR.parse_kv(args.opt)
    cfg = dataclasses.replace(get_config(args.arch), **cfg_over)
    rec = DR.analyze_cell(cfg, args.shape, multi_pod=False,
                          opts=StepOptions(**opt_over), rank=args.rank)
    res = {**analyze(rec, cfg), "remat": rec["remat"]}

    base = None
    base_path = DR.cell_path(args.baseline_dir, args.arch, args.shape,
                             "single")
    if base_path.exists():
        brec = json.loads(base_path.read_text())
        if brec.get("ok"):
            base = {**analyze(brec), "remat": brec.get("remat")}
    if base:
        print(f"baseline : {fmt(base)}")
    print(f"{args.tag:9s}: {fmt(res)}")
    if base:
        key = base["dominant"] + "_t"
        print(f"dominant-term delta: {base[key]*1e3:.3f}ms -> "
              f"{res[key]*1e3:.3f}ms ({res[key] / base[key]:.3f}x); step "
              f"{base['step_t']*1e3:.3f} -> {res['step_t']*1e3:.3f}ms")
    res["overrides"] = {"cfg": cfg_over, "opts": opt_over}
    res["tag"] = args.tag
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{args.arch}__{args.shape}__{args.tag}.json"
    path.write_text(json.dumps(res, indent=1))
    print(f"wrote {path}")
    return res


if __name__ == "__main__":
    main()
