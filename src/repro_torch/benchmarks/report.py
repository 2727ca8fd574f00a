"""The dry run's and the roofline's tables, written between markers.

Counterpart of ``benchmarks/report.py``: it reads the port's records
(``launch/dryrun``'s ``chiprun_out/dryrun/*.json`` and ``roofline``'s
``chiprun_out/roofline.json``) and replaces what follows the
``<!-- DRYRUN_TABLE -->`` and ``<!-- ROOFLINE_TABLE -->`` markers of
``--out`` up to the next ``## `` header (idempotent).  ``--out`` is
``chiprun_out/DRYRUN.md`` by default, made with both markers when it is
missing; it never writes ``EXPERIMENTS.md``, the reference's.  Both
tables are printed too.  Every figure is a count on meta (or its price
at the NVIDIA H100 80GB HBM3 datasheet constants), not a measurement::

  PYTHONPATH=src python -m repro_torch.benchmarks.report
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.benchmarks.roofline import DEFAULT_DIR, DEFAULT_DRYRUN_OUT

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_OUT = ROOT / "chiprun_out" / "DRYRUN.md"
SKELETON = ("# Dry run of the port (counted on meta)\n\n"
            "## Dry run\n\n<!-- DRYRUN_TABLE -->\n\n"
            "## Roofline\n\n<!-- ROOFLINE_TABLE -->\n")


def dryrun_table(directory: str | Path) -> str:
    rows = []
    for path in sorted(Path(directory).glob("*.json")):
        r = json.loads(path.read_text())
        if r.get("ok"):
            m = r["full"]["memory"]
            n_coll = sum(d.get("count", 0)
                         for d in r["full"].get("collectives", {}).values())
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                f"{r.get('rank', 0)} | ok | {r.get('remat', '-')} | "
                f"{m['argument_size_in_bytes']/2**30:.2f} | "
                f"{m['temp_size_in_bytes']/2**30:.2f} | "
                f"{'yes' if r.get('fits') else 'no'} | "
                f"{r['full']['flops']:.3e} | "
                f"{r['full']['bytes_accessed']:.3e} | {n_coll} | "
                f"{r.get('wall_s', 0):.1f} s |")
        else:
            rows.append(f"| {r.get('arch')} | {r.get('shape')} | "
                        f"{r.get('mesh')} | {r.get('rank', 0)} | **FAIL** "
                        f"| {r.get('remat', '-')} | - | - | - | - | - | - | "
                        f"{r.get('wall_s', 0):.1f} s |")
    hdr = ("| arch | shape | mesh | rank | status | remat | args GiB/card | "
           "temp GiB/card | fits 80 GB | FLOPs (counted) | bytes (unfused) "
           "| collectives | wall (meta) |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|")
    n_ok = sum("| ok |" in r for r in rows)
    note = (f"\n{n_ok}/{len(rows)} cells ran on meta. One rank's counts: "
            "FLOPs and bytes of every aten op and kernel of its step, "
            "nothing scanned, nothing corrected; bytes are an unfused upper "
            "bound.\n")
    return hdr + "\n" + "\n".join(rows) + "\n" + note


def roofline_table(path: str | Path) -> str:
    path = Path(path)
    if not path.exists():
        return "(run repro_torch.benchmarks.roofline after the dry run)\n"
    ok = [r for r in json.loads(path.read_text()) if "error" not in r]
    hdr = ("| arch | shape | compute | memory | collective | bound | "
           "6ND/counted | roofline frac | what moves the bound |\n"
           "|---|---|---|---|---|---|---|---|---|")
    out = [hdr]

    def t(x: float) -> str:
        return f"{x*1e3:.2f} ms" if x >= 1e-4 else f"{x*1e6:.0f} µs"

    for r in ok:
        out.append(
            f"| {r['arch']} | {r['shape']} | {t(r['compute_t'])} | "
            f"{t(r['memory_t'])} | {t(r['collective_t'])} | "
            f"{r['dominant']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_frac']:.2f} | {r['hint']} |")
    if ok:
        worst = min(ok, key=lambda r: r["roofline_frac"])
        collb = max(ok, key=lambda r: r["collective_t"]
                    / max(r["step_t"], 1e-12))
        out.append(
            f"\nworst roofline fraction: **{worst['arch']} "
            f"{worst['shape']}** ({worst['roofline_frac']:.2f}); most "
            f"collective-bound: **{collb['arch']} {collb['shape']}** "
            f"(coll/step = "
            f"{collb['collective_t'] / max(collb['step_t'], 1e-12):.2f}). "
            f"Priced at {ok[0]['priced_at']} constants, not measured.\n")
    return "\n".join(out) + "\n"


def inject(text: str, marker: str, content: str) -> str:
    pat = re.compile(
        re.escape(f"<!-- {marker} -->") + r".*?(?=\n## |\Z)", re.S)
    return pat.sub(lambda _: f"<!-- {marker} -->\n\n{content}", text)


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=str(DEFAULT_DIR),
                    help="the dry run's records")
    ap.add_argument("--roofline", default=str(DEFAULT_DRYRUN_OUT),
                    help="roofline's rows (repro_torch.benchmarks.roofline)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    out = Path(args.out)
    if out.name == "EXPERIMENTS.md":
        raise SystemExit("report: EXPERIMENTS.md is the reference's; write "
                         "the port's tables elsewhere (--out)")
    text = out.read_text() if out.exists() else SKELETON
    dry, roof = dryrun_table(args.dir), roofline_table(args.roofline)
    text = inject(text, "DRYRUN_TABLE", dry)
    text = inject(text, "ROOFLINE_TABLE", roof)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    print(dry)
    print(roof)
    print(f"{out} updated")
    return text


if __name__ == "__main__":
    main()
