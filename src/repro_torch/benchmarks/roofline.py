"""Roofline of the port: the dry run's cells against the card's
datasheet, and the VIKIN serving path from the engine cycle model.

Counterpart of ``benchmarks/roofline.py``, both halves.

The dry-run half (the default) reads the records of
``repro_torch.launch.dryrun`` (one rank's step counted on meta) and
prices each cell's three terms at the datasheet of the NVIDIA H100 80GB
HBM3 (SXM5, 700 W) -- constants, nothing measured:

    compute_t    = FLOPs / 989e12 (bf16 dense; 67e12 for an f32 arch)
    memory_t     = bytes / 3.35e12 (HBM3)
    collective_t = sum of each collective's operand bytes over the
                   slowest link its group crosses: NVLink 450e9 B/s a
                   direction inside a node of 8 cards, 50e9 B/s a card
                   (a 400 Gb/s NIC) across nodes

The records are a rank's own counts, so each term divides by one card's
rate, as the reference's per-device HLO terms do.  With the mesh's
row-major rank layout every ``model`` and ``data`` group of 16 x 16
crosses nodes.  Nothing is scan-corrected: the dry run counts every
layer and time step as it runs (no ``_slstm_correction``).
``MODEL_FLOPS`` is 6 N D for training (2 N D for inference; N the active
params from ``models/transformer.param_shapes``, D the tokens) over the
chips; ``useful_ratio`` is it over the counted FLOPs.

``--engine`` roofs the VIKIN serving path instead: for every servable
arch -- the ``vikin-*`` paper workloads and the KAN-FFN transformer
hybrids -- one row from ``core/engine.serving_report`` against the
modelled VIKIN hardware's own roofs: its 32-MAC/cycle datapath and the
shared host DMA port (``VikinArray.host_bytes_per_cycle``).  Every such
number is a cycle-model output (simulated VIKIN FPGA), computed on the
host.

Run (from the repository root, with ``PYTHONPATH=src``)::

    python -m repro_torch.benchmarks.roofline [--dir chiprun_out/dryrun] \
        [--mesh single] [--out PATH]
    python -m repro_torch.benchmarks.roofline --engine [--batch 8] \
        [--precision bf16] [--out PATH]

Each writes its rows to ``--out`` (``chiprun_out/roofline.json``, or
``chiprun_out/roofline_engine.json`` with ``--engine``) and prints the
table.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.configs.registry import KANFFN_ARCHS, get_config
from repro_torch.configs.vikin_models import VIKIN_ARCHS
from repro_torch.core.engine import VikinArray, VikinHW, serving_report
from repro_torch.launch.mesh import AXES, POD_AXES, ProcessMesh
from repro_torch.utils import leaf_paths

ROOT = Path(__file__).resolve().parents[3]
DEFAULT_OUT = ROOT / "chiprun_out" / "roofline_engine.json"
DEFAULT_DIR = ROOT / "chiprun_out" / "dryrun"
DEFAULT_DRYRUN_OUT = ROOT / "chiprun_out" / "roofline.json"

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) datasheet constants, per card
CARD = "NVIDIA H100 80GB HBM3 (SXM5, 700 W), datasheet"
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense
HBM_BW = 3.35e12               # bytes/s
NVLINK_BW = 450e9              # bytes/s a direction, inside a node
NIC_BW = 50e9                  # bytes/s a card (400 Gb/s), across nodes
CARDS_PER_NODE = 8

_PARAM_CACHE: Dict[str, Dict[str, float]] = {}


def _param_counts(arch: str, cfg: Optional[ArchConfig] = None
                  ) -> Dict[str, float]:
    """(total, active) parameter counts from the params' shapes on meta
    (``models/transformer.param_shapes``: nothing allocated); active
    counts ``top_k`` of a MoE's ``n_experts`` experts.  ``cfg`` for a
    config other than the registry's ``arch``."""
    from repro_torch.models.transformer import param_shapes

    key = arch if cfg is None else repr(cfg)
    if key in _PARAM_CACHE:
        return _PARAM_CACHE[key]
    cfg = cfg or get_config(arch)
    total = expert = 0.0
    for path, leaf in leaf_paths(param_shapes(cfg)):
        n = float(math.prod(leaf.shape))
        total += n
        if "experts" in path:
            expert += n
    active = total
    if cfg.is_moe and expert:
        active = total - expert * (1.0 - cfg.top_k / cfg.n_experts)
    out = {"total": total, "active": active}
    _PARAM_CACHE[key] = out
    return out


def crosses_nodes(mesh: str, axes: str, rank: int = 0) -> bool:
    """Whether the group along ``axes`` (comma-joined) of ``rank`` on a
    mesh ``"16x16"`` / ``"2x16x16"`` (row-major ranks) spans more than
    one node of ``CARDS_PER_NODE`` cards."""
    shape = tuple(int(n) for n in mesh.split("x"))
    m = ProcessMesh(POD_AXES if len(shape) == 3 else AXES, shape, rank=rank,
                    abstract=True)
    ax = tuple(a for a in axes.split(",") if a)
    ranks = [m.index_over(m.axis_names, m.coords_of(ax, j))
             for j in range(m.axis_size(ax))]
    return len({r // CARDS_PER_NODE for r in ranks}) > 1


def collective_bytes(rec: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Each collective kind's operand bytes split by the link its groups
    cross (``"nvlink"``, ``"nic"``)."""
    out: Dict[str, Dict[str, float]] = {}
    for kind, d in rec["full"].get("collectives", {}).items():
        links = out.setdefault(kind, {"nvlink": 0.0, "nic": 0.0})
        for axes, a in d.get("axes", {}).items():
            link = ("nic" if crosses_nodes(rec["mesh"], axes,
                                           rec.get("rank", 0))
                    else "nvlink")
            links[link] += a["bytes"]
    return out


_HINTS = {
    "compute": "compute-bound: cut recompute, compact the contraction "
               "(stage-2 patterns), keep products on tensor cores",
    "memory": "HBM-bound: fuse elementwise chains (kan_fused-style), "
              "keep intermediates bf16, raise arithmetic intensity",
    "collective": "link-bound: fewer all-gathers (reshard), overlap "
                  "collectives with compute, compress gradients",
}


def analyze(rec: Dict[str, Any], cfg: Optional[ArchConfig] = None
            ) -> Optional[Dict[str, Any]]:
    """The roofline row of one dry-run record (``ok`` ones; None else):
    the reference's fields, each time at the datasheet constants above.
    ``cfg`` for a config other than the registry's (``hillclimb``)."""
    if not rec.get("ok") or rec.get("full") is None:
        return None
    arch, chips = rec["arch"], rec["n_chips"]
    shape = SHAPES.get(rec["shape"])
    seq = rec.get("seq_len", shape.seq_len if shape else 0)
    batch = rec.get("global_batch", shape.global_batch if shape else 0)
    kind = rec.get("kind", shape.kind if shape else "train")
    dtype = rec.get("dtype") or (cfg or get_config(arch)).dtype
    flops = float(rec["full"]["flops"])
    byts = float(rec["full"]["bytes_accessed"])
    links = collective_bytes(rec)
    colls = {k: v["nvlink"] + v["nic"] for k, v in links.items()}
    coll_bytes = sum(colls.values())
    compute_t = flops / PEAK_FLOPS.get(dtype, PEAK_FLOPS["float32"])
    memory_t = byts / HBM_BW
    coll_t = sum(v["nvlink"] / NVLINK_BW + v["nic"] / NIC_BW
                 for v in links.values())
    terms = {"compute": compute_t, "memory": memory_t, "collective": coll_t}
    dominant = max(terms, key=terms.get)
    p = _param_counts(arch, cfg)
    tokens = seq * batch if kind in ("train", "prefill") else batch
    model_flops = (6.0 if kind == "train" else 2.0) * p["active"] * tokens
    model_flops /= chips             # per card, as the counted terms
    step_t = max(terms.values())
    mem = rec["full"]["memory"]
    return {
        "arch": arch, "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips, "rank": rec.get("rank", 0), "dtype": dtype,
        "flops": flops, "bytes": byts, "collective_bytes": coll_bytes,
        "collectives_by_type": colls, "collectives_by_link": links,
        "compute_t": compute_t, "memory_t": memory_t,
        "collective_t": coll_t, "dominant": dominant, "step_t": step_t,
        "roofline_frac": compute_t / step_t if step_t > 0 else 0.0,
        "model_flops": model_flops,
        "useful_ratio": model_flops / flops if flops else 0.0,
        "hint": _HINTS[dominant],
        "mem_gib": {"args": mem["argument_size_in_bytes"] / 2**30,
                    "temp": mem["temp_size_in_bytes"] / 2**30},
        "fits": rec.get("fits"), "wall_s": rec.get("wall_s"),
        "priced_at": CARD,
    }


def _engine_layer_works(name: str):
    """(family, LayerWork list) of one servable arch."""
    from repro_torch.runtime.backends import transformer_layer_works

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


def dryrun_rows(directory: str | Path, mesh: str = "single"
                ) -> List[Dict[str, Any]]:
    """One row per record ``<dir>/*__<mesh>.json``: ``analyze``'s, or the
    arch, shape and error of a failed cell."""
    rows = []
    for path in sorted(Path(directory).glob(f"*__{mesh}.json")):
        rec = json.loads(path.read_text())
        if not rec.get("ok"):
            rows.append({"arch": rec.get("arch"), "shape": rec.get("shape"),
                         "error": rec.get("error", "?")})
            continue
        rows.append(analyze(rec))
    return rows


def print_dryrun_table(rows: Sequence[Dict[str, Any]]) -> None:
    hdr = (f"| {'arch':26s} | {'shape':12s} | {'compute':11s} | "
           f"{'memory':11s} | {'collective':11s} | bound | "
           f"{'6ND/cnt':7s} | {'roofl.':6s} |")
    print(hdr)
    print("|" + "-" * (len(hdr) - 2) + "|")
    ok = [r for r in rows if "error" not in r]
    for r in ok:
        print(f"| {r['arch']:26s} | {r['shape']:12s} | "
              f"{fmt_t(r['compute_t'])} | {fmt_t(r['memory_t'])} | "
              f"{fmt_t(r['collective_t'])} | {r['dominant'][:5]:5s} | "
              f"{r['useful_ratio']:7.2f} | {r['roofline_frac']:6.2f} |")
    for r in rows:
        if "error" in r:
            print(f"| {r['arch']:26s} | {r['shape']:12s} | FAILED: "
                  f"{r['error'][:60]}")
    if ok:
        worst = min(ok, key=lambda r: r["roofline_frac"])
        collb = max(ok, key=lambda r: r["collective_t"]
                    / max(r["step_t"], 1e-12))
        print(f"\nworst roofline fraction : {worst['arch']} {worst['shape']}"
              f" ({worst['roofline_frac']:.2f})")
        print(f"most collective-bound   : {collb['arch']} {collb['shape']}")
    print(f"(counted on meta, priced at {CARD} constants; not measured)")


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=str(DEFAULT_DIR),
                    help="the dry run's records (launch/dryrun --out)")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--engine", action="store_true",
                    help="roofline the VIKIN serving path (vikin-* and "
                         "kan-ffn archs, the engine cycle model) instead "
                         "of the dry run's records")
    ap.add_argument("--batch", type=int, default=1,
                    help="--engine: served batch size of the rows")
    ap.add_argument("--precision", default="f32",
                    choices=["f32", "f16", "bf16", "int8"],
                    help="--engine: served dtype of the DMA accounting")
    ap.add_argument("--out", default=None,
                    help=f"JSON output path (default {DEFAULT_DRYRUN_OUT}, "
                         f"or {DEFAULT_OUT} with --engine)")
    args = ap.parse_args(argv)
    if args.engine:
        rows = engine_rows(batch=args.batch, precision=args.precision)
        out = Path(args.out) if args.out else DEFAULT_OUT
    else:
        rows = dryrun_rows(args.dir, args.mesh)
        out = Path(args.out) if args.out else DEFAULT_DRYRUN_OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    if args.engine:
        print_table(rows)
    else:
        print_dryrun_table(rows)
    print(f"wrote {out}")
    return rows


if __name__ == "__main__":
    main()
