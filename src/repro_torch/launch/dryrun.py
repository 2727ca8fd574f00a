"""The dry run on the meta device: one rank's real step of a production
cell, counted, with nothing allocated and no card.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles the
train and serve steps for 256 or 512 placeholder devices and reads XLA's
cost and memory analyses.  PyTorch compiles nothing ahead of time, so
here one rank of the production mesh runs its step for real, on
``torch.device("meta")``, over an abstract ``ProcessMesh`` (``rank``
set): the rank's shards of the state and its rows of the batch, by the
sharding rules (``launch/sharding``, ``steps.init_train_state(mesh=)``,
``steps.local_batch``, ``steps.cache_layout``), through the same
``MeshTrainStep``, ``make_prefill_step`` and ``make_decode_step`` a
card runs.  Meta computes no values: the collectives count their calls
and bytes and return meta tensors (``launch/collectives``), the kernel
wrappers check their operands and make their outputs and launch nothing
(``kernels/work``).  Nothing here is a fallback: every entry point that
computes still runs on the card unless asked for the CPU.

``count()`` measures a step while it runs, on any device:

* ``flops``: torch's ``FlopCounterMode`` formulas
  (``torch.utils.flop_counter.flop_registry``) over every aten op, plus
  each kernel's work from its shapes (``kernels/work``; the aten ops of a
  kernel wrapper's device branch -- the plain version's on the CPU -- are
  not counted);
* ``bytes_accessed``: the bytes of every aten op's tensor inputs and
  outputs (a view and an allocation move none), plus the kernels': an
  unfused upper bound on HBM traffic;
* ``temp_size_in_bytes``: the peak of the bytes of the storages the step
  makes on its device and still holds (``weakref.finalize`` on each);
  ``argument_size_in_bytes`` is the bytes of the leaves the step takes.

There are no ``calib1``/``calib2`` compiles: the port's layers and the
sLSTM, RG-LRU and mLSTM time loops are Python loops, each counted as it
runs, so nothing is scanned and nothing needs correcting (``--recalib``
is refused for that reason).

Usage (``PYTHONPATH=src``)::

  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing]
  python -m repro_torch.launch.dryrun --arch granite-20b --shape train_4k \\
      --mesh single --rank 17 --opt activation_mode=sp

Each cell writes ``chiprun_out/dryrun/<arch>__<shape>__<single|multi>.json``
with the reference's keys (``roofline`` and ``report`` read it), plus
``rank``, ``counted_by`` and ``fits`` (argument + temp within
``CARD_BYTES``); a cell that fails writes ``ok: false`` with its error,
and the exit code is 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.configs.registry import get_config, runnable_cells
from repro_torch.kernels import work as W
from repro_torch.launch import collectives as C
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (
    AXES,
    POD_AXES,
    ProcessMesh,
    make_production_mesh,
)
from repro_torch.models import transformer as T
from repro_torch.utils import leaf_paths

ROOT = Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "chiprun_out" / "dryrun"
META = torch.device("meta")
# the device memory of the card a rank runs on: an NVIDIA H100 80GB HBM3
# at 700 W, torch.cuda.get_device_properties(0).total_memory as read on
# that card (torch 2.11, CUDA 12.8) by chip_smoke.py phase 16: 79.18 GiB
CARD_BYTES = 85_017_493_504
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"

_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
                torch.ops.aten.new_empty_strided}


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of an aten op's arguments or results."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensor leaves of a step's inputs or outputs: the port's trees,
    its registered dataclasses (``OptState``) too (``utils.leaf_paths``)."""
    return [t for _, t in leaf_paths(tree) if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor) -> Optional[torch.UntypedStorage]:
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):   # no storage (sparse, ...)
        return None


def tree_bytes(tree: Any) -> int:
    """The bytes of the tensor leaves of a step's ``tree``, leaf by
    leaf."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _op_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class Count(TorchDispatchMode):
    """The counters of one step (module docstring).  ``kernels`` holds,
    by kernel name, the launches (or plain-version calls, or meta calls)
    and their work; ``ops`` the aten ops seen; ``by_op`` each counted
    aten op's calls, FLOPs and bytes, by name."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.by_op: Dict[str, List[float]] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.hidden = 0                   # kernels/work.kernel's regions
        self.argument_bytes = 0
        self.device_type: Optional[str] = None
        self.live = 0
        self.peak = 0
        self._held: set = set()           # storages the counts know

    def arguments(self, tree: Any) -> None:
        """Register the step's inputs: their bytes are the argument, their
        storages are never counted as made by the step, and their device
        is the one whose storages the tracker follows."""
        for t in _leaves(tree):
            self.argument_bytes += t.numel() * t.element_size()
            self.device_type = self.device_type or t.device.type
            st = _storage(t)
            if st is not None:
                self._held.add(st._cdata)

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def _free(self, key: int, n: int) -> None:
        self._held.discard(key)
        self.live -= n

    def _track(self, args: Any, out: Any) -> None:
        outs = _tensors(out)
        if not outs:
            return
        ins = {st._cdata for st in map(_storage, _tensors(args))
               if st is not None}
        for t in outs:
            if t.device.type != self.device_type:
                continue
            st = _storage(t)
            if st is None or st._cdata in self._held or st._cdata in ins:
                continue
            n = st.nbytes()
            self._held.add(st._cdata)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, st._cdata, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if not self.hidden:
            packet = func._overloadpacket
            formula = flop_registry.get(packet)
            flops = (0.0 if formula is None
                     else float(formula(*args, **kwargs, out_val=out)))
            nbytes = (0 if func.is_view or packet in _ALLOCATIONS
                      else _op_bytes((args, kwargs)) + _op_bytes(out))
            self.flops += flops
            self.bytes += nbytes
            row = self.by_op.setdefault(str(packet), [0, 0.0, 0.0])
            row[0] += 1
            row[1] += flops
            row[2] += nbytes
        self._track((args, kwargs), out)
        return out


@contextlib.contextmanager
def count(arguments: Any = None) -> Iterator[Count]:
    """Count what runs inside the block (``Count``); ``arguments`` are the
    step's inputs (``Count.arguments``)."""
    c = Count()
    if arguments is not None:
        c.arguments(arguments)
    W.COUNTERS.append(c)
    try:
        with c:
            yield c
    finally:
        W.COUNTERS.remove(c)


def abstract_mesh(multi_pod: bool = False, rank: int = 0,
                  shape: Optional[Sequence[int]] = None) -> ProcessMesh:
    """The production mesh (``make_production_mesh``) or one of ``shape``
    as rank ``rank`` sees it, abstract, on meta."""
    if shape is None:
        shape = make_production_mesh(multi_pod=multi_pod).shape
    shape = tuple(shape)
    mesh = ProcessMesh(POD_AXES if len(shape) == 3 else AXES, shape,
                       rank=rank, device=META, abstract=True)
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} outside a mesh of {mesh.size}")
    return mesh


def _collectives(mesh: ProcessMesh) -> Dict[str, Dict[str, Any]]:
    """``collectives.TALLY`` in the reference's layout: kind -> operand
    bytes (``entry``; ``body`` 0: nothing is scanned) and calls, with the
    axes each ran along and their group size."""
    out: Dict[str, Dict[str, Any]] = {}
    for (kind, ax), (n, nbytes) in sorted(C.TALLY.items()):
        d = out.setdefault(kind, {"entry": 0.0, "body": 0.0, "count": 0,
                                  "axes": {}, "group_size": 1})
        d["entry"] += float(nbytes)
        d["count"] += n
        size = mesh.axis_size(ax)
        d["axes"][",".join(ax)] = {"count": n, "bytes": float(nbytes),
                                   "group_size": size}
        d["group_size"] = max(d["group_size"], size)
    return out


def _shape(shape: str | ShapeSpec) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def cell_inputs(cfg: ArchConfig, shape: ShapeSpec, mesh: ProcessMesh,
                opts: ST.StepOptions, params: Any = None,
                batch: Any = None) -> tuple:
    """(step, its inputs) of one rank of ``mesh``: a train cell's
    ``MeshTrainStep`` and (state, its rows of the batch); a prefill or
    decode cell's serve step and (the rank's compute params, the global
    batch | its rows of the token and its pieces of the caches), the held
    FFN modules built once, outside the step.  ``params`` (whole) and
    ``batch`` (global, as ``specs.input_specs`` lays it out) default to
    meta ones; real ones run the same cell on a real mesh."""
    params = T.param_shapes(cfg) if params is None else params
    batch = SP.input_specs(cfg, shape) if batch is None else batch
    if shape.kind == "train":
        state = ST.init_train_state(cfg, opts, params=params, mesh=mesh)
        return (ST.make_train_step(cfg, opts, mesh),
                (state, ST.local_batch(batch, mesh)))
    cp = ST.compute_params(ST.shard_params(params, cfg, mesh), cfg, mesh)
    with ST.serve_mesh(cfg, mesh):
        ffns = T.ffn_modules(cp, cfg)
        enc = T.encoder_ffn_modules(cp, cfg) if cfg.enc_dec else None
    if shape.kind == "prefill":
        step = ST.make_prefill_step(cfg, ffns=ffns, enc_ffns=enc, mesh=mesh)
        return step, (cp, batch)
    whole = batch["caches"]
    layout = SH.cache_shardings(whole, mesh)
    batch = {"token": ST.local_batch({"token": batch["token"]},
                                     mesh)["token"],
             "caches": SH.shard_caches(whole, layout, mesh)}
    step = ST.make_decode_step(cfg, ffns=ffns, mesh=mesh, layout=layout)
    return step, (cp, batch)


def count_step(step, inputs: tuple) -> Dict[str, Any]:
    """Run ``step(*inputs)`` under ``count`` (collectives' counts zeroed
    first): its ``full`` record."""
    C.reset_sent()
    t0 = time.time()
    with count(inputs) as c:
        out = step(*inputs)
    full = {
        "tag": "full", "compile_s": round(time.time() - t0, 3),
        "flops": c.flops, "bytes_accessed": c.bytes,
        "bytes_accessed_is": "unfused upper bound: every aten op's inputs "
                             "and outputs, and each kernel's operands",
        "transcendentals": 0.0,
        "memory": {"generated_code_size_in_bytes": 0.0,
                   "argument_size_in_bytes": float(c.argument_bytes),
                   "output_size_in_bytes": float(tree_bytes(out)),
                   "alias_size_in_bytes": 0.0,
                   "temp_size_in_bytes": float(c.peak)},
        "kernels": c.kernels, "aten_ops": c.ops, "by_op": c.by_op,
        "sent": dict(C.SENT),
        "gathers": {",".join(k): v for k, v in sorted(C.GATHERS.items())},
    }
    return full


def analyze_cell(cfg: ArchConfig, shape_name: str | ShapeSpec,
                 multi_pod: bool = False,
                 opts: ST.StepOptions = ST.StepOptions(), rank: int = 0, *,
                 mesh_shape: Optional[Sequence[int]] = None
                 ) -> Dict[str, Any]:
    """The record of one cell: rank ``rank``'s step of ``cfg`` at
    ``shape_name`` (a ``SHAPES`` name or a ``ShapeSpec``) on the
    production mesh (``mesh_shape`` for another), counted on meta."""
    shape = _shape(shape_name)
    mesh = abstract_mesh(multi_pod, rank, mesh_shape)
    rec: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "x".join(map(str, mesh.shape)), "n_chips": mesh.size,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch, "dtype": cfg.dtype,
        "pattern": list(cfg.pattern),
        "n_units": cfg.n_layers // len(cfg.pattern),
        "n_extra": cfg.n_layers % len(cfg.pattern),
        "rank": rank, "counted_by": "torch meta", "ok": False,
        "opts": dataclasses.asdict(opts)}
    step, inputs = cell_inputs(cfg, shape, mesh, opts)
    full = count_step(step, inputs)
    full["collectives"] = _collectives(mesh)
    rec["full"] = full
    mem = full["memory"]
    rec["fits"] = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                   <= CARD_BYTES)
    rec["card_bytes"] = CARD_BYTES
    rec["ok"] = True
    return rec


def cell_path(out_dir: str | Path, arch: str, shape: str,
              mesh_tag: str) -> Path:
    return Path(out_dir) / f"{arch}__{shape}__{mesh_tag}.json"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | Path, skip_existing: bool = False,
             opts: ST.StepOptions = ST.StepOptions(), rank: int = 0
             ) -> Dict[str, Any]:
    """``analyze_cell`` of one cell into its file; a failure is recorded
    (``ok: false``, the error and its traceback), not raised."""
    mesh_tag = "multi" if multi_pod else "single"
    path = cell_path(out_dir, arch, shape_name, mesh_tag)
    if skip_existing and path.exists():
        rec = json.loads(path.read_text())
        print(f"[SKIP] {arch:25s} {shape_name:12s} {rec.get('mesh', '?'):8s} "
              f"ok={rec.get('ok')}", flush=True)
        return rec
    t0 = time.time()
    try:
        rec = analyze_cell(get_config(arch), shape_name, multi_pod, opts,
                           rank)
    except Exception as e:  # a failure here is a fault of the port's step
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "2x16x16" if multi_pod else "16x16", "rank": rank,
               "counted_by": "torch meta", "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    rec["wall_s"] = round(time.time() - t0, 1)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    status = "OK " if rec.get("ok") else "FAIL"
    mem = rec.get("full", {}).get("memory", {})
    print(f"[{status}] {arch:26s} {shape_name:12s} {rec['mesh']:8s} "
          f"rank {rank} args={mem.get('argument_size_in_bytes', 0)/2**30:.2f}"
          f"GiB temp={mem.get('temp_size_in_bytes', 0)/2**30:.2f}GiB "
          f"flops={rec.get('full', {}).get('flops', 0):.3e} "
          f"wall={rec['wall_s']}s", flush=True)
    if not rec.get("ok"):
        print(rec["error"], flush=True)
    return rec


def parse_kv(items: Optional[Sequence[str]]) -> Dict[str, Any]:
    """``k=v`` flags as a dict, each value an int, a float, a bool or the
    string as given (the reference's ``hillclimb.parse_kv``)."""
    out: Dict[str, Any] = {}
    for it in items or []:
        k, v = it.split("=", 1)
        val: Any = v
        for cast in (int, float):
            try:
                val = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "true"):
            val = True
        if v in ("False", "false"):
            val = False
        out[k] = val
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="every cell of configs.registry.runnable_cells()")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh whose step is counted")
    ap.add_argument("--opt", action="append", default=[],
                    help="StepOptions override k=v (activation_mode=sp)")
    ap.add_argument("--recalib", action="store_true",
                    help="the reference's calibration compiles; refused")
    args = ap.parse_args(argv)
    if args.recalib:
        raise SystemExit(
            "--recalib: the port counts every layer and time step as it "
            "runs (unrolled Python), so there is no scanned body to "
            "calibrate; the reference's jax_compat.py has no counterpart")
    opts = ST.StepOptions(**parse_kv(args.opt))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = runnable_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        raise SystemExit("--arch and --shape, or --all")
    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, mp, args.out, args.skip_existing,
                           opts, args.rank)
            n_fail += not rec.get("ok")
    print(f"done: {len(cells) * len(meshes)} cells, {n_fail} failures "
          f"(counted on meta; {CARD} memory {CARD_BYTES / 2**30:.2f} GiB)")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
