"""Devices and process meshes (counterpart of ``repro/launch/mesh.py``).

Serving half.  The reference serves its multi-chip array from one
controller over a 1-D mesh of devices.  Its counterpart here is one
process holding a list of torch devices: the first N visible cards, N
logical chips on the host (``device="cpu"``, the counterpart of the
reference's ``--xla_force_host_platform_device_count``), or an explicit
list, repeats allowed (``["cuda:0"] * 4`` serves four logical chips on
one card).

Training half.  The reference's ``jax.make_mesh`` lays devices out over
named axes (``("data", "model")`` or ``("pod", "data", "model")``) in
one program.  Its counterpart is a ``ProcessMesh``: one
``torch.distributed`` process a chip, the ranks laid out over the same
axes in row-major order (rank = ((pod * D) + data) * M + model), and one
subgroup for every line of every set of axes, made with ``new_group`` on
every rank in the same order.  ``init_process_mesh`` wires it (the
counterpart of ``jax.distributed.initialize`` plus ``jax.make_mesh``):

* the backend is explicit: NCCL when each rank has a card of its own,
  gloo on the CPU, and gloo when several ranks share one card (NCCL
  refuses two ranks on one device); ``launch/collectives`` copies a
  card's tensor to the host and back for gloo;
* rendezvous goes through ``file://`` in a given directory (tests under
  xdist never clash on a port) or ``env://`` under ``torchrun``.

``make_host_mesh()`` is the 1x1 mesh, which needs no process group;
``make_production_mesh`` gives the (16, 16) and (2, 16, 16) shapes, for
the sharding rules only (nothing is launched at that size).
``set_mesh`` is the counterpart of ``jax.set_mesh``: ``models/moe``
reads the active mesh as the reference reads the ambient one, and the
models read its ``MeshContext`` (the activation mode, the leaves
computed tensor-parallel) as GSPMD reads the shardings.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import subprocess
import sys
import time
from typing import (Any, Dict, FrozenSet, Iterator, List, Optional,
                    Sequence, Tuple)

import torch
import torch.distributed as dist

from repro_torch.utils import resolve_device

DeviceSpec = int | Sequence[str | torch.device]


def require_devices(n: DeviceSpec, context: str = "",
                    device: str | torch.device = "cuda"
                    ) -> List[torch.device]:
    """``n`` devices to serve an array on, checked before any stack is
    built, so a short device count fails with the fix instead of deep in
    a forward.

    An int takes the first ``n`` visible cards (``device`` of type cuda;
    refused when CUDA is missing or fewer cards are visible) or ``n``
    logical chips on the host (``device="cpu"``).  A sequence of devices
    passes through as given, repeats allowed; each must exist.
    """
    where = f" ({context})" if context else ""
    if not isinstance(n, int):
        devs = [resolve_device(d) for d in n]
        if not devs:
            raise ValueError(f"need at least 1 device{where}, got an empty "
                             f"device list")
        for d in devs:
            if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
                raise ValueError(
                    f"device {str(d)!r}{where} is not visible: "
                    f"{torch.cuda.device_count()} card(s) are")
        return devs
    if n < 1:
        raise ValueError(f"need at least 1 device, got request for {n}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    avail = torch.cuda.device_count()
    if n > avail:
        raise ValueError(
            f"{n} devices requested{where} but only {avail} visible; run on "
            f"a machine (or under CUDA_VISIBLE_DEVICES) with {n} cards, pass "
            f"an explicit device list such as ['cuda:0'] * {n} to serve {n} "
            f"logical chips on one card, or device='cpu' for {n} logical "
            f"chips on the host")
    return [torch.device(dev.type, i) for i in range(n)]


def serving_devices(n: DeviceSpec, device: str | torch.device = "cuda"
                    ) -> List[torch.device]:
    """The 1-D device list of the data plan (runtime/sharded.
    ShardedVikinBackend): ``require_devices`` for the reference's
    ``serving_mesh``."""
    return require_devices(n, "serving_devices", device)


# ---------------------------------------------------------------------------
# Training half: the process mesh
# ---------------------------------------------------------------------------

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
Axes = Tuple[str, ...]


@dataclasses.dataclass
class ProcessMesh:
    """Named axes over ranks, row-major: ``shape[i]`` ranks along
    ``axis_names[i]``.  ``groups[axes]`` is this rank's subgroup along
    ``axes`` (every subset of the axes, in mesh order; its ranks in
    row-major order of those axes) and ``backend`` the process group's
    (None: no process group, a 1-rank or an abstract mesh)."""
    axis_names: Axes
    shape: Tuple[int, ...]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    groups: Dict[Axes, Any] = dataclasses.field(default_factory=dict)
    abstract: bool = False

    def __post_init__(self) -> None:
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"mesh axes {self.axis_names} and shape "
                             f"{self.shape} differ in length")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def axis_size(self, axes: str | Sequence[str]) -> int:
        """Ranks along ``axes`` (1 for an axis the mesh lacks)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in axes:
            n *= self.sizes.get(a, 1)
        return n

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis."""
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.shape))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def index_over(self, axes: str | Sequence[str],
                   coords: Optional[Dict[str, int]] = None) -> int:
        """This rank's row-major index along ``axes`` (0 for absent
        axes), its position in ``groups[axes]``; that of the rank at
        ``coords`` when given."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx, c = 0, self.coords if coords is None else coords
        for a in axes:
            idx = idx * self.sizes.get(a, 1) + c.get(a, 0)
        return idx

    def coords_of(self, axes: str | Sequence[str],
                  j: int) -> Dict[str, int]:
        """The coordinates of the j-th rank of this rank's group along
        ``axes`` (row-major): this rank's, but along ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        c = dict(self.coords)
        for a in reversed([a for a in self.axis_names if a in axes]):
            c[a], j = j % self.sizes[a], j // self.sizes[a]
        return c

    def present(self, axes: str | Sequence[str]) -> Axes:
        """``axes`` that this mesh has with more than one rank, in mesh
        order: the axes a collective over ``axes`` runs on."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names
                     if a in axes and self.sizes[a] > 1)

    def group(self, axes: Axes) -> Any:
        if self.abstract:
            raise RuntimeError(
                f"mesh {self.shape} over {self.axis_names} is abstract (the "
                f"sharding rules' stand-in): it launches nothing")
        return self.groups[axes]

    def barrier(self) -> None:
        if self.backend is not None:
            dist.barrier()

    def __repr__(self) -> str:
        return (f"ProcessMesh({dict(self.sizes)}, rank {self.rank} "
                f"{self.coords}, {self.device}, backend {self.backend})")


def make_host_mesh(device: str | torch.device = "cpu") -> ProcessMesh:
    """The 1x1 ("data", "model") mesh: one process, no process group."""
    return ProcessMesh(AXES, (1, 1), device=torch.device(device))


def make_production_mesh(*, multi_pod: bool = False) -> ProcessMesh:
    """The reference's production shapes, (16, 16) over ("data",
    "model") or (2, 16, 16) over ("pod", "data", "model"): an abstract
    mesh for the sharding rules and specs, which launches nothing."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return ProcessMesh(POD_AXES if multi_pod else AXES, shape,
                       abstract=True)


def mesh_backend(device: torch.device, world_size: int,
                 rank: int = 0) -> str:
    """The process group's backend for ranks on ``device``, worked out
    from the layout: NCCL when each rank of the host has a card of its
    own (rank r on ``cuda:<local rank r>``), gloo on the CPU and when
    ranks share a card.  A layout that fits neither raises; nothing
    switches silently."""
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no process-mesh backend for device {device}")
    n = torch.cuda.device_count()
    idx = device.index or 0
    if idx >= n:
        raise ValueError(f"device {device} is not visible: {n} card(s)")
    if int(os.environ.get("LOCAL_WORLD_SIZE", world_size)) > n:
        return "gloo"
    local = int(os.environ.get("LOCAL_RANK", rank))
    if idx != local:
        raise ValueError(
            f"NCCL needs a card a rank (local rank {local} on "
            f"cuda:{local}): this rank is on {device}, {n} card(s) visible")
    return "nccl"


def init_process_mesh(shape: Sequence[int], axis_names: Axes = AXES, *,
                      rank: int, world_size: int,
                      device: str | torch.device,
                      rendezvous: Optional[str] = None,
                      timeout_s: float = 120.0) -> ProcessMesh:
    """Join the process group and lay ``world_size`` ranks over
    ``axis_names``; every rank calls it with the same arguments but its
    ``rank``.  ``rendezvous`` is a directory (a ``file://`` store in it)
    or None for ``env://`` (``torchrun``'s ``MASTER_ADDR``/``PORT``).
    A world size other than the product of ``shape`` raises."""
    import datetime

    shape = tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    mesh = ProcessMesh(axis_names, shape, rank=rank,
                       device=resolve_device(device))
    if mesh.size != world_size:
        raise ValueError(f"mesh {shape} over {axis_names} needs "
                         f"{mesh.size} ranks, the world has {world_size}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if world_size == 1:
        return mesh
    mesh.backend = mesh_backend(mesh.device, world_size, rank)
    if mesh.backend == "nccl":
        torch.cuda.set_device(mesh.device)
    if rendezvous is not None:
        os.makedirs(rendezvous, exist_ok=True)
    init = ("env://" if rendezvous is None else
            "file://" + os.path.join(os.path.abspath(rendezvous),
                                     "rendezvous"))
    dist.init_process_group(mesh.backend, init_method=init, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    # every rank makes every group, in the same order
    for k in range(1, len(axis_names) + 1):
        for axes in itertools.combinations(axis_names, k):
            for ranks in _lines(mesh, axes):
                g = dist.new_group(ranks)
                if rank in ranks:
                    mesh.groups[axes] = g
    return mesh


def _lines(mesh: ProcessMesh, axes: Axes) -> List[List[int]]:
    """The rank lists of the groups along ``axes``, each in row-major
    order of ``axes``, the groups in order of the other coordinates."""
    grids = [range(n) for n in mesh.shape]
    lines: Dict[Tuple[int, ...], List[int]] = {}
    for r, c in enumerate(itertools.product(*grids)):
        rest = tuple(ci for a, ci in zip(mesh.axis_names, c) if a not in axes)
        lines.setdefault(rest, []).append(r)
    return [lines[k] for k in sorted(lines)]


def destroy_process_mesh(mesh: ProcessMesh) -> None:
    if mesh.backend is not None and dist.is_initialized():
        dist.destroy_process_group()


ACTIVATION_MODES = ("replicated", "sp")


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """What the model code reads of the active mesh: the mesh, the
    residual stream's layout between blocks (``activation_mode``:
    ``"replicated"`` over ``model``, or ``"sp"``, its sequence split over
    ``model``), the paths of the leaves this rank holds only its
    ``model`` shard of and computes with (tensor parallelism,
    ``launch/steps._tp_paths``), and under a serve step the specs of the
    whole KV caches (``launch/sharding.cache_shardings``): which caches
    a rank holds a chunk of the sequence of (``launch/steps.
    cache_layout``; None outside the serve steps)."""
    mesh: ProcessMesh
    activation_mode: str = "replicated"
    tp: FrozenSet[str] = frozenset()
    caches: Any = None

    def __post_init__(self) -> None:
        if self.activation_mode not in ACTIVATION_MODES:
            raise ValueError(f"activation_mode {self.activation_mode!r}: "
                             f"expected one of {ACTIVATION_MODES}")

    @property
    def sp(self) -> bool:
        """Whether the residual stream is sequence-sharded: ``"sp"`` on
        more than one ``model`` rank."""
        return (self.activation_mode == "sp"
                and self.mesh.axis_size("model") > 1)


_ACTIVE: List[MeshContext] = []


@contextlib.contextmanager
def set_mesh(mesh: Optional[ProcessMesh], *,
             activation_mode: str = "replicated",
             tp: FrozenSet[str] = frozenset(),
             caches: Any = None) -> Iterator[None]:
    """Make ``mesh`` the active mesh inside the block (the counterpart of
    ``jax.set_mesh``), with the activation mode, the tensor-parallel
    leaves and the caches' specs of ``MeshContext``; None leaves the
    active mesh as it is."""
    if mesh is None:
        yield
        return
    _ACTIVE.append(MeshContext(mesh, activation_mode, frozenset(tp), caches))
    try:
        yield
    finally:
        _ACTIVE.pop()


@contextlib.contextmanager
def use_context(ctx: Optional[MeshContext]) -> Iterator[None]:
    """``ctx`` as the only active context inside the block (None: no
    mesh), whatever is active around it: the recompute of a checkpointed
    function (``models/layers.remat``) runs in its forward's context."""
    saved = list(_ACTIVE)
    _ACTIVE[:] = [] if ctx is None else [ctx]
    try:
        yield
    finally:
        _ACTIVE[:] = saved


def current_mesh() -> Optional[ProcessMesh]:
    return _ACTIVE[-1].mesh if _ACTIVE else None


def current_context() -> Optional[MeshContext]:
    return _ACTIVE[-1] if _ACTIVE else None


def data_axes(mesh: ProcessMesh) -> Axes:
    """Axes that carry batch parallelism on this mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis(mesh: ProcessMesh) -> str:
    return "model"


def n_chips(mesh: ProcessMesh) -> int:
    return mesh.size


def parse_mesh(text: str) -> Tuple[int, ...]:
    """``"2x2"`` -> (2, 2), ``"2x2x4"`` -> (2, 2, 4): a ``--mesh`` flag."""
    try:
        shape = tuple(int(n) for n in text.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"--mesh {text!r}: expected DxM (data x model) or "
                         f"PxDxM (pod x data x model), e.g. 2x2")
    return shape


def init_from_env(shape: Sequence[int], axis_names: Axes = AXES, *,
                  device: str | torch.device) -> ProcessMesh:
    """``init_process_mesh`` with the rank and world size of the
    environment (``RANK``, ``WORLD_SIZE``: ``torchrun``'s, or
    ``spawn_ranks``'), the rendezvous directory ``MESH_RENDEZVOUS`` (or
    ``env://`` without it); a 1-rank world makes no process group."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    return init_process_mesh(
        shape, axis_names, rank=int(os.environ.get("RANK", "0")),
        world_size=world, device=device,
        rendezvous=os.environ.get("MESH_RENDEZVOUS"))


def rank_device(device: str | torch.device) -> torch.device:
    """The device a rank runs on: ``cuda:<LOCAL_RANK>`` when every rank
    of the host has a card of its own, ``cuda:0`` when ranks share one
    card (more ranks than cards), the CPU for ``cpu``."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                 os.environ.get("WORLD_SIZE", "1")))
    return torch.device("cuda", local if n_local <= torch.cuda.device_count()
                        else 0)


def spawn_ranks(argv: Sequence[str], world_size: int, rendezvous: str, *,
                timeout_s: float = 120.0,
                env: Optional[Dict[str, str]] = None
                ) -> List[Tuple[str, str]]:
    """Run ``python argv`` as ``world_size`` ranks on this host (the
    counterpart of ``torchrun --nproc-per-node``), each with ``RANK``,
    ``LOCAL_RANK``, ``WORLD_SIZE`` and ``MESH_RENDEZVOUS=rendezvous`` in
    its environment; returns each rank's (stdout, stderr).  A rank that
    fails, or a run past ``timeout_s``, stops every rank and raises with
    the failing rank's output."""
    os.makedirs(rendezvous, exist_ok=True)
    procs = []
    for r in range(world_size):
        e = {**os.environ, **(env or {}), "RANK": str(r),
             "LOCAL_RANK": str(r), "WORLD_SIZE": str(world_size),
             "LOCAL_WORLD_SIZE": str(world_size),
             "MESH_RENDEZVOUS": rendezvous}
        out = open(os.path.join(rendezvous, f"rank{r}.out"), "w+")
        err = open(os.path.join(rendezvous, f"rank{r}.err"), "w+")
        procs.append((subprocess.Popen([sys.executable, *argv], env=e,
                                       stdout=out, stderr=err), out, err))
    deadline = time.monotonic() + timeout_s
    failed: Optional[int] = None
    try:
        while any(p.poll() is None for p, _, _ in procs):
            bad = [r for r, (p, _, _) in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = bad[0] if bad else -1
                break
            time.sleep(0.05)
        else:
            bad = [r for r, (p, _, _) in enumerate(procs) if p.returncode]
            failed = bad[0] if bad else None
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
        for p, _, _ in procs:
            p.wait()
    texts = []
    for p, out, err in procs:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    if failed is not None:
        r = max(failed, 0)
        why = (f"rank {failed} exited {procs[failed][0].returncode}"
               if failed >= 0 else f"ranks ran past {timeout_s} s")
        raise RuntimeError(f"spawn_ranks: {why}; rank {r} stderr:\n"
                           f"{texts[r][1][-3000:]}")
    return texts
