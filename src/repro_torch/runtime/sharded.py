"""The VIKIN array on torch devices: the data, pipeline and hetero plans.

Counterpart of ``repro/runtime/sharded.py`` (DESIGN.md Secs. 13 and 18),
with its names and its refusals.  One process serves the array over a
list of devices (``launch/mesh.require_devices``): the first N cards,
N logical chips on the host, or an explicit list such as
``["cuda:0"] * 4`` (four logical chips on one card).

* ``ShardedVikinBackend`` -- the DATA plan: one stack per distinct
  device (shards on one device share it), each engine tick's bucket
  split into ``n_shards`` per-shard power-of-two blocks, every shard's
  forward issued before any result is copied back, the blocks joined on
  the host.
* ``PipelineVikinBackend`` -- contiguous layer stages
  (``VikinStack(layer_range=...)``), one per chip (``stage_map``).
* ``HeteroVikinBackend`` -- chips pinned to one interconnect mode each
  (``mode_pins``); each same-mode segment runs on its pool's first chip,
  and ``pinned_modes`` tells the scheduler no flip is ever paid.

Every plan serves bitwise the answers of the single-device
``VikinBackend``: the kernels are row-independent (chip_smoke.py phase 2
holds it for each), a per-shard block is the same per-row program as the
global bucket, and the staged plans chain the same layers, at bf16 with
bf16 activations between stages (the host casts the input once and
widens the answer once).  The simulated fields come from the array's
cycle model (``core/engine.VikinArray``): wall cycles are per-chip
compute plus the host port's scatter/gather (``chip_cycles``,
``comm_cycles``, and ``bubble_cycles`` on the pipeline).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.engine import VikinArray, VikinHW
from repro_torch.core.modes import parse_mode
from repro_torch.launch.mesh import DeviceSpec, require_devices, serving_devices
from repro_torch.runtime.backends import VikinBackend
from repro_torch.utils import next_pow2


def _check_array(array: VikinArray, n_devices: int, hw: VikinHW,
                 precision: str) -> None:
    """The reference's agreement checks between an array model and the
    backend serving it."""
    if array.n_chips != n_devices:
        raise ValueError(
            f"array models {array.n_chips} chips but {n_devices} devices "
            f"were requested")
    if array.hw != hw:
        raise ValueError(
            "array.hw disagrees with the backend's hw: the array's chip "
            "model is what the cycle report runs")
    if array.precision != precision:
        raise ValueError(
            f"array precision {array.precision!r} disagrees with the "
            f"served precision {precision!r}")


class ShardedVikinBackend(VikinBackend):
    """``VikinBackend`` fanned out over ``devices`` data-parallel shards.

    ``devices`` is a count or a device list (``launch/mesh``); ``device``
    is the device type a count resolves on.  Only the bucket
    (``n_shards`` x a per-shard power of two), the device part of the
    forward and the cycle model (``VikinArray``, data plan) change; host
    staging, validation and slot handling are the single-device
    backend's.
    """

    def __init__(self, model: Any, params: Sequence[Dict[str, Any]], *,
                 devices: DeviceSpec, device: str | torch.device = "cuda",
                 hw: Optional[VikinHW] = None,
                 array: Optional[VikinArray] = None,
                 precision: str = "f32", **kw: Any) -> None:
        self.devices = serving_devices(devices, device)
        self.n_shards = len(self.devices)
        hw = hw or VikinHW()
        array = array or VikinArray(hw=hw, n_chips=self.n_shards,
                                    precision=precision)
        if array.plan != "data":
            raise ValueError(
                f"ShardedVikinBackend is the 'data' array plan; a "
                f"{array.plan!r} array belongs to "
                "PipelineVikinBackend/HeteroVikinBackend "
                "(make_array_backend picks by plan)")
        _check_array(array, self.n_shards, hw, precision)
        super().__init__(model, params, device=self.devices[0], hw=hw,
                         precision=precision, **kw)
        self.array = array

    def _place(self, params: Sequence[Dict[str, Any]]) -> None:
        # one stack per distinct device: shards on one device share it
        self._by_device = {dev: self.make_stack(params, dev)
                           for dev in dict.fromkeys(self.devices)}
        self.stack = self._by_device[self.devices[0]]

    def stacks(self) -> List[torch.nn.Module]:
        return list(self._by_device.values())

    def shard_bucket(self, n_active: int) -> int:
        """Per-shard rows: the power-of-two bucket for this shard's slice
        of the active set (>= min_bucket, the bitwise-determinism floor)."""
        per_shard = -(-max(n_active, 1) // self.n_shards)   # ceil div
        return next_pow2(max(per_shard, self.min_bucket))

    def bucket(self, n_active: int) -> int:
        """Global batch of one forward: ``n_shards`` contiguous per-shard
        buckets (shard j owns rows [j*b, (j+1)*b))."""
        return self.n_shards * self.shard_bucket(n_active)

    def run(self, x: torch.Tensor) -> List[torch.Tensor]:
        if x.shape[0] % self.n_shards:
            raise ValueError(
                f"a batch of {x.shape[0]} rows does not split into "
                f"{self.n_shards} shards; pad it to bucket(n)")
        rows = x.shape[0] // self.n_shards
        return [self.apply(self._by_device[dev], blk.to(dev))
                for blk, dev in zip(x.split(rows), self.devices)]


class _StagedVikinBackend(VikinBackend):
    """Shared body of the layer-staged plans (pipeline, hetero).

    Subclasses hand over ``_stage_ranges()`` -> [(lo, hi, device), ...]
    covering the stack in order; this base builds one
    ``VikinStack(layer_range=(lo, hi))`` per stage on its device and
    chains them, the activation hopping to the next stage's device in the
    served dtype.  The request bucket is the single-device backend's (one
    power-of-two bucket flows through every stage).
    """

    plan_name = "staged"

    def __init__(self, model: Any, params: Sequence[Dict[str, Any]], *,
                 devices: DeviceSpec, device: str | torch.device = "cuda",
                 array: Optional[VikinArray] = None,
                 precision: str = "f32", **kw: Any) -> None:
        if precision == "int8":
            raise ValueError(
                f"the {self.plan_name!r} array plan serves f32/bf16 only: "
                "the int8 path quantizes and runs the stack as one unit "
                "(core/quant.QuantVikinStack), which staging would split; "
                "use the 'data' plan for int8 arrays")
        self.devices = require_devices(
            devices, f"--array-plan {self.plan_name}", device)
        self.n_devices = len(self.devices)
        self._given_array = array
        super().__init__(model, params, device=self.devices[0],
                         precision=precision, **kw)

    def _place(self, params: Sequence[Dict[str, Any]]) -> None:
        array = self._given_array or self._default_array()
        if array.plan != self.plan_name:
            raise ValueError(
                f"{type(self).__name__} runs the {self.plan_name!r} plan "
                f"but the array is configured for {array.plan!r}")
        _check_array(array, self.n_devices, self.hw, self.precision)
        self.array = array
        self._stages = [(self.make_stack(params, dev, (lo, hi)), dev)
                        for lo, hi, dev in self._stage_ranges()]

    def stacks(self) -> List[torch.nn.Module]:
        return [stack for stack, _ in self._stages]

    def run(self, x: torch.Tensor) -> List[torch.Tensor]:
        for stack, dev in self._stages:
            x = self.apply(stack, x.to(dev))
        return [x]

    def _default_array(self) -> VikinArray:
        raise NotImplementedError

    def _stage_ranges(self) -> List[Tuple[int, int, torch.device]]:
        """[(lo, hi, device), ...] covering layers 0..n in order."""
        raise NotImplementedError


class PipelineVikinBackend(_StagedVikinBackend):
    """Pipeline plan: one contiguous layer stage per chip.

    The stages run one after another here (bitwise the single-device
    answers); the micro-batch overlap lives in the cycle model
    (``VikinArray(plan="pipeline")``: issue at the slowest stage plus the
    fill/drain bubble).  ``stage_map`` is the layers per stage; the
    default is an even split over ``min(devices, n_layers)`` chips.
    """

    plan_name = "pipeline"

    def __init__(self, model: Any, params: Sequence[Dict[str, Any]], *,
                 devices: DeviceSpec,
                 stage_map: Optional[Sequence[int]] = None,
                 **kw: Any) -> None:
        self._stage_map = (tuple(int(n) for n in stage_map)
                           if stage_map is not None else None)
        super().__init__(model, params, devices=devices, **kw)

    def _default_array(self) -> VikinArray:
        return VikinArray(hw=self.hw, n_chips=self.n_devices,
                          precision=self.precision, plan="pipeline",
                          stage_map=self._stage_map)

    def _stage_ranges(self) -> List[Tuple[int, int, torch.device]]:
        out, lo = [], 0
        for s, n in enumerate(self.array.stage_sizes(len(self.layers))):
            out.append((lo, lo + n, self.devices[s]))
            lo += n
        return out


class HeteroVikinBackend(_StagedVikinBackend):
    """Hetero plan: every chip pinned to one interconnect mode.

    ``mode_pins`` gives one mode per chip (default: half pipeline-mode,
    half parallel-mode); each maximal same-mode layer segment runs on its
    mode's pool, so ``reconfig_cycles`` is identically 0.  ``pinned_modes``
    is the scheduler contract (``SchedContext.pinned_modes``): every
    pinned mode is free to enter, so a mixed KAN/MLP stream is served in
    arrival order with no flips.
    """

    plan_name = "hetero"

    def __init__(self, model: Any, params: Sequence[Dict[str, Any]], *,
                 devices: DeviceSpec, mode_pins: Optional[Sequence] = None,
                 **kw: Any) -> None:
        self._mode_pins = (tuple(parse_mode(m) for m in mode_pins)
                           if mode_pins is not None else None)
        super().__init__(model, params, devices=devices, **kw)
        self.pinned_modes = frozenset(self.array.resolved_pins())

    def _default_array(self) -> VikinArray:
        return VikinArray(hw=self.hw, n_chips=self.n_devices,
                          precision=self.precision, plan="hetero",
                          mode_pins=self._mode_pins)

    def _stage_ranges(self) -> List[Tuple[int, int, torch.device]]:
        pins = self.array.resolved_pins()
        out = []
        for mode, lo, hi in self.plan.segment_slices():
            pool = [self.devices[i] for i, m in enumerate(pins) if m is mode]
            if not pool:
                # fail at construction, not at the first tick
                raise ValueError(
                    f"hetero array has no chip pinned to {mode.value!r} "
                    f"but {self.model.name!r} needs it (pins: "
                    f"{[m.value for m in pins]})")
            # the segment runs on the pool's first chip: rows are
            # independent, so where they run never changes them; the
            # pool's row split lives in the cycle model
            out.append((lo, hi, pool[0]))
        return out


def make_array_backend(model: Any, params: Sequence[Dict[str, Any]], *,
                       devices: DeviceSpec, plan: str = "data",
                       stage_map: Optional[Sequence[int]] = None,
                       mode_pins: Optional[Sequence] = None,
                       **kw: Any) -> VikinBackend:
    """The array backend of ``--array-plan``: data ->
    ``ShardedVikinBackend``, pipeline -> ``PipelineVikinBackend``
    (``stage_map``), hetero -> ``HeteroVikinBackend`` (``mode_pins``)."""
    if plan == "data":
        if stage_map is not None or mode_pins is not None:
            raise ValueError(
                "stage_map/mode_pins only apply to the pipeline/hetero "
                "plans; the data plan replicates the whole stack")
        return ShardedVikinBackend(model, params, devices=devices, **kw)
    if plan == "pipeline":
        if mode_pins is not None:
            raise ValueError("mode_pins is a hetero-plan knob")
        return PipelineVikinBackend(model, params, devices=devices,
                                    stage_map=stage_map, **kw)
    if plan == "hetero":
        if stage_map is not None:
            raise ValueError("stage_map is a pipeline-plan knob")
        return HeteroVikinBackend(model, params, devices=devices,
                                  mode_pins=mode_pins, **kw)
    raise ValueError(
        f"unknown array plan {plan!r}; choose from data|pipeline|hetero")
