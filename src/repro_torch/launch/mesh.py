"""Devices of the VIKIN array (the serving half of ``repro/launch/mesh.py``).

The reference serves its multi-chip array from one controller over a
1-D mesh of devices.  Its counterpart here is one process holding a list
of torch devices: the first N visible cards, N logical chips on the host
(``device="cpu"``, the counterpart of the reference's
``--xla_force_host_platform_device_count``), or an explicit list, repeats
allowed (``["cuda:0"] * 4`` serves four logical chips on one card).

The training half -- ``make_production_mesh``, ``make_host_mesh``,
``data_axes``, ``model_axis`` and ``n_chips`` -- waits for the
multi-process (``torch.distributed`` process group) design that expert
parallelism and the int32 gradient all-reduce share (ROADMAP.md queue 1,
items 4 and 5).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

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
