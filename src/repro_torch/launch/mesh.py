"""The data-parallel mesh: the reference's ``make_data_mesh``, as a list of
torch devices.

A ``DataMesh`` is the CNN serving shape: params are replicated on every
device, and a batch's leading dimension splits across the single "data"
axis, shard ``i`` on ``devices[i]``
(``cnn.executor.compile_plan(..., mesh=...)``). One program per batch
bucket stays one program; only its batch placement changes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.common import resolve_device


def _indexed(device) -> torch.device:
    """``device`` as a ``torch.device`` with an explicit index (0 where
    none is given)."""
    dev = torch.device(device)
    return torch.device(dev.type, 0 if dev.index is None else dev.index)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A one-axis ("data") mesh over ``devices``, each a ``torch.device``
    with an explicit index.

    ``make_data_mesh`` builds one over distinct devices. A mesh built
    directly may name a device more than once: shard ``i`` then runs on
    ``devices[i]`` all the same. That stands in for the reference's
    simulated host devices (``--xla_force_host_platform_device_count``):
    CPU tests get 2, 4 or 8 shards this way, and one card can run the whole
    split path (split, per-shard programs, gather). Such a mesh tests
    placement, never speed."""

    devices: Tuple[torch.device, ...]
    axis_names = ("data",)

    def __post_init__(self) -> None:
        devices = tuple(_indexed(d) for d in self.devices)
        if not devices:
            raise ValueError("a DataMesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"mesh devices {devices} mix device types")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}


def make_data_mesh(n_devices: Optional[int] = None,
                   device="cuda") -> DataMesh:
    """Pure data-parallel mesh over the first ``n_devices`` devices of
    ``device``'s type (all of them by default): the visible CUDA cards, or
    the one CPU. ``n_devices`` outside ``[1, count]`` raises
    ``ValueError``; asking for CUDA without a card raises as every entry
    point does. No device is named twice."""
    dev = resolve_device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_devices is not None:
        if not 1 <= n_devices <= count:
            raise ValueError(f"n_devices={n_devices} not in [1, {count}]")
        count = n_devices
    return DataMesh(tuple(torch.device(dev.type, i) for i in range(count)))
