"""Meshes: the reference's ``launch/mesh.py``.

``make_production_mesh`` and ``make_smoke_mesh`` are the LM meshes, each a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's shapes
and axis names: (data 16, model 16) = 256 ranks, (pod 2, data 16,
model 16) = 512, and the one-rank (data 1, model 1). A production mesh
takes the process group that exists (torchrun's, or the dry run's fake
group) and never falls back to a smaller mesh; the smoke mesh starts a
world-1 group when there is none. Functions, not module constants, so
importing this module touches no device and starts no group.

The data-parallel mesh: the reference's ``make_data_mesh``, as a list of
torch devices.

A ``DataMesh`` is the CNN serving shape: params are replicated on every
device, and a batch's leading dimension splits across the single "data"
axis, shard ``i`` on ``devices[i]``
(``cnn.executor.compile_plan(..., mesh=...)``). One program per batch
bucket stays one program; only its batch placement changes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

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


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the default
    process group's ranks (the reference's ``jax.make_mesh``), on
    ``device``'s type. The group must hold exactly ``prod(shape)`` ranks:
    any other size raises ``ValueError`` naming the size needed."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh {tuple(axis_names)} needs a "
            f"process group of world size {need}; "
            + ("no default group is initialised" if have is None
               else f"the default group has {have}"))
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks; the pod axis composes with data for
    gradient reduction. Needs a default group of exactly that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_smoke_mesh(device="cuda"):
    """The one-rank mesh with the production axis names. With no default
    process group it starts a world-1 group first (NCCL on a card, gloo
    on the CPU), in-process, with no address to pick."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh((1, 1), ("data", "model"), dev)
