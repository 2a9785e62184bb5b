"""Placement on a data-parallel mesh: the reference's ``data_axes`` and
``data_shard_count``, and the torch counterparts of its ``replicated``
and ``batch_input_sharding`` shardings.

Params are replicated on every device of the mesh; a batched input's
leading dimension splits evenly across the mesh's data axes, shard ``i``
on ``mesh.devices[i]``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Params = Dict[int, Dict[str, torch.Tensor]]


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_shard_count(mesh) -> int:
    """Number of ways the batch dimension splits on ``mesh`` — the product
    of the data-parallel axis sizes (1 when the mesh has no data axes).
    Every data-sharded batch must be a multiple of it, so the serving
    engine builds its bucket ladder in multiples of it."""
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


def replicate(params: Params, mesh) -> Tuple[Params, ...]:
    """One params dict per shard, each tensor on that shard's device: a
    tensor is copied to each device once (one already there is not
    copied), and shards on one device share one dict."""
    def placed(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        here = t.device
        if here.type == dev.type and (here.index or 0) == dev.index:
            return t
        return t.to(dev)

    per_device: Dict[torch.device, Params] = {}
    for dev in mesh.devices:
        if dev not in per_device:
            per_device[dev] = {nid: {k: placed(t, dev)
                                     for k, t in layer.items()}
                               for nid, layer in params.items()}
    return tuple(per_device[dev] for dev in mesh.devices)


def shard_batch(x, mesh) -> Tuple[torch.Tensor, ...]:
    """Per-shard views of a batched ``(B, H, W, C)`` tensor (a numpy array
    is taken as an f32 tensor first), in shard order: rows ``[i * B / n,
    (i + 1) * B / n)`` for shard ``i`` of ``n``. Anything else raises
    ``ValueError``: an unbatched input, or a batch that does not divide."""
    if isinstance(x, np.ndarray):
        x = torch.as_tensor(x, dtype=torch.float32)
    if x.ndim != 4:
        raise ValueError(
            "mesh-sharded compiled plans take batched (B, H, W, C) "
            f"input; got shape {tuple(x.shape)}")
    n = data_shard_count(mesh)
    if x.shape[0] % n:
        raise ValueError(
            f"batch {x.shape[0]} does not divide across "
            f"{n} data shards — pad to a multiple (the serving "
            "engine's sharded bucket ladder guarantees this)")
    per = x.shape[0] // n
    return tuple(x[i * per:(i + 1) * per] for i in range(n))
