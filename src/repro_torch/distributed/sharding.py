"""Sharding rules: the reference's ``distributed/sharding.py`` over torch.

Two halves:

* the CNN data-parallel mesh (``DataMesh``): ``data_axes``,
  ``data_shard_count``, ``replicate`` and ``shard_batch``. Params are
  replicated on every device of the mesh; a batched input's leading
  dimension splits evenly across the mesh's data axes, shard ``i`` on
  ``mesh.devices[i]``;
* the LM mesh (a ``DeviceMesh`` named ``("data", "model")`` or
  ``("pod", "data", "model")``): the reference's name-based rules
  ``param_spec``, ``params_shardings``, ``batch_shardings``,
  ``cache_shardings`` and ``replicated``, with its divisibility checks.

Strategy (the reference's baseline):
  * weights: TP on the model axis (column-split d_ff / heads / experts) ×
    FSDP on the data axis (row-split), ZeRO-3 style;
  * activations: batch on (pod, data);
  * decode KV caches: batch on data, sequence on model;
  * optimizer states inherit the parameter sharding.

A rule reads only the mesh's axis names and sizes, so it takes a
``DeviceMesh``, a ``DataMesh`` or a shape-only ``AbstractMesh`` (no
ranks: the tests hand it 16×16 and 2×16×16). ``PartitionSpec`` is the
reference's spec, one entry per tensor dim (``None``, an axis name or a
tuple of names), and compares equal to it entry for entry.
``NamedSharding(mesh, spec).placements`` is the torch form: one
``Shard(d)`` or ``Replicate()`` per mesh dim, a tensor dim on
``("pod", "data")`` being ``Shard(d)`` on both, in mesh-dim order (the
reference's major-to-minor order). ``distribute`` places a tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.scan_util import (tree_leaves,
                                          tree_leaves_with_path,
                                          tree_unflatten)

Params = Dict[int, Dict[str, torch.Tensor]]
PyTree = Any


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: ``PartitionSpec("model", None)``
    shards dim 0 on the model axis and replicates dim 1; an entry may be
    a tuple of axis names. Trailing dims past its length are replicated.
    As there, a one-name tuple is that name and an empty one ``None``."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, tuple) and len(e) <= 1:
                return e[0] if e else None
            return e
        return super().__new__(cls, tuple(canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no ranks, the reference's
    ``jax.sharding.AbstractMesh((16, 16), ("data", "model"))``."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh-dim order, for any of the three mesh
    kinds (a ``DeviceMesh`` keeps its names in ``mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def data_shard_count(mesh) -> int:
    """Number of ways the batch dimension splits on ``mesh`` — the product
    of the data-parallel axis sizes (1 when the mesh has no data axes).
    Every data-sharded batch must be a multiple of it, so the serving
    engine builds its bucket ladder in multiples of it."""
    return _axis_size(mesh, data_axes(mesh) or None)


# ---------------------------------------------------------------------------
# The CNN data-parallel mesh.
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# The LM mesh: specs, placements, rules.
# ---------------------------------------------------------------------------

def placements(spec: Sequence, mesh) -> tuple:
    """One ``Shard(d)`` / ``Replicate()`` per mesh dim of ``mesh`` for
    ``spec``. An axis named by two tensor dims raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is None:
                continue
            if a in owner:
                raise ValueError(f"{spec}: mesh axis {a!r} shards tensor "
                                 f"dims {owner[a]} and {d}")
            owner[a] = d
    unknown = set(owner) - set(mesh_axes(mesh))
    if unknown:
        raise ValueError(f"{spec} names {sorted(unknown)}, not axes of "
                         f"the mesh {tuple(mesh_axes(mesh))}")
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh_axes(mesh))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The reference's ``NamedSharding(mesh, spec)``."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _path_str(path: str) -> str:
    """A leaf's path as the reference's rules read it: dict keys and
    sequence indices joined by ``/``; a ``NamedTuple`` field (``.m``,
    ``.v``, ``.step`` of an ``OptState``) is dropped, as the reference's
    ``_path_str`` drops a ``GetAttrKey``."""
    return "/".join(p for p in path.split("/") if p and not p.startswith("."))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_axes(mesh)
    n = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        n *= sizes[a]
    return n


def param_spec(path_s: str, shape: Tuple[int, ...], mesh,
               fsdp: bool = True) -> PartitionSpec:
    """PartitionSpec for one parameter leaf. Axes are only assigned when
    the dimension divides the axis size exactly."""
    axes: list = [None] * len(shape)
    fsdp_axis = "data" if (fsdp and "data" in mesh_axes(mesh)) else None

    def put(dim: int, axis: Optional[str]):
        if axis is not None and 0 <= dim < len(shape) \
                and axes[dim] is None \
                and shape[dim] % _axis_size(mesh, axis) == 0:
            axes[dim] = axis

    nd = len(shape)
    if "embed/table" in path_s or "lm_head/table" in path_s:
        # (vocab, d): vocab → model, d → data (FSDP); fall back to sharding
        # d on model when the vocab doesn't divide (e.g. 50280).
        put(0, "model")
        if axes[0] is None:
            put(1, "model")
        else:
            put(1, fsdp_axis)
    elif any(k in path_s for k in ("w_gate", "w_up", "w_down")) and nd >= 3:
        # Expert-stacked (E, d, f): E → model (EP), d/f row → data (FSDP).
        put(nd - 3, "model")
        put(nd - 2, fsdp_axis)
    elif path_s.endswith("/w") and nd >= 2:
        # Generic 2-D projection (stacked under L/group dims): last two dims
        # are (in, out): out → model (TP), in → data (FSDP).
        put(nd - 1, "model")
        put(nd - 2, fsdp_axis)
        if axes[nd - 1] is None:       # odd out-dim: TP on the in-dim
            put(nd - 2, "model")
    elif path_s.endswith("conv_w") and nd >= 2:
        put(nd - 1, "model")        # depthwise channels
    elif nd >= 1 and shape[-1] >= 1024:
        put(nd - 1, "model")        # big vectors (norm scales stay small)
    return PartitionSpec(*axes)


def _map_with_path(fn, tree: PyTree) -> PyTree:
    """``fn(path, leaf)`` over ``tree``'s leaves, in the tree's shape."""
    return tree_unflatten(tree, [fn(p, leaf) for p, leaf in
                                 tree_leaves_with_path(tree)])


def params_shardings(param_shapes: PyTree, mesh, fsdp: bool = True) -> PyTree:
    return _map_with_path(lambda p, leaf: NamedSharding(
        mesh, param_spec(_path_str(p), tuple(leaf.shape), mesh, fsdp)),
        param_shapes)


def batch_shardings(batch_shapes: PyTree, mesh) -> PyTree:
    dp = data_axes(mesh)

    def f(_path, leaf):
        if leaf.ndim == 0:
            return NamedSharding(mesh, PartitionSpec())
        if leaf.shape[0] % _axis_size(mesh, dp) == 0:
            axes = [dp] + [None] * (leaf.ndim - 1)
        elif len(dp) > 1 and leaf.shape[0] % _axis_size(mesh, dp[:1]) == 0:
            axes = [dp[:1]] + [None] * (leaf.ndim - 1)
        else:
            axes = [None] * leaf.ndim
        return NamedSharding(mesh, PartitionSpec(*axes))
    return _map_with_path(f, batch_shapes)


def cache_shardings(cache_shapes: PyTree, mesh) -> PyTree:
    """Decode caches. Leaves are stacked (L..., B, S, ...) for attention,
    (L..., B, ...) for SSM states: the batch dim on data (if > 1) and the
    longest remaining dim on model (sequence-parallel KV / state
    channels)."""
    dp = data_axes(mesh)

    def f(path, leaf):
        p = _path_str(path)
        shape = tuple(leaf.shape)
        axes: list = [None] * len(shape)
        # The batch dim: 1 for (L, B, …), 2 for (ng, k, B, …).
        if "mamba" in p or "dense" in p:
            b_dim = 2 if len(shape) >= 5 else 1
        else:
            b_dim = 1
        if "attn" in p and "dense" in p:
            b_dim = 2
        if shape[b_dim] > 1 and shape[b_dim] % _axis_size(mesh, dp) == 0:
            axes[b_dim] = dp
        cand = [(d, i) for i, d in enumerate(shape)
                if i != b_dim and axes[i] is None
                and d % _axis_size(mesh, "model") == 0]
        if cand:
            d, i = max(cand)
            if d >= 16:
                axes[i] = "model"
        return NamedSharding(mesh, PartitionSpec(*axes))
    return _map_with_path(f, cache_shapes)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_slices(shape: Sequence[int], pl: Sequence, mesh) -> tuple:
    """This rank's shard of a tensor of ``shape`` under placements ``pl``
    on ``mesh``, as one ``slice`` per dim: the mesh dims in order, each
    ``Shard(d)`` taking this rank's ``torch.chunk`` of what dim ``d``
    still spans (DTensor's own split). Applies to a host array as well
    as to a tensor, so a rank can read its shard alone."""
    from torch.distributed.tensor import Shard
    start, size = [0] * len(shape), list(shape)
    for c, p, n in zip(mesh.get_coordinate(), pl, mesh.shape):
        if isinstance(p, Shard):
            d = p.dim % len(shape)
            chunk = -(-size[d] // n)
            lo = min(c * chunk, size[d])
            start[d] += lo
            size[d] = min(chunk, size[d] - lo)
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def _contiguous_strides(shape: Sequence[int]) -> tuple:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def from_shard(local: torch.Tensor, shape: Sequence[int],
               sh: NamedSharding):
    """A ``DTensor`` of global ``shape`` with placements ``sh`` from this
    rank's shard ``local`` (a host tensor, copied to the mesh's device
    here)."""
    from torch.distributed.tensor import DTensor
    dev = torch.device(sh.mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    local = local.to(dev, copy=True, memory_format=torch.contiguous_format)
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


@torch.no_grad()
def load_shard(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the whole tensor ``src`` (on the host, or any device) into
    ``dst``; a ``DTensor`` ``dst`` takes only its own shard of it (by its
    placements), which is all that is read of ``src``."""
    from torch.distributed.tensor import DTensor
    if isinstance(dst, DTensor):
        src = src[shard_slices(src.shape, dst.placements, dst.device_mesh)]
        dst = dst.to_local()
    dst.copy_(src)


def distribute(tree: PyTree, shardings: PyTree) -> PyTree:
    """The reference's ``jax.device_put(tree, shardings)``: each leaf a
    ``DTensor`` on its sharding's ``DeviceMesh``, each rank taking its own
    shard of the whole tensor it holds (a slice, copied alone to the
    device: the whole leaf never goes there); a ``DTensor`` leaf is
    redistributed."""
    from torch.distributed.tensor import DTensor

    def place(t: torch.Tensor, sh: NamedSharding):
        if isinstance(t, DTensor):
            return t.redistribute(sh.mesh, sh.placements)
        return from_shard(t[shard_slices(t.shape, sh.placements, sh.mesh)],
                          t.shape, sh)
    return tree_unflatten(tree, [place(t, sh) for t, sh in
                                 zip(tree_leaves(tree),
                                     tree_leaves(shardings))])
