"""Activation-sharding policy plumbing: the reference's
``distributed/api.py`` over DTensor.

The model code is mesh-agnostic; launchers install a policy (batch axes
+ sequence axis) before running a step, and the per-layer residual
stream is redistributed to it so saved activations (remat inputs) stay
sequence-sharded — Megatron-style sequence parallelism.

The reference's ``with_sharding_constraint`` becomes
``DTensor.redistribute`` onto the tensor's own mesh. Every helper is the
identity when no policy is installed or its input is not a ``DTensor``,
so an unsharded step runs exactly the ops it ran before.

GSPMD repartitions any op; DTensor raises on a view that splits or
merges a sharded dim and has no rule for some ops. So the model keeps
its activations batch-sharded between ops (``batch_sharded``: the batch
dim on the data axes, every other dim whole; the reference's
sequence-sharded residual is kept between blocks and gathered at the
next projection, as Megatron's sequence parallelism does), and runs the
blocks DTensor has no rule for on local shards (``local_map``: the
attention and MLA cores context-parallel over the model axis, or the
attention core head-parallel under ``REPRO_ATTN_SHARD=heads``, the SSD
scan and the decode cores per batch shard, the MoE dispatch
expert-parallel over the model axis).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional, Tuple

import torch

from repro_torch.distributed.sharding import (PartitionSpec as P,
                                              mesh_axes, placements)


@dataclasses.dataclass(frozen=True)
class ActivationPolicy:
    batch_axes: Tuple[str, ...]      # e.g. ("pod", "data")
    seq_axis: Optional[str]          # "model" for sequence parallelism
    batch_divisor: int               # product of batch axis sizes
    seq_divisor: int                 # size of the seq axis
    model_divisor: int = 1           # size of the model axis (TP)


_POLICY: Optional[ActivationPolicy] = None


def set_activation_policy(policy: Optional[ActivationPolicy]) -> None:
    global _POLICY
    _POLICY = policy


def current_policy() -> Optional[ActivationPolicy]:
    """The installed activation policy (None when there is none)."""
    return _POLICY


def policy_from_mesh(mesh, seq_parallel: bool = True) -> ActivationPolicy:
    sizes = mesh_axes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    bdiv = 1
    for a in batch_axes:
        bdiv *= sizes[a]
    mdiv = sizes.get("model", 1)
    sdiv = mdiv if seq_parallel else 1
    return ActivationPolicy(batch_axes=batch_axes,
                            seq_axis="model" if seq_parallel else None,
                            batch_divisor=bdiv, seq_divisor=sdiv,
                            model_divisor=mdiv)


@contextlib.contextmanager
def activation_policy(policy: Optional[ActivationPolicy]):
    global _POLICY
    prev = _POLICY
    _POLICY = policy
    try:
        yield
    finally:
        _POLICY = prev


_DTENSOR = None


def _is_dtensor(x) -> bool:
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


def _constrain(x, spec) -> torch.Tensor:
    """``x`` redistributed to ``spec`` on its own mesh (the reference's
    ``with_sharding_constraint``)."""
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(spec, mesh))


def _batch_axes(pol: ActivationPolicy, b: int):
    return pol.batch_axes if (pol.batch_axes and b % pol.batch_divisor == 0
                              and b > 1) else None


def gather_layer_params(layer_params):
    """Streamed-FSDP weight gather: each weight leaf of ONE layer's params
    replicated over the data axis (TP sharding on the model axis intact)
    right before use — one all-gather per weight and layer, whose
    backward is the gradient's reduce-scatter. Only the current layer is
    ever gathered."""
    pol = _POLICY
    if pol is None or not pol.batch_axes:
        return layer_params

    def f(name: str, leaf):
        if not _is_dtensor(leaf) or leaf.ndim < 2:
            return leaf
        nd = leaf.ndim
        spec = [None] * nd
        if any(k in name for k in ("w_gate", "w_up", "w_down")) and nd >= 3:
            if leaf.shape[nd - 3] % pol.model_divisor == 0:
                spec[nd - 3] = "model"       # experts stay EP-sharded
        elif name.endswith("/w"):
            if leaf.shape[nd - 1] % pol.model_divisor == 0:
                spec[nd - 1] = "model"       # TP out-dim intact
            elif leaf.shape[nd - 2] % pol.model_divisor == 0:
                spec[nd - 2] = "model"
        else:
            return leaf
        return _constrain(leaf, P(*spec))

    def walk(node, prefix: str):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        return f(prefix, node)

    return walk(layer_params, "")


def constrain_residual(x: torch.Tensor) -> torch.Tensor:
    """Apply the activation policy to a (B, S, d) residual-stream tensor.
    No-op when no policy is installed or dims don't divide."""
    pol = _POLICY
    if pol is None or not _is_dtensor(x) or x.ndim != 3:
        return x
    b, s, _ = x.shape
    b_ax = _batch_axes(pol, b)
    s_ax = pol.seq_axis if (pol.seq_axis and s % pol.seq_divisor == 0
                            and s > 1) else None
    if b_ax is None and s_ax is None:
        return x
    return _constrain(x, P(b_ax, s_ax, None))


def constrain_qkv(q, k, v):
    """Attention-strategy switch (``REPRO_ATTN_SHARD``):

    * "seq" (default): q/k/v inherit the sequence-sharded residual —
      context-parallel attention (``context_parallel``);
    * "heads": shard q on the head dim over the model axis, replicate k/v
      heads — attention becomes local per shard (``heads_parallel``);
      only the output projection's partial sum remains. Where the heads
      do not split evenly over the model axis q/k/v are left as they
      are and the "seq" strategy runs (the reference keeps its baseline
      where GSPMD rejects the uneven split; the port's local blocks take
      even shards only).
    """
    pol = _POLICY
    mode = os.environ.get("REPRO_ATTN_SHARD", "seq")
    if pol is None or mode != "heads" or q.ndim != 4 or not _is_dtensor(q):
        return q, k, v
    if q.shape[2] % model_size(q.device_mesh):
        return q, k, v
    b_ax = _batch_axes(pol, q.shape[0])
    return (_constrain(q, P(b_ax, None, "model", None)),
            _constrain(k, P(b_ax, None, None, None)),
            _constrain(v, P(b_ax, None, None, None)))


def constrain_decode_q(q):
    """Decode attention: align q's head_dim sharding with a head_dim-
    sharded KV cache, so the scores contract per shard and only the small
    partial scores are reduced."""
    pol = _POLICY
    if pol is None or not _is_dtensor(q) or q.ndim != 4 or q.shape[1] != 1:
        return q
    if q.shape[-1] % pol.model_divisor:
        return q
    return _constrain(q, P(_batch_axes(pol, q.shape[0]), None, None,
                           "model"))


# ---------------------------------------------------------------------------
# Batch-sharded activations and blocks on local shards.
# ---------------------------------------------------------------------------

def batch_axes_of(mesh, b: int):
    """The data axes of ``mesh`` when a batch of ``b`` > 1 rows splits
    evenly over them, else None (the batch is replicated; as in
    ``constrain_residual``, one row is never sharded: DTensor cannot
    view away a sharded dim of size 1)."""
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    n = 1
    for a in axes:
        n *= sizes[a]
    return axes if axes and b > 1 and b % n == 0 else None


def batch_sharded(x):
    """``x`` with its batch dim (0) on the data axes where it divides and
    every other dim whole: what each op of the model may view, reshape or
    reduce freely. The identity on a tensor that is not a ``DTensor``."""
    if not _is_dtensor(x) or x.ndim == 0:
        return x
    return _constrain(x, P(batch_axes_of(x.device_mesh, x.shape[0]),
                           *([None] * (x.ndim - 1))))


def gathered(x):
    """``x`` whole on every rank (the identity on a tensor that is not a
    ``DTensor``): for small params an op reads beside an activation."""
    if not _is_dtensor(x):
        return x
    return _constrain(x, P())


def data_gathered(x):
    """``x`` whole over the data axes, its model-axis placement kept: the
    FSDP gather of a weight read outside a layer (the unembedding)."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    return x.redistribute(mesh, tuple(
        pl if a == "model" else Replicate()
        for a, pl in zip(mesh_axes(mesh), x.placements)))


def model_size(mesh) -> int:
    return mesh_axes(mesh).get("model", 1)


def model_rank(mesh) -> int:
    """This rank's coordinate on the model axis (0 without one)."""
    if "model" not in mesh_axes(mesh):
        return 0
    return mesh.get_local_rank("model")


def mesh_placements(mesh, batch: bool, model=None) -> tuple:
    """One placement per mesh dim: ``Shard(0)`` on the data axes when
    ``batch``, else ``Replicate()``; ``model`` (default ``Replicate()``)
    on the model axis."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple((model or Replicate()) if a == "model"
                 else Shard(0) if batch else Replicate()
                 for a in mesh_axes(mesh))


def weight_grads(mesh, batch: bool, model=None) -> tuple:
    """Gradient placements of a weight every rank reads whole on the data
    axes: partial sums there when the batch is split (``batch``), else
    whole; ``model`` (default ``Replicate()``) on the model axis —
    ``Partial()`` where the model ranks split the work, ``Shard(d)``
    where each reads only its slice."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple((model or Replicate()) if a == "model"
                 else Partial() if batch else Replicate()
                 for a in mesh_axes(mesh))


def local_map(fn, mesh, args, in_placements, out_placements,
              grad_placements=None):
    """``fn`` on the local shards of ``args`` (the reference's GSPMD
    partitioning a block DTensor has no rule for). Tensor ``i`` is
    redistributed to ``in_placements[i]`` (a tensor that is not a
    ``DTensor`` is taken as replicated), its gradient comes back in
    ``grad_placements[i]`` (default: its placements, Partial made
    Replicate), and each output of ``fn`` becomes a ``DTensor`` with
    ``out_placements[i]``. Every shard is an even split (the rules'
    divisibility checks)."""
    from torch.distributed.tensor import DTensor, Replicate
    grads = grad_placements or [None] * len(args)
    local = []
    for a, pl, gpl in zip(args, in_placements, grads):
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * len(pl),
                                   run_check=False)
        local.append(a.redistribute(mesh, pl).to_local(grad_placements=gpl))
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(t, mesh, pl, run_check=False)
                     for t, pl in zip(out, out_placements))
    return DTensor.from_local(out, mesh, out_placements, run_check=False)


def is_sharded(*xs) -> bool:
    """Whether any of ``xs`` is a ``DTensor``: the model takes its mesh
    branch only then."""
    return any(_is_dtensor(x) for x in xs)


def context_parallel(core, q_args, kv_args, w_args=()):
    """``core(shift, *q_args, *kv_args, *w_args)`` with the queries' rows
    (dim 1) split over the model axis when it divides them, the keys and
    values and ``w_args`` whole, each batch-sharded (the reference's
    "seq" attention strategy, which GSPMD derives from the sequence-
    sharded residual). ``shift`` is this rank's first query row; the
    output is sharded as the queries are. Keys', values' and weights'
    gradients are partial sums where their readers are split."""
    from torch.distributed.tensor import Partial, Shard
    mesh = q_args[0].device_mesh
    b, s = q_args[0].shape[:2]
    batch = batch_axes_of(mesh, b) is not None
    m = model_size(mesh)
    split = m > 1 and s % m == 0
    q_pl = mesh_placements(mesh, batch, Shard(1) if split else None)
    kv_pl = mesh_placements(mesh, batch)
    kv_grad = mesh_placements(mesh, batch, Partial() if split else None)
    shift = model_rank(mesh) * (s // m) if split else 0
    return local_map(
        lambda *t: core(shift, *t), mesh, (*q_args, *kv_args, *w_args),
        [q_pl] * len(q_args) + [kv_pl] * len(kv_args)
        + [mesh_placements(mesh, False)] * len(w_args), q_pl,
        [None] * len(q_args) + [kv_grad] * len(kv_args)
        + [weight_grads(mesh, batch, Partial() if split else None)]
        * len(w_args))


def heads_split(q) -> bool:
    """Whether ``q`` (B, S, H, D) has its heads (dim 2) on the model axis:
    ``constrain_qkv``'s "heads" strategy placed it so."""
    from torch.distributed.tensor import Shard
    if not _is_dtensor(q) or "model" not in mesh_axes(q.device_mesh):
        return False
    axis = list(mesh_axes(q.device_mesh)).index("model")
    return q.placements[axis] == Shard(2)


def heads_parallel(core, q, kv_args):
    """``core(h0, q, *kv_args)`` on this rank's query heads (the
    reference's "heads" attention strategy): q's head dim (2) split over
    the model axis, the keys and values whole, their heads replicated,
    each batch-sharded. ``h0`` is this rank's first query head; no query
    row reads another rank's heads, so the core needs no collective. The
    output is sharded as q is; the keys' and values' gradients are
    partial sums over the model axis (each rank's heads read their own
    share of the key and value heads)."""
    from torch.distributed.tensor import Partial, Shard
    mesh = q.device_mesh
    batch = batch_axes_of(mesh, q.shape[0]) is not None
    m = model_size(mesh)
    h0 = model_rank(mesh) * (q.shape[2] // m)
    q_pl = mesh_placements(mesh, batch, Shard(2))
    kv_pl = mesh_placements(mesh, batch)
    kv_grad = mesh_placements(mesh, batch, Partial() if m > 1 else None)
    return local_map(lambda q_, *kv: core(h0, q_, *kv), mesh,
                     (q, *kv_args), [q_pl] + [kv_pl] * len(kv_args), q_pl,
                     [None] + [kv_grad] * len(kv_args))


def batch_local(core, args, w_args=()):
    """``core(*args, *w_args)`` on each batch shard: ``args`` (and the
    output) batch-sharded, ``w_args`` whole; the model axis repeats the
    work (the SSD scan, whose heads and state the reference's
    partitioner may split, runs whole on every model rank)."""
    mesh = args[0].device_mesh
    batch = batch_axes_of(mesh, args[0].shape[0]) is not None
    pl = mesh_placements(mesh, batch)
    return local_map(core, mesh, (*args, *w_args),
                     [pl] * len(args)
                     + [mesh_placements(mesh, False)] * len(w_args), pl,
                     [None] * len(args)
                     + [weight_grads(mesh, batch)] * len(w_args))


def batch_sums(core, args, n_out: int):
    """``core(*args)`` on each batch shard, its ``n_out`` outputs sums
    over the rows: partial sums over the data axes the batch is split on
    (a gradient flows back to each shard's rows only, where a replicated
    sum would broadcast it to the whole batch on every rank)."""
    mesh = args[0].device_mesh
    batch = batch_axes_of(mesh, args[0].shape[0]) is not None
    pl = mesh_placements(mesh, batch)
    return local_map(core, mesh, args, [pl] * len(args),
                     (weight_grads(mesh, batch),) * n_out)


def decode_local(core, args, caches, w_args=()):
    """A decode block on local shards: ``core(*args, *w_args, *caches)``
    with ``args`` batch-sharded, ``w_args`` whole and each cache leaf
    gathered whole on its batch shard (the reference's partitioner
    gathers a sequence-sharded cache the same way); ``core`` updates the
    caches in place, and each
    leaf's own shard is written back. Returns ``core``'s output,
    batch-sharded. Runs under ``no_grad`` (decode has no backward)."""
    from torch.distributed.tensor import DTensor
    mesh = caches[0].device_mesh
    batch = batch_axes_of(mesh, args[0].shape[0]) is not None
    pl = mesh_placements(mesh, batch)
    full = [c.redistribute(mesh, pl).to_local() for c in caches]
    out = local_map(lambda *t: core(*t, *full), mesh, (*args, *w_args),
                    [pl] * len(args)
                    + [mesh_placements(mesh, False)] * len(w_args), pl)
    for c, f in zip(caches, full):
        c.to_local().copy_(DTensor.from_local(f, mesh, pl, run_check=False)
                           .redistribute(mesh, c.placements).to_local())
    return out
