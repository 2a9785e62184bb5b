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
merges a sharded dim and has no rule for some ops. So the model states
the reference's activation plan (read from its compiled HLO on a 2×2
mesh) in these pieces:

* the residual stream sequence-sharded over the model axis
  (``constrain_residual``); row-wise ops (the norms) run on it as it is;
* one gather per norm of that residual, whole over the model axis
  (``model_whole``), read by the column-parallel products that follow
  (``sharded_linear``: the output kept sharded on its last dim);
* row-parallel products on those outputs, whose model-axis partial sums
  are reduce-scattered back onto the residual's layout
  (``residual_out``);
* the vocab-parallel cross entropy (``vocab_ce_sums``): per-rank max,
  sum of exponentials and target logit, reduced over the model axis;
* blocks DTensor has no rule for on local shards (``local_map``): the
  attention and MLA cores on each rank's heads (``heads_parallel``), or
  context-parallel where the heads do not split (``context_parallel``),
  the SSD block on each rank's heads (``models.ssm``), the MoE dispatch
  expert-parallel over the model axis.

Decode (``decode_plan``, entered by ``models.model.decode_step``) runs
the reference's compiled ``serve_step`` plan with the weights resident:
every product reads its weight where it lies (``resident_linear``:
column-parallel on a whole input, a column output gathered first, a row
each), and each attention core attends its caches on their own shards
(``decode_attend``, ``CacheShard``): each rank scores its slots, and the
softmax's partial max, sums and outputs are all-reduced over the model
axis, as the reference's MLA plan does (its GQA plan re-lays the cache
onto head shards by all-to-all instead); the new token is written by
the rank that holds its slot. No cache leaf is made whole.

Prefill (``prefill_plan``, entered by ``models.model.prefill``) runs the
reference's compiled ``prefill_step`` plan: the residual stays on each
rank's rows of the sequence from the embedding to the last row. Every
weight is gathered whole (``sharded_linear``'s product on row shards);
the only activations that move are the keys and values (the
context-parallel core), the MoE's rows (its routing groups are whole
rows), the SSD block's conv halo and carried state (``SeqRows``), the
last row (``last_row``: one row a sequence, from the rank that holds
it), and the logits, made replicated. The embedding table is gathered
whole, as the reference's HLO does, so no (B, S, d) partial sum moves.
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


_DECODE = False


@contextlib.contextmanager
def decode_plan():
    """Decode's plan for the products meanwhile (``models.model.
    decode_step`` enters it): the weights are resident and never move,
    so a product whose input a column-parallel product left split
    gathers that input (one token a row) instead of redistributing its
    weight, and ``whole`` gathers the output."""
    global _DECODE
    prev = _DECODE
    _DECODE = True
    try:
        yield
    finally:
        _DECODE = prev


def in_decode() -> bool:
    """Whether ``decode_plan`` is in force."""
    return _DECODE


_PREFILL = False


@contextlib.contextmanager
def prefill_plan():
    """Prefill's plan meanwhile (``models.model.prefill`` enters it):
    the residual stays on each rank's rows of the sequence, so a block's
    normed input is not gathered (``block_input``), every product on it
    reads its weight whole and keeps the rows (``whole`` products too),
    and the embedding table is gathered whole for the lookup."""
    global _PREFILL
    prev = _PREFILL
    _PREFILL = True
    try:
        yield
    finally:
        _PREFILL = prev


def in_prefill() -> bool:
    """Whether ``prefill_plan`` is in force."""
    return _PREFILL


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

    * "seq" (default): q/k/v as their column-parallel products leave
      them, heads on the model axis: the core runs per head shard with
      each rank's own key and value heads (``heads_parallel``), or
      context-parallel where the heads do not split (the reference's
      GSPMD runs the context-parallel core here, gathering K and V over
      the sequence);
    * "heads": q sharded on the head dim over the model axis, k/v heads
      replicated, as the reference's "heads" strategy: the core per head
      shard reads the kv heads of its query heads. Where the heads do
      not split evenly over the model axis q/k/v are left as they are
      and the "seq" strategy runs (the reference keeps its baseline
      where GSPMD rejects the uneven split; the port's local blocks
      take even shards only).
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


def _model_pl(x):
    """``x``'s placement on the model axis (None off the mesh or on a
    mesh without one)."""
    if not _is_dtensor(x):
        return None
    axes = list(mesh_axes(x.device_mesh))
    return x.placements[axes.index("model")] if "model" in axes else None


def last_dim_on_model(x) -> bool:
    """Whether ``x``'s last dim is sharded on the model axis: the output
    of a column-parallel product, the input of a row-parallel one."""
    from torch.distributed.tensor import Shard
    pl = _model_pl(x)
    return isinstance(pl, Shard) and pl.dim in (-1, x.ndim - 1)


def model_whole(x):
    """``x`` whole on the model axis, its data-axis placements kept: the
    one gather of the sequence-sharded residual (after a norm) that the
    column-parallel products of a block share, Megatron's sequence
    parallelism. Its backward reduce-scatters the products' partial
    input gradients. The identity off the mesh and on a tensor already
    whole there."""
    from torch.distributed.tensor import Replicate
    pl = _model_pl(x)
    if pl is None or isinstance(pl, Replicate):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, tuple(
        Replicate() if a == "model" else p
        for a, p in zip(mesh_axes(mesh), x.placements)))


def block_input(h):
    """A block's normed input as its products read it: whole on the
    model axis (``model_whole``, the train and decode plans' one gather
    per norm), or under ``prefill_plan`` on this rank's rows as the
    residual lies (each product then reads its weight whole)."""
    return h if _PREFILL else model_whole(h)


def rows_split(x) -> bool:
    """Whether ``x`` (B, S, ...) has its rows (dim 1) on the model axis:
    the sequence-sharded residual and what a row product made of it."""
    from torch.distributed.tensor import Shard
    return _model_pl(x) == Shard(1)


def last_row(x):
    """``x[:, -1:]`` of a (B, S, d) tensor. With its rows on the model
    axis, only the rank that holds the last row gives it: each rank's
    last row (one a sequence) is gathered over the model axis and the
    last rank's kept, so the sequence is never made whole; the result is
    batch-sharded and whole on the model axis."""
    if not rows_split(x):
        return x[:, -1:, :]
    mesh = x.device_mesh
    batch = batch_axes_of(mesh, x.shape[0]) is not None
    return local_map(
        lambda t: _over_model(t[:, -1:].contiguous(), mesh, gather=1)[:, -1:],
        mesh, (x,), [x.placements], mesh_placements(mesh, batch))


def _on_model(w, dim: Optional[int]):
    """Weight ``w`` whole on the data axes, with tensor dim ``dim`` on
    the model axis (whole there when ``dim`` is None)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = w.device_mesh
    target = tuple(Shard(dim) if a == "model" and dim is not None
                   else Replicate() for a in mesh_axes(mesh))
    return w if tuple(w.placements) == target else \
        w.redistribute(mesh, target)


def sharded_linear(x, w, b=None, whole: bool = False):
    """``x @ w (+ b)`` on the mesh, the product chosen by where ``x`` and
    ``w`` lie on the model axis:

    * row-parallel where ``x``'s last dim is on it (a column-parallel
      group's output): ``w`` read with its in-dim on the model axis (the
      rules put a ``/w``'s out-dim there, so this is a per-layer
      redistribution of the weight's bytes over the model size); the
      output is a partial sum over the model axis, which
      ``residual_out`` reduce-scatters;
    * sequence-parallel where ``x`` is sharded on another dim there (the
      context-parallel attention's rows): ``w`` gathered whole, the
      output sharded as ``x`` is;
    * column-parallel otherwise: ``x`` whole on the model axis
      (``model_whole``: the identity when the caller gathered it once
      for its group), ``w``'s out-dim kept on the model axis where the
      rules put it (else ``w`` gathered whole), the output sharded as
      that out-dim. ``whole`` gathers ``w`` instead, so the output is
      whole (a small latent that every rank's heads read).

    Under ``decode_plan`` ``w`` stays as it lies: ``resident_linear``.
    Under ``prefill_plan`` an ``x`` on its rows keeps them with ``whole``
    too (the output's features are whole either way)."""
    from torch.distributed.tensor import Shard
    if _DECODE:
        return resident_linear(x, w, b, whole)
    last = w.ndim - 1
    xpl, wpl = _model_pl(x), _model_pl(w)
    m = model_size(x.device_mesh)
    if last_dim_on_model(x) and w.shape[-2] % m == 0:
        y = x @ _on_model(w, last - 1)
        if b is not None:
            y = batch_sharded(y) + gathered(b)
        return y
    col = False
    if isinstance(xpl, Shard) and (not whole or _PREFILL):
        y = _rows_product(x, _on_model(w, None))
    else:
        col = isinstance(wpl, Shard) and wpl.dim == last and not whole
        y = model_whole(x) @ (w if col else _on_model(w, None))
    if b is not None:        # the bias laid out as the output's last dim
        y = y + _on_model(b, 0 if col else None)
    return y


def resident_linear(x, w, b=None, whole: bool = False):
    """``x @ w (+ b)`` on a resident weight, decode's product: ``x``
    whole on the model axis (gathered where a column-parallel product
    left its last dim there: a few rows of one token each), ``w`` read
    where it lies. Its out-dim on the model axis gives the output
    sharded there; its in-dim there a partial sum, all-reduced (``x``'s
    columns split locally to match); whole, a whole output. ``whole``
    gathers the output."""
    from torch.distributed.tensor import Partial, Shard
    x = model_whole(x)
    wpl = _model_pl(w)
    if isinstance(wpl, Shard) and wpl.dim % w.ndim == w.ndim - 2:
        mesh = x.device_mesh
        x = x.redistribute(mesh, tuple(
            Shard(x.ndim - 1) if a == "model" else p
            for a, p in zip(mesh_axes(mesh), x.placements)))
    y = x @ w
    if any(isinstance(p, Partial) for p in y.placements):
        y = batch_sharded(y)
    if b is not None:        # the bias laid out as the output's last dim
        out = _model_pl(y)
        y = y + _on_model(b, 0 if isinstance(out, Shard) else None)
    return model_whole(y) if whole else y


def _rows_product(x, w):
    """``x @ w`` on local shards for an ``x`` sharded on its rows (batch
    and sequence) and a whole ``w``: the output sharded as ``x`` is, the
    weight's gradient a partial sum over every mesh dim that splits
    ``x``'s rows (DTensor refuses to flatten a sharded sequence dim)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    return local_map(lambda a, b: a @ b, mesh, (x, w),
                     [x.placements, w.placements], x.placements,
                     [None, tuple(Partial() if isinstance(p, Shard)
                                  else Replicate() for p in x.placements)])


def residual_out(y):
    """A block's (B, S, d) output in the residual stream's layout: the
    row-parallel products' model-axis partial sums reduce-scattered onto
    ``constrain_residual``'s sequence-sharded placement (all-reduced
    where the sequence does not split: decode, one row of a chunk); an
    output already whole or sharded on the model axis is moved there
    too. The identity off the mesh."""
    if not _is_dtensor(y):
        return y
    pol = _POLICY
    b, s = y.shape[0], y.shape[1]
    s_ax = pol.seq_axis if (pol is not None and pol.seq_axis
                            and s % pol.seq_divisor == 0 and s > 1) \
        else None
    return _constrain(y, P(batch_axes_of(y.device_mesh, b), s_ax,
                           *([None] * (y.ndim - 2))))


def norm_scale(scale, x):
    """A norm's scale as ``x`` needs it: sharded on the model axis as
    ``x``'s last dim is (the SSD block's gated norm over this rank's
    heads), else whole. The identity off the mesh."""
    if not _is_dtensor(scale):
        return scale
    return _on_model(scale, 0) if last_dim_on_model(x) else gathered(scale)


def row_mean(t):
    """``torch.mean(t, dim=-1, keepdim=True)``; where ``t``'s last dim is
    on the model axis, each rank's row sums (a local op, so the gradient
    stays sharded as ``t`` is) all-reduced over the model axis."""
    if not last_dim_on_model(t):
        return torch.mean(t, dim=-1, keepdim=True)
    from torch.distributed.tensor import Partial
    mesh = t.device_mesh
    n = t.shape[-1]
    batch = batch_axes_of(mesh, t.shape[0]) is not None
    s = local_map(lambda a: a.sum(-1, keepdim=True) / n, mesh, (t,),
                  [t.placements], mesh_placements(mesh, batch, Partial()))
    return s.redistribute(mesh, mesh_placements(mesh, batch))


def split_heads(t, n: int):
    """(..., n·D) → (..., n, D). A column-parallel output keeps its
    columns on the model axis as heads where ``n`` divides over it, and
    is gathered whole first where it does not."""
    if last_dim_on_model(t) and n % model_size(t.device_mesh):
        t = model_whole(t)
    return t.reshape(*t.shape[:-1], n, t.shape[-1] // n)


def vocab_table(table):
    """The (vocab, d) unembedding read once per step's microbatch: whole
    over the data axes (the FSDP gather, hoisted out of the CE chunks so
    each chunk's gradient accumulates into one reduce-scatter), its
    vocab kept on the model axis where the rules put it there, else
    whole. The identity off the mesh."""
    from torch.distributed.tensor import Shard
    if not _is_dtensor(table):
        return table
    pl = _model_pl(table)
    vocab = isinstance(pl, Shard) and pl.dim == 0
    return _on_model(table, 0 if vocab else None)


def vocab_ce_sums(logits, labels):
    """``models.model._ce_sums`` on logits whose vocab (last) dim is on
    the model axis, Megatron's vocab-parallel cross entropy: each rank's
    max and sum of exponentials over its vocab slice are reduced over the
    model axis ((B, c) values each), and the target logit is taken on
    the rank whose slice holds it and summed there; the logits are never
    gathered. Returns (summed CE of the valid positions, their count),
    partial sums over the data axes as ``batch_sums``'s."""
    from torch.distributed.tensor import Partial, Shard
    mesh = logits.device_mesh
    batch = batch_axes_of(mesh, logits.shape[0]) is not None
    rows = mesh_placements(mesh, batch)
    v_loc = logits.shape[-1] // model_size(mesh)
    v0 = model_rank(mesh) * v_loc
    mx = logits.detach().amax(-1, keepdim=True).redistribute(mesh, rows)
    logz = (logits - mx).exp().sum(-1).redistribute(mesh, rows).log() \
        + mx[..., 0]

    def pick(lg, lab):
        mine = (lab >= v0) & (lab < v0 + lg.shape[-1])
        gold = torch.gather(lg, -1, torch.where(mine, lab - v0, 0)[..., None])
        return gold[..., 0] * mine

    gold = local_map(pick, mesh, (logits, labels),
                     [mesh_placements(mesh, batch, Shard(logits.ndim - 1)),
                      rows], mesh_placements(mesh, batch, Partial()))
    gold = gold.redistribute(mesh, rows)
    valid = (labels >= 0).float()
    return batch_sums(lambda per, val: (torch.sum(per * val), val.sum()),
                      (logz - gold, valid), 2)


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
    a column-parallel product's heads, or ``constrain_qkv``'s "heads"
    strategy placed it so."""
    from torch.distributed.tensor import Shard
    return _model_pl(q) == Shard(2)


def heads_parallel(core, q, kv_args, w_args=(), kv_split=False):
    """``core(h0, *q, *kv_args, *w_args)`` on this rank's query heads
    (``q`` a tensor or a tuple of them, each (B, S, H, ·) with its head
    dim on the model axis). The keys and values come whole, their heads
    replicated (``core`` slices the kv heads its query heads read), or,
    with ``kv_split``, as their own column-parallel products left them,
    each rank's kv heads those of its query heads; ``w_args`` are
    per-head weights with their out-dim on the model axis (the MLA
    decompressions). Everything is batch-sharded. ``h0`` is this rank's
    first query head; no query row reads another rank's heads, so the
    core needs no collective. The output is sharded as q is; whole keys'
    and values' gradients are partial sums over the model axis."""
    from torch.distributed.tensor import Partial, Shard
    qs = q if isinstance(q, tuple) else (q,)
    mesh = qs[0].device_mesh
    batch = batch_axes_of(mesh, qs[0].shape[0]) is not None
    m = model_size(mesh)
    h0 = model_rank(mesh) * (qs[0].shape[2] // m)
    q_pl = mesh_placements(mesh, batch, Shard(2))
    kv_pl = q_pl if kv_split else mesh_placements(mesh, batch)
    kv_grad = None if kv_split else \
        mesh_placements(mesh, batch, Partial() if m > 1 else None)
    w_pl = mesh_placements(mesh, False, Shard(1))
    return local_map(lambda *t: core(h0, *t), mesh,
                     (*qs, *kv_args, *w_args),
                     [q_pl] * len(qs) + [kv_pl] * len(kv_args)
                     + [w_pl] * len(w_args), q_pl,
                     [None] * len(qs) + [kv_grad] * len(kv_args)
                     + [weight_grads(mesh, batch, Shard(1))] * len(w_args))


def batch_local(core, args, w_args=()):
    """``core(*args, *w_args)`` on each batch shard: ``args`` (and the
    output) batch-sharded, ``w_args`` whole; the model axis repeats the
    work (the SSD block where its heads do not split over the model
    axis)."""
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


@dataclasses.dataclass(frozen=True)
class CacheShard:
    """What a decode core reads of one cache leaf (B, S, ..., F) on this
    rank, and how it combines over the model axis. ``split`` is what
    that axis splits: "seq", this rank's slots ``lo`` .. of the ring's
    ``slots``; "features", the last dim's ``f0`` .. ``f1``; None, nothing
    (``WHOLE``: the plain core, every method the identity or the plain
    op). ``seq`` is the layer's route: every leaf of the layer on its
    slots, so the core scores only its own slots and combines its
    softmax over the model axis (``attend``: the partial max, then the
    partial sums and outputs, each one all-reduce). Otherwise the scores
    are made whole (``scores``: a features split's partial sums
    all-reduced, a slots split's gathered) and the softmax runs whole."""
    split: Optional[str] = None
    lo: int = 0
    slots: int = 0               # 0: the leaf's own
    f0: int = 0
    f1: Optional[int] = None
    mesh: object = None          # whose model axis splits the leaf
    seq: bool = False

    def ring(self, n: int) -> int:
        """The ring's slots, for a leaf with ``n`` here."""
        return self.slots or n

    def slot_index(self, n: int, device) -> torch.Tensor:
        """The ring slots the core's scores stand for."""
        if self.seq:
            return self.lo + torch.arange(n, device=device)
        return torch.arange(self.ring(n), device=device)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s last dim cut to this shard's features."""
        return t[..., self.f0:self.f1] if self.split == "features" else t

    def write(self, cache: torch.Tensor, slot: torch.Tensor,
              new: torch.Tensor) -> torch.Tensor:
        """``new`` (B, 1, ..., F) written into ``cache`` at ring slot
        ``slot`` (a (1,) tensor), in place: its features here, and on a
        slots split only on the rank that holds the slot (the others
        rewrite a slot of their own with what it holds: no host sync)."""
        new = self.local(new).to(cache.dtype)
        if self.split != "seq":
            return cache.index_copy_(1, slot, new)
        at = slot - self.lo
        mine = ((at >= 0) & (at < cache.shape[1])).reshape(())
        at = at.clamp(0, cache.shape[1] - 1)
        return cache.index_copy_(1, at, torch.where(
            mine, new, cache.index_select(1, at)))

    def scores(self, s: torch.Tensor) -> torch.Tensor:
        """Scores (B, heads.., 1, n) of this leaf's slots made whole where
        the softmax runs whole."""
        if self.seq or self.split is None:
            return s
        if self.split == "features":
            return _over_model(s, self.mesh, "sum")
        return _over_model(s, self.mesh, gather=s.ndim - 1)

    def attend(self, s: torch.Tensor, v: torch.Tensor,
               eq: str) -> torch.Tensor:
        """``einsum(eq, softmax(s), v)`` over the ring, for the value leaf
        ``v`` here and scores ``s`` (B, heads.., 1, slots); the output
        (B, 1, heads.., F) whole on the model axis."""
        if not self.seq:
            w = torch.softmax(s, dim=-1)
            if self.split == "seq":
                w = w[..., self.lo:self.lo + v.shape[1]]
            o = torch.einsum(eq, w.to(v.dtype), v)
            if self.split == "seq":
                return _over_model(o, self.mesh, "sum")
            if self.split == "features":
                return _over_model(o, self.mesh, gather=o.ndim - 1)
            return o
        # The softmax split over the ranks' slots.
        m = _over_model(s.amax(dim=-1, keepdim=True), self.mesh, "max")
        p = torch.exp(s - m)
        o = torch.einsum(eq, p.to(v.dtype), v).float()
        l = p.sum(dim=-1, keepdim=True).movedim(-2, 1)       # (B, 1, H.., 1)
        ol = _over_model(torch.cat([o, l], dim=-1), self.mesh, "sum")
        return (ol[..., :-1] / ol[..., -1:]).to(v.dtype)


WHOLE = CacheShard()


@dataclasses.dataclass(frozen=True)
class SeqRows:
    """What a sequence scan run on this rank's rows (prefill's SSD block,
    ``models.ssm``) reads of the rows before them, on ``mesh``'s model
    axis: the conv's halo and the state the scan carries in. Each is one
    small gather over the model axis; the first rank's is zeros."""
    mesh: object

    def halo(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """The ``n`` rows of the sequence just before this rank's ``t``
        (B, L, F), L >= n: the last ``n`` rows of the rank before."""
        if t.shape[1] < n:
            raise NotImplementedError(
                f"a rank's {t.shape[1]} rows are fewer than the {n} rows "
                f"of the conv's halo")
        r = model_rank(self.mesh)
        tails = _over_model(t[:, t.shape[1] - n:].contiguous(), self.mesh,
                            gather=1)
        if r == 0:
            return torch.zeros_like(tails[:, :n])
        return tails[:, (r - 1) * n:r * n]

    def carry(self, states: torch.Tensor,
              decay: torch.Tensor) -> torch.Tensor:
        """The state (B, H, N, P) entering this rank's rows, from its
        chunks' final states ``states`` (B, nc, H, N, P; each from a zero
        state) and decays ``decay`` (B, H, nc): every rank's last state
        and whole decay are gathered over the model axis and folded, in
        order, over the ranks before this one."""
        s = torch.zeros_like(states[:, 0], dtype=torch.float32)
        total = torch.ones_like(decay[..., 0])
        for c in range(states.shape[1]):
            s = s * decay[:, :, c, None, None] + states[:, c].float()
            total = total * decay[:, :, c]
        s_all = _over_model(s[None], self.mesh, gather=0)
        d_all = _over_model(total[None], self.mesh, gather=0)
        out = torch.zeros_like(s)
        for j in range(model_rank(self.mesh)):
            out = out * d_all[j, :, :, None, None] + s_all[j]
        return out


def _over_model(t: torch.Tensor, mesh, op: str = "sum",
                gather: Optional[int] = None) -> torch.Tensor:
    """A local ``t`` all-reduced (``op``) over ``mesh``'s model axis, or
    with ``gather`` all-gathered there along that dim."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    src = Partial(op) if gather is None else Shard(gather)
    return DTensor.from_local(
        t, mesh, tuple(src if a == "model" else Replicate()
                       for a in mesh_axes(mesh)), run_check=False) \
        .redistribute(mesh, mesh_placements(mesh, False)).to_local()


def cache_shards(caches) -> tuple:
    """Each cache leaf's ``CacheShard`` on this rank, from its placement
    on the model axis (``sharding.cache_shardings``: the slots, or the
    last dim where that is the longest)."""
    from torch.distributed.tensor import Shard
    mesh = caches[0].device_mesh
    m, r = model_size(mesh), model_rank(mesh)
    out = []
    for c in caches:
        pl = _model_pl(c)
        if m == 1 or not isinstance(pl, Shard):
            out.append(WHOLE)
            continue
        d = pl.dim % c.ndim
        n = c.shape[d] // m
        if d == 1:
            out.append(CacheShard("seq", lo=r * n, slots=c.shape[1],
                                  mesh=mesh))
        elif d == c.ndim - 1:
            out.append(CacheShard("features", f0=r * n, f1=(r + 1) * n,
                                  mesh=mesh))
        else:
            raise NotImplementedError(
                f"a decode cache of shape {tuple(c.shape)} sharded on dim "
                f"{d} over the model axis")
    if all(s.split == "seq" for s in out):
        out = [dataclasses.replace(s, seq=True) for s in out]
    return tuple(out)


def decode_attend(core, args, caches, w_args=()):
    """A decode attention core on the caches' own shards:
    ``core(*args, *w_args, *caches, shards)`` with ``args`` (the new
    token's queries, keys and values: a few rows each) batch-sharded and
    whole on the model axis, ``w_args`` whole, each cache leaf its local
    shard as it lies (never moved) and ``shards`` their ``cache_shards``.
    ``core`` writes the new token into its shards in place and combines
    over the model axis through them (a split softmax where the caches
    lie on their slots, the reference's MLA plan). Returns ``core``'s
    output, batch-sharded and whole on the model axis. Decode has no
    backward."""
    mesh = caches[0].device_mesh
    batch = batch_axes_of(mesh, args[0].shape[0]) is not None
    pl = mesh_placements(mesh, batch)
    whole = mesh_placements(mesh, False)
    local = [a.redistribute(mesh, pl).to_local() for a in args] + [
        w.redistribute(mesh, whole).to_local() for w in w_args]
    from torch.distributed.tensor import DTensor
    out = core(*local, *(c.to_local() for c in caches),
               cache_shards(caches))
    return DTensor.from_local(out, mesh, pl, run_check=False)
