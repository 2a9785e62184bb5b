"""Train / serve step functions: the reference's ``launch/steps.py``
under autograd.

``compile_train_step`` is the counterpart of the reference's
``jax.jit(train_step, donate_argnums=(0, 1))``: a ``CompiledTrainStep``
owns the params and optimizer state it is given, reads static batch
buffers and updates its state in place (``optim.adamw.apply_updates_``).
On a CUDA device its first ``WARM_PASSES`` calls run the step eagerly
through those buffers, the next captures it once as a CUDA graph, and
every call from then on is one replay; on the CPU every call runs the
same body eagerly. With ``DTensor`` params, state and batch it is the
reference's jitted step on a mesh (``in_shardings`` / ``out_shardings``
the leaves' placements): the graph then also records the step's
collectives. ``launch.train`` runs every step through it, on any
``--mesh``. ``compile_serve_step`` is the reference's jitted
``serve_step`` the same way: a ``CompiledServeStep`` owns the params and
the cache, reads a static token and position, and on a card replays one
CUDA graph of the decode step (on a mesh, with its collectives).
``compile_prefill_step`` is the reference's jitted ``prefill_step`` (its
``out_shardings=replicated(mesh)``): a ``CompiledPrefillStep`` owns the
params, reads static token buffers and returns the static logits,
replicated on a mesh.

``train_step`` differentiates ``loss_fn`` eagerly (``torch.autograd``)
and applies one AdamW update; its state is functional, as in the
reference: new (params, opt_state) trees come back and the inputs are
left as they are. With params, optimizer state and batch as
``DTensor``s (``distributed.sharding``'s rules) and an activation policy
installed, the same step runs sharded on an LM mesh
(``compile_train_step`` captures that sharded step too). ``input_specs`` /
``model_shapes`` / ``opt_shapes`` are the reference's
``ShapeDtypeStruct`` trees as tensors on the ``meta`` device: shapes and
dtypes, nothing allocated.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.api import (activation_policy, current_policy,
                                         is_sharded)
from repro_torch.distributed.sharding import load_shard
from repro_torch.models.model import (decode_step, init_cache, init_model,
                                      loss_fn, prefill)
from repro_torch.models.scan_util import tree_leaves, tree_unflatten
from repro_torch.optim.adamw import (AdamWConfig, OptState, apply_updates,
                                     apply_updates_, init_opt_state)

PyTree = Any


def make_opt_config(cfg: ModelConfig, total_steps: int = 10000) -> AdamWConfig:
    return AdamWConfig(state_dtype=cfg.opt_dtype, total_steps=total_steps)


def _value_and_grad(params: PyTree, batch: Dict[str, torch.Tensor],
                    cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], PyTree]:
    """(loss, metrics, grads) of ``loss_fn`` at ``params``, detached. The
    leaves are differentiated through detached aliases (no copy), so the
    caller's tensors never join a graph; a leaf the loss does not read
    (Command-R's unused ``ln_mlp``) gets a zero gradient, as under
    ``jax.grad``."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_unflatten(params, list(grads))


def _on_mesh(tree: PyTree):
    """The context a step runs in: with ``DTensor`` leaves, DTensor's
    ``implicit_replication`` (a plain tensor the model makes, a position
    or a mask, is taken as replicated); else nothing."""
    if not is_sharded(*tree_leaves(tree)):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _whole(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Metrics as plain tensors (a ``DTensor`` reduced to its value)."""
    return {k: v.full_tensor() if is_sharded(v) else v
            for k, v in metrics.items()}


def train_step(params: PyTree, opt_state: OptState,
               batch: Dict[str, torch.Tensor], *, cfg: ModelConfig,
               opt_cfg: AdamWConfig, microbatches: int = 1
               ) -> Tuple[PyTree, OptState, Dict[str, torch.Tensor]]:
    """One optimizer step, optionally microbatched.

    Microbatching bounds the live activation set to one microbatch:
    gradients accumulate in ``opt_cfg.state_dtype``, each divided by
    ``microbatches``, and ``loss`` and ``ce`` are averaged, as the
    reference's scan does (its ``aux`` is reported only unbatched).
    On a mesh (``DTensor`` params, state and batch) the new params and
    state keep their placements and the metrics come back whole.
    """
    with _on_mesh(params):
        params, opt_state, metrics = _train_step(
            params, opt_state, batch, cfg, opt_cfg, microbatches)
    return params, opt_state, _whole(metrics)


def train_step_(params: PyTree, opt_state: OptState,
                batch: Dict[str, torch.Tensor], *, cfg: ModelConfig,
                opt_cfg: AdamWConfig, microbatches: int = 1
                ) -> Dict[str, torch.Tensor]:
    """``train_step`` with the update in place (``apply_updates_``): the
    new params and state written into the leaves given, as the compiled
    step (and the reference's update on donated buffers) does, so no
    second copy of the tree is ever live. Returns the metrics (whole)."""
    with _on_mesh(params):
        metrics, grads = _loss_and_grads(params, batch, cfg, opt_cfg,
                                         microbatches)
        metrics.update(apply_updates_(params, grads, opt_state, opt_cfg))
    return _whole(metrics)


def _train_step(params, opt_state, batch, cfg, opt_cfg, microbatches):
    metrics, grads = _loss_and_grads(params, batch, cfg, opt_cfg,
                                     microbatches)
    params, opt_state, opt_metrics = apply_updates(
        params, grads, opt_state, opt_cfg)
    return params, opt_state, dict(metrics, **opt_metrics)


def _loss_and_grads(params, batch, cfg, opt_cfg, microbatches,
                    acc_g: Optional[List[torch.Tensor]] = None):
    """(metrics, gradient tree) of one step's batch. Over microbatches
    the gradients accumulate into ``acc_g`` (zeroed here; new zeros in
    ``opt_cfg.state_dtype`` when None), each divided by
    ``microbatches``."""
    if microbatches <= 1:
        loss, metrics, grads = _value_and_grad(params, batch, cfg)
        return dict(metrics, loss=loss), _placed_like(grads, params)

    if acc_g is None:
        acc_dt = getattr(torch, opt_cfg.state_dtype)
        acc_g = [torch.zeros_like(p, dtype=acc_dt)
                 for p in tree_leaves(params)]
    else:
        for a in acc_g:
            a.zero_()
    first = tree_leaves(params)[0]
    acc_loss = torch.zeros((), device=first.device)
    acc_ce = torch.zeros((), device=first.device)
    whole = {k: v.full_tensor() if is_sharded(v) else v
             for k, v in batch.items()}
    for i in range(microbatches):
        loss, metrics, grads = _value_and_grad(
            params, _microbatch(whole, batch, microbatches, i), cfg)
        with torch.no_grad():
            for a, g in zip(acc_g, tree_leaves(grads)):
                if is_sharded(g):
                    g = g.redistribute(a.device_mesh, a.placements)
                a.add_(g.to(a.dtype) / microbatches)
        del grads
        acc_loss = acc_loss + loss / microbatches
        acc_ce = acc_ce + metrics["ce"] / microbatches
    return dict(loss=acc_loss, ce=acc_ce), tree_unflatten(params, acc_g)


def _placed_like(grads: PyTree, params: PyTree) -> PyTree:
    """Each ``DTensor`` gradient on its param's placements (a product on
    the mesh leaves a replicated bias's gradient sharded as the product's
    output was), as the accumulators over microbatches hold them."""
    out = [g.redistribute(p.device_mesh, p.placements)
           if is_sharded(g) and g.placements != p.placements else g
           for g, p in zip(tree_leaves(grads), tree_leaves(params))]
    return tree_unflatten(grads, out)


def _microbatch(whole: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], n: int,
                i: int) -> Dict[str, torch.Tensor]:
    """Microbatch ``i`` of ``n``: rows ``[i B/n, (i+1) B/n)`` of ``whole``
    (the batch, a ``DTensor`` leaf gathered whole once per step: token
    ids, a few MB). A leaf that is a ``DTensor`` in ``batch`` takes its
    placements again by a local slice, so a microbatch's rows, and the
    loss's batch statistics, are the unsharded split's."""
    out = {}
    for k, w in whole.items():
        per = w.shape[0] // n
        rows = w[i * per:(i + 1) * per]
        v = batch[k]
        if is_sharded(v):
            from torch.distributed.tensor import DTensor, Replicate
            mesh = v.device_mesh
            rows = DTensor.from_local(rows, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False
                                      ).redistribute(mesh, v.placements)
        out[k] = rows
    return out


# ---------------------------------------------------------------------------
# The compiled train step: donated state, static buffers, one CUDA graph.
# ---------------------------------------------------------------------------

# Eager passes on a card before the capture. The first makes what a
# capture cannot: autograd's device thread, cuBLAS's handle and workspace
# for the capture stream, the static metrics and, on a mesh, the NCCL
# communicator of every group the body's collectives use (each made at
# its group's first collective). The second runs the body
# with nothing left to make, so its kernels are the ones the graph
# records (``chip_smoke.py`` counts both); PyTorch's whole-network
# capture example likewise warms up over a few iterations on a side
# stream. Each pass is a real step on its own batch.
WARM_PASSES = 2


class _CapturedStep:
    """What a compiled step does with its ``_body`` on a card: the first
    ``WARM_PASSES`` calls run it eagerly on a stream of its own, the
    next captures it once as a CUDA graph (which records without
    running) and replays it, and every later call is one ``replay()``;
    a capture or replay that fails raises. On the CPU every call runs
    the body eagerly."""

    device: torch.device

    def _init_capture(self) -> None:
        self._stream: Optional["torch.cuda.Stream"] = None
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.calls = 0

    def _body(self) -> None:
        raise NotImplementedError

    def _run(self) -> None:
        if self.device.type != "cuda":
            self._body()
        elif self.graph is not None:
            self.graph.replay()
        elif self.calls < WARM_PASSES:
            self._warm_pass()
        else:
            self._capture()
            self.graph.replay()
        self.calls += 1

    def _warm_pass(self) -> None:
        """One eager pass of ``_body`` on the capture stream, ordered
        after the inputs' copy and before whatever the caller runs next."""
        if self._stream is None:
            # The passes allocate on a stream of their own, which cannot
            # reuse the blocks freed on the caller's stream (the trees
            # that ``distribute`` or a restore replaced, as large as the
            # state): release those first, as the capture does.
            torch.cuda.empty_cache()
            self._stream = torch.cuda.Stream(device=self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            self._body()
        current.wait_stream(self._stream)

    def _capture(self) -> None:
        """Record ``_body`` on the capture stream (``thread_local``: CUDA
        forbids the calls that could break it to this thread only, so the
        process group's watchdog may go on querying its events); nothing
        runs. The ``cudaGraph_t`` is kept beside its instance
        (``raw_cuda_graph``: ``chip_smoke.py`` counts its kernel nodes)."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=self._stream,
                              capture_error_mode="thread_local"):
            self._body()
        graph.instantiate()
        self.graph = graph

    def _static_like(self, like: torch.Tensor, what: str,
                     dtype=None) -> torch.Tensor:
        """The static buffer of input ``what``: ``like``'s shape (and on a
        mesh its placements), in ``dtype`` (default ``like``'s)."""
        dtype = dtype or like.dtype
        if is_sharded(like) != self.sharded:
            raise ValueError(
                f"{what} is {_kind(like)}; the compiled step's state is "
                f"{'on a mesh' if self.sharded else 'plain'}")
        if not self.sharded:
            return torch.empty(tuple(like.shape), dtype=dtype,
                               device=self.device)
        from torch.distributed.tensor import DTensor
        local = like.to_local()
        return DTensor.from_local(
            torch.empty(tuple(local.shape), dtype=dtype, device=self.device),
            like.device_mesh, like.placements, run_check=False,
            shape=like.shape, stride=like.stride())

    @torch.no_grad()
    def _load_batch(self, batch: Dict[str, torch.Tensor]) -> None:
        """Copy ``batch`` into the static batch buffers ``_batch``."""
        if set(batch) != set(self._batch):
            raise ValueError(f"batch has {sorted(batch)}; the compiled step "
                             f"reads {sorted(self._batch)}")
        for k, buf in self._batch.items():
            self._load(buf, batch[k], f"batch[{k!r}]")

    @staticmethod
    def _load(buf: torch.Tensor, v: torch.Tensor, what: str) -> None:
        """Copy input ``v`` into its static buffer (this rank's shard on a
        mesh), which it must match in shape and placements."""
        if tuple(v.shape) != tuple(buf.shape) or _layout(v) != _layout(buf):
            raise ValueError(
                f"{what} is {_kind(v)} {tuple(v.shape)} {_layout(v)}; the "
                f"compiled step reads {_kind(buf)} {tuple(buf.shape)} "
                f"{_layout(buf)}")
        _local(buf).copy_(_local(v))


def _owned(tree: PyTree, what: str) -> bool:
    """Whether ``tree``'s leaves are ``DTensor``s; a tree that mixes them
    with plain tensors raises."""
    leaves = tree_leaves(tree)
    sharded = is_sharded(*leaves)
    if sharded and not all(is_sharded(t) for t in leaves):
        raise ValueError(
            f"{what} mix DTensor and plain leaves; place every leaf on the "
            f"mesh (distribute) or none")
    return sharded


class CompiledTrainStep(_CapturedStep):
    """``compile_train_step``'s callable: ``step(batch) -> metrics``.

    It owns (is donated) the params and ``OptState`` trees it was made
    with: the caller reads them back through ``.params`` / ``.opt_state``
    and writes them through ``load_state``, since a captured graph binds
    every buffer by address. Each call copies ``batch`` into static
    buffers (``tokens`` as int64, ``frontend_embeds`` for the frontend
    architectures), runs the step (``_loss_and_grads`` over views of the
    static batch, the gradients accumulated in owned f32 buffers, then
    ``apply_updates_``) and returns the static metrics, ``train_step``'s
    keys, overwritten by the next call. On a card the first
    ``WARM_PASSES`` calls run eagerly on the capture stream, the next
    captures the body (which records without running) and replays it,
    and every later call is one ``replay()``; a capture or replay that
    fails raises. On the CPU every call runs the body eagerly.

    On a mesh every leaf of the state is a ``DTensor`` (a tree that mixes
    them with plain tensors raises). The batch buffers and accumulators
    are ``DTensor``s with the placements of ``batch_like`` and of the
    params, a call copies only this rank's shard of the batch (whose
    placements must be ``batch_like``'s), the metrics come back whole on
    every rank, and the body runs under ``_on_mesh`` and the activation
    policy installed when the step was made. The warm passes make every
    communicator the body's collectives use, so the capture records
    those collectives and creates nothing."""

    def __init__(self, params: PyTree, opt_state: OptState,
                 batch_like: Dict[str, torch.Tensor], cfg: ModelConfig,
                 opt_cfg: AdamWConfig, microbatches: int = 1) -> None:
        self.sharded = _owned((params, opt_state), "compile_train_step: "
                              "the params and optimizer state")
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.microbatches = microbatches
        self.policy = current_policy()
        self._params, self._opt_state = params, opt_state
        self.device = tree_leaves(params)[0].device
        self._batch = {k: self._static_like(
            v, f"batch[{k!r}]", torch.long if k == "tokens" else None)
            for k, v in batch_like.items()}
        self._acc = None
        if microbatches > 1:
            acc_dt = getattr(torch, opt_cfg.state_dtype)
            self._acc = [torch.zeros_like(p, dtype=acc_dt)
                         for p in tree_leaves(params)]
        self._metrics: Optional[Dict[str, torch.Tensor]] = None
        self._init_capture()

    @property
    def params(self) -> PyTree:
        return self._params

    @property
    def opt_state(self) -> OptState:
        return self._opt_state

    @torch.no_grad()
    def load_state(self, params: PyTree, opt_state: OptState) -> None:
        """Copy a (params, ``OptState``) tree of the same structure,
        shapes and dtypes into the owned buffers (a restore). On a mesh
        a ``DTensor`` source leaf is redistributed to the owned leaf's
        placements and its local shard copied
        (``CheckpointManager.restore(..., shardings=)``'s tree); a plain
        source leaf is whole (a checkpoint restored to the host, mapped
        from its file), and each rank copies only its shard of it
        (``distributed.sharding.load_shard``), so the state never exists
        twice on the card."""
        src = tree_leaves((params, opt_state))
        dst = tree_leaves((self._params, self._opt_state))
        if len(src) != len(dst):
            raise ValueError(f"load_state: {len(src)} leaves; the compiled "
                             f"step holds {len(dst)}")
        for i, (s, d) in enumerate(zip(src, dst)):
            if s.shape != d.shape or s.dtype != d.dtype \
                    or is_sharded(s) and not self.sharded:
                raise ValueError(
                    f"load_state: leaf {i} is {_kind(s)} {s.dtype} "
                    f"{tuple(s.shape)}; the compiled step holds {_kind(d)} "
                    f"{d.dtype} {tuple(d.shape)}")
            if is_sharded(s):
                s = s.redistribute(d.device_mesh, d.placements)
                _local(d).copy_(_local(s))
            else:
                load_shard(d, s)

    def _body(self) -> None:
        """The step the graph records: gradients of the static batch,
        the in-place update, the metrics (whole) copied into their static
        tensors."""
        with _on_mesh(self._params), activation_policy(self.policy):
            metrics, grads = _loss_and_grads(
                self._params, self._batch, self.cfg, self.opt_cfg,
                self.microbatches, self._acc)
            metrics.update(apply_updates_(self._params, grads,
                                          self._opt_state, self.opt_cfg))
            del grads
            metrics = _whole(metrics)
        if self._metrics is None:
            self._metrics = {k: torch.empty_like(v)
                             for k, v in metrics.items()}
        with torch.no_grad():
            for k, v in metrics.items():
                self._metrics[k].copy_(v)

    def __call__(self, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        self._load_batch(batch)
        self._run()
        return self._metrics


def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local shard, which a copy into writes the
    ``DTensor``; any other tensor as it is."""
    return t.to_local() if is_sharded(t) else t


def _kind(t: torch.Tensor) -> str:
    return "a DTensor" if is_sharded(t) else "a tensor"


def _layout(t: torch.Tensor):
    """A ``DTensor``'s (mesh, placements); None for a plain tensor."""
    return (t.device_mesh, tuple(t.placements)) if is_sharded(t) else None


def compile_train_step(params: PyTree, opt_state: OptState,
                       batch_like: Dict[str, torch.Tensor], *,
                       cfg: ModelConfig, opt_cfg: AdamWConfig,
                       microbatches: int = 1) -> CompiledTrainStep:
    """The reference's ``jax.jit(train_step, in_shardings=...,
    out_shardings=..., donate_argnums=(0, 1))``: a ``CompiledTrainStep``
    that owns ``params`` and ``opt_state`` (plain tensors on one device,
    or every leaf a ``DTensor`` on an LM mesh) and reads batches shaped
    and placed like ``batch_like`` (tensors, ``meta`` ones included, or
    ``make_batch(mesh=)``'s ``DTensor``s). Call it under the activation
    policy its steps run in (``activation_policy``): the step keeps the
    one installed when it is made. Each call takes one optimizer step, as
    ``train_step`` does on the same state and batch, bit for bit."""
    return CompiledTrainStep(params, opt_state, batch_like, cfg, opt_cfg,
                             microbatches)


def prefill_step(params: PyTree, batch: Dict[str, torch.Tensor], *,
                 cfg: ModelConfig) -> torch.Tensor:
    """Last-position logits (B, vocab) of ``batch``'s tokens (and
    ``frontend_embeds``); on a mesh replicated on every rank."""
    with torch.no_grad(), _on_mesh(params):
        return prefill(params, batch["tokens"], cfg,
                       batch.get("frontend_embeds"))


class CompiledPrefillStep(_CapturedStep):
    """``compile_prefill_step``'s callable: ``step(batch) -> logits``.

    It owns the params it was made with (``.params``): each call copies
    ``batch`` into static buffers (``tokens`` as int64, and
    ``frontend_embeds`` for the front-end architectures), runs
    ``prefill_step`` and returns the static (B, vocab) logits, overwritten
    by the next call. On a card the calls go as ``_CapturedStep`` says.
    On a mesh every param leaf is a ``DTensor`` (the FSDP rules), the
    buffers have the placements of ``batch_like`` (a call copies this
    rank's shard), the logits come back replicated on every rank, and
    the body runs under the activation policy installed when the step was
    made; the warm passes make every communicator the collectives use."""

    def __init__(self, params: PyTree, batch_like: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> None:
        self.sharded = _owned(params, "compile_prefill_step: the params")
        self.cfg = cfg
        self.policy = current_policy()
        self._params = params
        self.device = tree_leaves(params)[0].device
        self._batch = {k: self._static_like(
            v, f"batch[{k!r}]", torch.long if k == "tokens" else None)
            for k, v in batch_like.items()}
        self._logits: Optional[torch.Tensor] = None
        self._init_capture()

    @property
    def params(self) -> PyTree:
        return self._params

    def _body(self) -> None:
        """The step the graph records: ``prefill_step`` on the static
        buffers, its logits copied into their static tensor."""
        with activation_policy(self.policy):
            logits = prefill_step(self._params, self._batch, cfg=self.cfg)
        if self._logits is None:
            self._logits = torch.empty_like(logits)
        with torch.no_grad():
            _local(self._logits).copy_(_local(logits))

    def __call__(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        self._load_batch(batch)
        self._run()
        return self._logits


def compile_prefill_step(params: PyTree, batch_like: Dict[str, torch.Tensor],
                         *, cfg: ModelConfig) -> CompiledPrefillStep:
    """The reference's ``jax.jit(prefill_step, in_shardings=(p_sh, b_sh),
    out_shardings=replicated(mesh))``: a ``CompiledPrefillStep`` that owns
    ``params`` (plain tensors on one device, or every leaf a ``DTensor``
    on an LM mesh) and reads batches shaped and placed like
    ``batch_like``. Call it under the activation policy its steps run in:
    the step keeps the one installed when it is made. Each call is one
    ``prefill_step``, bit for bit."""
    return CompiledPrefillStep(params, batch_like, cfg)


def serve_step(params: PyTree, tokens: torch.Tensor, cache: PyTree,
               pos, *, cfg: ModelConfig) -> Tuple[torch.Tensor, PyTree]:
    """One decode step: new token for every sequence in the batch."""
    with torch.no_grad(), _on_mesh(params):
        return decode_step(params, tokens, cache, pos, cfg)


class CompiledServeStep(_CapturedStep):
    """``compile_serve_step``'s callable: ``step(tokens, pos) -> logits``.

    It owns the params and the cache it was made with (``.params``,
    ``.cache``): each call copies ``tokens`` (B, 1) into a static buffer
    and ``pos`` into a static (1,) position, runs ``serve_step``, which
    writes the new token into the cache in place, and returns the static
    (B, vocab) logits, overwritten by the next call. On a card the calls
    go as ``_CapturedStep`` says. On a mesh every leaf is a ``DTensor``
    (the params resident, the cache as ``cache_shardings`` places it),
    the token buffer has the placements of ``tokens_like``, the position
    is a plain tensor on the rank's card, the logits come back as
    ``serve_step``'s (batch-sharded), and the body runs under the
    activation policy installed when the step was made; the warm passes
    make every communicator the collectives use."""

    def __init__(self, params: PyTree, cache: PyTree,
                 tokens_like: torch.Tensor, cfg: ModelConfig) -> None:
        self.sharded = _owned((params, cache),
                              "compile_serve_step: the params and cache")
        self.cfg = cfg
        self.policy = current_policy()
        self._params, self._cache = params, cache
        self.device = tree_leaves(params)[0].device
        self._tokens = self._static_like(tokens_like, "tokens", torch.long)
        self._pos = torch.zeros((1,), dtype=torch.long, device=self.device)
        self._logits: Optional[torch.Tensor] = None
        self._init_capture()

    @property
    def params(self) -> PyTree:
        return self._params

    @property
    def cache(self) -> PyTree:
        return self._cache

    def _body(self) -> None:
        """The step the graph records: ``serve_step`` on the static token
        and position buffers, its logits copied into their static
        tensor."""
        with activation_policy(self.policy):
            logits, _ = serve_step(self._params, self._tokens, self._cache,
                                   self._pos, cfg=self.cfg)
        if self._logits is None:
            self._logits = torch.empty_like(logits)
        with torch.no_grad():
            _local(self._logits).copy_(_local(logits))

    @torch.no_grad()
    def __call__(self, tokens: torch.Tensor, pos) -> torch.Tensor:
        self._load(self._tokens, tokens, "tokens")
        self._pos.copy_(torch.as_tensor(pos, dtype=torch.long).reshape(1))
        self._run()
        return self._logits


def compile_serve_step(params: PyTree, cache: PyTree,
                       tokens_like: torch.Tensor, *,
                       cfg: ModelConfig) -> CompiledServeStep:
    """The reference's ``jax.jit(serve_step, in_shardings=...,
    out_shardings=...)``: a ``CompiledServeStep`` that owns ``params``
    and ``cache`` (plain tensors on one device, or every leaf a
    ``DTensor`` on an LM mesh) and reads tokens shaped and placed like
    ``tokens_like``. Call it under the activation policy its steps run
    in: the step keeps the one installed when it is made. Each call is
    one ``serve_step`` on the owned cache, bit for bit."""
    return CompiledServeStep(params, cache, tokens_like, cfg)


# ---------------------------------------------------------------------------
# Shape-only stand-ins (``meta`` tensors, no allocation) for every input.
# ---------------------------------------------------------------------------

META = torch.device("meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Dry-run inputs for the given (arch × shape) cell, on ``meta``.

    train/prefill: {'tokens': (B, S_text) [, 'frontend_embeds']}
    decode:        {'tokens': (B, 1), 'pos': scalar, 'cache': tree}

    Token ids and the position are int64, the port's index type (the
    reference's are int32; the values are the same)."""
    b, s = shape.global_batch, shape.seq_len
    n_front = cfg.frontend_tokens if cfg.frontend != "none" else 0
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {
            "tokens": torch.empty((b, s - n_front), dtype=torch.long,
                                  device=META)}
        if n_front:
            specs["frontend_embeds"] = torch.empty(
                (b, n_front, cfg.frontend_dim),
                dtype=getattr(torch, cfg.dtype), device=META)
        return specs
    # decode: cache holds `s` tokens of context, one new token comes in.
    return {"tokens": torch.empty((b, 1), dtype=torch.long, device=META),
            "pos": torch.empty((), dtype=torch.long, device=META),
            "cache": init_cache(cfg, b, s, device=META)}


def model_shapes(cfg: ModelConfig) -> PyTree:
    """The parameter tree of ``cfg`` on ``meta``, without allocating."""
    return init_model(cfg, torch.Generator(), META)


def opt_shapes(cfg: ModelConfig, params_sds: PyTree) -> OptState:
    return init_opt_state(params_sds, make_opt_config(cfg))
