"""Train / serve step functions: the reference's ``launch/steps.py``
under autograd.

``train_step`` differentiates ``loss_fn`` eagerly (``torch.autograd``;
no graph capture of the whole step yet) and applies one AdamW update;
the state is functional, as in the reference: new (params, opt_state)
trees come back and the inputs are left as they are. With params,
optimizer state and batch as ``DTensor``s (``distributed.sharding``'s
rules) and an activation policy installed, the same step runs sharded on
an LM mesh. ``input_specs`` / ``model_shapes`` / ``opt_shapes`` are the
reference's ``ShapeDtypeStruct`` trees as tensors on the ``meta`` device:
shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.api import is_sharded
from repro_torch.models.model import (decode_step, init_cache, init_model,
                                      loss_fn, prefill)
from repro_torch.models.scan_util import tree_leaves, tree_unflatten
from repro_torch.optim.adamw import (AdamWConfig, OptState, apply_updates,
                                     init_opt_state)

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


def _train_step(params, opt_state, batch, cfg, opt_cfg, microbatches):
    if microbatches <= 1:
        loss, metrics, grads = _value_and_grad(params, batch, cfg)
        params, opt_state, opt_metrics = apply_updates(
            params, grads, opt_state, opt_cfg)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    acc_dt = getattr(torch, opt_cfg.state_dtype)
    acc_g = [torch.zeros_like(p, dtype=acc_dt) for p in tree_leaves(params)]
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
    params, opt_state, opt_metrics = apply_updates(
        params, tree_unflatten(params, acc_g), opt_state, opt_cfg)
    return params, opt_state, dict(loss=acc_loss, ce=acc_ce, **opt_metrics)


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


def prefill_step(params: PyTree, batch: Dict[str, torch.Tensor], *,
                 cfg: ModelConfig) -> torch.Tensor:
    with torch.no_grad(), _on_mesh(params):
        return prefill(params, batch["tokens"], cfg,
                       batch.get("frontend_embeds"))


def serve_step(params: PyTree, tokens: torch.Tensor, cache: PyTree,
               pos, *, cfg: ModelConfig) -> Tuple[torch.Tensor, PyTree]:
    """One decode step: new token for every sequence in the batch."""
    with torch.no_grad(), _on_mesh(params):
        return decode_step(params, tokens, cache, pos, cfg)


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
