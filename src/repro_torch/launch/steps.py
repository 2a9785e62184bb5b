"""Train / serve step functions: the reference's ``launch/steps.py``
under autograd.

``train_step`` differentiates ``loss_fn`` eagerly (``torch.autograd``;
no graph capture of the whole step yet) and applies one AdamW update;
the state is functional, as in the reference: new (params, opt_state)
trees come back and the inputs are left as they are. The dry run's
``input_specs`` / ``model_shapes`` / ``opt_shapes`` come with the dry
run (ROADMAP item C.8).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import decode_step, loss_fn, prefill
from repro_torch.models.scan_util import tree_leaves, tree_unflatten
from repro_torch.optim.adamw import AdamWConfig, OptState, apply_updates

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


def train_step(params: PyTree, opt_state: OptState,
               batch: Dict[str, torch.Tensor], *, cfg: ModelConfig,
               opt_cfg: AdamWConfig, microbatches: int = 1
               ) -> Tuple[PyTree, OptState, Dict[str, torch.Tensor]]:
    """One optimizer step, optionally microbatched.

    Microbatching bounds the live activation set to one microbatch:
    gradients accumulate in ``opt_cfg.state_dtype``, each divided by
    ``microbatches``, and ``loss`` and ``ce`` are averaged, as the
    reference's scan does (its ``aux`` is reported only unbatched).
    """
    if microbatches <= 1:
        loss, metrics, grads = _value_and_grad(params, batch, cfg)
        params, opt_state, opt_metrics = apply_updates(
            params, grads, opt_state, opt_cfg)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    acc_dt = getattr(torch, opt_cfg.state_dtype)
    acc_g = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
             for p in tree_leaves(params)]
    first = tree_leaves(params)[0]
    acc_loss = torch.zeros((), device=first.device)
    acc_ce = torch.zeros((), device=first.device)
    mb_batch = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                             *v.shape[1:]) for k, v in batch.items()}
    for i in range(microbatches):
        loss, metrics, grads = _value_and_grad(
            params, {k: v[i] for k, v in mb_batch.items()}, cfg)
        with torch.no_grad():
            for a, g in zip(acc_g, tree_leaves(grads)):
                a.add_(g.to(a.dtype) / microbatches)
        del grads
        acc_loss = acc_loss + loss / microbatches
        acc_ce = acc_ce + metrics["ce"] / microbatches
    params, opt_state, opt_metrics = apply_updates(
        params, tree_unflatten(params, acc_g), opt_state, opt_cfg)
    return params, opt_state, dict(loss=acc_loss, ce=acc_ce, **opt_metrics)


def prefill_step(params: PyTree, batch: Dict[str, torch.Tensor], *,
                 cfg: ModelConfig) -> torch.Tensor:
    with torch.no_grad():
        return prefill(params, batch["tokens"], cfg,
                       batch.get("frontend_embeds"))


def serve_step(params: PyTree, tokens: torch.Tensor, cache: PyTree,
               pos, *, cfg: ModelConfig) -> Tuple[torch.Tensor, PyTree]:
    """One decode step: new token for every sequence in the batch."""
    with torch.no_grad():
        return decode_step(params, tokens, cache, pos, cfg)
