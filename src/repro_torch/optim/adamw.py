"""AdamW with global-norm clipping, cosine schedule, optional int8
gradient compression with error feedback (distributed-optimization trick
for bandwidth-bound multi-pod gradient reduction).

The reference's optimizer (``optim/adamw.py``) written over torch
tensors: the same ``OptState`` tree, so a checkpoint of either package
fills the other's, and the same arithmetic in the same order (the update
in f32, cast back to each parameter's dtype; ``m`` and ``v`` kept in
``state_dtype``). ``torch.optim.AdamW`` orders it differently and has
neither the clip nor the schedule. Nothing here builds an autograd
graph: the update runs under ``torch.no_grad``. ``apply_updates`` is
functional (the eager ``train_step``'s); ``apply_updates_`` writes the
same values into the params and state it is given (the compiled step's,
whose CUDA graph binds those buffers).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.scan_util import (tree_leaves, tree_map,
                                          tree_unflatten)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"


class OptState(NamedTuple):
    m: PyTree
    v: PyTree
    step: torch.Tensor


def init_opt_state(params: PyTree, cfg: AdamWConfig) -> OptState:
    """Zero moments in ``cfg.state_dtype``, each on its parameter's
    device; the step count an int32 scalar on the first leaf's device."""
    dt = getattr(torch, cfg.state_dtype)
    first = tree_leaves(params)[0]
    return OptState(
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                   params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                   params),
        step=torch.zeros((), dtype=torch.int32, device=first.device))


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac``; f32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, summed leaf by
    leaf in the reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def _clip_and_schedule(grads: PyTree, step: torch.Tensor, cfg: AdamWConfig):
    """(grad norm, clip scale, lr, bias corrections 1 and 2) of the step
    numbered ``step`` (a device tensor, already incremented)."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
    lr = schedule(step, cfg)
    bc1 = 1 - cfg.beta1 ** step.to(torch.float32)
    bc2 = 1 - cfg.beta2 ** step.to(torch.float32)
    return gnorm, scale, lr, bc1, bc2


def _update(p, g, m, v, scale, lr, bc1, bc2, cfg: AdamWConfig):
    """One leaf's AdamW update in f32: (new p, new m, new v), each in its
    own dtype."""
    b1, b2 = cfg.beta1, cfg.beta2
    g32 = g.to(torch.float32) * scale
    m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
    v32 = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
    mhat = m32 / bc1
    vhat = v32 / bc2
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
        + cfg.weight_decay * p.to(torch.float32)
    p_new = (p.to(torch.float32) - lr * delta).to(p.dtype)
    return p_new, m32.to(m.dtype), v32.to(v.dtype)


@torch.no_grad()
def apply_updates(params: PyTree, grads: PyTree, state: OptState,
                  cfg: AdamWConfig
                  ) -> Tuple[PyTree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: new (params, state) trees and
    ``{"grad_norm", "lr"}``; the inputs are left as they are."""
    step = state.step + 1
    gnorm, *coef = _clip_and_schedule(grads, step, cfg)
    out = [_update(p, g, m, v, *coef, cfg) for p, g, m, v in
           zip(tree_leaves(params), tree_leaves(grads),
               tree_leaves(state.m), tree_leaves(state.v))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, OptState(new_m, new_v, step), \
        {"grad_norm": gnorm, "lr": coef[1]}


@torch.no_grad()
def apply_updates_(params: PyTree, grads: PyTree, state: OptState,
                   cfg: AdamWConfig) -> Dict[str, torch.Tensor]:
    """``apply_updates`` in place, the counterpart of the reference's
    update on donated buffers: the same arithmetic in the same order, each
    leaf's new ``p``, ``m`` and ``v`` written into its own storage, leaf
    by leaf (one leaf's f32 temporaries alive at a time), and
    ``state.step`` incremented on the device. Returns ``{"grad_norm",
    "lr"}`` as device tensors. Nothing reads the host, so a CUDA graph
    can record it."""
    state.step.add_(1)
    gnorm, *coef = _clip_and_schedule(grads, state.step, cfg)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        _update_(p, g, m, v, coef, cfg)
    return {"grad_norm": gnorm, "lr": coef[1]}


def _update_(p, g, m, v, coef, cfg: AdamWConfig) -> None:
    p_new, m_new, v_new = _update(p, g, m, v, *coef, cfg)
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback (for DCI-bound pods).
# ---------------------------------------------------------------------------

def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_grad(g: torch.Tensor, err: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compression: quantize (g + carried error), carry the
    quantization residual to the next step."""
    g32 = g.to(torch.float32) + err
    q, scale = compress_int8(g32)
    deq = decompress_int8(q, scale)
    return deq.to(g.dtype), g32 - deq
