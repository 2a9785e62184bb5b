"""Mixture-of-Experts FFN.

Two dispatch algorithms, as in the reference:

* ``moe_ffn_dense`` — the classic GShard (T, E, C) one-hot einsum
  dispatch; the oracle for tiny token counts.
* ``moe_ffn`` (default) — sort-based capacity dispatch, per sequence row:
    1. top-k routing per token;
    2. a stable per-row argsort by expert id → each expert's tokens are
       contiguous;
    3. (E, C) gather indices from per-expert offsets (capacity-bounded,
       overflow dropped — GShard semantics);
    4. gather → (B, E, C, d), stacked-expert SwiGLU einsum, scatter-add
       back.

Top-k keeps the reference's order of ties (``jax.lax.top_k``: the lower
expert first) by a stable descending sort, and capacity positions follow
the same stable sort and ``cumsum``.

On a mesh (``DTensor`` inputs) the sort-based dispatch runs on local
shards (``distributed.api.local_map``): each batch shard routes its own
rows, and each model rank runs only its experts (the experts dim is
sharded on the model axis), so the output is a partial sum over the
model axis; the shared experts' row-parallel MLP adds its own, and the
block reduces the sum once (``api.residual_out``). The load-balance
statistics come back as partial sums scaled to the mean over the whole
batch, so the aux loss is the unsharded one.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import api
from repro_torch.models.layers import Params, init_linear, init_mlp, mlp


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
             device="cpu") -> Params:
    mo = cfg.moe
    d = cfg.d_model
    scale = d ** -0.5

    def normal(shape, s):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * s).to(dtype)

    p: Params = {
        "router": init_linear(gen, d, mo.n_experts, dtype=torch.float32,
                              device=device),
        # Expert-stacked SwiGLU weights: (E, d, f) / (E, f, d).
        "w_gate": normal((mo.n_experts, d, mo.d_ff_expert), scale),
        "w_up": normal((mo.n_experts, d, mo.d_ff_expert), scale),
        "w_down": normal((mo.n_experts, mo.d_ff_expert, d),
                         mo.d_ff_expert ** -0.5),
    }
    if mo.n_shared:
        p["shared"] = init_mlp(gen, d, (mo.d_ff_shared or mo.d_ff_expert)
                               * mo.n_shared, dtype=dtype, device=device)
    return p


def _capacity(tokens: int, mo) -> int:
    cap = int(tokens * mo.top_k / mo.n_experts * mo.capacity_factor)
    return max(4, -(-cap // 4) * 4)


def _router(router_w: torch.Tensor, xt: torch.Tensor, mo):
    """Per-token routing: (gates (…,k), experts (…,k), probs (…,E),
    logits (…,E))."""
    logits = xt.float() @ router_w
    return (*_route(logits, mo), logits)


def _route(logits: torch.Tensor, mo):
    """Top-k of the router's ``logits``: (gates (…,k), experts (…,k),
    probs (…,E))."""
    probs = torch.softmax(logits, dim=-1)
    topg, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topg, topi = topg[..., :mo.top_k], topi[..., :mo.top_k]
    topg = topg / torch.clamp_min(topg.sum(-1, keepdim=True), 1e-9)
    return topg, topi, probs


def _aux_stats(probs: torch.Tensor, topi: torch.Tensor,
               logits: torch.Tensor, mo):
    """Token means of the router: (probs (E,), selections (E,), squared
    log-partition)."""
    me = probs.reshape(-1, mo.n_experts).mean(0)
    sel = F.one_hot(topi.reshape(-1), mo.n_experts).float().mean(0) \
        * mo.top_k
    zl = torch.mean(torch.logsumexp(logits.reshape(-1, mo.n_experts),
                                    dim=-1) ** 2)
    return me, sel, zl


def _aux(me: torch.Tensor, sel: torch.Tensor, zl: torch.Tensor,
         mo) -> Dict[str, torch.Tensor]:
    lb = mo.n_experts * torch.sum(me * sel / mo.top_k)
    return {"load_balance": lb, "router_z": zl}


# ---------------------------------------------------------------------------
# Sort-based dispatch (default).
# ---------------------------------------------------------------------------

def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, aux: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d). Routing groups are sequence rows, so every gather
    stays within one row. ``aux=False`` (decode) skips the aux losses:
    ``{}`` in their place."""
    mo = cfg.moe
    x = api.batch_sharded(x)        # rows whole: routing groups are rows
    weights = (p["router"]["w"], p["w_gate"], p["w_up"], p["w_down"])
    if api.is_sharded(x):
        y, me, sel, zl = _moe_sharded(x, weights, mo)
    else:
        y, (me, sel, zl) = _dispatch(x, *weights, 0, mo)
    y = y.to(x.dtype)
    if "shared" in p:
        y = y + mlp(p["shared"], x)
    return y, (_aux(me, sel, zl, mo) if aux else {})


def _moe_sharded(x: torch.Tensor, weights, mo):
    """``_dispatch`` on local shards: rows on the data axes, experts on
    the model axis when it divides them. (y, a partial sum over the model
    axis where the experts split, and the three router statistics, each
    a DTensor.) In decode (``api.decode_plan``) the router's logits are
    its resident product, gathered (a few rows of E each), so the
    router's weight is never moved."""
    from torch.distributed.tensor import Partial, Shard
    mesh = x.device_mesh
    batch = api.batch_axes_of(mesh, x.shape[0]) is not None
    m = api.model_size(mesh)
    split = m > 1 and mo.n_experts % m == 0
    e0 = api.model_rank(mesh) * (mo.n_experts // m) if split else 0
    # Partial wherever the work is split: the router's statistics are
    # scaled by those dims' size, so their sum is the whole batch's mean
    # and their gradient is a partial sum like the dispatch's.
    part = api.weight_grads(mesh, batch, Partial() if split else None)
    n_part = 1
    for pl, size in zip(part, api.mesh_axes(mesh).values()):
        n_part *= size if isinstance(pl, Partial) else 1
    experts = Shard(0) if split else None
    w_pl = api.mesh_placements(mesh, False, experts)
    w_grad = api.weight_grads(mesh, batch, experts)
    rows = api.mesh_placements(mesh, batch)
    decode = api.in_decode()
    if decode:
        route = api.resident_linear(x.float(), weights[0], whole=True)
        route_pl = rows
    else:
        route, route_pl = weights[0], api.mesh_placements(mesh, False)

    def core(x_, r_, g_, u_, d_):
        y, (me, sel, zl) = _dispatch(x_, None if decode else r_, g_, u_, d_,
                                     e0, mo, logits=r_ if decode else None)
        return y, me / n_part, sel / n_part, zl / n_part

    y, me, sel, zl = api.local_map(
        core, mesh, (x, route, *weights[1:]),
        [rows, route_pl, w_pl, w_pl, w_pl],
        (api.mesh_placements(mesh, batch, Partial() if split else None),
         part, part, part),
        [api.mesh_placements(mesh, batch, Partial() if split else None),
         part, w_grad, w_grad, w_grad])
    return y, me, sel, zl


def _dispatch(x: torch.Tensor, router_w, w_gate, w_up, w_down, e0: int,
              mo, logits=None):
    """Route every token of ``x`` (B, S, d) (by ``router_w``, or by the
    router's ``logits`` where they are given) and run experts ``[e0, e0
    + E_local)`` (the leading dim of ``w_gate``): (their summed outputs
    (B, S, d), the router statistics of ``_aux_stats``)."""
    b, s, d = x.shape
    k, e = mo.top_k, mo.n_experts
    cap = _capacity(s, mo)
    dev = x.device

    if logits is None:                    # (B,S,k)×2, (B,S,E)×2
        topg, topi, probs, logits = _router(router_w, x, mo)
    else:
        topg, topi, probs = _route(logits, mo)

    # Flatten routed copies within each row: (B, S·k).
    flat_e = topi.reshape(b, s * k)
    flat_g = topg.reshape(b, s * k)
    tok_of = torch.arange(s, device=dev).repeat_interleave(k)[None, :] \
        .expand(b, s * k)

    order = torch.argsort(flat_e, dim=-1, stable=True)  # contiguous experts
    sg = torch.gather(flat_g, 1, order)
    st = torch.gather(tok_of, 1, order)                 # token id per slot

    counts = torch.zeros((b, e), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=-1) - counts     # start of each expert

    arange_c = torch.arange(cap, device=dev)
    slot = offsets[:, :, None] + arange_c[None, None, :]    # (B,E,C)
    valid = arange_c[None, None, :] < counts[:, :, None]
    slot_c = torch.clamp(slot, 0, s * k - 1).reshape(b, -1)

    tok_idx = torch.gather(st, 1, slot_c).reshape(b, e, cap)  # token ids
    gate = torch.gather(sg, 1, slot_c).reshape(b, e, cap) * valid
    mine = slice(e0, e0 + w_gate.shape[0])                  # local experts
    tok_idx, gate, valid = tok_idx[:, mine], gate[:, mine], valid[:, mine]

    rows = torch.arange(b, device=dev)
    xe = x[rows[:, None, None], tok_idx] * valid[..., None].to(x.dtype)

    h = torch.einsum("becd,edf->becf", xe, w_gate)
    u = torch.einsum("becd,edf->becf", xe, w_up)
    ye = torch.einsum("becf,efd->becd", F.silu(h) * u, w_down)
    ye = ye * gate[..., None].to(ye.dtype)

    # Scatter-add back per row.
    y = torch.zeros((b, s, d), dtype=ye.dtype, device=dev).index_put_(
        (rows[:, None], tok_idx.reshape(b, -1)), ye.reshape(b, -1, d),
        accumulate=True)
    return y, _aux_stats(probs, topi, logits, mo)


# ---------------------------------------------------------------------------
# Dense GShard dispatch (the oracle).
# ---------------------------------------------------------------------------

def moe_ffn_dense(p: Params, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    topg, topi, probs, logits = _router(p["router"]["w"], xt, mo)
    cap = _capacity(t, mo)

    combine = torch.zeros((t, mo.n_experts, cap), device=x.device)
    prev = torch.zeros((mo.n_experts,), dtype=torch.long, device=x.device)
    for kk in range(mo.top_k):
        onehot = F.one_hot(topi[:, kk], mo.n_experts).float()
        pos = torch.cumsum(onehot, dim=0) - 1.0 + prev[None, :]
        pos_tok = (pos * onehot).sum(-1)
        keep = pos_tok < cap
        # one_hot of an index >= cap is all zeros, as jax.nn.one_hot's.
        pos_oh = (pos_tok.long()[:, None] == torch.arange(
            cap, device=x.device)[None, :]).float() * keep[:, None]
        combine = combine + topg[:, kk, None, None] * onehot[:, :, None] \
            * pos_oh[:, None, :]
        prev = prev + onehot.sum(0).long()
    dispatch = (combine > 0).to(x.dtype)

    xe = torch.einsum("tec,td->ecd", dispatch, xt)
    h = torch.einsum("ecd,edf->ecf", xe, p["w_gate"])
    u = torch.einsum("ecd,edf->ecf", xe, p["w_up"])
    ye = torch.einsum("ecf,efd->ecd", F.silu(h) * u, p["w_down"])
    y = torch.einsum("tec,ecd->td", combine.to(x.dtype), ye)
    y = y.reshape(b, s, d)
    if "shared" in p:
        y = y + mlp(p["shared"], xt).reshape(b, s, d)
    return y, _aux(*_aux_stats(probs, topi, logits, mo), mo)
