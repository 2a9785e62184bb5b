"""LM primitives: norms, RoPE, MLPs, embeddings — pure-functional params.

Parameters are nested dicts of tensors with the reference's names (its
sharding rules match on them, and ``bridge.lm_params_from_jax`` carries
its trees over unchanged). Every ``init_*`` draws from a
``torch.Generator`` on the device the tensors are made on.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed import api

Params = Dict[str, torch.Tensor]


def _normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """f32 normal draws times ``scale``, cast to ``dtype``."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


# ----------------------------------------------------------------- norms
def init_rmsnorm(d: int, dtype=torch.bfloat16, device="cpu") -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last dim. It is row-wise, so on a mesh it runs
    on the sequence-sharded residual as it is (the column-parallel
    products after it gather its output once); where the last dim is on
    the model axis (the SSD block's gated norm) the scale is sharded as
    it is and the mean of squares is reduced over the model axis."""
    scale = api.norm_scale(p["scale"], x)
    x32 = x.float()
    var = api.row_mean(x32 * x32)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ----------------------------------------------------------------- linear
def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = False, dtype=torch.bfloat16,
                device="cpu") -> Params:
    p = {"w": _normal(gen, (d_in, d_out), d_in ** -0.5, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(p: Params, x: torch.Tensor, whole: bool = False) -> torch.Tensor:
    """``x @ w (+ b)``. On a mesh the placements of ``x`` and ``w`` on the
    model axis pick the product (``distributed.api.sharded_linear``):
    column-parallel on a whole input (the output's last dim stays on the
    model axis), row-parallel on a column-parallel output (a partial sum
    over the model axis), or with ``whole`` the weight gathered and the
    output whole."""
    if api.is_sharded(x):
        return api.sharded_linear(x, p["w"], p.get("b"), whole)
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ----------------------------------------------------------------- RoPE
@functools.lru_cache(maxsize=None)
def rope_freqs(d_head: int, theta: float,
               device: torch.device) -> torch.Tensor:
    """(D/2,) inverse frequencies, made once per (D, theta, device)."""
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)     # (D/2,)
    ang = positions[..., None].float() * freqs           # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., ::2], x32[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


# ----------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype=torch.bfloat16,
             device="cpu") -> Params:
    return {
        "gate": init_linear(gen, d, d_ff, dtype=dtype, device=device),
        "up": init_linear(gen, d, d_ff, dtype=dtype, device=device),
        "down": init_linear(gen, d_ff, d, dtype=dtype, device=device),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (the default for all assigned archs). On a mesh gate and up
    are column-parallel and down row-parallel: the output is a partial
    sum over the model axis (``api.residual_out`` reduces it)."""
    return linear(p["down"], F.silu(linear(p["gate"], x))
                  * linear(p["up"], x))


# ------------------------------------------------------------ embeddings
def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.bfloat16, device="cpu") -> Params:
    return {"table": _normal(gen, (vocab, d), 1.0, dtype, device)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table for ``tokens``."""
    if api.is_sharded(p["table"]):
        return _embed_sharded(p["table"], tokens)
    return p["table"][tokens]


def _embed_sharded(table, tokens):
    """The vocab-parallel lookup: with the vocab on the model axis, each
    model rank reads the tokens in its slice (the rest masked to zero)
    and the ranks' rows are summed; the table is never gathered over the
    model axis (its rows are over the data axis). In decode a table whose
    d lies there (a vocab that does not divide) is read on its columns.
    Under ``api.prefill_plan`` the table is gathered whole for the lookup,
    as the reference's compiled prefill does: no (B, S, d) partial sum is
    reduced."""
    from torch.distributed.tensor import Partial, Shard
    mesh = table.device_mesh
    v, m = table.shape[0], api.model_size(mesh)
    split = m > 1 and v % m == 0 and not api.in_prefill()
    v0 = api.model_rank(mesh) * (v // m) if split else 0
    batch = api.batch_axes_of(mesh, tokens.shape[0]) is not None

    def lookup(tab, tok):
        if not split:
            return tab[tok]
        mine = (tok >= v0) & (tok < v0 + tab.shape[0])
        rows = tab[torch.where(mine, tok - v0, 0)]
        return rows * mine[..., None].to(rows.dtype)

    vocab = Shard(0) if split else None
    if not split and api.in_decode() and api.last_dim_on_model(table):
        # Decode: each rank's columns of the rows, gathered (a row a
        # token), never the resident table.
        out = api.local_map(lambda tab, tok: tab[tok], mesh, (table, tokens),
                            [api.mesh_placements(mesh, False, Shard(1)),
                             api.mesh_placements(mesh, batch)],
                            api.mesh_placements(mesh, batch, Shard(2)))
        return api.batch_sharded(out)
    out = api.local_map(
        lookup, mesh, (table, tokens),
        [api.mesh_placements(mesh, False, vocab),
         api.mesh_placements(mesh, batch)],
        api.mesh_placements(mesh, batch, Partial() if split else None),
        [api.weight_grads(mesh, batch, vocab), None])
    return api.batch_sharded(out)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 for a stable softmax-CE. On a mesh they are
    vocab-sharded over the model axis where the table's vocab is
    (``api.vocab_table``), from ``x`` whole there. Under
    ``api.prefill_plan`` a table whose d lies there (a vocab that does
    not divide) is read on its columns as decode reads it: the logits'
    partial sums are reduced, the table never gathered."""
    if api.is_sharded(x) and (api.in_decode() or api.in_prefill()
                              and api.last_dim_on_model(p["table"])):
        # The resident table as it lies: its vocab or its d on the model
        # axis (a vocab that does not divide), never gathered.
        return api.resident_linear(x.float(), p["table"].T.float())
    table = api.vocab_table(p["table"])
    return api.model_whole(x).float() @ table.T.float()
