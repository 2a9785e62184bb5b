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
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


# ----------------------------------------------------------------- linear
def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = False, dtype=torch.bfloat16,
                device="cpu") -> Params:
    p = {"w": _normal(gen, (d_in, d_out), d_in ** -0.5, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
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
    """SwiGLU (the default for all assigned archs)."""
    return linear(p["down"], F.silu(linear(p["gate"], x))
                  * linear(p["up"], x))


# ------------------------------------------------------------ embeddings
def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.bfloat16, device="cpu") -> Params:
    return {"table": _normal(gen, (vocab, d), 1.0, dtype, device)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 for a stable softmax-CE."""
    return x.float() @ p["table"].T.float()
