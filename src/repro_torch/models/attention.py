"""Attention: GQA/MHA with RoPE, sliding-window, chunked-softmax (flash
style) prefill, KV-cache decode, and DeepSeek-V2 MLA (decompress-per-
chunk prefill; absorbed-matmul decode).

The chunked online softmax keeps the (Sq × Skv) score matrix out of
memory: scores exist only per (Sq × chunk) block, one block per loop
step, as in the reference's scan. Products the reference asks in f32
(``preferred_element_type``) take f32 copies of their operands, which is
exact for bf16 inputs. Decode writes the new key and value into the
cache in place (``index_copy_`` at a position held in a tensor) and
returns the same cache.

On a mesh (``DTensor`` inputs) q, k and v (and MLA's queries and
per-head decompressions) are column-parallel products, their heads on
the model axis, the attention cores run on each rank's heads
(``distributed.api.heads_parallel``; context-parallel over the model
axis where the heads do not split), and the output projection is
row-parallel. Decode (``distributed.api.decode_plan``) reads every weight
where it lies and attends each cache on its own shards
(``distributed.api.decode_attend``): ``_decode_core`` and
``_mla_latent_attend`` take each leaf's ``CacheShard``, whose ops are the
plain ones off the mesh; MLA's absorbed products run on each rank's heads
(``heads_parallel``) around it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.api import (WHOLE, constrain_qkv,
                                         context_parallel, decode_attend,
                                         heads_parallel, heads_split,
                                         is_sharded, last_dim_on_model,
                                         model_whole, split_heads)
from repro_torch.models.layers import Params, apply_rope, init_linear, linear

NEG_INF = -1e30


def _f32_einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``einsum`` with f32 operands and result: the reference's
    ``preferred_element_type=jnp.float32``."""
    return torch.einsum(eq, *(o.float() for o in ops))


# ---------------------------------------------------------------------------
# Parameter init.
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.bfloat16, device="cpu") -> Params:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        return _init_mla(gen, cfg, dtype, device)
    kw = dict(bias=cfg.qkv_bias, dtype=dtype, device=device)
    return {
        "wq": init_linear(gen, d, h * hd, **kw),
        "wk": init_linear(gen, d, kvh * hd, **kw),
        "wv": init_linear(gen, d, kvh * hd, **kw),
        "wo": init_linear(gen, h * hd, d, dtype=dtype, device=device),
    }


def _init_mla(gen: torch.Generator, cfg: ModelConfig, dtype,
              device) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    q_in = m.q_lora_rank or d
    kw = dict(dtype=dtype, device=device)
    p: Params = {
        # joint compressed KV + shared rope key: d → kv_lora + rope
        "w_dkv": init_linear(gen, d, m.kv_lora_rank + m.qk_rope_dim, **kw),
        "w_uk": init_linear(gen, m.kv_lora_rank, h * m.qk_nope_dim, **kw),
        "w_uv": init_linear(gen, m.kv_lora_rank, h * m.v_dim, **kw),
        "wq": init_linear(gen, q_in, h * (m.qk_nope_dim + m.qk_rope_dim),
                          **kw),
        "wo": init_linear(gen, h * m.v_dim, d, **kw),
    }
    if m.q_lora_rank:
        p["w_dq"] = init_linear(gen, d, m.q_lora_rank, **kw)
    return p


# ---------------------------------------------------------------------------
# Chunked online-softmax attention core.
# ---------------------------------------------------------------------------

def _online_softmax_step(carry, s: torch.Tensor, v: torch.Tensor):
    """One chunk of the online softmax: scores ``s`` (B, H, Sq, C), f32,
    masked; ``v`` (B, C, H, Dv)."""
    m_prev, l_prev, o_prev = carry
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new)
    l_new = l_prev * alpha + p.sum(dim=-1, keepdim=True)
    o_new = o_prev * alpha + _f32_einsum("bhqk,bkhd->bhqd", p.to(v.dtype), v)
    return m_new, l_new, o_new


def _online_softmax_init(b: int, h: int, sq: int, dv: int,
                         device: torch.device):
    return (torch.full((b, h, sq, 1), NEG_INF, device=device),
            torch.zeros((b, h, sq, 1), device=device),
            torch.zeros((b, h, sq, dv), device=device))


def _chunk_scan(q: torch.Tensor, k_chunks: torch.Tensor,
                v_chunks: torch.Tensor, q_pos: torch.Tensor,
                k_pos_chunks: torch.Tensor, window: int,
                scale: float) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v_chunks: (n, B, C, KvH, Dk/Dv);
    k_pos_chunks: (n, C). Causal (+ optional sliding window)."""
    b, sq, h, _ = q.shape
    n, _, _, kvh, dv = v_chunks.shape
    rep = h // kvh
    q32 = (q * scale).to(q.dtype)
    carry = _online_softmax_init(b, h, sq, dv, q.device)
    for i in range(n):
        k_c, v_c, kp = k_chunks[i], v_chunks[i], k_pos_chunks[i]
        if rep > 1:
            k_c = torch.repeat_interleave(k_c, rep, dim=2)
            v_c = torch.repeat_interleave(v_c, rep, dim=2)
        s = _f32_einsum("bqhd,bkhd->bhqk", q32, k_c)
        msk = kp[None, :] > q_pos[:, None]                # future → mask
        if window > 0:
            msk = msk | (q_pos[:, None] - kp[None, :] >= window)
        s = torch.where(msk[None, None], NEG_INF, s)
        carry = _online_softmax_step(carry, s, v_c)
    _, l, o = carry
    out = o / torch.clamp_min(l, 1e-20)
    return out.permute(0, 2, 1, 3)                        # (B, Sq, H, Dv)


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dim 1 of (B, S, ...) by ``pad`` at the end."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


def _chunk_positions(pos: torch.Tensor, pad: int, n: int,
                     c: int) -> torch.Tensor:
    """(n, C) key positions, padding keys at 2**30 (always masked)."""
    if pad:
        pos = torch.cat([pos, torch.full((pad,), 2 ** 30, dtype=pos.dtype,
                                         device=pos.device)])
    return pos.reshape(n, c)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_offset: int = 0, window: int = 0,
                      chunk: int = 1024) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KvH, D); causal."""
    b, sq, _, _ = q.shape
    skv = k.shape[1]
    c = min(chunk, skv)
    n = -(-skv // c)
    pad = n * c - skv
    k, v = _pad_seq(k, pad), _pad_seq(v, pad)
    kc = k.reshape(b, n, c, *k.shape[2:]).permute(1, 0, 2, 3, 4)
    vc = v.reshape(b, n, c, *v.shape[2:]).permute(1, 0, 2, 3, 4)
    kpc = _chunk_positions(torch.arange(skv, device=q.device), pad, n, c)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    scale = q.shape[-1] ** -0.5
    return _chunk_scan(q, kc, vc, q_pos, kpc, window, scale)


def kv_heads(t: torch.Tensor, h0: int, n: int, rep: int) -> torch.Tensor:
    """The key or value heads of (B, S, KvH, D) ``t`` that query heads
    ``h0 .. h0 + n - 1`` read (``rep`` query heads to a kv head): a slice
    of whole groups where the query heads make whole groups, else one kv
    head per query head."""
    if h0 % rep == 0 and n % rep == 0:
        return t[:, :, h0 // rep:(h0 + n) // rep]
    idx = torch.arange(h0, h0 + n, device=t.device) // rep
    return t.index_select(2, idx)


# ---------------------------------------------------------------------------
# GQA forward (prefill) and decode.
# ---------------------------------------------------------------------------

def attention_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      q_offset: int = 0) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d). (The reference's ``return_cache``, which
    no caller of the serving path sets, is left out.)"""
    if cfg.mla is not None:
        return _mla_forward(p, x, cfg, q_offset)
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(linear(p["wq"], x), h)
    k = split_heads(linear(p["wk"], x), kvh)
    v = split_heads(linear(p["wv"], x), kvh)
    pos = q_offset + torch.arange(s, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    q, k, v = constrain_qkv(q, k, v)
    if heads_split(q):
        kv_split = heads_split(k)      # each rank's kv heads its own

        def core(h0, q_, k_, v_):
            if not kv_split:
                k_, v_ = (kv_heads(t, h0, q_.shape[2], h // kvh)
                          for t in (k_, v_))
            return chunked_attention(q_, k_, v_, q_offset=q_offset,
                                     window=cfg.sliding_window)
        out = heads_parallel(core, q, (k, v), (), kv_split)
    elif is_sharded(q):
        out = context_parallel(
            lambda shift, q_, k_, v_: chunked_attention(
                q_, k_, v_, q_offset=q_offset + shift,
                window=cfg.sliding_window),
            (q,), (model_whole(k), model_whole(v)))
    else:
        out = chunked_attention(q, k, v, q_offset=q_offset,
                                window=cfg.sliding_window)
    return linear(p["wo"], out.reshape(b, s, h * hd).to(x.dtype))


def position_tensor(pos, device: torch.device) -> torch.Tensor:
    """The decode position (an int or a tensor of one element) as a (1,)
    long tensor on ``device`` (the same tensor when it is one already)."""
    return torch.as_tensor(pos, dtype=torch.long, device=device).reshape(1)


def attention_decode(p: Params, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], pos,
                     cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, d); cache k/v: (B, S, KvH, D) ring
    buffer (S = window for SWA archs, full context otherwise), updated in
    place; pos: count of tokens already in context."""
    if cfg.mla is not None:
        return _mla_decode(p, x, cache, pos, cfg)
    b = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = position_tensor(pos, x.device)
    q = split_heads(linear(p["wq"], x), h)
    k_new = split_heads(linear(p["wk"], x), kvh)
    v_new = split_heads(linear(p["wv"], x), kvh)
    q = apply_rope(q, pos, cfg.rope_theta)
    k_new = apply_rope(k_new, pos, cfg.rope_theta)
    if is_sharded(q):
        o = decode_attend(
            lambda q_, k_, v_, ck, cv, parts: _decode_core(
                q_, k_, v_, ck, cv, pos, cfg, parts),
            (q, k_new, v_new), (cache["k"], cache["v"]))
    else:
        o = _decode_core(q, k_new, v_new, cache["k"], cache["v"], pos, cfg)
    out = linear(p["wo"], o.reshape(b, 1, h * hd))
    return out, cache


def _decode_core(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                 cache_k: torch.Tensor, cache_v: torch.Tensor,
                 pos: torch.Tensor, cfg: ModelConfig,
                 parts=(WHOLE, WHOLE)) -> torch.Tensor:
    """The new key and value written into the ring buffer at ``pos``
    (in place), then q attends over it: (B, 1, H, D). ``parts`` are the
    caches' ``CacheShard``s: on a mesh each rank's shards of the ring,
    whose ops combine over the model axis (``distributed.api.
    decode_attend``); whole, the plain ops."""
    pk, pv = parts
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s_cache = pk.ring(cache_k.shape[1])
    slot = pos % s_cache                # ring buffer (wraps only for SWA)
    k = pk.write(cache_k, slot, k_new)
    v = pv.write(cache_v, slot, v_new)

    # Positions of cache slots (ring-aware): slot i holds token
    # pos - ((slot - i) mod S) for filled slots.
    idx = pk.slot_index(cache_k.shape[1], q.device)
    tok_pos = pos - (slot - idx) % s_cache
    valid = tok_pos >= 0
    # Each kv head's query heads as a group: the keys and values are read
    # as they lie, never repeated per query head.
    scale = hd ** -0.5
    qg = (pk.local(q) * scale).unflatten(2, (kvh, h // kvh))
    s_ = pk.scores(_f32_einsum("bqgrd,bkgd->bgrqk", qg, k))
    msk = ~valid
    if cfg.sliding_window > 0:
        msk = msk | (pos - tok_pos >= cfg.sliding_window)
    s_ = torch.where(msk, NEG_INF, s_)
    return pv.attend(s_, v, "bgrqk,bkgd->bqgrd").flatten(2, 3)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2).
# ---------------------------------------------------------------------------

def _mla_q(p: Params, x: torch.Tensor, cfg: ModelConfig,
           pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.mla
    b, s, _ = x.shape
    xq = linear(p["w_dq"], x, whole=True) if "w_dq" in p else x
    q = split_heads(linear(p["wq"], xq), cfg.n_heads)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, pos, cfg.rope_theta)


def _mla_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 q_offset: int) -> torch.Tensor:
    """Prefill: decompress K/V per chunk (the latent cache never expands
    to full per-head K/V in memory at once)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    pos = q_offset + torch.arange(s, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, pos)
    ckv_full = linear(p["w_dkv"], x, whole=True)  # (B, S, kv_lora + rope)
    c_kv, k_rope = ckv_full[..., :m.kv_lora_rank], \
        ckv_full[..., m.kv_lora_rank:]
    k_rope = apply_rope(k_rope[..., None, :], pos, cfg.rope_theta)[..., 0, :]
    w_uk, w_uv = p["w_uk"]["w"], p["w_uv"]["w"]
    if heads_split(q_nope) and last_dim_on_model(w_uk) \
            and last_dim_on_model(w_uv):
        out = heads_parallel(
            lambda h0, qn, qr, ck, kr, wk, wv: _mla_attend(
                qn, qr, ck, kr, wk, wv, pos, pos, cfg),
            (q_nope, q_rope), (c_kv, k_rope), (w_uk, w_uv))
    elif is_sharded(q_nope):
        out = context_parallel(
            lambda shift, qn, qr, ck, kr, wk, wv: _mla_attend(
                qn, qr, ck, kr, wk, wv, pos[shift:shift + qn.shape[1]], pos,
                cfg), (q_nope, q_rope),
            (c_kv, k_rope), (w_uk, w_uv))
    else:
        out = _mla_attend(q_nope, q_rope, c_kv, k_rope, w_uk, w_uv, pos,
                          pos, cfg)
    return linear(p["wo"], out.reshape(b, s, h * m.v_dim).to(x.dtype))


def _mla_attend(q_nope, q_rope, c_kv, k_rope, w_uk, w_uv,
                q_pos: torch.Tensor, pos: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """The chunked MLA core: queries at ``q_pos`` over the latent keys at
    ``pos``, each chunk decompressed on the fly; (B, Sq, H, v_dim) for
    the H heads of ``q_nope`` (on a mesh, a rank's share of the heads and
    of ``w_uk``'s and ``w_uv``'s columns)."""
    m = cfg.mla
    b, sq, h = q_nope.shape[:3]
    s = c_kv.shape[1]
    chunk = min(1024, s)
    n = -(-s // chunk)
    pad = n * chunk - s
    c_kv_p, k_rope_p = _pad_seq(c_kv, pad), _pad_seq(k_rope, pad)
    k_pos = _chunk_positions(pos, pad, n, chunk)
    ckv_c = c_kv_p.reshape(b, n, chunk, -1).permute(1, 0, 2, 3)
    krope_c = k_rope_p.reshape(b, n, chunk, -1).permute(1, 0, 2, 3)
    w_uk = w_uk.reshape(m.kv_lora_rank, h, m.qk_nope_dim)
    w_uv = w_uv.reshape(m.kv_lora_rank, h, m.v_dim)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5

    carry = _online_softmax_init(b, h, sq, m.v_dim, q_nope.device)
    for i in range(n):
        ckv_i, kr_i, kp = ckv_c[i], krope_c[i], k_pos[i]
        k_nope = torch.einsum("bkl,lhd->bkhd", ckv_i, w_uk)   # decompress
        v_i = torch.einsum("bkl,lhd->bkhd", ckv_i, w_uv)
        s_ = (_f32_einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + _f32_einsum("bqhd,bkd->bhqk", q_rope, kr_i)) * scale
        msk = kp[None, :] > q_pos[:, None]
        s_ = torch.where(msk[None, None], NEG_INF, s_)
        carry = _online_softmax_step(carry, s_, v_i)
    _, l, o = carry
    return (o / torch.clamp_min(l, 1e-20)).permute(0, 2, 1, 3)


def _mla_decode(p: Params, x: torch.Tensor, cache, pos, cfg: ModelConfig):
    """Absorbed-matmul decode: scores via q̃ = W_uk^T q_nope against the
    latent cache — the cache stays (kv_lora + rope)-wide."""
    m = cfg.mla
    b = x.shape[0]
    pos = position_tensor(pos, x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, pos)
    ckv_full = linear(p["w_dkv"], x, whole=True)
    c_new, kr_new = ckv_full[..., :m.kv_lora_rank], \
        ckv_full[..., m.kv_lora_rank:]
    kr_new = apply_rope(kr_new[..., None, :], pos, cfg.rope_theta)[..., 0, :]
    caches = (cache["c_kv"], cache["k_rope"])
    w_uk, w_uv = p["w_uk"]["w"], p["w_uv"]["w"]
    if is_sharded(q_nope) and heads_split(q_nope) \
            and last_dim_on_model(w_uk) and last_dim_on_model(w_uv):
        # Each rank's heads through its columns of the decompressions;
        # every head against each rank's slots of the latent cache.
        q_abs = heads_parallel(lambda h0, qn, wk: _mla_absorb(qn, wk, cfg),
                               q_nope, (), (w_uk,))
        o_lat = decode_attend(
            lambda qa, qr, cn, kn, cc, cr, parts: _mla_latent_attend(
                qa, qr, cn, kn, cc, cr, pos, cfg, parts),
            (q_abs, q_rope, c_new, kr_new), caches)
        o = heads_parallel(lambda h0, ol, wv: _mla_expand(ol, wv, cfg),
                           o_lat, (), (w_uv,))
    elif is_sharded(q_nope):
        # Heads that do not split over the model axis: the
        # decompressions read whole.
        o = decode_attend(
            lambda qn, qr, cn, kn, wk, wv, cc, cr, parts: _mla_decode_core(
                qn, qr, cn, kn, wk, wv, cc, cr, pos, cfg, parts),
            (q_nope, q_rope, c_new, kr_new), caches, (w_uk, w_uv))
    else:
        o = _mla_decode_core(q_nope, q_rope, c_new, kr_new, w_uk, w_uv,
                             *caches, pos, cfg)
    out = linear(p["wo"], o.reshape(b, 1, cfg.n_heads * m.v_dim))
    return out, cache


def _mla_decode_core(q_nope, q_rope, c_new, kr_new, w_uk, w_uv, cache_c,
                     cache_r, pos: torch.Tensor, cfg: ModelConfig,
                     parts=(WHOLE, WHOLE)) -> torch.Tensor:
    """The latent and rope key written at ``pos`` (in place), then the
    absorbed-matmul attention over the latent cache: (B, 1, H, v_dim).
    ``parts`` as ``_decode_core``'s."""
    q_abs = _mla_absorb(q_nope, w_uk, cfg)                # (B,1,H,kv_lora)
    o_lat = _mla_latent_attend(q_abs, q_rope, c_new, kr_new, cache_c,
                               cache_r, pos, cfg, parts)
    return _mla_expand(o_lat, w_uv, cfg)


def _mla_absorb(q_nope, w_uk, cfg: ModelConfig) -> torch.Tensor:
    """q̃ = W_uk^T q_nope for the heads of ``q_nope`` (``w_uk``'s columns
    of those heads): (B, 1, H, kv_lora)."""
    m = cfg.mla
    w_uk = w_uk.reshape(m.kv_lora_rank, -1, m.qk_nope_dim)
    return torch.einsum("bqhd,lhd->bqhl", q_nope, w_uk)


def _mla_expand(o_lat, w_uv, cfg: ModelConfig) -> torch.Tensor:
    """The latent outputs (B, 1, H, kv_lora) through ``w_uv``'s columns of
    the same heads: (B, 1, H, v_dim)."""
    m = cfg.mla
    w_uv = w_uv.reshape(m.kv_lora_rank, -1, m.v_dim)
    return torch.einsum("bqhl,lhd->bqhd", o_lat, w_uv)


def _mla_latent_attend(q_abs, q_rope, c_new, kr_new, cache_c, cache_r,
                       pos: torch.Tensor, cfg: ModelConfig,
                       parts=(WHOLE, WHOLE)) -> torch.Tensor:
    """The latent and rope key written at ``pos`` (in place), then every
    head of ``q_abs`` and ``q_rope`` over the latent cache: (B, 1, H,
    kv_lora)."""
    m = cfg.mla
    pc, pr = parts
    c_kv = pc.write(cache_c, pos, c_new)
    k_rope = pr.write(cache_r, pos, kr_new)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    s_ = (pc.scores(_f32_einsum("bqhl,bkl->bhqk", pc.local(q_abs), c_kv))
          + pr.scores(_f32_einsum("bqhd,bkd->bhqk", pr.local(q_rope),
                                  k_rope))) * scale
    valid = pc.slot_index(cache_c.shape[1], q_abs.device) <= pos
    s_ = torch.where(~valid[None, None, None, :], NEG_INF, s_)
    return pc.attend(s_, c_kv, "bhqk,bkl->bqhl")
