"""Model assembly: block composition, the loop over stacked layers, the
loss, prefill and decode — one code path for all ten architectures.

Layer parameters are stacked on a leading L axis, as in the reference,
and walked one layer at a time (``scan_util`` views: ``tree_unstack``'s
in the forward, ``tree_at``'s over params and caches in decode). Hybrid
(Zamba-style) stacks walk groups of ``attn_every`` mamba layers, each
followed by ONE shared attention+MLP block whose parameters are not
stacked; interleaved MoE stacks (Llama-4) walk groups of
``moe_every - 1`` dense blocks and one MoE block.

``forward`` and ``loss_fn`` run under autograd (``launch.steps``
differentiates ``loss_fn``), with the reference's rematerialisation
points (``remat=``). ``decode_step`` writes each layer's cache in place
and returns the same cache tree; it reads the position from a tensor and
makes no host sync, so the serving engine can capture it as one CUDA
graph.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockType, ModelConfig
from repro_torch.distributed.api import (batch_sharded, batch_sums,
                                         block_input, constrain_residual,
                                         decode_plan, gather_layer_params,
                                         gathered, in_prefill, is_sharded,
                                         last_dim_on_model, last_row,
                                         model_whole, prefill_plan,
                                         residual_out, vocab_ce_sums,
                                         vocab_table)
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models.layers import (Params, embed, init_embedding,
                                       init_linear, init_mlp, init_rmsnorm,
                                       linear, mlp, rmsnorm, unembed)
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.scan_util import (tree_at, tree_map, tree_stack,
                                          tree_unstack)

PyTree = Any


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Per-layer init / apply.
# ---------------------------------------------------------------------------

def _init_attn_block(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                     use_moe: Optional[bool] = None) -> Params:
    use_moe = (cfg.moe is not None) if use_moe is None else use_moe
    p: Params = {
        "ln_attn": init_rmsnorm(cfg.d_model, dtype, device),
        "attn": A.init_attention(gen, cfg, dtype, device),
        "ln_mlp": init_rmsnorm(cfg.d_model, dtype, device),
    }
    if use_moe:
        p["moe"] = init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def _apply_attn_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, moe_aux_loss). A block is MoE iff its params carry the
    'moe' subtree (interleaved stacks mix dense and MoE blocks)."""
    p = gather_layer_params(p)      # streamed-FSDP weight gather
    aux = torch.zeros((), device=x.device)

    def ffn(h):
        nonlocal aux
        if "moe" in p:      # prefill discards the aux loss: not made
            fo, al = moe_ffn(p["moe"], h, cfg, aux=not in_prefill())
            if al:
                aux = aux + al["load_balance"] * 0.01 \
                    + al["router_z"] * 1e-4
            return fo
        return mlp(p["mlp"], h)

    # On a mesh each norm's output is gathered once for the products that
    # read it, and each branch's partial sums are reduce-scattered back
    # (in prefill it stays on the rank's rows: ``block_input``).
    h = block_input(rmsnorm(p["ln_attn"], x, cfg.norm_eps))
    ao = residual_out(A.attention_forward(p["attn"], h, cfg, q_offset))
    if cfg.parallel_block:
        # Command-R: attention and FFN read the same normed input.
        return x + ao + residual_out(ffn(h)), aux
    x = x + ao
    h = block_input(rmsnorm(p["ln_mlp"], x, cfg.norm_eps))
    return x + residual_out(ffn(h)), aux


def _init_mamba_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                      device) -> Params:
    return {"ln": init_rmsnorm(cfg.d_model, dtype, device),
            "mamba": S.init_mamba(gen, cfg, dtype, device)}


def _apply_mamba_block(p: Params, x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    p = gather_layer_params(p)      # streamed-FSDP weight gather
    h = block_input(rmsnorm(p["ln"], x, cfg.norm_eps))
    return x + residual_out(S.mamba_forward(p["mamba"], h, cfg))


# ---------------------------------------------------------------------------
# Whole-model init.
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device="cuda") -> PyTree:
    """Random parameters of ``cfg`` on ``device`` in ``cfg.dtype``, drawn
    from ``generator`` (a ``torch.Generator`` on that device; None: one
    seeded with 0), the reference's tree of names and stacked shapes.
    Raises without CUDA unless the caller asks for the CPU."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    dtype = _dtype(cfg)
    params: Dict[str, PyTree] = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dtype, dev),
        "ln_f": init_rmsnorm(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab, cfg.d_model,
                                           dtype, dev)
    if cfg.frontend != "none":
        params["frontend_proj"] = init_linear(gen, cfg.frontend_dim,
                                              cfg.d_model, dtype=dtype,
                                              device=dev)

    if cfg.block_type is BlockType.MAMBA:
        layers = [_init_mamba_block(gen, cfg, dtype, dev)
                  for _ in range(cfg.n_layers)]
        if cfg.attn_every:
            ng, k = cfg.n_layers // cfg.attn_every, cfg.attn_every
            params["layers"] = tree_stack([tree_stack(layers[i * k:(i + 1)
                                                             * k])
                                           for i in range(ng)])
            params["shared_attn"] = _init_attn_block(gen, cfg, dtype, dev,
                                                     use_moe=False)
        else:
            params["layers"] = tree_stack(layers)
    elif cfg.moe is not None and cfg.moe_every > 1:
        # Interleaved dense/MoE (Llama-4): groups of (moe_every-1) dense
        # blocks followed by one MoE block.
        ng = cfg.n_layers // cfg.moe_every
        dense, moe_blocks = [], []
        for _ in range(ng):
            dense.append(tree_stack([
                _init_attn_block(gen, cfg, dtype, dev, use_moe=False)
                for _ in range(cfg.moe_every - 1)]))
            moe_blocks.append(_init_attn_block(gen, cfg, dtype, dev,
                                               use_moe=True))
        params["layers"] = {"dense": tree_stack(dense),
                            "moe": tree_stack(moe_blocks)}
    else:
        params["layers"] = tree_stack([_init_attn_block(gen, cfg, dtype, dev)
                                       for _ in range(cfg.n_layers)])
    return params


def _n(tree: PyTree) -> int:
    """Length of a stacked tree's leading axis."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(tree.shape[0])


# ---------------------------------------------------------------------------
# Forward (prefill).
# ---------------------------------------------------------------------------

def _embed_inputs(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                  frontend_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    x = embed(params["embed"], tokens)
    if cfg.frontend != "none":
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name} requires frontend embeddings")
        fe = batch_sharded(linear(params["frontend_proj"],
                                  frontend_embeds.to(x.dtype)))
        x = torch.cat([fe, x], dim=1)
    return x


def _remat(remat: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat`` and
    autograd is recording: its activations are recomputed in the
    backward pass instead of kept (the reference's ``jax.checkpoint``).
    The recomputation gives the same values, so the gradients are those
    of the plain call bit for bit."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _mamba_group(group: PyTree, shared: Params, x: torch.Tensor,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """A hybrid stack's group: its mamba layers, then the shared block."""
    for mp in tree_unstack(group):
        x = _apply_mamba_block(mp, constrain_residual(x), cfg)
    return _apply_attn_block(shared, x, cfg)


def _moe_pair(dense: PyTree, moe_block: Params, x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """An interleaved stack's group: its dense blocks, then the MoE one."""
    aux = torch.zeros((), device=x.device)
    for dp in tree_unstack(dense):
        x, a = _apply_attn_block(dp, x, cfg)
        aux = aux + a
    x, a = _apply_attn_block(moe_block, x, cfg)
    return x, aux + a


def forward(params: PyTree, tokens: torch.Tensor, cfg: ModelConfig,
            frontend_embeds: Optional[torch.Tensor] = None,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S_text) → (final-normed hidden (B, S, d), moe_aux
    scalar; on a mesh the hidden is whole over the model axis, gathered
    once from the sequence-sharded residual); ``logits_from_hidden`` maps
    the hidden to logits. With
    ``remat`` each layer (each group of a hybrid or interleaved stack) is
    recomputed in the backward pass, where the reference puts
    ``jax.checkpoint``. Stacked leaves are walked as ``unbind`` views, so
    their gradients come back stacked, with no per-layer copy."""
    hidden, aux = _normed_hidden(params, tokens, cfg, frontend_embeds, remat)
    return model_whole(hidden), aux


def _normed_hidden(params: PyTree, tokens: torch.Tensor, cfg: ModelConfig,
                   frontend_embeds: Optional[torch.Tensor],
                   remat: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``forward``'s final-normed hidden as the residual lies (on a mesh
    sequence-sharded, each rank's rows), and moe_aux."""
    x = _embed_inputs(params, cfg, tokens, frontend_embeds)
    aux = torch.zeros((), device=x.device)
    layers = params["layers"]
    if cfg.block_type is BlockType.MAMBA and cfg.attn_every:
        for group in tree_unstack(layers):
            x, a = _remat(remat, _mamba_group, group, params["shared_attn"],
                          constrain_residual(x), cfg)
            aux = aux + a
    elif cfg.block_type is BlockType.MAMBA:
        for lp in tree_unstack(layers):
            x = _remat(remat, _apply_mamba_block, lp,
                       constrain_residual(x), cfg)
    elif cfg.moe is not None and cfg.moe_every > 1:
        for dense, moe_block in zip(tree_unstack(layers["dense"]),
                                    tree_unstack(layers["moe"])):
            x, a = _remat(remat, _moe_pair, dense, moe_block,
                          constrain_residual(x), cfg)
            aux = aux + a
    else:
        for lp in tree_unstack(layers):
            x, a = _remat(remat, _apply_attn_block, lp,
                          constrain_residual(x), cfg)
            aux = aux + a
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux


def _head(params: PyTree, cfg: ModelConfig) -> Params:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def logits_from_hidden(params: PyTree, cfg: ModelConfig,
                       x: torch.Tensor) -> torch.Tensor:
    """Logits of ``x`` (on a mesh batch-sharded, the vocab whole)."""
    return batch_sharded(unembed(_head(params, cfg), x))


def _ce_sums(logits: torch.Tensor, labels: torch.Tensor):
    """(summed cross entropy, count) of the valid (label >= 0) positions."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    valid = (labels >= 0).float()
    return torch.sum((logz - gold) * valid), valid.sum()


def loss_fn(params: PyTree, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            ce_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy over the text positions, plus the MoE aux
    loss: (loss, {"ce", "aux"}). The (B, S, vocab) logits are never
    formed at once: CE runs over sequence chunks, f32 per chunk, and each
    chunk's logits are recomputed in the backward pass instead of kept
    (as the reference checkpoints its scan body)."""
    hidden, aux = forward(params, batch["tokens"], cfg,
                          batch.get("frontend_embeds"))
    n_front = cfg.frontend_tokens if cfg.frontend != "none" else 0
    h = hidden[:, n_front:, :]
    h_in = h[:, :-1]
    labels = batch["tokens"][:, 1:]
    c = min(ce_chunk, h_in.shape[1])
    head = {"table": vocab_table(_head(params, cfg)["table"])}

    def chunk_ce(h_i, l_i):
        logits = unembed(head, h_i)                       # (B, c, V) fp32
        if last_dim_on_model(logits):                     # vocab-parallel
            return vocab_ce_sums(logits, l_i)
        if is_sharded(logits):
            return batch_sums(_ce_sums, (logits, l_i), 2)
        return _ce_sums(logits, l_i)

    ce_sum = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for i in range(0, h_in.shape[1], c):
        s_i, n_i = _remat(True, chunk_ce, h_in[:, i:i + c],
                          labels[:, i:i + c])
        ce_sum = ce_sum + s_i
        cnt = cnt + n_i
    ce = ce_sum / torch.clamp_min(cnt, 1.0)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode.
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> PyTree:
    """Decode cache, zeros. Attention archs: (L, B, S_cache, KvH, D) KV
    (S_cache = min(max_len, sliding window) if a window is set); MLA: the
    latent cache; SSM: conv + ssm states (f32)."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    s_cache = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len

    def attn_cache(lead):
        if cfg.mla is not None:
            m = cfg.mla
            shapes = {"c_kv": (batch, s_cache, m.kv_lora_rank),
                      "k_rope": (batch, s_cache, m.qk_rope_dim)}
        else:
            kv = (batch, s_cache, cfg.n_kv_heads, cfg.head_dim)
            shapes = {"k": kv, "v": kv}
        return {k: torch.zeros(lead + s, dtype=dtype, device=dev)
                for k, s in shapes.items()}

    def mamba_cache(lead):
        return tree_map(lambda t: t.new_zeros(lead + tuple(t.shape)),
                        S.init_mamba_cache(cfg, batch, device=dev))

    if cfg.block_type is BlockType.MAMBA and cfg.attn_every:
        ng = cfg.n_layers // cfg.attn_every
        return {"mamba": mamba_cache((ng, cfg.attn_every)),
                "attn": attn_cache((ng,))}
    if cfg.block_type is BlockType.MAMBA:
        return {"mamba": mamba_cache((cfg.n_layers,))}
    if cfg.moe is not None and cfg.moe_every > 1:
        ng = cfg.n_layers // cfg.moe_every
        return {"attn": {"dense": attn_cache((ng, cfg.moe_every - 1)),
                         "moe": attn_cache((ng,))}}
    return {"attn": attn_cache((cfg.n_layers,))}


def _decode_attn_block(lp: Params, x: torch.Tensor, ac, pos,
                       cfg: ModelConfig) -> torch.Tensor:
    def ffn(h):
        return mlp(lp["mlp"], h) if "mlp" in lp \
            else moe_ffn(lp["moe"], h, cfg, aux=False)[0]

    h = rmsnorm(lp["ln_attn"], x, cfg.norm_eps)
    ao = residual_out(A.attention_decode(lp["attn"], h, ac, pos, cfg)[0])
    if cfg.parallel_block:
        return x + ao + residual_out(ffn(h))
    x = x + ao
    h = rmsnorm(lp["ln_mlp"], x, cfg.norm_eps)
    return x + residual_out(ffn(h))


def _decode_mamba_block(mp: Params, x: torch.Tensor, mc,
                        cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(mp["ln"], x, cfg.norm_eps)
    y, _ = S.mamba_decode(mp["mamba"], h, mc, cfg)
    return x + residual_out(y)


def decode_step(params: PyTree, tokens: torch.Tensor, cache: PyTree, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, PyTree]:
    """tokens: (B, 1) — one new token per sequence; pos: count of tokens
    already in the cache (an int or a 0-d tensor). Returns (logits
    (B, vocab), cache), the cache updated in place. On a mesh the weights
    stay where they lie (``distributed.api.decode_plan``) and each layer
    attends its caches on their own shards."""
    with decode_plan():
        return _decode_step(params, tokens, cache, pos, cfg)


def _decode_step(params: PyTree, tokens: torch.Tensor, cache: PyTree, pos,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, PyTree]:
    x = embed(params["embed"], tokens)
    pos = A.position_tensor(pos, x.device)        # one copy per step
    layers = params["layers"]
    if cfg.block_type is BlockType.MAMBA:
        for g in range(_n(layers)):
            group, mc = tree_at(layers, g), tree_at(cache["mamba"], g)
            if cfg.attn_every:
                for j in range(_n(group)):
                    x = _decode_mamba_block(tree_at(group, j), x,
                                            tree_at(mc, j), cfg)
                x = _decode_attn_block(params["shared_attn"], x,
                                       tree_at(cache["attn"], g), pos, cfg)
            else:
                x = _decode_mamba_block(group, x, mc, cfg)
    elif cfg.moe is not None and cfg.moe_every > 1:
        ac = cache["attn"]
        for g in range(_n(layers["moe"])):
            dense, dc = tree_at(layers["dense"], g), tree_at(ac["dense"], g)
            for j in range(_n(dense)):
                x = _decode_attn_block(tree_at(dense, j), x, tree_at(dc, j),
                                       pos, cfg)
            x = _decode_attn_block(tree_at(layers["moe"], g), x,
                                   tree_at(ac["moe"], g), pos, cfg)
    else:
        for i in range(_n(layers)):
            x = _decode_attn_block(tree_at(layers, i), x,
                                   tree_at(cache["attn"], i), pos, cfg)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x)[:, 0], cache


def prefill(params: PyTree, tokens: torch.Tensor, cfg: ModelConfig,
            frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill forward; returns last-position logits (B, vocab) — the full
    (B, S, vocab) tensor is never formed. On a mesh it runs
    ``distributed.api.prefill_plan`` (the reference's compiled
    ``prefill_step``): the hidden stays on each rank's rows, only the
    last row moves (``last_row``), and the logits come back replicated,
    as the reference's ``out_shardings=replicated(mesh)``."""
    with prefill_plan():
        hidden, _ = _normed_hidden(params, tokens, cfg, frontend_embeds,
                                   remat=True)
        logits = logits_from_hidden(params, cfg, last_row(hidden))[:, 0]
    return gathered(logits)
