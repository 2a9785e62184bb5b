"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060.

Chunked SSD: intra-chunk "attention" (the duality's quadratic branch)
plus the inter-chunk state recurrence (linear branch), a loop over
chunks. Decode is the O(1) recurrent update of (conv_state, ssm_state),
written into the cache in place.

On a mesh (``DTensor`` inputs) the SSD heads lie on the model axis: each
rank takes the fused input projection's z, x and dt columns of its heads
and B and C whole (the rules shard that projection's out-dim
contiguously, which does not align with the head groups, so its weight
is gathered whole and sliced), runs the causal conv on its channels and
``ssd_chunked`` on its heads, and the gated RMS norm over d_in reduces
its mean of squares over the model axis; ``out_proj`` is row-parallel.
Where the heads do not split over the model axis the block between the
two projections runs on each batch shard (``distributed.api.
batch_local``). Decode (``_mamba_step_sharded``) updates each state on
the shards ``cache_shardings`` gives it, with the inner params as they
lie: ``_conv_step`` on the rank's channels, ``_ssm_step`` on its shard of
the SSD state, its read-out C·h reduced over the model axis. Prefill
(``distributed.api.prefill_plan``) runs the block on each rank's rows of
the sequence (``_mamba_rows``): the conv reads the rank before's last
rows, and the scan starts from the state the ranks before carry in
(``distributed.api.SeqRows``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import api
from repro_torch.distributed.api import batch_local, is_sharded
from repro_torch.distributed.sharding import shard_slices
from repro_torch.models.layers import Params, init_linear, linear, rmsnorm


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.state_dim      # x, B, C share the causal conv
    return s, d_in, nh, conv_ch


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device="cpu") -> Params:
    s, d_in, nh, conv_ch = _dims(cfg)
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # z, x, B, C, dt fused input projection.
        "in_proj": init_linear(gen, d, 2 * d_in + 2 * s.state_dim + nh,
                               dtype=dtype, device=device),
        "conv_w": (torch.randn((s.conv_width, conv_ch), generator=gen, **f32)
                   * 0.2).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.zeros((nh,), **f32),             # A = -exp(a_log)
        "dt_bias": torch.zeros((nh,), **f32),
        "d_skip": torch.ones((nh,), **f32),
        "norm": {"scale": torch.ones((d_in,), dtype=dtype, device=device)},
        "out_proj": init_linear(gen, d_in, d, dtype=dtype, device=device),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) → (..., Q, Q) with out[q, k] = Σ_{j=k+1..q} x_j (−inf
    above the diagonal)."""
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    q = x.shape[-1]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, -torch.inf)


def ssd_chunked(xbar: torch.Tensor, da: torch.Tensor, b_in: torch.Tensor,
                c_in: torch.Tensor, chunk: int, carry=None) -> torch.Tensor:
    """xbar: (B, L, H, P) = dt·x;  da: (B, L, H) = dt·A (negative);
    b_in, c_in: (B, L, N). Returns y: (B, L, H, P). ``carry`` (rows of a
    longer sequence: ``SeqRows.carry``) maps the chunks' final states
    and decays to the state entering the rows; by default zeros."""
    bsz, l, h, p = xbar.shape
    n = b_in.shape[-1]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        xbar = F.pad(xbar, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    nc = xbar.shape[1] // q
    xc = xbar.reshape(bsz, nc, q, h, p)
    dac = da.reshape(bsz, nc, q, h).permute(0, 3, 1, 2)    # (B,H,nc,Q)
    bc = b_in.reshape(bsz, nc, q, n)
    cc = c_in.reshape(bsz, nc, q, n)

    da_cs = torch.cumsum(dac, dim=-1)                       # (B,H,nc,Q)
    decay = torch.exp(_segsum(dac))                         # (B,H,nc,Q,Q)

    # Intra-chunk (quadratic branch).
    scores = torch.einsum("bcqn,bckn->bcqk", cc, bc)        # (B,nc,Q,Q)
    m = torch.einsum("bcqk,bhcqk->bhcqk", scores, decay)
    y_diag = torch.einsum("bhcqk,bckhp->bcqhp", m, xc)

    # Chunk-final states.
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)       # (B,H,nc,Q)
    states = torch.einsum("bckn,bhck,bckhp->bchnp", bc, decay_states, xc)

    # Inter-chunk recurrence: the state entering each chunk.
    chunk_decay = torch.exp(da_cs[..., -1])                 # (B,H,nc)
    s_prev = torch.zeros((bsz, h, n, p), device=xbar.device)
    if carry is not None:
        s_prev = carry(states, chunk_decay)
    prev_states = []
    for c in range(nc):
        prev_states.append(s_prev)
        s_prev = s_prev * chunk_decay[:, :, c, None, None] \
            + states[:, c].float()
    prev_states = torch.stack(prev_states, dim=1)           # (B,nc,H,N,P)

    # Contribution of carried state into each position.
    state_decay = torch.exp(da_cs)                          # (B,H,nc,Q)
    y_off = torch.einsum("bcqn,bchnp,bhcq->bcqhp", cc,
                         prev_states.to(xc.dtype), state_decay)
    y = (y_diag + y_off).reshape(bsz, nc * q, h, p)
    return y[:, :l]


def _split_proj(zxbcdt: torch.Tensor, s, d_in: int, nh: int):
    """(z, x, B, C, dt) of the fused input projection."""
    return torch.split(zxbcdt, [d_in, d_in, s.state_dim, s.state_dim, nh],
                       dim=-1)


def _inner_params(p: Params):
    """The block's parameters between its two projections."""
    return (p["conv_w"], p["conv_b"], p["dt_bias"], p["a_log"], p["d_skip"],
            p["norm"]["scale"])


def mamba_forward(p: Params, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d)."""
    _, _, nh, _ = _dims(cfg)
    if api.in_prefill() and api.rows_split(x):
        return _mamba_rows(p, x, cfg)
    if is_sharded(x) and nh % api.model_size(x.device_mesh) == 0:
        return _mamba_heads(p, x, cfg)
    zxbcdt = linear(p["in_proj"], x, whole=True)
    if is_sharded(zxbcdt):
        y = batch_local(lambda t, *w: _mamba_inner(t, *w, cfg), (zxbcdt,),
                        _inner_params(p))
    else:
        y = _mamba_inner(zxbcdt, *_inner_params(p), cfg)
    return linear(p["out_proj"], y)


def _mamba_inner(zxbcdt, conv_w, conv_b, dt_bias, a_log, d_skip, norm_scale,
                 cfg: ModelConfig, rows=None) -> torch.Tensor:
    """Causal conv, SSD scan and gated norm: (B, S, d_in). ``rows``
    (``SeqRows``): ``zxbcdt`` is this rank's rows of the sequence."""
    s, d_in, nh, _ = _dims(cfg)
    y, z = _mamba_scan(zxbcdt, conv_w, conv_b, dt_bias, a_log, d_skip, s,
                       d_in, nh, rows)
    return rmsnorm({"scale": norm_scale}, y * F.silu(z))


def _mamba_scan(zxbcdt, conv_w, conv_b, dt_bias, a_log, d_skip, s,
                d_in: int, nh: int, rows=None):
    """Causal conv and SSD scan over ``nh`` heads of ``d_in`` channels:
    the pre-norm output and the gate z, each (B, S, d_in). With ``rows``
    the conv's first rows read the halo and the scan starts from the
    carried state."""
    bsz, l, _ = zxbcdt.shape
    z, xin, b_in, c_in, dt = _split_proj(zxbcdt, s, d_in, nh)
    # Causal depthwise conv over (x, B, C).
    xbc = torch.cat([xin, b_in, c_in], dim=-1)              # (B, L, conv_ch)
    w = conv_w.float()
    if rows is None:
        xbc_p = F.pad(xbc.float(), (0, 0, s.conv_width - 1, 0))
    else:
        xbc_p = torch.cat([rows.halo(xbc.float(), s.conv_width - 1),
                           xbc.float()], dim=1)
    conv = sum(xbc_p[:, i:i + l] * w[i] for i in range(s.conv_width))
    conv = F.silu(conv + conv_b.float())
    xin, b_in, c_in = torch.split(conv, [d_in, s.state_dim, s.state_dim],
                                  dim=-1)

    dt = F.softplus(dt.float() + dt_bias)                   # (B,L,H)
    a = -torch.exp(a_log)                                   # (H,)
    xh = xin.reshape(bsz, l, nh, s.head_dim)
    y = ssd_chunked((xh * dt[..., None]).float(), dt * a, b_in, c_in,
                    s.chunk, None if rows is None else rows.carry)
    y = y + xh.float() * d_skip[None, None, :, None]
    return y.reshape(bsz, l, d_in).to(zxbcdt.dtype), z


def _mamba_rows(p: Params, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Prefill's block on this rank's rows of the sequence (``x`` with
    its rows on the model axis): both projections read their weights
    whole and keep the rows, and the conv, the scan and the gated norm
    run on the rows, the conv's halo and the scan's entering state from
    the ranks before (``SeqRows``)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    batch = api.batch_axes_of(mesh, x.shape[0]) is not None
    rows = api.mesh_placements(mesh, batch, Shard(1))
    seq = api.SeqRows(mesh)
    y = api.local_map(
        lambda t, *w: _mamba_inner(t, *w, cfg, seq), mesh,
        (linear(p["in_proj"], x, whole=True), *_inner_params(p)),
        [rows] + [api.mesh_placements(mesh, False)] * 6, rows)
    return linear(p["out_proj"], y)


def _mamba_heads(p: Params, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The block with its SSD heads on the model axis (``x`` on a mesh
    whose model size divides the heads): each rank's heads' z, x and dt
    columns and B and C whole from the gathered ``in_proj``, its
    channels' conv, its heads' scan, then the gated norm over the
    sharded d_in and the row-parallel ``out_proj``."""
    from torch.distributed.tensor import Partial, Shard
    s, d_in, nh, _ = _dims(cfg)
    mesh = x.device_mesh
    m, r = api.model_size(mesh), api.model_rank(mesh)
    dl, hl, n = d_in // m, nh // m, s.state_dim
    batch = api.batch_axes_of(mesh, x.shape[0]) is not None

    def core(x_, w_in, conv_w, conv_b, dt_bias, a_log, d_skip):
        xs = slice(d_in + r * dl, d_in + (r + 1) * dl)     # its x channels
        bc = slice(2 * d_in, 2 * d_in + 2 * n)               # B and C
        dts = slice(2 * d_in + 2 * n + r * hl, 2 * d_in + 2 * n + (r + 1) * hl)
        w_loc = torch.cat([w_in[:, r * dl:(r + 1) * dl], w_in[:, xs],
                           w_in[:, bc], w_in[:, dts]], dim=1)
        ch = [slice(r * dl, (r + 1) * dl), slice(d_in, d_in + 2 * n)]
        return _mamba_scan(
            x_ @ w_loc, torch.cat([conv_w[:, c] for c in ch], dim=1),
            torch.cat([conv_b[c] for c in ch]), dt_bias[r * hl:(r + 1) * hl],
            a_log[r * hl:(r + 1) * hl], d_skip[r * hl:(r + 1) * hl], s, dl,
            hl)

    whole = api.mesh_placements(mesh, False)
    rows = api.mesh_placements(mesh, batch)
    grads = api.weight_grads(mesh, batch, Partial())
    y, z = api.local_map(
        core, mesh, (api.model_whole(x), p["in_proj"]["w"], *(
            _inner_params(p)[:5])), [rows] + [whole] * 6,
        (api.mesh_placements(mesh, batch, Shard(2)),) * 2,
        [api.mesh_placements(mesh, batch, Partial())] + [grads] * 6)
    return linear(p["out_proj"], rmsnorm(p["norm"], y * F.silu(z)))


# ---------------------------------------------------------------------------
# Decode (recurrent) path.
# ---------------------------------------------------------------------------

def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu") -> Dict[str, torch.Tensor]:
    s, d_in, nh, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, s.head_dim, s.state_dim), dtype=dtype,
                           device=device),
    }


def mamba_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d); O(1) state update, written into ``cache``."""
    zxbcdt = linear(p["in_proj"], x[:, 0])
    if is_sharded(zxbcdt):
        y = _mamba_step_sharded(p, zxbcdt, cache["conv"], cache["ssm"], cfg)
    else:
        y = _mamba_step(zxbcdt, *_inner_params(p), cache["conv"],
                        cache["ssm"], cfg)
    return linear(p["out_proj"], y), cache


def _mamba_step(zxbcdt, conv_w, conv_b, dt_bias, a_log, d_skip, norm_scale,
                conv_state, ssm_state, cfg: ModelConfig) -> torch.Tensor:
    """The recurrent update of both states (in place) and the gated norm:
    (B, 1, d_in)."""
    s, d_in, nh, _ = _dims(cfg)
    bsz = zxbcdt.shape[0]
    z, xin, b_in, c_in, dt = _split_proj(zxbcdt, s, d_in, nh)
    conv = _conv_step(torch.cat([xin, b_in, c_in], dim=-1), conv_state,
                      conv_w, conv_b)
    xin, b_in, c_in = torch.split(conv, [d_in, s.state_dim, s.state_dim],
                                  dim=-1)
    xh = xin.reshape(bsz, nh, s.head_dim)
    y = _ssm_step(xh, b_in, c_in, dt, dt_bias, a_log, ssm_state) \
        + xh * d_skip[None, :, None]
    y = y.reshape(bsz, 1, d_in).to(zxbcdt.dtype)
    return rmsnorm({"scale": norm_scale}, y * F.silu(z[:, None]))


def _conv_step(xbc, conv_state, conv_w, conv_b) -> torch.Tensor:
    """The causal conv's step over the channels of ``xbc`` (B, ch): the
    window ``conv_state`` (B, W - 1, ch) shifted by ``xbc`` in place, and
    the conv's silu'd output (B, ch), f32."""
    hist = torch.cat([conv_state, xbc[:, None].to(conv_state.dtype)], dim=1)
    w = conv_w.float()
    conv = torch.einsum("bwc,wc->bc", hist.float(), w)
    conv_state.copy_(hist[:, 1:])
    return F.silu(conv + conv_b.float())


def _ssm_step(xh, b_in, c_in, dt, dt_bias, a_log, ssm_state) -> torch.Tensor:
    """The SSD state (B, H, P, N) advanced by one token in place (``xh``
    (B, H, P), ``b_in``/``c_in`` (B, N), ``dt`` (B, H) before its bias),
    and its read-out C·h (B, H, P), without the skip."""
    dt1 = F.softplus(dt.float() + dt_bias)                  # (B,H)
    a = -torch.exp(a_log)
    da = torch.exp(dt1 * a)                                 # (B,H)
    ssm = ssm_state * da[..., None, None] \
        + torch.einsum("bhp,bn,bh->bhpn", xh, b_in, dt1)
    ssm_state.copy_(ssm)
    return torch.einsum("bhpn,bn->bhp", ssm, c_in)


def _mamba_step_sharded(p: Params, zxbcdt, conv_state, ssm_state,
                        cfg: ModelConfig):
    """``_mamba_step`` on the states' own shards (``sharding.
    cache_shardings``: the conv window on its channels over the model
    axis, the SSD state on its longest dim there) and the inner params
    as they lie: ``zxbcdt`` (the in-projection's column-parallel output,
    a few rows) gathered whole; each rank's conv over its channels;
    those outputs gathered whole (over the rows the SSD shard holds);
    the SSD shard's update, its read-out C·h a partial sum where the
    state dim is split, reduced over the model axis; the gated norm over
    the norm scale's shards (its row sums all-reduced). Returns the
    (B, 1, d_in) input of the out-projection, batch-sharded."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    s, d_in, nh, _ = _dims(cfg)
    n = s.state_dim
    mesh = zxbcdt.device_mesh
    bsz = zxbcdt.shape[0]
    batch = api.batch_axes_of(mesh, bsz) is not None
    rows = api.mesh_placements(mesh, batch)
    z, xin, b_in, c_in, dt = _split_proj(
        zxbcdt.redistribute(mesh, rows).to_local(), s, d_in, nh)
    ch = shard_slices(conv_state.shape, conv_state.placements, mesh)[-1]
    conv = _conv_step(torch.cat([xin, b_in, c_in], dim=-1)[:, ch],
                      conv_state.to_local(), _param_piece(p["conv_w"], ch),
                      _param_piece(p["conv_b"], ch))
    split = ch.stop - ch.start < conv_state.shape[-1]
    conv = DTensor.from_local(conv, mesh, api.mesh_placements(
        mesh, batch, Shard(1) if split else None), run_check=False) \
        .redistribute(mesh, rows)
    # The rows the SSD shard holds: from this rank's batch shard where
    # it holds them, else from every row.
    sl = shard_slices(ssm_state.shape, ssm_state.placements, mesh)
    act = shard_slices((bsz,), rows, mesh)[0]
    conv_r, dt_r, off = conv.to_local(), dt, act.start
    if not act.start <= sl[0].start <= sl[0].stop <= act.stop:
        whole = api.mesh_placements(mesh, False)
        conv_r = conv.redistribute(mesh, whole).to_local()
        dt_r = DTensor.from_local(dt, mesh, rows, run_check=False) \
            .redistribute(mesh, whole).to_local()
        off = 0
    r = slice(sl[0].start - off, sl[0].stop - off)
    conv_r, dt_r = conv_r[r], dt_r[r]
    xs, bs, cs = torch.split(conv_r, [d_in, n, n], dim=-1)
    xh = xs.reshape(xs.shape[0], nh, s.head_dim)[:, sl[1], sl[2]]
    y = _ssm_step(xh, bs[:, sl[3]], cs[:, sl[3]], dt_r[:, sl[1]],
                  _param_piece(p["dt_bias"], sl[1]),
                  _param_piece(p["a_log"], sl[1]), ssm_state.to_local())
    y = DTensor.from_local(y, mesh, tuple(
        Partial() if isinstance(pl, Shard) and pl.dim == 3 else pl
        for pl in ssm_state.placements), run_check=False) \
        .redistribute(mesh, rows).to_local()
    xin = conv.to_local()[:, :d_in].reshape(-1, nh, s.head_dim)
    y = y + xin * _param_piece(p["d_skip"], slice(0, nh))[None, :, None]
    y = y.reshape(-1, 1, d_in).to(zxbcdt.dtype) * F.silu(z[:, None])
    y = DTensor.from_local(y, mesh, rows, run_check=False)
    scale = p["norm"]["scale"]
    if api.last_dim_on_model(scale):
        y = y.redistribute(mesh, api.mesh_placements(mesh, batch,
                                                     Shard(2)))
    return rmsnorm(p["norm"], y)


def _param_piece(w, sl: slice) -> torch.Tensor:
    """Columns ``sl`` (of the whole last dim) of a resident param,
    read from this rank's shard, which must hold them."""
    lo = shard_slices(w.shape, w.placements, w.device_mesh)[-1].start
    if sl.start < lo or sl.stop - lo > w.to_local().shape[-1]:
        raise NotImplementedError(
            f"columns {sl.start}:{sl.stop} of a param of shape "
            f"{tuple(w.shape)} lie outside this rank's shard")
    return w.to_local()[..., sl.start - lo:sl.stop - lo]
