"""Runtime layout conversions — the store/load legs of Table 2 in software.

``materialize`` converts a producer's NHWC output into the store format an
edge carries (``core.layouts.LayoutSpec``); ``restore`` is the exact
inverse, used when a consumer at a split fan-out needs a different
representation than the one stored (the Table 2 "converting load").

Both are pure gathers with indices precomputed in numpy once per
(spec, device). Overlapping positions in the Toeplitz and Winograd-tile
layouts hold identical copies, so ``restore(materialize(x)) == x``
exactly. A leading batch dim is kept.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.layouts import LayoutSpec, invertible, is_nhwc
from repro_torch.kernels.conv_im2col.ref import toeplitz_ref
from repro_torch.kernels.winograd.winograd import pad_for_tiles


def materialize(x: torch.Tensor, spec: Optional[LayoutSpec]) -> torch.Tensor:
    """NHWC ``(…, H, W, C)`` → the ``spec`` store format (batch preserved)."""
    if is_nhwc(spec):
        return x
    if tuple(x.shape[-3:]) != (spec.h, spec.w, spec.c) or x.ndim not in (3, 4):
        raise ValueError(f"cannot materialize {tuple(x.shape)} as {spec.key}")
    if spec.kind == "toeplitz":
        return toeplitz_ref(x, spec.k1, spec.k2, spec.stride, spec.padding)
    return _winograd_tiles(x, spec)


def restore(v: torch.Tensor, spec: Optional[LayoutSpec]) -> torch.Tensor:
    """Exact inverse of ``materialize`` — the converting-load leg."""
    if is_nhwc(spec):
        return v
    if not invertible(spec):
        raise ValueError(f"layout {spec.key} is not invertible; "
                         "lower_plan should not have stored it")
    if spec.kind == "winograd":
        tile, a, b = _winograd_restore_indices(spec, v.device)
        return v[..., tile, a, b, :]
    row, tap = _toeplitz_restore_indices(spec, v.device)
    lead = v.shape[:-2]
    t3 = v.reshape(*lead, spec.o1 * spec.o2, spec.k1 * spec.k2, spec.c)
    return t3[..., row, tap, :]


# ---------------------------------------------------------------------------
# Winograd scattered-tile layout: overlapping T×T input tiles, stride m.
# ---------------------------------------------------------------------------

def _winograd_tiles(x: torch.Tensor, spec: LayoutSpec) -> torch.Tensor:
    """(…, H, W, C) → (…, tiles_y·tiles_x, T, T, C), padded exactly as the
    single-round F(m,r) conv core pads (SAME halo + bottom/right fill so
    every tile slice is in range)."""
    ty, tx = spec.tiles_y, spec.tiles_x
    xp = pad_for_tiles(x, m=spec.m, r=spec.r, tiles_y=ty, tiles_x=tx,
                       pad_top=spec.pad_top, pad_left=spec.pad_left)
    r_idx, c_idx = _winograd_tile_indices(spec, x.device)
    tiles = xp[..., r_idx, c_idx, :]                   # (…, ty, tx, T, T, C)
    return tiles.reshape(*x.shape[:-3], ty * tx, spec.t, spec.t, spec.c)


@functools.lru_cache(maxsize=None)
def _winograd_tile_indices(spec: LayoutSpec, device: torch.device
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded-map (row, col) gather indices of every tile element,
    broadcasting to (tiles_y, tiles_x, T, T)."""
    t, m = spec.t, spec.m
    r_idx = np.arange(spec.tiles_y)[:, None] * m + np.arange(t)[None, :]
    c_idx = np.arange(spec.tiles_x)[:, None] * m + np.arange(t)[None, :]
    return (torch.as_tensor(r_idx[:, None, :, None], device=device),
            torch.as_tensor(c_idx[None, :, None, :], device=device))


@functools.lru_cache(maxsize=None)
def _winograd_restore_indices(spec: LayoutSpec, device: torch.device
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Per-pixel (tile, row-in-tile, col-in-tile) gather indices: pixel
    (y, x) lives at padded (y+pt, x+pl), inside tile (min(p//m, tiles-1))
    at local offset p - tile·m (< T because tiles overlap by r-1)."""
    m, ty, tx = spec.m, spec.tiles_y, spec.tiles_x
    ys = np.arange(spec.h) + spec.pad_top
    xs = np.arange(spec.w) + spec.pad_left
    iy = np.minimum(ys // m, ty - 1)
    ix = np.minimum(xs // m, tx - 1)
    a, b = ys - iy * m, xs - ix * m
    assert a.max() < spec.t and b.max() < spec.t
    tile = iy[:, None] * tx + ix[None, :]                 # (H, W)
    return (torch.as_tensor(tile, device=device),
            torch.as_tensor(a[:, None], device=device),
            torch.as_tensor(b[None, :], device=device))


# ---------------------------------------------------------------------------
# Toeplitz layout: (O1·O2, K1·K2·C) — recoverable while stride ≤ kernel.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _toeplitz_restore_indices(spec: LayoutSpec, device: torch.device
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (gemm-row, kernel-tap) gather indices: padded coord p is
    sampled by output position min(p//s, O-1) at tap p - pos·s (< K by the
    ``invertible`` guard)."""
    s, o1, o2 = spec.stride, spec.o1, spec.o2
    ys = np.arange(spec.h) + spec.pad_top
    xs = np.arange(spec.w) + spec.pad_left
    oy = np.minimum(ys // s, o1 - 1)
    ox = np.minimum(xs // s, o2 - 1)
    dk1, dk2 = ys - oy * s, xs - ox * s
    assert dk1.max() < spec.k1 and dk2.max() < spec.k2
    row = oy[:, None] * o2 + ox[None, :]                  # (H, W)
    tap = dk1[:, None] * spec.k2 + dk2[None, :]
    return (torch.as_tensor(row, dtype=torch.long, device=device),
            torch.as_tensor(tap, dtype=torch.long, device=device))
