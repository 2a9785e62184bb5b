"""Runtime layout conversions — the store/load legs of Table 2 in software.

``materialize`` converts a producer's NHWC output into the store format an
edge carries (``core.layouts.LayoutSpec``); ``restore`` is the exact
inverse, used when a consumer at a split fan-out needs a different
representation than the one stored (the Table 2 "converting load").

Both are pure gathers with indices precomputed in numpy once per
(spec, device). Overlapping positions of a Toeplitz matrix hold identical
copies, so ``restore(materialize(x)) == x`` exactly. The Winograd-tile
layout comes with the Winograd kernels; until then it raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.layouts import LayoutSpec, invertible, is_nhwc
from repro_torch.kernels.conv_im2col.ref import toeplitz_ref


def _no_winograd(spec: LayoutSpec) -> None:
    if spec.kind == "winograd":
        raise NotImplementedError(
            f"layout {spec.key}: the Winograd tile layout is not ported yet")


def materialize(x: torch.Tensor, spec: Optional[LayoutSpec]) -> torch.Tensor:
    """NHWC ``(…, H, W, C)`` → the ``spec`` store format (batch preserved)."""
    if is_nhwc(spec):
        return x
    _no_winograd(spec)
    if tuple(x.shape[-3:]) != (spec.h, spec.w, spec.c) or x.ndim not in (3, 4):
        raise ValueError(f"cannot materialize {tuple(x.shape)} as {spec.key}")
    return toeplitz_ref(x, spec.k1, spec.k2, spec.stride, spec.padding)


def restore(v: torch.Tensor, spec: Optional[LayoutSpec]) -> torch.Tensor:
    """Exact inverse of ``materialize`` — the converting-load leg."""
    if is_nhwc(spec):
        return v
    _no_winograd(spec)
    if not invertible(spec):
        raise ValueError(f"layout {spec.key} is not invertible; "
                         "lower_plan should not have stored it")
    row, tap = _toeplitz_restore_indices(spec, v.device)
    lead = v.shape[:-2]
    t3 = v.reshape(*lead, spec.o1 * spec.o2, spec.k1 * spec.k2, spec.c)
    return t3[..., row, tap, :]


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
