"""Oracle: spatial convolution via ``F.conv2d`` plus an explicit Toeplitz
construction matching Eq. 2 (used to validate layouts, not just values).

Every function keeps the reference's layouts: NHWC activations,
``(K1, K2, Cin, Cout)`` weights, ``(O1·O2, K1K2·Cin)`` Toeplitz matrices
with columns in (k1, k2, cin) order. SAME padding is XLA's asymmetric
split ``(ph // 2, ph - ph // 2)``, padded explicitly because ``F.conv2d``
only pads symmetrically."""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.common import pad_nhwc, same_pads


def conv_geometry(h: int, w: int, k1: int, k2: int, stride: int,
                  padding: str) -> Tuple[int, int, int, int, int, int]:
    """(o1, o2, pad_top, pad_bottom, pad_left, pad_right) of one conv."""
    if padding == "SAME":
        o1, pt, pb = same_pads(h, k1, stride)
        o2, pl, pr = same_pads(w, k2, stride)
        return o1, o2, pt, pb, pl, pr
    if padding != "VALID":
        raise ValueError(f"bad padding {padding!r}; want SAME|VALID")
    return (h - k1) // stride + 1, (w - k2) // stride + 1, 0, 0, 0, 0


def conv_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
             padding: str = "SAME") -> torch.Tensor:
    """x: (H, W, Cin) or (B, H, W, Cin); w: (K1, K2, Cin, Cout)."""
    single = x.ndim == 3
    xb = x[None] if single else x
    k1, k2 = int(w.shape[0]), int(w.shape[1])
    _, _, pt, pb, pl, pr = conv_geometry(xb.shape[1], xb.shape[2], k1, k2,
                                         stride, padding)
    xp = pad_nhwc(xb.to(torch.float32), pt, pb, pl, pr)
    out = F.conv2d(xp.permute(0, 3, 1, 2),
                   w.to(torch.float32).permute(3, 2, 0, 1), stride=stride)
    out = out.permute(0, 2, 3, 1).contiguous()
    return (out[0] if single else out).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _toeplitz_gather_index(hp: int, wp: int, k1: int, k2: int, stride: int,
                           o1: int, o2: int, device: torch.device
                           ) -> torch.Tensor:
    """(O1·O2, K1·K2) flat padded-pixel index of every Toeplitz entry."""
    oy = np.arange(o1)[:, None] * stride
    ox = np.arange(o2)[None, :] * stride
    rows = (oy * wp + ox).reshape(-1)                        # (O1·O2,)
    taps = (np.arange(k1)[:, None] * wp
            + np.arange(k2)[None, :]).reshape(-1)            # (K1·K2,)
    idx = rows[:, None] + taps[None, :]
    assert idx.max() < hp * wp
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def toeplitz_ref(x: torch.Tensor, k1: int, k2: int, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """The explicit im2col matrix (O1*O2, K1*K2*Cin) of §2.1.1; a leading
    batch dim is kept: (B, H, W, C) → (B, O1*O2, K1*K2*Cin)."""
    h, w_, c = (int(d) for d in x.shape[-3:])
    o1, o2, pt, pb, pl, pr = conv_geometry(h, w_, k1, k2, stride, padding)
    xp = pad_nhwc(x, pt, pb, pl, pr)
    hp, wp = h + pt + pb, w_ + pl + pr
    idx = _toeplitz_gather_index(hp, wp, k1, k2, stride, o1, o2, x.device)
    flat = xp.reshape(*x.shape[:-3], hp * wp, c)
    t = flat[..., idx, :]                          # (…, O1O2, K1K2, C)
    return t.reshape(*x.shape[:-3], o1 * o2, k1 * k2 * c)


def conv_from_toeplitz_ref(t: torch.Tensor, w: torch.Tensor, o1: int,
                           o2: int) -> torch.Tensor:
    """Eq. 2 GEMM on a pre-materialized Toeplitz operand (matched-layout
    load): t (O1·O2, K1K2·Cin) or (B, …), w (K1, K2, Cin, Cout)."""
    c_out = w.shape[-1]
    out = t.to(torch.float32) @ w.reshape(-1, c_out).to(torch.float32)
    return out.reshape(*t.shape[:-2], o1, o2, c_out).to(t.dtype)


def conv_via_toeplitz_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                          padding: str = "SAME") -> torch.Tensor:
    """Explicit Toeplitz gather, then one GEMM: (…, H, W, Cin) →
    (…, O1, O2, Cout)."""
    k1, k2, _, c_out = (int(d) for d in w.shape)
    h, w_ = int(x.shape[-3]), int(x.shape[-2])
    o1, o2 = conv_geometry(h, w_, k1, k2, stride, padding)[:2]
    t = toeplitz_ref(x, k1, k2, stride, padding)
    out = t.to(torch.float32) @ w.reshape(-1, c_out).to(torch.float32)
    return out.reshape(*x.shape[:-3], o1, o2, c_out).to(x.dtype)
