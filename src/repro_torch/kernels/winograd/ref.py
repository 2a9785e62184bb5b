"""Torch oracles for Winograd F(m,r) — a direct transcription of Eq. 5/6,
one image or a batch."""
from __future__ import annotations

import torch

from repro_torch.kernels.winograd.winograd import (pad_for_tiles,
                                                   torch_matrices)


def winograd_from_tiles_ref(tiles: torch.Tensor, w: torch.Tensor, m: int,
                            tiles_y: int, tiles_x: int, o1: int,
                            o2: int) -> torch.Tensor:
    """Eq. 5/6 on pre-gathered scattered-layout tiles (matched load, §3.3):
    tiles (…, tiles_y·tiles_x, T, T, Cin) spatial values, w (r, r, Cin,
    Cout) → (…, o1, o2, Cout). The transforms run unchanged — only the
    spatial re-gather of the tile layout is skipped."""
    r = w.shape[0]
    bt, g_mat, at = torch_matrices(m, r, tiles.device)
    c_out = w.shape[-1]
    lead = tiles.shape[:-4]
    u = torch.einsum("ti,ijco,uj->tuco", g_mat, w.to(torch.float32), g_mat)
    d = tiles.to(torch.float32)                            # (…, n, t, t, c)
    v = torch.einsum("ti,...nijc,uj->...tunc", bt, d, bt)
    mm = torch.einsum("...tunc,tuco->...tuno", v, u)
    y = torch.einsum("at,...tuno,bu->...nabo", at, mm, at)  # (…, n, m, m, co)
    y = y.reshape(*lead, tiles_y, tiles_x, m, m, c_out)
    y = y.transpose(-4, -3).reshape(*lead, tiles_y * m, tiles_x * m, c_out)
    return y[..., :o1, :o2, :].to(tiles.dtype)


def winograd_ref(x: torch.Tensor, w: torch.Tensor, m: int = 2,
                 padding: str = "SAME") -> torch.Tensor:
    """x: (H, W, Cin) or (B, H, W, Cin); w: (r, r, Cin, Cout), stride 1.

    Y = Aᵀ [ (G g Gᵀ) ⊙ (Bᵀ d B) ] A, reduced over C_in in transform space
    (the amortization noted under Eq. 5), tiles concatenated back."""
    r = w.shape[0]
    if w.shape[0] != w.shape[1]:
        raise ValueError("the Winograd oracle needs square kernels")
    t = m + r - 1
    h, w_dim = x.shape[-3], x.shape[-2]
    if padding == "SAME":
        o1, o2, pt, pl = h, w_dim, (r - 1) // 2, (r - 1) // 2
    else:
        o1, o2, pt, pl = h - r + 1, w_dim - r + 1, 0, 0
    ty, tx = -(-o1 // m), -(-o2 // m)
    xp = pad_for_tiles(x.to(torch.float32), m=m, r=r, tiles_y=ty,
                       tiles_x=tx, pad_top=pt, pad_left=pl)
    # (…, ty, tx, C, t, t) → (…, ty·tx, t, t, C)
    d = xp.unfold(-3, t, m).unfold(-3, t, m)[..., :ty, :tx, :, :, :]
    d = d.movedim(-3, -1).reshape(*x.shape[:-3], ty * tx, t, t, x.shape[-1])
    return winograd_from_tiles_ref(d, w, m, ty, tx, o1, o2).to(x.dtype)
