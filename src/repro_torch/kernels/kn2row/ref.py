"""Torch oracle for kn2row (Eq. 3 + Eq. 4), independent of ``F.conv2d``."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import pad_nhwc
from repro_torch.kernels.conv_im2col.ref import conv_geometry


def kn2row_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               padding: str = "SAME") -> torch.Tensor:
    """x: (H, W, Cin) or (B, H, W, Cin); w: (K1, K2, Cin, Cout) →
    (…, O1, O2, Cout). Per kernel offset, the unit conv of the padded map
    (Eq. 3), its strided shifted slice, summed over the offsets (Eq. 4).
    SAME pads (ph // 2) before and the rest after, as the reference."""
    h, w_dim = int(x.shape[-3]), int(x.shape[-2])
    k1, k2, _, c_out = (int(d) for d in w.shape)
    o1, o2, pt, _, pl, _ = conv_geometry(h, w_dim, k1, k2, stride, padding)
    w32 = w.to(torch.float32)
    xp = pad_nhwc(x.to(torch.float32), pt, k1, pl, k2)
    acc = torch.zeros((*x.shape[:-3], o1, o2, c_out), dtype=torch.float32,
                      device=x.device)
    for dk1 in range(k1):
        for dk2 in range(k2):
            p = xp @ w32[dk1, dk2]                      # (…, Hp, Wp, Cout)
            acc = acc + p[..., dk1:dk1 + (o1 - 1) * stride + 1:stride,
                          dk2:dk2 + (o2 - 1) * stride + 1:stride, :]
    return acc.to(x.dtype)
