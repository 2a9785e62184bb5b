"""Public Winograd conv: transforms + batched GEMM (the hand-written
kernels), with the multi-round decomposition for kernels larger than r×r.

The transform-space Hadamard products are (n, Cin) × (Cin, Cout) GEMMs
batched over the (m+r-1)² tile positions; the plan's dataflow/(p1, p2)
binding is forwarded to that batched GEMM's block dims (Eq. 9). Accepts
(H, W, Cin) or batched (B, H, W, Cin) inputs. The weight transform U is
shared by every image, so the batch folds into the tile dim: one V of
(T², B·tiles, Cin), one batched GEMM and one output transform per layer
per forward (the reference maps the conv over the batch).

bf16 operands round where the reference's pipeline rounds: V in the input
transform's store, U (computed in f32) once to the activation dtype, M in
the batched GEMM's flush (f32 sums), the output once after the epilogue;
the K > r rounds accumulate in the activation dtype, each ``acc + part``
rounded once, and the epilogue follows the sum.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.cost_model import Dataflow
from repro_torch.kernels.common import apply_epilogue, pad_nhwc
from repro_torch.kernels.gemm.gemm import batched_gemm_plain
from repro_torch.kernels.gemm.ops import batched_gemm
from repro_torch.kernels.layouts import materialize, restore
from repro_torch.kernels.winograd.winograd import (
    input_transform_call, input_transform_plain, input_transform_tiles_call,
    output_transform_call, output_transform_plain, transform_kernel_weights)


def _gemm(v: torch.Tensor, u: torch.Tensor, dataflow: Dataflow, p1: int,
          p2: int, plain: bool) -> torch.Tensor:
    return (batched_gemm_plain(v, u) if plain
            else batched_gemm(v, u, dataflow, p1, p2))


def _conv_f_mr(x: torch.Tensor, w: torch.Tensor, m: int, o1: int, o2: int,
               pt: int, pl: int, dataflow: Dataflow, p1: int, p2: int,
               epilogue: str = "none",
               bias: Optional[torch.Tensor] = None,
               plain: bool = False) -> torch.Tensor:
    """Single-round F(m,r) stride-1 conv core; x unpadded (B, H, W, Cin),
    read with (pt, pl) of zero halo → (B, o1, o2, Cout). The epilogue
    fuses into the output transform — the last kernel of the pipeline.
    ``plain`` runs every stage's plain version whatever the device."""
    r = w.shape[0]
    ty, tx = -(-o1 // m), -(-o2 // m)
    transform = input_transform_plain if plain else input_transform_call
    v = transform(x, m=m, r=r, tiles_y=ty, tiles_x=tx, pad_top=pt,
                  pad_left=pl)                          # (T², B·tiles, Cin)
    u = transform_kernel_weights(w, m, r).to(x.dtype)   # (T², Cin, Cout)
    mm = _gemm(v, u, dataflow, p1, p2, plain)           # (T², B·tiles, Cout)
    back = output_transform_plain if plain else output_transform_call
    return back(mm, m=m, r=r, tiles_y=ty, tiles_x=tx, o1=o1, o2=o2,
                epilogue=epilogue, bias=bias)


def _conv_from_tiles(tiles: torch.Tensor, w: torch.Tensor, m: int, spec,
                     dataflow: Dataflow, p1: int, p2: int, epilogue: str,
                     bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Matched scattered-layout consumer (§3.3): the producer stored this
    layer's (T, T) input tiles, (B, tiles, T, T, Cin), so the spatial
    re-gather is skipped and the pipeline is tile transform → batched GEMM
    → output transform. → (B, o1, o2, Cout)."""
    r = w.shape[0]
    flat = tiles.reshape(-1, *tiles.shape[-3:]).contiguous()
    v = input_transform_tiles_call(flat, m=m, r=r)
    u = transform_kernel_weights(w, m, r).to(tiles.dtype)
    mm = batched_gemm(v, u, dataflow, p1, p2)
    return output_transform_call(mm, m=m, r=r, tiles_y=spec.tiles_y,
                                 tiles_x=spec.tiles_x, o1=spec.o1, o2=spec.o2,
                                 epilogue=epilogue, bias=bias)


def conv_winograd(x: torch.Tensor, w: torch.Tensor, m: int = 2,
                  padding: str = "SAME",
                  dataflow: Dataflow = Dataflow.NS,
                  p1: int = 128, p2: int = 128,
                  epilogue: str = "none",
                  bias: Optional[torch.Tensor] = None,
                  in_layout=None, out_layout=None,
                  plain: bool = False) -> torch.Tensor:
    """Winograd convolution, stride 1, square K×K kernels.

    K > r runs in ceil(K/r)² rounds of shifted r×r sub-kernels with output
    accumulation (§6.1.2's K1K2/r² rounds). Single-round kernels fuse the
    epilogue into the output transform; the multi-round path applies it
    after the cross-round accumulation (ReLU does not distribute over +).

    A matching "winograd" ``in_layout`` (same m, single-round K == r) means
    ``x`` is already the scattered tile layout — the layer consumes it
    without the spatial re-gather; any other layout is restored on entry.
    A non-NHWC ``out_layout`` emits the consumer's store format.
    ``plain=True`` runs the kernels' plain versions on any device (the
    "reference" backend's route for K > r); it restores a matched layout
    and takes the NHWC route."""
    r = 3
    k1, k2, _, _ = w.shape
    if k1 != k2:
        raise ValueError(f"the Winograd path needs square kernels, got "
                         f"{k1}x{k2}")
    w = w.contiguous()
    if not plain and in_layout is not None and in_layout.kind == \
            "winograd" and in_layout.m == m and k1 == in_layout.r:
        single = x.ndim == in_layout.base_rank
        y = _conv_from_tiles(x, w, m, in_layout, dataflow, p1, p2,
                             epilogue, bias)
        return materialize(y[0] if single else y, out_layout)
    x = restore(x, in_layout)
    single = x.ndim == 3
    xb = (x[None] if single else x).contiguous()
    h, w_dim = xb.shape[1], xb.shape[2]
    if padding == "SAME":
        o1, o2 = h, w_dim
        pt, pl = (k1 - 1) // 2, (k2 - 1) // 2
    else:
        o1, o2 = h - k1 + 1, w_dim - k2 + 1
        pt = pl = 0
    if k1 == r:
        y = _conv_f_mr(xb, w, m, o1, o2, pt, pl, dataflow, p1, p2,
                       epilogue=epilogue, bias=bias, plain=plain)
        return materialize(y[0] if single else y, out_layout)

    # Multi-round: pad the kernel to a multiple of r and accumulate
    # shifted rounds: out[y, x] = Σ_{ry,rx} Σ_{i,j<r}
    # X[y+ry·r+i-pt, x+rx·r+j-pl]·W[ry·r+i, rx·r+j] = Σ_rounds F(m,r)-conv
    # of X shifted by (ry·r, rx·r) with the sub-kernel.
    rounds = -(-k1 // r)
    kp = rounds * r
    wp = F.pad(w, (0, 0, 0, 0, 0, kp - k2, 0, kp - k1))
    xbig = pad_nhwc(xb, pt, kp, pl, kp)
    acc = None
    for ry in range(rounds):
        for rx in range(rounds):
            sub = wp[ry * r:(ry + 1) * r, rx * r:(rx + 1) * r]
            # VALID conv of this window with ``sub`` gives exactly (o1, o2).
            xs = xbig[:, ry * r:ry * r + o1 + r - 1,
                      rx * r:rx * r + o2 + r - 1].contiguous()
            part = _conv_f_mr(xs, sub, m, o1, o2, 0, 0, dataflow, p1, p2,
                              plain=plain)
            acc = part if acc is None else acc + part
    y = apply_epilogue(acc, epilogue, bias)
    return materialize(y[0] if single else y, out_layout)
