"""Public wrapper: full kn2row convolution = unit-conv GEMMs + pad-and-
accumulate (the hand-written kernels).

The unit-conv GEMM is (B·H·W, Cin) × (K1K2, Cin, Cout); the plan's
dataflow binds (p1, p2) onto its (bm, bn) block dims via Eq. 9 — kn2row is
the one algorithm whose GEMM shape matches the binding with no
translation. Accepts (H, W, Cin) or batched (B, H, W, Cin) inputs. The
weights are shared by every image, so the batch folds into M: one launch
of each kernel per layer per forward (the reference maps the conv over
the batch).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.cost_model import Dataflow
from repro_torch.kernels.common import check_int8_depth, unbatched_rank
from repro_torch.kernels.conv_im2col.ref import conv_geometry
from repro_torch.kernels.gemm.ops import dataflow_blocks
from repro_torch.kernels.kn2row.kn2row import (pad_accumulate_call,
                                               unit_conv_gemms_call)
from repro_torch.kernels.layouts import materialize, restore


def conv_kn2row(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: str = "SAME",
                dataflow: Dataflow = Dataflow.NS,
                p1: int = 128, p2: int = 128,
                epilogue: str = "none",
                bias: Optional[torch.Tensor] = None,
                in_layout=None, out_layout=None,
                scale: Optional[torch.Tensor] = None,
                out_scale: Optional[float] = None) -> torch.Tensor:
    """Convolution via kn2row. x: (H, W, Cin) or (B, H, W, Cin), w: (K1,
    K2, Cin, Cout) → (…, O1, O2, Cout). ``epilogue`` fuses into the final
    pad-and-accumulate.

    bf16 ``x``, ``w`` and ``bias``: phase 1 rounds each offset's f32
    product once to bf16 (p), phase 2 sums p in f32 and rounds the output
    once after the epilogue, where the reference's kernels round.

    int8 ``x`` and ``w``: phase 1 writes exact int32 partials, phase 2
    sums them in int32 and dequantizes by ``scale`` (Cout,) before the
    epilogue; ``out_scale`` requantizes the output to int8.

    kn2row's input layout IS the 3-D tensor (§3.3), so a matched
    ``in_layout`` is simply NHWC; other layouts are restored on entry
    (converting load), and ``out_layout`` emits a consumer's store
    format."""
    single = x.ndim == unbatched_rank(in_layout)
    x = restore(x, in_layout)
    xb = (x[None] if single else x).contiguous()
    batch, h, w_dim, c_in = (int(d) for d in xb.shape)
    k1, k2, _, c_out = (int(d) for d in w.shape)
    o1, o2, pt, _, pl, _ = conv_geometry(h, w_dim, k1, k2, stride, padding)
    if xb.dtype == torch.int8:
        check_int8_depth("conv_kn2row", k1 * k2 * c_in)   # the summed depth

    # Phase 1: (B·H·W, Cin) @ (K1K2, Cin, Cout) under the plan's binding.
    bm, bn, _ = dataflow_blocks(dataflow, p1, p2)
    p = unit_conv_gemms_call(xb.reshape(batch * h * w_dim, c_in),
                             w.reshape(k1 * k2, c_in, c_out).contiguous(),
                             bm=bm, bn=bn)
    # Phase 2: shift and accumulate, the map's edge as a predicate.
    out = pad_accumulate_call(p.view(k1 * k2, batch, h, w_dim, c_out),
                              k1=k1, k2=k2, o1=o1, o2=o2,
                              stride=stride, pad_top=pt, pad_left=pl,
                              epilogue=epilogue, bias=bias, scale=scale,
                              out_scale=out_scale)
    return materialize(out[0] if single else out, out_layout)
