"""Public wrapper for the implicit-GEMM im2col convolution.

The induced GEMM is (B·O1·O2, K1K2·Cin) × (K1K2·Cin, Cout); the plan's
dataflow binds (p1, p2) onto two of those dims (Eq. 9), which picks the
kernel's output tile. Accepts (H, W, Cin) or batched (B, H, W, Cin)
inputs, or the layer's Toeplitz matrix when the plan stored it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.cost_model import Dataflow
from repro_torch.kernels.common import unbatched_rank
from repro_torch.kernels.conv_im2col.conv_im2col import conv_im2col_call
from repro_torch.kernels.gemm.ops import dataflow_blocks, toeplitz_gemm
from repro_torch.kernels.layouts import materialize, restore


def conv_im2col(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: str = "SAME",
                dataflow: Dataflow = Dataflow.NS,
                p1: int = 128, p2: int = 128,
                epilogue: str = "none",
                bias: Optional[torch.Tensor] = None,
                in_layout=None, out_layout=None,
                scale: Optional[torch.Tensor] = None,
                out_scale: Optional[float] = None) -> torch.Tensor:
    """Convolution via the im2col algorithm. x: (H, W, Cin) or
    (B, H, W, Cin), w: (K1, K2, Cin, Cout) → (…, O1, O2, Cout).
    ``epilogue`` fuses ReLU / bias into the kernel's output flush.

    ``in_layout``/``out_layout`` (``core.layouts.LayoutSpec``) realize the
    plan's store formats: a "toeplitz" ``in_layout`` means ``x`` IS the
    layer's Toeplitz matrix — the window gather was paid once at the
    producer's store, so the layer is a plain dataflow-bound GEMM; a
    non-NHWC ``out_layout`` emits the consumer's store format.

    int8 ``x`` (NHWC map or Toeplitz matrix) and ``w`` run the int8
    kernels: ``scale`` (Cout,) dequantizes the int32 sum before the
    epilogue and ``out_scale`` requantizes the output to int8."""
    if in_layout is not None and in_layout.kind == "toeplitz":
        out = toeplitz_gemm(x, w.reshape(-1, w.shape[-1]), in_layout,
                            dataflow, p1, p2, epilogue=epilogue, bias=bias,
                            scale=scale, out_scale=out_scale)
        return materialize(out, out_layout)
    single = x.ndim == unbatched_rank(in_layout)
    x = restore(x, in_layout)
    xb = (x[None] if single else x).contiguous()
    bm, bn, _ = dataflow_blocks(dataflow, p1, p2)
    out = conv_im2col_call(xb, w.contiguous(), stride=stride,
                           padding=padding, bm=bm, bn=bn,
                           epilogue=epilogue, bias=bias, scale=scale,
                           out_scale=out_scale)
    return materialize(out[0] if single else out, out_layout)
