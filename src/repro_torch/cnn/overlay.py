"""The DYNAMAP Computing Unit overlay — single entry point for every conv.

``apply_conv`` takes the plan's per-layer ``(algo, dataflow, p1, p2)`` and
routes the convolution to the hand-written kernels (``kernels/conv_im2col``
and ``kernels/gemm``) or to the plain torch oracles. The backend names
are the reference's: "pallas" is the Hopper kernel, "reference" the plain
per-algorithm torch oracle, "lax" the vendor convolution (``F.conv2d``,
cuDNN on the card). ``use_pallas=None`` (the default) follows the device:
CUDA tensors take the kernels, CPU tensors their plain versions; asking
for the kernels on CPU tensors raises.

Layout semantics (§3.3, Table 2): ``in_layout``/``out_layout`` carry the
plan's store formats. A matched Toeplitz ``in_layout`` means ``x`` arrives
as the layer's own Toeplitz matrix; a non-NHWC ``out_layout`` makes the
call emit its consumer's store format. Backends that cannot consume a
layout directly restore to NHWC first, so every (backend, layout) pair
computes the same function. Every path accepts one sample or a batch.

This slice ports the im2col algorithm: kn2row and Winograd layers, and
int8 layers on the kernel path, raise ``NotImplementedError`` — a layer
never falls back to another algorithm.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.algorithms import Algorithm, AlgoFamily
from repro_torch.core.cost_model import Dataflow
from repro_torch.core.layouts import LayoutSpec, is_nhwc
from repro_torch.kernels.common import (PRECISIONS, apply_epilogue,
                                        dequantize, quantize, requantize,
                                        weight_scales)
from repro_torch.kernels.conv_im2col.ops import conv_im2col
from repro_torch.kernels.conv_im2col.ref import (conv_from_toeplitz_ref,
                                                 conv_ref,
                                                 conv_via_toeplitz_ref)
from repro_torch.kernels.layouts import materialize, restore


def apply_conv(x: torch.Tensor, w: torch.Tensor, algo: Algorithm,
               dataflow: Dataflow = Dataflow.NS,
               p1: int = 128, p2: int = 128, *,
               stride: int = 1, padding: str = "SAME",
               use_pallas: Optional[bool] = None,
               backend: Optional[str] = None,
               epilogue: str = "none",
               bias: Optional[torch.Tensor] = None,
               in_layout: Optional[LayoutSpec] = None,
               out_layout: Optional[LayoutSpec] = None,
               precision: str = "bf16",
               in_scale: Optional[float] = None,
               out_scale: Optional[float] = None,
               in_quantized: bool = False) -> torch.Tensor:
    """Run one conv layer on the overlay under a plan binding.

    x: the layer input in ``in_layout`` (default NHWC): (H, W, Cin) /
    (B, H, W, Cin) or a Toeplitz matrix (O1O2, K1K2·Cin) / (B, …);
    w: (K1, K2, Cin, Cout). ``dataflow``/(p1, p2) select the Eq. 9 block
    binding — the kernel's tile, never the math.

    ``backend`` (when given) overrides ``use_pallas``. ``epilogue``
    ("none" | "relu" | "bias" | "bias_relu") is fused into the kernel's
    flush and applied post-hoc on the plain paths, so every backend
    computes the same function.

    ``precision="int8"`` runs the reference's fake-quant emulation
    (quantized-then-dequantized f32 operands) on the "reference" and
    "lax" backends; the int8 kernels are not ported yet."""
    in_layout = None if is_nhwc(in_layout) else in_layout
    out_layout = None if is_nhwc(out_layout) else out_layout
    if backend is not None and backend not in ("lax", "pallas", "reference"):
        raise ValueError(f"unknown backend {backend!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; want {PRECISIONS}")
    if algo.family is not AlgoFamily.IM2COL and backend != "lax":
        raise NotImplementedError(
            f"{algo.key} is not ported yet; only im2col layers run")
    if backend is not None:
        use_pallas = backend == "pallas"
    if precision == "int8" and use_pallas is not False:
        raise NotImplementedError(
            "int8 kernels are not ported yet; int8 layers run only on the "
            "'reference' and 'lax' backends")
    if use_pallas and x.device.type != "cuda":
        raise ValueError("the Hopper kernels take CUDA tensors; got "
                         f"{x.device} (use backend='reference' on the CPU)")
    post_requant = None
    if precision == "int8":
        if in_scale is None:
            raise ValueError("int8 precision needs a calibrated in_scale")
        # Fake-quant emulation: dequantized f32 operands carry the
        # identical quantization error as the true int8 path.
        if in_quantized:
            x = dequantize(x, in_scale)
        else:
            if in_layout is not None and in_layout.kind != "toeplitz":
                x, in_layout = restore(x, in_layout), None
            x = dequantize(quantize(x, in_scale), in_scale)
        w_scale = weight_scales(w)
        w = dequantize(quantize(w, w_scale), w_scale)
        post_requant = out_scale
    if backend == "lax":
        y = apply_epilogue(conv_ref(restore(x, in_layout), w, stride=stride,
                                    padding=padding), epilogue, bias)
    elif use_pallas is not False:
        return conv_im2col(x, w, stride=stride, padding=padding,
                           dataflow=dataflow, p1=p1, p2=p2,
                           epilogue=epilogue, bias=bias,
                           in_layout=in_layout, out_layout=out_layout)
    elif in_layout is not None and in_layout.kind == "toeplitz":
        y = apply_epilogue(
            conv_from_toeplitz_ref(x, w, in_layout.o1, in_layout.o2),
            epilogue, bias)
    else:
        y = apply_epilogue(
            conv_via_toeplitz_ref(restore(x, in_layout), w, stride=stride,
                                  padding=padding), epilogue, bias)
    y = materialize(y, out_layout)
    return requantize(y, post_requant) if post_requant else y
