"""The DYNAMAP Computing Unit overlay — single entry point for every conv.

``apply_conv`` takes the plan's per-layer ``(algo, dataflow, p1, p2)`` and
routes the convolution to the hand-written kernels (``kernels/conv_im2col``,
``kernels/gemm``, ``kernels/kn2row`` and ``kernels/winograd``) or to the
plain torch oracles.
The backend names are the reference's: "pallas" is the Hopper kernel,
"reference" the plain per-algorithm torch oracle, "lax" the vendor
convolution (``F.conv2d``, cuDNN on the card). ``use_pallas=None`` (the
default) follows the device: CUDA tensors take the kernels, CPU tensors
their plain versions; asking for the kernels on CPU tensors raises.

Layout semantics (§3.3, Table 2): ``in_layout``/``out_layout`` carry the
plan's store formats. A matched Toeplitz or Winograd-tile ``in_layout``
means ``x`` arrives as the layer's own Toeplitz matrix or input tiles; a
non-NHWC ``out_layout`` makes the call emit its consumer's store format.
Backends that cannot consume a layout directly restore to NHWC first, so
every (backend, layout) pair computes the same function. Every path
accepts one sample or a batch.

All three algorithms are ported, and im2col and kn2row in int8 too: an
int8 layer on the kernel path quantizes its operands and runs the int8
kernels (their plain versions for CPU tensors), the plain backends
emulate it with fake-quantized f32 operands — a layer never falls back
to another algorithm. Winograd rejects int8, as the reference does.

A bf16 model (``init_params(dtype=bf16)``) follows the reference's dtype
rule, which is its type promotion. A layer with bf16 ``x`` and ``w`` runs
the bf16 kernels of its algorithm (im2col, kn2row, Winograd), whose f32
sums round once per kernel where the reference's do, and emits bf16. An
int8 layer quantizes its bf16 (or f32) input as it is and emits f32, or
int8 under ``out_scale``, with its bias widened to f32 for the int8
flush. So in a gated plan every layer downstream of an int8 one
receives f32: such a layer widens its bf16 weights and bias to f32
(exactly), runs the f32 kernels and emits f32, as the reference's
promotion of f32 x with bf16 w computes. Any other operand pair (bf16 x
with f32 w) raises ``TypeError``. The plain backends follow the same
rule.

Tests that monkeypatch ``apply_conv`` with a plain NHWC oracle wrap it
with ``nhwc_conv`` so it honors the layout contract.
"""
from __future__ import annotations

import functools
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
from repro_torch.kernels.kn2row.ops import conv_kn2row
from repro_torch.kernels.kn2row.ref import kn2row_ref
from repro_torch.kernels.layouts import materialize, restore
from repro_torch.kernels.winograd.ops import conv_winograd
from repro_torch.kernels.winograd.ref import (winograd_from_tiles_ref,
                                              winograd_ref)


def nhwc_conv(fn):
    """Adapt a plain NHWC conv ``fn(x, w, ...)`` to the overlay's
    layout-carrying call contract: restore a non-NHWC input, materialize a
    requested output format. Reference executors (and tests that
    monkeypatch ``apply_conv`` with an oracle) wrap with this so a
    layout-aware compiled plan can still be replayed against them."""
    @functools.wraps(fn)
    def wrapper(x, w, *args, in_layout=None, out_layout=None, **kw):
        y = fn(restore(x, in_layout), w, *args, **kw)
        return materialize(y, out_layout)
    return wrapper


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

    ``precision="int8"`` (im2col and kn2row) quantizes the weights per
    output channel and the input per tensor at the calibrated ``in_scale``
    (skipped when ``in_quantized`` says the producer already emitted int8
    at this scale — the fused precision edge), and runs the true int8
    path: int32 sums, dequant · in_scale·w_scale, bias, ReLU and, with
    ``out_scale``, the requant to int8, all in the kernel's flush. The
    "reference" and "lax" backends run the reference's fake-quant
    emulation instead (quantized-then-dequantized f32 operands: the same
    quantization error)."""
    in_layout = None if is_nhwc(in_layout) else in_layout
    out_layout = None if is_nhwc(out_layout) else out_layout
    if backend is not None and backend not in ("lax", "pallas", "reference"):
        raise ValueError(f"unknown backend {backend!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; want {PRECISIONS}")
    if precision == "int8" and algo.family is AlgoFamily.WINOGRAD:
        raise ValueError("Winograd is bf16-only: its input/output "
                         "transforms amplify quantization error")
    if backend is not None:
        use_pallas = backend == "pallas"
    if use_pallas and x.device.type != "cuda":
        raise ValueError("the Hopper kernels take CUDA tensors; got "
                         f"{x.device} (use backend='reference' on the CPU)")
    if torch.bfloat16 in (x.dtype, w.dtype):
        w, bias = _bf16_model_operands(x, w, bias, precision)
    quant_kw = {}
    post_requant = None
    if precision == "int8":
        if in_scale is None:
            raise ValueError("int8 precision needs a calibrated in_scale")
        w_scale = weight_scales(w)
        if use_pallas is not False:
            # True int8: NHWC and Toeplitz inputs hold raw activations, so
            # quantization commutes with the layout; anything else (a
            # Winograd store holding tiles) restores first.
            if not in_quantized:
                if in_layout is not None and in_layout.kind != "toeplitz":
                    x, in_layout = restore(x, in_layout), None
                x = quantize(x, in_scale)
            w = quantize(w, w_scale)
            quant_kw = dict(scale=in_scale * w_scale, out_scale=out_scale)
        else:
            # Fake-quant emulation: dequantized f32 operands carry the
            # identical quantization error as the true int8 path.
            if in_quantized:
                x = dequantize(x, in_scale)
            else:
                if in_layout is not None and in_layout.kind != "toeplitz":
                    x, in_layout = restore(x, in_layout), None
                x = dequantize(quantize(x, in_scale), in_scale)
            w = dequantize(quantize(w, w_scale), w_scale)
            post_requant = out_scale
    if backend == "lax":
        y = apply_epilogue(conv_ref(restore(x, in_layout), w, stride=stride,
                                    padding=padding), epilogue, bias)
    elif algo.family is AlgoFamily.WINOGRAD:
        return _winograd(x, w, algo, dataflow, p1, p2, stride=stride,
                         padding=padding, use_pallas=use_pallas,
                         epilogue=epilogue, bias=bias, in_layout=in_layout,
                         out_layout=out_layout)
    elif algo.family is AlgoFamily.KN2ROW:
        if use_pallas is not False:
            return conv_kn2row(x, w, stride=stride, padding=padding,
                               dataflow=dataflow, p1=p1, p2=p2,
                               epilogue=epilogue, bias=bias,
                               in_layout=in_layout, out_layout=out_layout,
                               **quant_kw)
        y = apply_epilogue(kn2row_ref(restore(x, in_layout), w,
                                      stride=stride, padding=padding),
                           epilogue, bias)
    elif use_pallas is not False:
        return conv_im2col(x, w, stride=stride, padding=padding,
                           dataflow=dataflow, p1=p1, p2=p2,
                           epilogue=epilogue, bias=bias,
                           in_layout=in_layout, out_layout=out_layout,
                           **quant_kw)
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


def _bf16_model_operands(x: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor], precision: str):
    """``(w, bias)`` as a layer of a bf16 model runs them (the
    reference's dtype rule, its type promotion): unchanged for bf16 ``x``
    and ``w`` at bf16 precision (the bf16 kernels); widened to f32, which
    is exact, for f32 ``x`` (the f32 kernels, f32 out) and for an int8
    layer, whose input (bf16, f32 or its producer's int8) is quantized as
    it is and whose flush adds an f32 bias. Any other pair raises
    ``TypeError``."""
    if w.dtype == torch.bfloat16:
        if precision != "int8" and x.dtype == torch.bfloat16:
            return w, bias
        if x.dtype == torch.float32 or (
                precision == "int8" and x.dtype in (torch.bfloat16,
                                                    torch.int8)):
            return w.float(), None if bias is None else bias.float()
    raise TypeError(f"{precision} conv with x of {x.dtype} and w of "
                    f"{w.dtype}: a bf16 model's layer takes bf16 or f32 x "
                    "with bf16 w")


def _winograd(x: torch.Tensor, w: torch.Tensor, algo: Algorithm,
              dataflow: Dataflow, p1: int, p2: int, *, stride: int,
              padding: str, use_pallas: Optional[bool], epilogue: str,
              bias: Optional[torch.Tensor],
              in_layout: Optional[LayoutSpec],
              out_layout: Optional[LayoutSpec]) -> torch.Tensor:
    """The WINOGRAD branch: stride-1 square kernels only (``menu_for``
    never assigns Winograd to anything else). The kernel path runs
    ``conv_winograd``; the plain path runs the oracles, on the matched
    tile layout directly, and K > r through ``conv_winograd``'s plain
    stages (the oracle is single-round only)."""
    if stride != 1 or w.shape[0] != w.shape[1]:
        raise ValueError(f"{algo.key} needs a stride-1 square kernel, got "
                         f"stride {stride} and {tuple(w.shape[:2])}")
    if use_pallas is not False:
        return conv_winograd(x, w, m=algo.m, padding=padding,
                             dataflow=dataflow, p1=p1, p2=p2,
                             epilogue=epilogue, bias=bias,
                             in_layout=in_layout, out_layout=out_layout)
    if in_layout is not None and in_layout.kind == "winograd" \
            and in_layout.m == algo.m and w.shape[0] == in_layout.r:
        spec = in_layout
        y = winograd_from_tiles_ref(x, w, algo.m, spec.tiles_y,
                                    spec.tiles_x, spec.o1, spec.o2)
        return materialize(apply_epilogue(y, epilogue, bias), out_layout)
    x = restore(x, in_layout)
    if w.shape[0] == 3:
        y = apply_epilogue(winograd_ref(x, w, m=algo.m, padding=padding),
                           epilogue, bias)
        return materialize(y, out_layout)
    return conv_winograd(x, w, m=algo.m, padding=padding, dataflow=dataflow,
                         p1=p1, p2=p2, epilogue=epilogue, bias=bias,
                         out_layout=out_layout, plain=True)
