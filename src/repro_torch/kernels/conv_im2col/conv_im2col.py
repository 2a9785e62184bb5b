"""im2col convolution as a hand-written *implicit-GEMM* Hopper kernel
(``csrc/conv_im2col.cu``), with its plain torch version beside it.

The paper's im2col (§2.1.1) stretches input windows into a Toeplitz matrix
and runs one GEMM (Eq. 2). The kernel never stores that matrix: each K
chunk of it is gathered from the NHWC input straight into shared memory,
so device memory sees the input map, the weights and the output once.
M = B·O1·O2 output pixels, N = Cout, K = K1·K2·Cin. SAME padding (XLA's
asymmetric split) and the window overhang are predicates in the kernel.

f32 operands run ``conv_im2col_f32`` on the f32 GEMMs' ``cp.async`` loop
(``csrc/tile_gemm_async.cuh``), which splits K on a grid smaller than the
card as the f32 GEMM does (``split_k``, a workspace of partials summed in
a fixed order), so a shape gives the same bits on every call.

An int8 map and int8 weights run ``conv_im2col_i8`` on the int8 GEMMs'
tensor-core loop (``csrc/tile_mma_i8.cuh``): exact int32 sums, then
dequant (· ``scale``) → bias → ReLU → optional requant at ``out_scale``.
Its entry point picks the A path by ``I8_GATHER_RULE``
(``conv_i8_vector_path``, mirrored here): Cin a multiple of 16, Cout a
multiple of 4 and x and w aligned take 16-byte ``cp.async`` copies of one
tap's channels; any other operand (Cin 3 at Inception-v4's stem/c1,
reduced widths, offset views) takes the byte path, which gathers A a byte
at a time through registers.

A bf16 map and bf16 weights (and bias) run ``conv_im2col_bf16`` on the
bf16 GEMM's tensor-core loop (``csrc/tile_mma_bf16.cuh``): f32 sums, bias
and ReLU in f32, one round-to-nearest-even store of the bf16 output, as
the reference's kernel flushes its f32 accumulator. Its A path follows
``BF16_GATHER_RULE``: Cin a multiple of 8 (one tap's channels in 16-byte
copies), else the element path (Cin 3 at GoogleNet's stem). Any other
operand dtype raises ``TypeError`` (``KERNEL_DTYPES``).

``conv_im2col_call`` launches the kernel for CUDA tensors and runs
``conv_plain`` / ``conv_i8_plain`` for CPU tensors; nothing else selects
between the two.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import (apply_epilogue, check_int8_depth,
                                        check_kernel_dtype, int8_product)
from repro_torch.kernels.conv_im2col.ref import (conv_geometry,
                                                 conv_via_toeplitz_ref,
                                                 toeplitz_ref)
from repro_torch.kernels.gemm.gemm import (_MAX_GRID_Y, b_vector_path,
                                          check_epilogue, check_operand,
                                          check_quant_args, grid_splits,
                                          kernel_tile, sm_count,
                                          split_workspace)

CONV = CudaKernel("conv_im2col", "conv_im2col_f32",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 17
                  + [ctypes.c_void_p])
CONV_I8 = CudaKernel("conv_im2col", "conv_im2col_i8",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16
                     + [ctypes.c_float, ctypes.c_void_p])
CONV_BF16 = CudaKernel("conv_im2col", "conv_im2col_bf16",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p])

# csrc/conv_im2col.cu::conv_i8_vector_path: conv_im2col_i8 copies A in 16
# bytes when c_in and c_out are multiples of these and x and w are aligned
# to these bytes; else it gathers A a byte at a time.
I8_GATHER_RULE = {"c_in": 16, "c_out": 4, "x": 16, "w": 4}
# csrc/conv_im2col.cu::conv_bf16_vector_path, the same for conv_im2col_bf16
# (else it gathers A an element at a time).
BF16_GATHER_RULE = {"c_in": 8, "c_out": 2, "x": 16, "w": 4}


def conv_i8_vector_path(c_in: int, c_out: int, x_ptr: int,
                        w_ptr: int, rule=I8_GATHER_RULE) -> bool:
    """Whether ``conv_im2col_i8`` takes its 16-byte gather path for a map
    of ``c_in`` channels at address ``x_ptr`` and weights of ``c_out``
    channels at ``w_ptr`` (the entry point decides; this mirrors it)."""
    sizes = {"c_in": c_in, "c_out": c_out, "x": x_ptr, "w": w_ptr}
    return all(sizes[key] % d == 0 for key, d in rule.items())


def conv_bf16_vector_path(c_in: int, c_out: int, x_ptr: int,
                          w_ptr: int) -> bool:
    """Whether ``conv_im2col_bf16`` takes its 16-byte gather path (else
    its element path), as ``conv_i8_vector_path`` says for int8."""
    return conv_i8_vector_path(c_in, c_out, x_ptr, w_ptr, BF16_GATHER_RULE)


def conv_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               padding: str = "SAME", epilogue: str = "none",
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain torch: an explicit Toeplitz gather,
    then ``@`` and the epilogue. x (B, H, W, Cin), w (K1, K2, Cin, Cout)
    → (B, O1, O2, Cout). A bf16 conv is computed in f32 and its epilogue's
    result rounded once to bf16, as the kernel rounds."""
    check_epilogue(epilogue, bias)
    if x.dtype == torch.bfloat16:
        y = conv_via_toeplitz_ref(x.to(torch.float32), w.to(torch.float32),
                                  stride, padding)
        return apply_epilogue(y, epilogue, bias).to(torch.bfloat16)
    return apply_epilogue(conv_via_toeplitz_ref(x, w, stride, padding),
                          epilogue, bias)


def conv_i8_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                  padding: str = "SAME", epilogue: str = "none",
                  bias: Optional[torch.Tensor] = None,
                  scale: torch.Tensor,
                  out_scale: Optional[float] = None) -> torch.Tensor:
    """The int8 kernel's function in plain torch: the explicit Toeplitz
    gather of the int8 map, its exact int32 product with the int8
    weights, then dequant · ``scale`` (Cout,), the epilogue and, with
    ``out_scale``, the requant to int8."""
    check_epilogue(epilogue, bias)
    k1, k2, _, c_out = (int(d) for d in w.shape)
    check_int8_depth("conv_im2col", k1 * k2 * int(w.shape[2]))
    h, w_in = int(x.shape[-3]), int(x.shape[-2])
    o1, o2 = conv_geometry(h, w_in, k1, k2, stride, padding)[:2]
    acc = int8_product(toeplitz_ref(x, k1, k2, stride, padding),
                       w.reshape(-1, c_out))
    return apply_epilogue(acc.reshape(*x.shape[:-3], o1, o2, c_out),
                          epilogue, bias, scale=scale, out_scale=out_scale)


def conv_im2col_call(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                     padding: str = "SAME", bm: int = 128, bn: int = 128,
                     epilogue: str = "none",
                     bias: Optional[torch.Tensor] = None,
                     scale: Optional[torch.Tensor] = None,
                     out_scale: Optional[float] = None) -> torch.Tensor:
    """out (B, O1, O2, Cout) = epilogue(conv(x (B, H, W, Cin), w
    (K1, K2, Cin, Cout)) [+ bias (Cout,)]).

    f32 operands run ``conv_im2col_f32``, with K = K1·K2·Cin split
    ``split_k`` ways on a grid smaller than the card. bf16 ``x``, ``w``
    and bias run ``conv_im2col_bf16`` on the tensor cores (a bf16 output,
    rounded once). int8 ``x`` and ``w``
    run ``conv_im2col_i8`` on the int8 tensor cores, A by 16-byte copies
    where ``conv_i8_vector_path`` holds and a byte at a time elsewhere: the
    exact int32 sum is dequantized by ``scale`` (Cout,) before the
    epilogue, and ``out_scale`` requantizes the output to int8 (else it is
    f32).

    CUDA tensors launch the kernel on the current stream under the tile
    ``kernel_tile(bm, bn, B·O1·O2, Cout)``; CPU tensors run
    ``conv_plain`` / ``conv_i8_plain``. Any other dtype raises
    ``TypeError``."""
    check_kernel_dtype("conv_im2col", x)
    quant = check_quant_args("conv_im2col", x, scale, out_scale)
    if x.device.type == "cpu":
        if quant:
            return conv_i8_plain(x, w, stride=stride, padding=padding,
                                 epilogue=epilogue, bias=bias, scale=scale,
                                 out_scale=out_scale)
        return conv_plain(x, w, stride=stride, padding=padding,
                          epilogue=epilogue, bias=bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv_im2col: unsupported device {x.device}")
    relu = check_epilogue(epilogue, bias)
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"conv_im2col wants x (B, H, W, Cin) and w "
                         f"(K1, K2, Cin, Cout), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    batch, h, w_in, c_in = (int(d) for d in x.shape)
    k1, k2, _, c_out = (int(d) for d in w.shape)
    check_operand("x", x, x.device, (batch, h, w_in, c_in), x.dtype)
    check_operand("w", w, x.device, (k1, k2, c_in, c_out), x.dtype)
    if bias is not None and not epilogue.startswith("bias"):
        bias = None
    bf16 = x.dtype == torch.bfloat16
    if bias is not None:
        check_operand("bias", bias, x.device, (c_out,),
                      torch.bfloat16 if bf16 else torch.float32)
    if stride < 1:
        raise ValueError(f"conv_im2col: bad stride {stride}")
    o1, o2, pad_top, _, pad_left, _ = conv_geometry(h, w_in, k1, k2, stride,
                                                    padding)
    if min(batch, o1, o2, c_out) < 1:
        raise ValueError(f"conv_im2col: empty output {(batch, o1, o2, c_out)}")
    m = batch * o1 * o2
    if max(x.numel(), m * c_out) >= 2 ** 31:
        raise ValueError("conv_im2col: tensor too large for 32-bit indices")
    tile_m, tile_n = kernel_tile(bm, bn, m, c_out)
    if -(-m // tile_m) > _MAX_GRID_Y:
        raise ValueError(f"conv_im2col: M={m} exceeds the launch grid")
    geom = (batch, h, w_in, c_in, k1, k2, stride, pad_top, pad_left, o1, o2,
            c_out, tile_m, tile_n, int(relu))
    bias_ptr = None if bias is None else bias.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if quant:
        check_int8_depth("conv_im2col", k1 * k2 * c_in)
        check_operand("scale", scale, x.device, (c_out,))
        out = torch.empty((batch, o1, o2, c_out), device=x.device,
                          dtype=torch.float32 if out_scale is None
                          else torch.int8)
        with torch.cuda.device(x.device):
            CONV_I8.launch(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                           bias_ptr, out.data_ptr(), *geom,
                           int(out_scale is not None),
                           float(out_scale or 0.0), stream)
        return out
    if bf16:
        out = torch.empty((batch, o1, o2, c_out), device=x.device,
                          dtype=torch.bfloat16)
        with torch.cuda.device(x.device):
            CONV_BF16.launch(x.data_ptr(), w.data_ptr(), bias_ptr,
                             out.data_ptr(), *geom, stream)
        return out
    out = torch.empty((batch, o1, o2, c_out), device=x.device,
                      dtype=torch.float32)
    k = k1 * k2 * c_in
    splits = grid_splits(m, c_out, k, (tile_m, tile_n), sm_count(x.device))
    work = split_workspace(splits, m, c_out, x.device)
    with torch.cuda.device(x.device):
        CONV.launch(x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(),
                    None if work is None else work.data_ptr(), *geom, splits,
                    b_vector_path(w, c_out), stream)
    return out
