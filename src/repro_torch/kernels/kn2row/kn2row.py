"""kn2row convolution kernels (§2.1.2) — hand-written Hopper kernels
(``csrc/kn2row.cu``), each with its plain torch version beside it.

Phase 1 ("unit-CONV GEMM", Eq. 3): each (k1, k2) kernel offset is a 1×1
convolution, a (B·H·W, Cin) × (Cin, Cout) GEMM. All K1K2 of them run as
one launch whose A operand (the flattened map) is the same for every
offset — the reference's X block index map that ignores the offset.

Phase 2 ("Pad-and-Accumulate", Eq. 4): each product p_{k1,k2} is shifted
by its offset and summed: z[y, x] = Σ p_{k1,k2}[S·y + k1 − pt,
S·x + k2 − pl]. The reference zero-pads p on the host first; the kernel
takes p unpadded, and rows or columns outside one image's map count as 0.
As the last kn2row stage it owns the fused bias/ReLU epilogue.

bf16 (the reference's bf16 path: its kernels are dtype-generic): phase
1 takes bf16 x2d and w, sums in f32 on the tensor cores and rounds p once
to bf16; phase 2 sums bf16 p in f32, applies the bf16 bias (widened) and
ReLU in f32 and rounds the output once to bf16.

Int8 (the reference's int8 path): phase 1 takes int8 x2d and w and
writes the exact int32 partials p; phase 2 sums them in int32 and flushes
dequant (· ``scale``) → bias → ReLU → optional requant at ``out_scale``.

``unit_conv_gemms_call`` and ``pad_accumulate_call`` launch the kernels
(f32, bf16 or int8 on the operands' dtype) for CUDA tensors and run
``unit_conv_gemms_plain`` / ``pad_accumulate_plain`` for CPU tensors;
nothing else selects between the two.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import (apply_epilogue, check_int8_depth,
                                        check_kernel_dtype, int8_product)
from repro_torch.kernels.gemm.gemm import (_MAX_GRID_Y, b_vector_path,
                                          check_epilogue, check_operand,
                                          check_quant_args, grid_splits,
                                          kernel_tile, sm_count,
                                          split_workspace)

UNIT_CONV_GEMMS = CudaKernel("kn2row", "unit_conv_gemms_f32",
                             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                             + [ctypes.c_void_p])
PAD_ACCUMULATE = CudaKernel("kn2row", "pad_accumulate_f32",
                            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13
                            + [ctypes.c_void_p])
UNIT_CONV_GEMMS_I8 = CudaKernel("kn2row", "unit_conv_gemms_i8",
                                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                                + [ctypes.c_void_p])
UNIT_CONV_GEMMS_BF16 = CudaKernel("kn2row", "unit_conv_gemms_bf16",
                                  [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                                  + [ctypes.c_void_p])
PAD_ACCUMULATE_BF16 = CudaKernel("kn2row", "pad_accumulate_bf16",
                                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13
                                 + [ctypes.c_void_p])
PAD_ACCUMULATE_I32 = CudaKernel("kn2row", "pad_accumulate_i32",
                                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                                + [ctypes.c_float, ctypes.c_int,
                                   ctypes.c_void_p])

_INDEX_LIMIT = 2 ** 31
# The (K1, K2) whose offsets the pad-and-accumulate kernels unroll
# (csrc/kn2row.cu, dispatch_offsets); any other runs their generic form.
UNROLLED_OFFSETS = ((3, 3), (1, 3), (3, 1), (1, 1))


# ---------------------------------------------------------------------------
# Phase 1 — unit-conv GEMMs, batched over kernel offsets.
# ---------------------------------------------------------------------------

def unit_conv_gemms_plain(x2d: torch.Tensor, w: torch.Tensor
                          ) -> torch.Tensor:
    """The kernel's function in plain torch: x2d (M, Cin) @ w (G, Cin,
    Cout), broadcast over G → p (G, M, Cout); for int8 operands the exact
    int32 sums; for bf16 ones the f32 product of the widened operands,
    rounded once to bf16 (as the kernel's f32 sums are)."""
    if x2d.dtype == torch.int8:
        check_int8_depth("unit_conv_gemms", int(x2d.shape[-1]))
        return int8_product(x2d, w)
    if x2d.dtype == torch.bfloat16:
        return (x2d.float() @ w.float()).to(torch.bfloat16)
    return x2d @ w


def unit_conv_gemms_call(x2d: torch.Tensor, w: torch.Tensor, *,
                         bm: int = 128, bn: int = 128) -> torch.Tensor:
    """p (G, M, Cout) = x2d (M, Cin) · w[g] (Cin, Cout) for every g < G,
    with no epilogue (phase 1 ends before the offsets' sum): f32 for f32
    operands, with K split ``split_k`` ways on a grid smaller than the
    card; bf16 for bf16 ones (f32 sums on the tensor cores, rounded once,
    K not split); the exact int32 sums for int8 ones.

    CUDA tensors launch the kernel on the current stream under the tile
    ``kernel_tile(bm, bn, M, Cout)``; CPU tensors run
    ``unit_conv_gemms_plain``."""
    check_kernel_dtype("unit_conv_gemms", x2d)
    if x2d.device.type == "cpu":
        return unit_conv_gemms_plain(x2d, w)
    if x2d.device.type != "cuda":
        raise ValueError(f"unit_conv_gemms: unsupported device {x2d.device}")
    if x2d.ndim != 2 or w.ndim != 3:
        raise ValueError(f"unit_conv_gemms wants x2d (M, Cin) and w (G, Cin, "
                         f"Cout), got {tuple(x2d.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = (int(d) for d in x2d.shape)
    g, n = int(w.shape[0]), int(w.shape[2])
    quant = x2d.dtype == torch.int8
    half = x2d.dtype == torch.bfloat16
    check_operand("x2d", x2d, x2d.device, (m, k), x2d.dtype)
    check_operand("w", w, x2d.device, (g, k, n), x2d.dtype)
    if min(g, m, n, k) < 1:
        raise ValueError(f"unit_conv_gemms: empty operand G={g} M={m} N={n} "
                         f"K={k}")
    if max(x2d.numel(), w.numel(), g * m * n) >= _INDEX_LIMIT:
        raise ValueError("unit_conv_gemms: tensor too large for 32-bit "
                         "indices")
    tile_m, tile_n = kernel_tile(bm, bn, m, n)
    if -(-m // tile_m) > _MAX_GRID_Y or g > _MAX_GRID_Y:
        raise ValueError(f"unit_conv_gemms: G={g} M={m} exceeds the launch "
                         "grid")
    if quant:
        check_int8_depth("unit_conv_gemms", k)
    p = torch.empty((g, m, n), device=x2d.device,
                    dtype=torch.int32 if quant else x2d.dtype)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        if quant or half:
            kern = UNIT_CONV_GEMMS_I8 if quant else UNIT_CONV_GEMMS_BF16
            kern.launch(x2d.data_ptr(), w.data_ptr(), p.data_ptr(), g, m, n,
                        k, tile_m, tile_n, stream)
            return p
        splits = grid_splits(m, n, k, (tile_m, tile_n), sm_count(x2d.device),
                             groups=g)
        work = split_workspace(splits, g * m, n, x2d.device)
        UNIT_CONV_GEMMS.launch(x2d.data_ptr(), w.data_ptr(), p.data_ptr(),
                               None if work is None else work.data_ptr(), g,
                               m, n, k, tile_m, tile_n, splits,
                               b_vector_path(w, n), stream)
    return p


# ---------------------------------------------------------------------------
# Phase 2 — Pad-and-Accumulate.
# ---------------------------------------------------------------------------

def _check_geometry(p: torch.Tensor, k1: int, k2: int, o1: int, o2: int,
                    stride: int, pad_top: int, pad_left: int) -> None:
    """Validate p (K1K2, B, H, W, C) and the output geometry."""
    if p.ndim != 5 or p.shape[0] != k1 * k2:
        raise ValueError(f"pad_accumulate wants p (K1K2={k1 * k2}, B, H, W, "
                         f"C), got {tuple(p.shape)}")
    if min(o1, o2, stride, k1, k2) < 1:
        raise ValueError(f"pad_accumulate: bad geometry o=({o1}, {o2}) "
                         f"stride {stride} kernel {k1}x{k2}")
    if min(pad_top, pad_left) < 0:
        raise ValueError(f"negative pad ({pad_top}, {pad_left})")


def accumulate_vector_path(p: torch.Tensor, out: torch.Tensor) -> int:
    """Whether pad_accumulate runs 4 channels a thread (one load of 4 of
    p's values a tap, 16 bytes or 8 for bf16): C % 4 == 0 and p and out
    aligned to 4 of p's elements (an offset view takes the one-channel
    path)."""
    align = 4 * p.element_size()
    return int(int(p.shape[-1]) % 4 == 0 and p.data_ptr() % align == 0
               and out.data_ptr() % align == 0)


def pad_accumulate_plain(p: torch.Tensor, *, k1: int, k2: int, o1: int,
                         o2: int, stride: int = 1,
                         pad_top: int = 0, pad_left: int = 0,
                         epilogue: str = "none",
                         bias: Optional[torch.Tensor] = None,
                         scale: Optional[torch.Tensor] = None,
                         out_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """The kernel's function in plain torch: zero-pad p (K1K2, B, H, W, C)
    with ``F.pad``, sum the K1K2 strided slices in the order g = 0 … G−1
    (in int32 for int32 p, else in f32), then the epilogue (dequant ·
    ``scale`` first and requant at ``out_scale`` last for int32 p) → (B,
    O1, O2, C), rounded once to bf16 for bf16 p."""
    _check_geometry(p, k1, k2, o1, o2, stride, pad_top, pad_left)
    check_epilogue(epilogue, bias)
    check_quant_args("pad_accumulate", p, scale, out_scale, torch.int32)
    h, w = int(p.shape[2]), int(p.shape[3])
    span_r, span_c = (o1 - 1) * stride + 1, (o2 - 1) * stride + 1
    pad_bottom = max(0, span_r + k1 - 1 - pad_top - h)
    pad_right = max(0, span_c + k2 - 1 - pad_left - w)
    pp = F.pad(p if p.dtype == torch.int32 else p.to(torch.float32),
               (0, 0, pad_left, pad_right, pad_top, pad_bottom))
    acc = None
    for g in range(k1 * k2):
        dk1, dk2 = divmod(g, k2)
        sl = pp[g, :, dk1:dk1 + span_r:stride, dk2:dk2 + span_c:stride]
        acc = sl if acc is None else acc + sl
    out = apply_epilogue(acc, epilogue, bias, scale=scale,
                         out_scale=out_scale)
    return out.to(torch.bfloat16) if p.dtype == torch.bfloat16 else out


def pad_accumulate_call(p: torch.Tensor, *, k1: int, k2: int, o1: int,
                        o2: int, stride: int = 1,
                        pad_top: int = 0, pad_left: int = 0,
                        epilogue: str = "none",
                        bias: Optional[torch.Tensor] = None,
                        scale: Optional[torch.Tensor] = None,
                        out_scale: Optional[float] = None
                        ) -> torch.Tensor:
    """out (B, O1, O2, C) = epilogue(Σ_{k1,k2} p_{k1,k2}[S·y + k1 −
    pad_top, S·x + k2 − pad_left] [+ bias (C,)]) for the unpadded unit-conv
    products p (K1K2, B, H, W, C); rows and columns outside each image's
    (H, W) map count as 0. For int32 p (the int8 path) the sum is int32
    and is dequantized by ``scale`` (C,) before the epilogue; ``out_scale``
    requantizes the output to int8 (else it is f32). For bf16 p the sum is
    f32, the bias must be bf16, and the output is bf16, rounded once after
    the epilogue.

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    ``pad_accumulate_plain``."""
    check_kernel_dtype("pad_accumulate", p)
    if p.device.type == "cpu":
        return pad_accumulate_plain(p, k1=k1, k2=k2, o1=o1, o2=o2,
                                    stride=stride, pad_top=pad_top,
                                    pad_left=pad_left, epilogue=epilogue,
                                    bias=bias, scale=scale,
                                    out_scale=out_scale)
    if p.device.type != "cuda":
        raise ValueError(f"pad_accumulate: unsupported device {p.device}")
    _check_geometry(p, k1, k2, o1, o2, stride, pad_top, pad_left)
    relu = check_epilogue(epilogue, bias)
    quant = check_quant_args("pad_accumulate", p, scale, out_scale,
                             torch.int32)
    _, batch, h, w, c = (int(d) for d in p.shape)
    check_operand("p", p, p.device, (k1 * k2, batch, h, w, c), p.dtype)
    if min(batch, c) < 1:
        raise ValueError(f"pad_accumulate: empty problem B={batch} C={c}")
    if bias is not None and not epilogue.startswith("bias"):
        bias = None
    half = p.dtype == torch.bfloat16
    if bias is not None:
        check_operand("bias", bias, p.device, (c,),
                      torch.bfloat16 if half else torch.float32)
    if quant:
        check_operand("scale", scale, p.device, (c,))
    if max(p.numel(), batch * o1 * o2 * c) >= _INDEX_LIMIT:
        raise ValueError("pad_accumulate: tensor too large for 32-bit "
                         "indices")
    geom = (batch, h, w, c, k1, k2, o1, o2, stride, pad_top, pad_left,
            int(relu))
    bias_ptr = None if bias is None else bias.data_ptr()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    out = torch.empty((batch, o1, o2, c), device=p.device,
                      dtype=torch.int8 if out_scale is not None
                      else p.dtype if half else torch.float32)
    vec = accumulate_vector_path(p, out)
    with torch.cuda.device(p.device):
        if half:
            PAD_ACCUMULATE_BF16.launch(p.data_ptr(), bias_ptr, out.data_ptr(),
                                       *geom, vec, stream)
        elif quant:
            PAD_ACCUMULATE_I32.launch(p.data_ptr(), scale.data_ptr(),
                                      bias_ptr, out.data_ptr(), *geom,
                                      int(out_scale is not None),
                                      float(out_scale or 0.0), vec, stream)
        else:
            PAD_ACCUMULATE.launch(p.data_ptr(), bias_ptr, out.data_ptr(),
                                  *geom, vec, stream)
    return out
