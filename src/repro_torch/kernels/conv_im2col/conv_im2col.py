"""im2col convolution as a hand-written *implicit-GEMM* Hopper kernel
(``csrc/conv_im2col.cu``), with its plain torch version beside it.

The paper's im2col (§2.1.1) stretches input windows into a Toeplitz matrix
and runs one GEMM (Eq. 2). The kernel never stores that matrix: each K
chunk of it is gathered from the NHWC input straight into shared memory,
so device memory sees the input map, the weights and the output once.
M = B·O1·O2 output pixels, N = Cout, K = K1·K2·Cin. SAME padding (XLA's
asymmetric split) and the window overhang are predicates in the kernel.
``conv_im2col_call`` launches it for CUDA tensors and runs ``conv_plain``
for CPU tensors; nothing else selects between the two.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import apply_epilogue
from repro_torch.kernels.conv_im2col.ref import (conv_geometry,
                                                 conv_via_toeplitz_ref)
from repro_torch.kernels.gemm.gemm import (_MAX_GRID_Y, check_cuda_f32,
                                          check_epilogue, kernel_tile)

CONV = CudaKernel("conv_im2col", "conv_im2col_f32",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                  + [ctypes.c_void_p])


def conv_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               padding: str = "SAME", epilogue: str = "none",
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain torch: an explicit Toeplitz gather,
    then ``@`` and the epilogue. x (B, H, W, Cin), w (K1, K2, Cin, Cout)
    → (B, O1, O2, Cout)."""
    check_epilogue(epilogue, bias)
    return apply_epilogue(conv_via_toeplitz_ref(x, w, stride, padding),
                          epilogue, bias)


def conv_im2col_call(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                     padding: str = "SAME", bm: int = 128, bn: int = 128,
                     epilogue: str = "none",
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out (B, O1, O2, Cout) = epilogue(conv(x (B, H, W, Cin), w
    (K1, K2, Cin, Cout)) [+ bias (Cout,)]).

    CUDA tensors launch the kernel on the current stream under the tile
    ``kernel_tile(bm, bn, B·O1·O2, Cout)``; CPU tensors run
    ``conv_plain``."""
    if x.device.type == "cpu":
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
    check_cuda_f32("x", x, x.device, (batch, h, w_in, c_in))
    check_cuda_f32("w", w, x.device, (k1, k2, c_in, c_out))
    if bias is not None and not epilogue.startswith("bias"):
        bias = None
    if bias is not None:
        check_cuda_f32("bias", bias, x.device, (c_out,))
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
    out = torch.empty((batch, o1, o2, c_out), device=x.device,
                      dtype=torch.float32)
    with torch.cuda.device(x.device):
        CONV.launch(x.data_ptr(), w.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    out.data_ptr(), batch, h, w_in, c_in, k1, k2, stride,
                    pad_top, pad_left, o1, o2, c_out, tile_m, tile_n,
                    int(relu), torch.cuda.current_stream().cuda_stream)
    return out
