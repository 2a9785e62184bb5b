"""Dataflow-bound tiled GEMM — the paper's Computing Unit as a hand-written
Hopper kernel (``csrc/gemm.cu``), with its plain torch version beside it.

C = epilogue(A · B [+ bias]) in IEEE f32. The kernel masks ragged M/N/K
edges itself, so no operand is padded on the host, and applies bias/ReLU
in registers before its single store. ``gemm_call`` launches it for CUDA
tensors and runs ``gemm_plain`` for CPU tensors; nothing else selects
between the two.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import EPILOGUES, apply_epilogue, ceil_to

GEMM = CudaKernel("gemm", "gemm_f32",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p])

_MAX_GRID_Y = 65535


def kernel_tile(bm: int, bn: int, m: int, n: int) -> Tuple[int, int]:
    """Map the plan's (bm, bn) block binding onto one of the tiles the
    kernels are instantiated for (64 or 128 each, ``csrc/tile_gemm.cuh``).

    The block is first clamped to the problem (64-granular, as the
    reference clamps to its (8, 128) tiles); an edge of 128 or more runs
    on the 128 tile — bindings of p1 or p2 = 256..512 included — and a
    smaller one on the 64 tile. The tile shapes only the schedule: every
    tile computes the same sums in the same K order."""
    bm = min(bm, ceil_to(m, 64))
    bn = min(bn, ceil_to(n, 64))
    return (128 if bm >= 128 else 64), (128 if bn >= 128 else 64)


def check_epilogue(epilogue: str, bias: Optional[torch.Tensor]) -> bool:
    """Validate (epilogue, bias); returns whether the epilogue has ReLU."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; want {EPILOGUES}")
    if epilogue.startswith("bias") and bias is None:
        raise ValueError(f"epilogue {epilogue!r} needs a bias array")
    return epilogue.endswith("relu")


def check_cuda_f32(name: str, t: torch.Tensor, device: torch.device,
                   shape: Tuple[int, ...]) -> None:
    """Raise unless ``t`` is a contiguous f32 tensor of ``shape`` on the
    CUDA ``device`` — all the kernels take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        "float32 only")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def gemm_plain(a: torch.Tensor, b: torch.Tensor, epilogue: str = "none",
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain torch: ``a @ b`` plus the epilogue."""
    check_epilogue(epilogue, bias)
    return apply_epilogue(a @ b, epilogue, bias)


def gemm_call(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
              bn: int = 128, epilogue: str = "none",
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C (M, N) = epilogue(A (M, K) · B (K, N) [+ bias (N,)]).

    CUDA tensors launch the kernel on the current stream under the tile
    ``kernel_tile(bm, bn, M, N)``; CPU tensors run ``gemm_plain``."""
    if a.device.type == "cpu":
        return gemm_plain(a, b, epilogue, bias)
    if a.device.type != "cuda":
        raise ValueError(f"gemm: unsupported device {a.device}")
    relu = check_epilogue(epilogue, bias)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"gemm wants 2-D operands, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    m, k = (int(d) for d in a.shape)
    n = int(b.shape[1])
    check_cuda_f32("a", a, a.device, (m, k))
    check_cuda_f32("b", b, a.device, (k, n))
    if bias is not None and not epilogue.startswith("bias"):
        bias = None
    if bias is not None:
        check_cuda_f32("bias", bias, a.device, (n,))
    if min(m, n, k) < 1:
        raise ValueError(f"gemm: empty operand M={m} N={n} K={k}")
    tile_m, tile_n = kernel_tile(bm, bn, m, n)
    if -(-m // tile_m) > _MAX_GRID_Y:
        raise ValueError(f"gemm: M={m} exceeds the launch grid")
    out = torch.empty((m, n), device=a.device, dtype=torch.float32)
    with torch.cuda.device(a.device):
        GEMM.launch(a.data_ptr(), b.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    out.data_ptr(), m, n, k, tile_m, tile_n, int(relu),
                    torch.cuda.current_stream().cuda_stream)
    return out
