"""Winograd F(m,r) convolution kernels (§2.1.3, Eq. 5/6) — hand-written
Hopper kernels (``csrc/winograd.cu``), each with its plain torch version
beside it.

Pipeline (the paper's Linear Transform Modules):
  1. input transform   V[ξν, tile, c]  = (Bᵀ d B)           — kernel
  2. kernel transform  U[ξν, c, k]     = (G g Gᵀ)           — plain torch
  3. (m+r-1)² independent GEMMs M = V·U (Eq. 6)             — batched GEMM
     kernel (``kernels/gemm/gemm.py::batched_gemm_call``)
  4. output transform  Y = Aᵀ M A, tiles scattered back      — kernel

V and M live in the "scattered" Winograd layout (T², n, C) — elements at
the same intra-tile position adjacent — so the GEMM batch dim is the
intra-tile coordinate (ξ, ν). The batch is folded into the tile dim:
n = B·tiles_y·tiles_x, tile index b·tiles + ty·tiles_x + tx, so one
launch of each kernel covers a layer for the whole batch.

Unlike the reference, nothing is padded or cropped on the host: the input
transform reads NHWC with the SAME halo and the bottom/right fill as
predicates, and the output transform writes only the in-range pixels of
(B, O1, O2, C). Each ``*_call`` launches its kernel for CUDA tensors and
runs its ``*_plain`` version for CPU tensors; nothing else selects between
the two.

Each kernel takes f32 or bf16 (``KERNEL_DTYPES``), as the reference's
dtype-generic kernels do: loads widen to f32, the transform, bias and ReLU
run in f32, and the single store rounds once to the input's dtype; the
plain versions compute in f32 and round once the same way.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import (apply_epilogue, check_kernel_dtype,
                                        pad_nhwc)
from repro_torch.kernels.gemm.gemm import check_operand, check_epilogue

_INPUT_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_TILES_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_OUTPUT_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
INPUT_TRANSFORM = CudaKernel("winograd", "winograd_input_transform_f32",
                             _INPUT_ARGS)
INPUT_TRANSFORM_TILES = CudaKernel(
    "winograd", "winograd_input_transform_tiles_f32", _TILES_ARGS)
OUTPUT_TRANSFORM = CudaKernel("winograd", "winograd_output_transform_f32",
                              _OUTPUT_ARGS)
INPUT_TRANSFORM_BF16 = CudaKernel(
    "winograd", "winograd_input_transform_bf16", _INPUT_ARGS)
INPUT_TRANSFORM_TILES_BF16 = CudaKernel(
    "winograd", "winograd_input_transform_tiles_bf16", _TILES_ARGS)
OUTPUT_TRANSFORM_BF16 = CudaKernel(
    "winograd", "winograd_output_transform_bf16", _OUTPUT_ARGS)

# ---------------------------------------------------------------------------
# Transform matrices (Lavin & Gray). F(2,3) uses only ±1, ±1/2 — the paper
# notes these reduce to shift-adds on FPGA; the CUDA kernels write them out
# as adds and small-constant FMAs.
# ---------------------------------------------------------------------------

_BT = {
    (2, 3): np.array([[1, 0, -1, 0],
                      [0, 1, 1, 0],
                      [0, -1, 1, 0],
                      [0, 1, 0, -1]], np.float32),
    (4, 3): np.array([[4, 0, -5, 0, 1, 0],
                      [0, -4, -4, 1, 1, 0],
                      [0, 4, -4, -1, 1, 0],
                      [0, -2, -1, 2, 1, 0],
                      [0, 2, -1, -2, 1, 0],
                      [0, 4, 0, -5, 0, 1]], np.float32),
}
_G = {
    (2, 3): np.array([[1, 0, 0],
                      [0.5, 0.5, 0.5],
                      [0.5, -0.5, 0.5],
                      [0, 0, 1]], np.float32),
    (4, 3): np.array([[1 / 4, 0, 0],
                      [-1 / 6, -1 / 6, -1 / 6],
                      [-1 / 6, 1 / 6, -1 / 6],
                      [1 / 24, 1 / 12, 1 / 6],
                      [1 / 24, -1 / 12, 1 / 6],
                      [0, 0, 1]], np.float32),
}
_AT = {
    (2, 3): np.array([[1, 1, 1, 0],
                      [0, 1, -1, -1]], np.float32),
    (4, 3): np.array([[1, 1, 1, 1, 1, 0],
                      [0, 1, -1, 2, -2, 0],
                      [0, 1, 1, 4, 4, 0],
                      [0, 1, -1, 8, -8, 1]], np.float32),
}


def matrices(m: int, r: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(Bᵀ, G, Aᵀ) of F(m, r) as numpy f32."""
    if (m, r) not in _BT:
        raise ValueError(f"F({m},{r}) not supported; have {_BT.keys()}")
    return _BT[(m, r)], _G[(m, r)], _AT[(m, r)]


@functools.lru_cache(maxsize=None)
def torch_matrices(m: int, r: int, device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``matrices(m, r)`` as f32 tensors on ``device`` (cached)."""
    return tuple(torch.as_tensor(a, device=device) for a in matrices(m, r))


def transform_kernel_weights(w: torch.Tensor, m: int, r: int
                             ) -> torch.Tensor:
    """U[ξν, Cin, Cout] = G g Gᵀ — the kernel transform; w (r, r, Cin,
    Cout) → (T², Cin, Cout). Plain torch, run every forward (the
    reference runs it in-trace): one (T², r²) × (r², Cin·Cout) product
    with G ⊗ G, since U[(t, u)] = Σ_(i, j) G[t, i]·G[u, j]·g[i, j]."""
    t = m + r - 1
    u = _g_kron(m, r, w.device) @ w.to(torch.float32).reshape(r * r, -1)
    return u.reshape(t * t, *w.shape[2:])


@functools.lru_cache(maxsize=None)
def _g_kron(m: int, r: int, device: torch.device) -> torch.Tensor:
    _, g_mat, _ = torch_matrices(m, r, device)
    return torch.kron(g_mat, g_mat)


def pad_for_tiles(x: torch.Tensor, *, m: int, r: int, tiles_y: int,
                  tiles_x: int, pad_top: int, pad_left: int) -> torch.Tensor:
    """Pad x (…, H, W, C) by the (pad_top, pad_left) halo and the
    bottom/right fill that put every T×T tile (stride m) of a tiles_y ×
    tiles_x grid in range."""
    h, w = x.shape[-3], x.shape[-2]
    return pad_nhwc(x, pad_top, max(0, tiles_y * m + r - 1 - h - pad_top),
                    pad_left, max(0, tiles_x * m + r - 1 - w - pad_left))


def _check_fm(m: int, r: int) -> int:
    """Validate F(m, r) for the kernels; returns T = m + r - 1."""
    matrices(m, r)
    return m + r - 1


def _check_tiling(tiles_y: int, tiles_x: int, pad_top: int,
                  pad_left: int) -> None:
    """Validate the tile grid and halo the input transform reads."""
    if min(tiles_y, tiles_x) < 1:
        raise ValueError(f"empty tile grid {tiles_y}x{tiles_x}")
    if min(pad_top, pad_left) < 0:
        raise ValueError(f"negative pad ({pad_top}, {pad_left})")


# ---------------------------------------------------------------------------
# 1. Input transform: NHWC → V (scattered layout).
# ---------------------------------------------------------------------------

def input_transform_plain(x: torch.Tensor, *, m: int, r: int = 3,
                          tiles_y: int, tiles_x: int, pad_top: int = 0,
                          pad_left: int = 0) -> torch.Tensor:
    """The input transform in plain torch: pad x (B, H, W, C) by the halo
    and the bottom/right fill, cut the overlapping T×T tiles (stride m) and
    apply Bᵀ d B in f32. Returns V (T², B·tiles_y·tiles_x, C) in x's
    dtype (a bf16 V rounded once)."""
    t = _check_fm(m, r)
    _check_tiling(tiles_y, tiles_x, pad_top, pad_left)
    b, _, _, c = x.shape
    xp = pad_for_tiles(x, m=m, r=r, tiles_y=tiles_y, tiles_x=tiles_x,
                       pad_top=pad_top, pad_left=pad_left)
    d = xp.unfold(1, t, m).unfold(2, t, m)[:, :tiles_y, :tiles_x]
    bt, _, _ = torch_matrices(m, r, x.device)
    v = torch.einsum("ti,byxcij,uj->tubyxc", bt, d.to(torch.float32), bt)
    return v.reshape(t * t, b * tiles_y * tiles_x, c).to(x.dtype)


def input_transform_call(x: torch.Tensor, *, m: int, r: int = 3,
                         tiles_y: int, tiles_x: int, pad_top: int = 0,
                         pad_left: int = 0) -> torch.Tensor:
    """V (T², B·tiles_y·tiles_x, C) = Bᵀ d B over the T×T windows (stride
    m) of x (B, H, W, C), whose first window starts at input pixel
    (-pad_top, -pad_left); pixels outside the map count as 0.

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    ``input_transform_plain``."""
    check_kernel_dtype("input_transform", x)
    if x.device.type == "cpu":
        return input_transform_plain(x, m=m, r=r, tiles_y=tiles_y,
                                     tiles_x=tiles_x, pad_top=pad_top,
                                     pad_left=pad_left)
    if x.device.type != "cuda":
        raise ValueError(f"input_transform: unsupported device {x.device}")
    t = _check_fm(m, r)
    _check_tiling(tiles_y, tiles_x, pad_top, pad_left)
    if x.ndim != 4:
        raise ValueError(f"input_transform wants x (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    b, h, w, c = (int(d) for d in x.shape)
    check_operand("x", x, x.device, (b, h, w, c), x.dtype)
    n = b * tiles_y * tiles_x
    if min(n, c) < 1:
        raise ValueError(f"input_transform: empty problem n={n} C={c}")
    if max(x.numel(), t * t * n * c) >= 2 ** 31:
        raise ValueError("input_transform: tensor too large for 32-bit "
                         "indices")
    v = torch.empty((t * t, n, c), device=x.device, dtype=x.dtype)
    kernel = (INPUT_TRANSFORM_BF16 if x.dtype == torch.bfloat16
              else INPUT_TRANSFORM)
    with torch.cuda.device(x.device):
        kernel.launch(x.data_ptr(), v.data_ptr(), b, h, w, c, m, tiles_y,
                      tiles_x, pad_top, pad_left,
                      torch.cuda.current_stream().cuda_stream)
    return v


# ---------------------------------------------------------------------------
# 1'. Matched-layout input transform: stored tiles → V.
# ---------------------------------------------------------------------------

def input_transform_tiles_plain(tiles: torch.Tensor, *, m: int,
                                r: int = 3) -> torch.Tensor:
    """Bᵀ d B on each tile of tiles (n, T, T, C) in plain torch, in f32 →
    V (T², n, C) in the tiles' dtype (a bf16 V rounded once)."""
    t = _check_fm(m, r)
    n, _, _, c = tiles.shape
    bt, _, _ = torch_matrices(m, r, tiles.device)
    v = torch.einsum("ti,nijc,uj->tunc", bt, tiles.to(torch.float32), bt)
    return v.reshape(t * t, n, c).to(tiles.dtype)


def input_transform_tiles_call(tiles: torch.Tensor, *, m: int,
                               r: int = 3) -> torch.Tensor:
    """Matched-layout input transform: ``tiles`` (n, T, T, C) already sit
    in the stored Winograd tile layout (the producer stored them — Table 2
    row 4's streaming load), so no spatial re-gather happens here; each
    tile goes straight through Bᵀ d B. Returns V (T², n, C).

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    ``input_transform_tiles_plain``."""
    check_kernel_dtype("input_transform_tiles", tiles)
    if tiles.device.type == "cpu":
        return input_transform_tiles_plain(tiles, m=m, r=r)
    if tiles.device.type != "cuda":
        raise ValueError(f"input_transform_tiles: unsupported device "
                         f"{tiles.device}")
    t = _check_fm(m, r)
    if tiles.ndim != 4:
        raise ValueError(f"input_transform_tiles wants (n, T, T, C), got "
                         f"{tuple(tiles.shape)}")
    n, c = int(tiles.shape[0]), int(tiles.shape[3])
    check_operand("tiles", tiles, tiles.device, (n, t, t, c), tiles.dtype)
    if min(n, c) < 1:
        raise ValueError(f"input_transform_tiles: empty problem n={n} C={c}")
    if tiles.numel() >= 2 ** 31:
        raise ValueError("input_transform_tiles: tensor too large for "
                         "32-bit indices")
    v = torch.empty((t * t, n, c), device=tiles.device, dtype=tiles.dtype)
    kernel = (INPUT_TRANSFORM_TILES_BF16 if tiles.dtype == torch.bfloat16
              else INPUT_TRANSFORM_TILES)
    with torch.cuda.device(tiles.device):
        kernel.launch(tiles.data_ptr(), v.data_ptr(), n, c, m,
                      torch.cuda.current_stream().cuda_stream)
    return v


# ---------------------------------------------------------------------------
# 4. Output transform: M (scattered) → NHWC Y.
# ---------------------------------------------------------------------------

def output_transform_plain(mm: torch.Tensor, *, m: int, r: int = 3,
                           tiles_y: int, tiles_x: int, o1: int, o2: int,
                           epilogue: str = "none",
                           bias: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The output transform in plain torch: Aᵀ M A per tile of mm (T²,
    B·tiles, C) and the epilogue in f32, the m×m blocks put back in place
    and the map cropped to (B, o1, o2, C), in mm's dtype (a bf16 output
    rounded once, after the epilogue)."""
    t = _check_fm(m, r)
    check_epilogue(epilogue, bias)
    _, n, c = mm.shape
    _, _, at = torch_matrices(m, r, mm.device)
    y = torch.einsum("ai,ijnc,bj->nabc", at,
                     mm.to(torch.float32).reshape(t, t, n, c), at)
    y = apply_epilogue(y, epilogue, bias).to(mm.dtype)
    y = y.reshape(-1, tiles_y, tiles_x, m, m, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(-1, tiles_y * m, tiles_x * m, c)[:, :o1, :o2]


def output_transform_call(mm: torch.Tensor, *, m: int, r: int = 3,
                          tiles_y: int, tiles_x: int, o1: int, o2: int,
                          epilogue: str = "none",
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """out (B, o1, o2, C) = epilogue(Aᵀ M A [+ bias (C,)]) for mm (T²,
    B·tiles_y·tiles_x, C): tile (ty, tx) of image b lands at rows ty·m…,
    columns tx·m… and only the pixels inside (o1, o2) are written. As the
    last Winograd stage it owns the fused epilogue.

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    ``output_transform_plain``."""
    check_kernel_dtype("output_transform", mm)
    if mm.device.type == "cpu":
        return output_transform_plain(mm, m=m, r=r, tiles_y=tiles_y,
                                      tiles_x=tiles_x, o1=o1, o2=o2,
                                      epilogue=epilogue, bias=bias)
    if mm.device.type != "cuda":
        raise ValueError(f"output_transform: unsupported device {mm.device}")
    t = _check_fm(m, r)
    relu = check_epilogue(epilogue, bias)
    if mm.ndim != 3:
        raise ValueError(f"output_transform wants M (T², n, C), got "
                         f"{tuple(mm.shape)}")
    n, c = int(mm.shape[1]), int(mm.shape[2])
    check_operand("M", mm, mm.device, (t * t, n, c), mm.dtype)
    per_image = tiles_y * tiles_x
    if per_image < 1 or n % per_image:
        raise ValueError(f"output_transform: {n} tiles is not a whole "
                         f"number of {tiles_y}x{tiles_x} images")
    if not (0 < o1 <= tiles_y * m and 0 < o2 <= tiles_x * m):
        raise ValueError(f"output_transform: ({o1}, {o2}) does not fit "
                         f"{tiles_y}x{tiles_x} tiles of {m}")
    if bias is not None and not epilogue.startswith("bias"):
        bias = None
    if bias is not None:
        check_operand("bias", bias, mm.device, (c,), mm.dtype)
    if mm.numel() >= 2 ** 31:
        raise ValueError("output_transform: tensor too large for 32-bit "
                         "indices")
    batch = n // per_image
    out = torch.empty((batch, o1, o2, c), device=mm.device, dtype=mm.dtype)
    kernel = (OUTPUT_TRANSFORM_BF16 if mm.dtype == torch.bfloat16
              else OUTPUT_TRANSFORM)
    with torch.cuda.device(mm.device):
        kernel.launch(mm.data_ptr(),
                      None if bias is None else bias.data_ptr(),
                      out.data_ptr(), batch, c, m, tiles_y, tiles_x, o1, o2,
                      int(relu), torch.cuda.current_stream().cuda_stream)
    return out
