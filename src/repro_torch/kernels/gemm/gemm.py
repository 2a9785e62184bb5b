"""Dataflow-bound tiled GEMM — the paper's Computing Unit as a hand-written
Hopper kernel (``csrc/gemm.cu``), dense, batched, int8 and bf16, each with
its plain torch version beside it.

C = epilogue(A · B [+ bias]) in IEEE f32; the batched form computes G
independent products C[g] = epilogue(A[g] · B[g] [+ bias]) with one bias
shared by every g (Winograd's transform-space GEMMs), in f32 or bf16. The int8 form takes
int8 A and B, sums exactly in int32 and flushes dequant (· ``scale``, the
per-channel in_scale · w_scale) → bias → ReLU → optional requant at
``out_scale`` to an int8 C. The kernels mask ragged M/N/K edges
themselves, so no operand is padded on the host, and apply the epilogue
in registers before their single store. The bf16 form takes bf16 A, B
and bias, sums in f32 on the tensor cores, applies bias and ReLU in f32
and rounds once to the output dtype (bf16 unless ``out_dtype`` asks for
f32), as the reference's kernel flushes its f32 accumulator; the f32
forms store a bf16 C the same way under ``out_dtype=bf16``.
``gemm_call`` (on the operands' dtype, which ``KERNEL_DTYPES`` bounds)
and ``batched_gemm_call`` launch them for CUDA tensors and run
``gemm_plain`` / ``gemm_i8_plain`` / ``batched_gemm_plain`` for CPU
tensors; nothing else selects between the two.

bf16 operands run one of two loops, picked by shape and alignment alone
(``wgmma_path``): operands whose rows TMA can address (K and N multiples
of 8, A and B 16-byte aligned: every main-path launch) run the Hopper loop
(``csrc/tile_wgmma_bf16.cuh``: a TMA ring feeding ``wgmma``), any other
runs the ``mma.sync`` loop (``csrc/tile_mma_bf16.cuh``, the ``_mma``
entry points). Each loop has its own entry point and launch count.

The f32 GEMM and the bf16 wgmma loop split K when the grid has fewer
blocks than the card has SMs (``split_k``, at the loop's chunk depth; the
bf16 ``mma.sync`` loop, which no main-path operand takes, never splits):
each slice writes
its raw f32 partial into a workspace the wrapper allocates, and a second
kernel of the same entry point sums the slices in a fixed order before
the epilogue and the one rounding, so a shape gives the same bits on
every call. The batched GEMMs never split: their main-path grids (G = 36
layers of output tiles) fill the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import (EPILOGUES, apply_epilogue, ceil_to,
                                        check_int8_depth, check_kernel_dtype,
                                        int8_product)

GEMM = CudaKernel("gemm", "gemm_f32",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                  + [ctypes.c_void_p])
GEMM_I8 = CudaKernel("gemm", "gemm_i8",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_void_p])
# The bf16 GEMMs, one entry point per loop: gemm_bf16 and
# batched_gemm_bf16 run the TMA / wgmma loop (wgmma_path operands), the
# _mma entry points the mma.sync loop (any other operand).
GEMM_BF16 = CudaKernel("gemm", "gemm_bf16",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
GEMM_BF16_MMA = CudaKernel("gemm", "gemm_bf16_mma",
                           [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p])
BATCHED_GEMM = CudaKernel("gemm", "batched_gemm_f32",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                          + [ctypes.c_void_p])
BATCHED_GEMM_BF16 = CudaKernel("gemm", "batched_gemm_bf16",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                               + [ctypes.c_void_p])
BATCHED_GEMM_BF16_MMA = CudaKernel("gemm", "batched_gemm_bf16_mma",
                                   [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                   + [ctypes.c_void_p])

_MAX_GRID_Y = 65535
# The depth of one K chunk, elements: the f32 loop's (csrc/tile_gemm.cuh::
# kBK) and the bf16 wgmma loop's (tile_wgmma_bf16.cuh::kWgChunk).
K_CHUNK = 16
BF16_WGMMA_CHUNK = 64
MIN_SLICE_CHUNKS = 4   # the fewest f32 K chunks split_k leaves a slice
# ... that is, the fewest elements of K, in any loop's whole chunks.
MIN_SLICE_DEPTH = MIN_SLICE_CHUNKS * K_CHUNK


def split_k(blocks: int, k: int, sms: int, chunk: int = K_CHUNK) -> int:
    """How many K slices S a grid of ``blocks`` output tiles runs on a card
    of ``sms`` SMs, for a loop of ``chunk``-deep K chunks: 1 when the grid
    already fills the card, else the largest S whose grid still runs in
    one wave (``blocks · S <= sms``: at the 128 x 128 tile one block fits
    an SM, and a partial second wave costs a whole slice), capped so that
    a slice keeps at least ``MIN_SLICE_DEPTH`` elements of K (whole
    chunks, at least one), then lowered to the number of slices of that
    depth K needs, so that no slice is empty. The slices are
    ``k_slices(k, S, chunk)``; the shape, the loop and the SM count alone
    decide S."""
    if blocks >= sms:
        return 1
    chunks = -(-k // chunk)
    min_chunks = max(1, MIN_SLICE_DEPTH // chunk)
    splits = min(sms // blocks, max(1, chunks // min_chunks))
    return -(-chunks // -(-chunks // splits))


def grid_splits(m: int, n: int, k: int, tile: Tuple[int, int], sms: int,
                groups: int = 1, chunk: int = K_CHUNK) -> int:
    """``split_k`` for a grid of ``groups`` x ⌈m / tile_m⌉ x ⌈n / tile_n⌉
    output tiles of a loop of ``chunk``-deep K chunks: the K slices a
    kernel runs for this shape."""
    blocks = groups * -(-m // tile[0]) * -(-n // tile[1])
    return split_k(blocks, k, sms, chunk)


def k_slices(k: int, splits: int, chunk: int = K_CHUNK
             ) -> List[Tuple[int, int]]:
    """The K ranges [begin, end) of ``splits`` slices, as the kernels cut
    them (``csrc/tile_gemm_async.cuh::slice_depth``): whole chunks each,
    only the last ragged or short."""
    depth = -(-(-(-k // chunk)) // splits) * chunk
    return [(s * depth, min(k, (s + 1) * depth)) for s in range(splits)]


def wgmma_path(a: torch.Tensor, b: torch.Tensor, n: int, k: int) -> bool:
    """Whether bf16 operands run the TMA / wgmma loop
    (``csrc/tile_wgmma_bf16.cuh::wgmma_path``): TMA addresses rows of
    16-byte multiples from 16-byte aligned bases, so K and N must be
    multiples of 8 and A and B 16-byte aligned (then every matrix of a
    batched product is too). Any other operand runs the mma.sync loop."""
    return (k % 8 == 0 and n % 8 == 0 and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0)


def bf16_loop_launches() -> dict:
    """{entry point: launches} of the bf16 GEMMs' two loops."""
    return {kern.symbol: kern.launches for kern in (
        GEMM_BF16, GEMM_BF16_MMA, BATCHED_GEMM_BF16, BATCHED_GEMM_BF16_MMA)}


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_workspace(splits: int, rows: int, n: int,
                    device: torch.device) -> Optional[torch.Tensor]:
    """The f32 workspace (splits, rows, n) of a split product's partials,
    or None for an unsplit one."""
    if splits == 1:
        return None
    return torch.empty((splits, rows, n), device=device, dtype=torch.float32)


def b_vector_path(b: torch.Tensor, n: int) -> int:
    """Whether the f32 loop copies B in 16-byte pieces: n % 4 == 0 and B
    16-byte aligned (an offset view takes the 4-byte path)."""
    return int(n % 4 == 0 and b.data_ptr() % 16 == 0)


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


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  shape: Tuple[int, ...],
                  dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    the CUDA ``device`` — all the kernels take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{dtype} here")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_quant_args(name: str, x: torch.Tensor,
                     scale: Optional[torch.Tensor],
                     out_scale: Optional[float],
                     quant_dtype: torch.dtype = torch.int8) -> bool:
    """Whether ``x`` takes the quantized path: ``quant_dtype`` operands
    (int8, or the int32 partials of kn2row's phase 2) need the dequant
    ``scale``; f32 ones take neither ``scale`` nor ``out_scale``."""
    if x.dtype == quant_dtype:
        if scale is None:
            raise ValueError(f"{name}: {quant_dtype} operands need a "
                             "dequant scale")
        return True
    if scale is not None or out_scale is not None:
        raise ValueError(f"{name}: scale/out_scale need {quant_dtype} "
                         f"operands, got {x.dtype}")
    return False


def gemm_out_dtype(dtype: torch.dtype, out_dtype: Optional[torch.dtype],
                   out_scale: Optional[float] = None) -> torch.dtype:
    """C's dtype for operands of ``dtype``: the reference's default (int8
    under ``out_scale``, f32 for other int8 operands, else the operands'
    dtype) when ``out_dtype`` is None or names it; f32 and bf16 operands
    also take the other of the two, a store of the flush. Any other
    ``out_dtype`` raises ``ValueError``."""
    default = (torch.int8 if out_scale is not None
               else torch.float32 if dtype == torch.int8 else dtype)
    if out_dtype is None or out_dtype == default:
        return default
    if dtype == torch.int8 or out_dtype not in (torch.float32,
                                                torch.bfloat16):
        raise ValueError(f"out_dtype={out_dtype} is not taken for {dtype} "
                         f"operands; want None, {default} or, for f32 and "
                         "bf16 operands, the other of the two")
    return out_dtype


def gemm_plain(a: torch.Tensor, b: torch.Tensor, epilogue: str = "none",
               bias: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's function in plain torch: ``a @ b`` plus the epilogue
    (for (G, M, K) × (G, K, N) operands, the batched kernel's: the bias
    (N,) is shared across G), in C's dtype (``gemm_out_dtype``). bf16
    operands are multiplied in f32 and the epilogue's result is rounded
    once, as the kernel rounds."""
    check_epilogue(epilogue, bias)
    out_dtype = gemm_out_dtype(a.dtype, out_dtype)
    if a.dtype == torch.bfloat16:
        a, b = a.to(torch.float32), b.to(torch.float32)
    return apply_epilogue(a @ b, epilogue, bias).to(out_dtype)


def gemm_i8_plain(a: torch.Tensor, b: torch.Tensor, epilogue: str = "none",
                  bias: Optional[torch.Tensor] = None, *,
                  scale: torch.Tensor,
                  out_scale: Optional[float] = None) -> torch.Tensor:
    """The int8 kernel's function in plain torch: the exact int32 sums of
    int8 ``a @ b``, then dequant · ``scale`` (N,), the epilogue and, with
    ``out_scale``, the requant to int8."""
    check_epilogue(epilogue, bias)
    check_int8_depth("gemm", int(a.shape[-1]))
    return apply_epilogue(int8_product(a, b), epilogue, bias, scale=scale,
                          out_scale=out_scale)


def gemm_call(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
              bn: int = 128, epilogue: str = "none",
              bias: Optional[torch.Tensor] = None,
              scale: Optional[torch.Tensor] = None,
              out_scale: Optional[float] = None,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C (M, N) = epilogue(A (M, K) · B (K, N) [+ bias (N,)]).

    f32 operands run ``gemm_f32``, with K split ``split_k`` ways on a grid
    smaller than the card. bf16 operands (and a bf16 bias) run
    ``gemm_bf16`` (the wgmma loop, K split the same way at its 64-deep
    chunks) or, for operands ``wgmma_path`` refuses, ``gemm_bf16_mma``
    (the mma.sync loop, K not split) on the tensor cores, f32 sums and one
    rounding at the flush. int8 operands run ``gemm_i8``: the exact int32 sum is
    dequantized by ``scale`` (N,) before the epilogue, and ``out_scale``
    requantizes C to int8 (else C is f32). ``out_dtype`` (f32 or bf16,
    ``gemm_out_dtype``) is the dtype C is stored in by the flush; any
    other operand dtype raises ``TypeError``.

    CUDA tensors launch the kernel on the current stream under the tile
    ``kernel_tile(bm, bn, M, N)``; CPU tensors run ``gemm_plain`` /
    ``gemm_i8_plain``."""
    check_kernel_dtype("gemm", a)
    quant = check_quant_args("gemm", a, scale, out_scale)
    out_dtype = gemm_out_dtype(a.dtype, out_dtype, out_scale)
    if a.device.type == "cpu":
        if quant:
            return gemm_i8_plain(a, b, epilogue, bias, scale=scale,
                                 out_scale=out_scale)
        return gemm_plain(a, b, epilogue, bias, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"gemm: unsupported device {a.device}")
    relu = check_epilogue(epilogue, bias)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"gemm wants 2-D operands, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    m, k = (int(d) for d in a.shape)
    n = int(b.shape[1])
    check_operand("a", a, a.device, (m, k), a.dtype)
    check_operand("b", b, a.device, (k, n), a.dtype)
    if bias is not None and not epilogue.startswith("bias"):
        bias = None
    if bias is not None:
        check_operand("bias", bias, a.device, (n,),
                      torch.bfloat16 if a.dtype == torch.bfloat16
                      else torch.float32)
    if min(m, n, k) < 1:
        raise ValueError(f"gemm: empty operand M={m} N={n} K={k}")
    tile_m, tile_n = kernel_tile(bm, bn, m, n)
    if -(-m // tile_m) > _MAX_GRID_Y:
        raise ValueError(f"gemm: M={m} exceeds the launch grid")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    bias_ptr = None if bias is None else bias.data_ptr()
    if quant:
        check_int8_depth("gemm", k)
        check_operand("scale", scale, a.device, (n,))
        out = torch.empty((m, n), device=a.device,
                          dtype=torch.float32 if out_scale is None
                          else torch.int8)
        with torch.cuda.device(a.device):
            GEMM_I8.launch(a.data_ptr(), b.data_ptr(), scale.data_ptr(),
                           bias_ptr, out.data_ptr(), m, n, k, tile_m, tile_n,
                           int(relu), int(out_scale is not None),
                           float(out_scale or 0.0), stream)
        return out
    out = torch.empty((m, n), device=a.device, dtype=out_dtype)
    if a.dtype == torch.bfloat16:
        out_f32 = int(out_dtype == torch.float32)
        if not wgmma_path(a, b, n, k):
            with torch.cuda.device(a.device):
                GEMM_BF16_MMA.launch(a.data_ptr(), b.data_ptr(), bias_ptr,
                                     out.data_ptr(), m, n, k, tile_m, tile_n,
                                     int(relu), out_f32, stream)
            return out
        splits = grid_splits(m, n, k, (tile_m, tile_n), sm_count(a.device),
                             chunk=BF16_WGMMA_CHUNK)
        work = split_workspace(splits, m, n, a.device)
        with torch.cuda.device(a.device):
            GEMM_BF16.launch(a.data_ptr(), b.data_ptr(), bias_ptr,
                             out.data_ptr(),
                             None if work is None else work.data_ptr(), m, n,
                             k, tile_m, tile_n, int(relu), splits, out_f32,
                             stream)
        return out
    splits = grid_splits(m, n, k, (tile_m, tile_n), sm_count(a.device))
    work = split_workspace(splits, m, n, a.device)
    with torch.cuda.device(a.device):
        GEMM.launch(a.data_ptr(), b.data_ptr(), bias_ptr, out.data_ptr(),
                    None if work is None else work.data_ptr(), m, n, k,
                    tile_m, tile_n, int(relu), splits, b_vector_path(b, n),
                    int(out_dtype == torch.bfloat16), stream)
    return out


# ``a @ b`` broadcasts over the leading dim, so one plain body serves both.
batched_gemm_plain = gemm_plain


def batched_gemm_call(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                      bn: int = 128, epilogue: str = "none",
                      bias: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """C (G, M, N) = epilogue(A (G, M, K) · B (G, K, N) [+ bias (N,)]) for
    f32 or bf16 operands (any other dtype raises ``TypeError``). f32
    operands store C in ``out_dtype`` (f32, or bf16 rounded once at the
    flush); bf16 operands (and a bf16 bias) sum in f32 on the tensor cores
    and store a bf16 C, rounded once, the reference's ``out_dtype =
    a.dtype``: any other ``out_dtype`` raises ``ValueError``.

    CUDA tensors launch the batched kernel (one grid layer per g, K not
    split; for bf16 the wgmma loop, or the mma.sync loop for operands
    ``wgmma_path`` refuses) on the current stream under the tile
    ``kernel_tile(bm, bn, M, N)``; CPU tensors run
    ``batched_gemm_plain``."""
    check_kernel_dtype("batched_gemm", a)
    out_dtype = gemm_out_dtype(a.dtype, out_dtype)
    if a.dtype == torch.bfloat16 and out_dtype != torch.bfloat16:
        raise ValueError(f"batched_gemm: out_dtype={out_dtype} is not taken "
                         "for bfloat16 operands; want None or bfloat16")
    if a.device.type == "cpu":
        return batched_gemm_plain(a, b, epilogue, bias, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"batched_gemm: unsupported device {a.device}")
    relu = check_epilogue(epilogue, bias)
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"batched_gemm wants 3-D operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    g, m, k = (int(d) for d in a.shape)
    n = int(b.shape[2])
    check_operand("a", a, a.device, (g, m, k), a.dtype)
    check_operand("b", b, a.device, (g, k, n), a.dtype)
    if bias is not None and not epilogue.startswith("bias"):
        bias = None
    if bias is not None:
        check_operand("bias", bias, a.device, (n,), a.dtype)
    if min(g, m, n, k) < 1:
        raise ValueError(f"batched_gemm: empty operand G={g} M={m} N={n} "
                         f"K={k}")
    tile_m, tile_n = kernel_tile(bm, bn, m, n)
    if -(-m // tile_m) > _MAX_GRID_Y or g > _MAX_GRID_Y:
        raise ValueError(f"batched_gemm: G={g} M={m} exceeds the launch grid")
    out = torch.empty((g, m, n), device=a.device, dtype=out_dtype)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    bias_ptr = None if bias is None else bias.data_ptr()
    if a.dtype == torch.bfloat16:
        kern = (BATCHED_GEMM_BF16 if wgmma_path(a, b, n, k)
                else BATCHED_GEMM_BF16_MMA)
        with torch.cuda.device(a.device):
            kern.launch(a.data_ptr(), b.data_ptr(), bias_ptr, out.data_ptr(),
                        g, m, n, k, tile_m, tile_n, int(relu), stream)
        return out
    with torch.cuda.device(a.device):
        BATCHED_GEMM.launch(a.data_ptr(), b.data_ptr(), bias_ptr,
                            out.data_ptr(), g, m, n, k, tile_m, tile_n,
                            int(relu), b_vector_path(b, n),
                            int(out_dtype == torch.bfloat16), stream)
    return out
