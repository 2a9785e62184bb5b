"""Shared helpers for the kernels: epilogues, int8 primitives, SAME
padding and the device rule."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F


# Post-GEMM epilogues the Computing Unit can fuse into a kernel's output
# flush (§3's in-pipeline auxiliary units: the conv output streams through
# ReLU/bias without a DRAM round trip). "none" is the identity.
EPILOGUES = ("none", "relu", "bias", "bias_relu")

# Symmetric int8: zero-point 0, range [-127, 127] (−128 excluded so the
# range is sign-symmetric and |q|·|q| accumulation bounds stay tight).
INT8_MAX = 127
_SCALE_EPS = 1e-12

# Per-layer precisions the mapper can assign. Winograd is bf16-only.
PRECISIONS = ("bf16", "int8")

# The operand dtypes each kernel wrapper takes (the dtype of its first
# operand): a wrapper raises ``TypeError`` for any other, on every device,
# before it picks the kernel or its plain version, so no operand of
# another dtype ever reaches a kernel's buffers. Every kernel takes the
# dtypes the reference's counterpart takes: f32 and bf16 everywhere, int8
# (int32 partials for pad_accumulate) where the reference has an int8 path.
KERNEL_DTYPES = {
    "gemm": (torch.float32, torch.bfloat16, torch.int8),
    "conv_im2col": (torch.float32, torch.bfloat16, torch.int8),
    "batched_gemm": (torch.float32, torch.bfloat16),
    "unit_conv_gemms": (torch.float32, torch.bfloat16, torch.int8),
    "pad_accumulate": (torch.float32, torch.bfloat16, torch.int32),
    "input_transform": (torch.float32, torch.bfloat16),
    "input_transform_tiles": (torch.float32, torch.bfloat16),
    "output_transform": (torch.float32, torch.bfloat16),
}


def check_kernel_dtype(kernel: str, t: torch.Tensor) -> None:
    """Raise ``TypeError`` unless ``t``'s dtype is one ``kernel`` takes
    (``KERNEL_DTYPES``)."""
    allowed = KERNEL_DTYPES[kernel]
    if t.dtype not in allowed:
        names = ", ".join(str(d).replace("torch.", "") for d in allowed)
        raise TypeError(f"{kernel}: operands of dtype {t.dtype} have no "
                        f"kernel; it takes {names}")


def resolve_device(device) -> torch.device:
    """The device rule of every entry point: a CUDA device is used only
    when one is present — asking for it without one raises; nothing ever
    carries on on the CPU unless the caller asked for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain versions")
    return dev


def device_guard(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device with an index, so
    the launches, copies, replays and events entered under it go to that
    card's current stream; a no-op for the CPU and for a bare ``"cuda"``
    (the current card already)."""
    if device.type == "cuda" and device.index is not None:
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def unbatched_rank(in_layout) -> int:
    """Rank of one un-batched input in ``in_layout`` (a
    ``core.layouts.LayoutSpec`` or None = NHWC): one more is a batch."""
    if in_layout is None or in_layout.kind == "nhwc":
        return 3
    return in_layout.base_rank


def apply_epilogue(y: torch.Tensor, epilogue: str,
                   bias: Optional[torch.Tensor] = None, *,
                   scale: Optional[torch.Tensor] = None,
                   out_scale: Optional[float] = None) -> torch.Tensor:
    """Apply a named epilogue; ``bias`` broadcasts over the minor dim.

    Quantized variants: ``scale`` dequantizes an integer accumulator to
    f32 *before* bias/relu; ``out_scale`` requantizes the result to int8
    *after* bias/relu. A bf16 ``y`` is worked in f32 (bias widened, ReLU)
    and cast back once, rounding to nearest even, as the reference's
    kernels flush their f32 accumulator (``.astype(o_ref.dtype)``)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; want {EPILOGUES}")
    if y.dtype == torch.bfloat16 and scale is None:
        out = apply_epilogue(y.to(torch.float32), epilogue, bias,
                             out_scale=out_scale)
        return out if out_scale is not None else out.to(torch.bfloat16)
    if scale is not None:
        y = y.to(torch.float32) * scale
    if epilogue.startswith("bias"):
        if bias is None:
            raise ValueError(f"epilogue {epilogue!r} needs a bias array")
        y = y + bias.to(y.dtype)
    if epilogue.endswith("relu"):
        y = torch.clamp_min(y, 0)
    if out_scale is not None:
        y = requantize(y, out_scale)
    return y


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """f32 → symmetric int8 (round to nearest even, saturate at ±127).

    The division is IEEE f32 division on every device, as the int8
    kernels' flush computes it: a Python ``scale`` becomes a 0-dim tensor
    on ``x``'s device first, because CUDA torch divides by a host scalar
    as a multiply by its reciprocal."""
    if not torch.is_tensor(scale):
        scale = torch.full((), float(scale), dtype=torch.float32,
                           device=x.device)
    q = torch.round(x.to(torch.float32) / scale)
    return torch.clamp(q, -INT8_MAX, INT8_MAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    """int8 (or int32 accumulator) → f32: multiply by the scale."""
    return q.to(torch.float32) * scale


def requantize(y: torch.Tensor, out_scale: float) -> torch.Tensor:
    """f32 epilogue output → int8 at the consumer's activation scale."""
    return quantize(y, out_scale)


def weight_scales(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric scales for a weight whose LAST axis is
    the output channel. Returns an f32 vector of shape (Cout,)."""
    amax = torch.amax(torch.abs(w.to(torch.float32)),
                      dim=tuple(range(w.ndim - 1)))
    return torch.clamp_min(amax, _SCALE_EPS) / INT8_MAX


# |sum| ≤ K·127² must fit int32: the deepest K an int8 product may have.
INT8_MAX_K = (2 ** 31 - 1) // (INT8_MAX * INT8_MAX)


def check_int8_depth(name: str, k: int) -> None:
    """Raise when a K-deep int8 product could overflow its int32 sum."""
    if k > INT8_MAX_K:
        raise ValueError(f"{name}: K={k} exceeds {INT8_MAX_K}, the deepest "
                         "int8 product whose int32 sum cannot overflow")


def int8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 operands as its exact int32 sums, in plain torch:
    CPU torch multiplies int8 in int8 (wrapping) and CUDA torch has no
    integer matmul, so both widen to float64, exact while |sum| < 2^53."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def same_pads(size: int, k: int, stride: int):
    """(output size, pad before, pad after) of SAME padding — the
    asymmetric split XLA uses: the larger half goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, total // 2, total - total // 2


def pad_nhwc(x: torch.Tensor, top: int, bottom: int, left: int, right: int,
             value: float = 0.0) -> torch.Tensor:
    """Pad the H and W dims of an (…, H, W, C) tensor."""
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)
