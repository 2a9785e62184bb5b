"""Public GEMM wrappers: dataflow → block-dim binding (Eq. 9), the
matched-Toeplitz conv leg and Winograd's batched transform-space GEMM."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.cost_model import Dataflow
from repro_torch.kernels.gemm.gemm import batched_gemm_call, gemm_call

_STREAM_TILE = 128   # granularity of the streamed dim (the reference's MXU)


def dataflow_blocks(dataflow: Dataflow, p1: int, p2: int
                    ) -> Tuple[int, int, int]:
    """(bm, bn, bk) binding for a given dataflow — §3.2 mapping.

    NS: (a→p1, c→p2) ⇒ blocks on (M, N), K streams at 128.
    WS: (b→p1, c→p2) ⇒ blocks on (K, N), M streams at 128.
    IS: (b→p1, a→p2) ⇒ blocks on (K, M), N streams at 128.
    """
    if dataflow is Dataflow.NS:
        return p1, p2, _STREAM_TILE
    if dataflow is Dataflow.WS:
        return _STREAM_TILE, p2, p1
    return p2, _STREAM_TILE, p1


def gemm(a: torch.Tensor, b: torch.Tensor,
         dataflow: Dataflow = Dataflow.NS,
         p1: int = 128, p2: int = 128,
         epilogue: str = "none",
         bias: Optional[torch.Tensor] = None,
         scale: Optional[torch.Tensor] = None,
         out_scale: Optional[float] = None,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = epilogue(A @ B [+ bias]) on the dataflow-switchable Computing
    Unit; the epilogue is fused into the kernel's output flush. The
    binding picks the kernel's tile, never the math.

    Int8 operands accumulate in int32; ``scale`` ((N,) per-output-channel
    dequant factors) and ``out_scale`` (requantize to int8) ride the same
    fused flush as bias/relu. ``out_dtype`` is the reference's: None
    stores C in the operands' dtype (f32 for int8 operands, int8 under
    ``out_scale``); f32 and bf16 operands take f32 or bf16, rounded once
    in the flush; other values raise (``gemm.gemm_out_dtype``)."""
    bm, bn, _ = dataflow_blocks(dataflow, p1, p2)
    return gemm_call(a, b, bm=bm, bn=bn, epilogue=epilogue, bias=bias,
                     scale=scale, out_scale=out_scale, out_dtype=out_dtype)


def toeplitz_gemm(t: torch.Tensor, w2d: torch.Tensor, spec,
                  dataflow: Dataflow = Dataflow.NS,
                  p1: int = 128, p2: int = 128,
                  epilogue: str = "none",
                  bias: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None,
                  out_scale: Optional[float] = None) -> torch.Tensor:
    """Matched-layout conv leg: a consumer whose edge already carries its
    Toeplitz matrix (``core.layouts.LayoutSpec`` kind "toeplitz") feeds
    the GEMM unit directly — Table 2's streaming Load(n, n), no window
    re-gather. ``t``: (O1·O2, K1K2·Cin) or batched (B, …); ``w2d``:
    (K1K2·Cin, Cout) → (…, O1, O2, Cout). The weight is shared, so the
    batch folds into M: one launch per layer per forward. Int8 ``t`` and
    ``w2d`` take ``scale``/``out_scale`` as ``gemm`` does."""
    lead = t.shape[:-2]
    out = gemm(t.reshape(-1, t.shape[-1]).contiguous(), w2d.contiguous(),
               dataflow, p1, p2, epilogue=epilogue, bias=bias, scale=scale,
               out_scale=out_scale)
    return out.reshape(*lead, spec.o1, spec.o2, w2d.shape[1])


def batched_gemm(a: torch.Tensor, b: torch.Tensor,
                 dataflow: Dataflow = Dataflow.NS,
                 p1: int = 128, p2: int = 128,
                 epilogue: str = "none",
                 bias: Optional[torch.Tensor] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[g] = epilogue(A[g] @ B[g] [+ bias]) — Winograd's (m+r−1)²
    transform-space products (Eq. 6) under the plan's block binding.
    Unlike the reference, nothing is padded or cropped: the kernel masks
    ragged edges. f32 operands take ``out_dtype`` None (f32) or bf16,
    rounded once in the flush; bf16 operands (a bf16 bias) sum in f32 and
    store bf16, rounded once (``out_dtype`` None or bf16)."""
    bm, bn, _ = dataflow_blocks(dataflow, p1, p2)
    return batched_gemm_call(a, b, bm=bm, bn=bn, epilogue=epilogue,
                             bias=bias, out_dtype=out_dtype)
