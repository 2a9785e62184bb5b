"""Public GEMM wrappers: dataflow → block-dim binding (Eq. 9) and the
matched-Toeplitz conv leg."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.cost_model import Dataflow
from repro_torch.kernels.gemm.gemm import gemm_call

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
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = epilogue(A @ B [+ bias]) on the dataflow-switchable Computing
    Unit; the epilogue is fused into the kernel's output flush. The
    binding picks the kernel's tile, never the math."""
    bm, bn, _ = dataflow_blocks(dataflow, p1, p2)
    return gemm_call(a, b, bm=bm, bn=bn, epilogue=epilogue, bias=bias)


def toeplitz_gemm(t: torch.Tensor, w2d: torch.Tensor, spec,
                  dataflow: Dataflow = Dataflow.NS,
                  p1: int = 128, p2: int = 128,
                  epilogue: str = "none",
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Matched-layout conv leg: a consumer whose edge already carries its
    Toeplitz matrix (``core.layouts.LayoutSpec`` kind "toeplitz") feeds
    the GEMM unit directly — Table 2's streaming Load(n, n), no window
    re-gather. ``t``: (O1·O2, K1K2·Cin) or batched (B, …); ``w2d``:
    (K1K2·Cin, Cout) → (…, O1, O2, Cout). The weight is shared, so the
    batch folds into M: one launch per layer per forward."""
    lead = t.shape[:-2]
    out = gemm(t.reshape(-1, t.shape[-1]).contiguous(), w2d.contiguous(),
               dataflow, p1, p2, epilogue=epilogue, bias=bias)
    return out.reshape(*lead, spec.o1, spec.o2, w2d.shape[1])
