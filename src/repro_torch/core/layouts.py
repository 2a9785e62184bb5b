"""DRAM store-format specs for inter-layer layout transitions (§3.3/§5.1).

DYNAMAP's cost graph prices every edge with a Table 2 store+load matrix and
lets split vertices pick one DRAM layout per fan-out. Until now those
choices were cost-model-only; this module is the metadata half of making
them *executable*: a ``LayoutSpec`` names the concrete tensor representation
an edge carries between two layers, pinned to the consumer's conv geometry
(a Toeplitz matrix is only meaningful for a specific (K, stride, padding)).

The three kinds mirror ``core.algorithms.Layout`` (Table 1):

* ``nhwc``     — the spatial 3-D tensor (TENSOR3D); the universal
  interchange format every kernel can produce and consume.
* ``toeplitz`` — the im2col matrix ``(O1·O2, K1·K2·C)`` of the consumer's
  conv (TOEPLITZ); a matched consumer feeds it straight to the GEMM unit.
* ``winograd`` — the scattered tile layout: overlapping (m+r-1)² input
  tiles ``(tiles, T, T, C)`` of the consumer's F(m,r) conv (WINOGRAD);
  a matched consumer skips the spatial re-gather and transforms tiles
  directly.

``repro_torch.kernels.layouts`` holds the runtime (torch) conversions; this
module stays import-light so the mapper can build transition specs without
pulling in torch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.algorithms import Algorithm, AlgoFamily, Layout
from repro_torch.core.graph import ConvMeta

LAYOUT_KINDS = ("nhwc", "toeplitz", "winograd")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class LayoutSpec:
    """One concrete inter-layer tensor representation.

    ``(h, w, c)`` is the producer's NHWC output shape — the shape the spec
    converts from and restores to. ``k1/k2/stride/padding`` pin the
    consumer conv geometry for ``toeplitz``; ``m/r`` additionally pin the
    Winograd tile size for ``winograd`` (where ``k1 == k2 == r``: only
    single-round F(m,r) layers consume tiles directly). Frozen and hashable
    so specs ride inside ``ConvLowering`` as jit-static arguments.
    """
    kind: str = "nhwc"
    h: int = 0
    w: int = 0
    c: int = 0
    k1: int = 0
    k2: int = 0
    stride: int = 1
    padding: str = "SAME"
    m: int = 0
    r: int = 0

    def __post_init__(self) -> None:
        if self.kind not in LAYOUT_KINDS:
            raise ValueError(
                f"unknown layout kind {self.kind!r}; want one of {LAYOUT_KINDS}")
        if self.padding not in ("SAME", "VALID"):
            raise ValueError(f"bad padding {self.padding!r}; want SAME|VALID")
        if self.kind != "nhwc":
            if min(self.h, self.w, self.c, self.k1, self.k2) <= 0:
                raise ValueError(f"{self.kind} spec needs positive geometry, "
                                 f"got {self}")
            if self.stride < 1:
                raise ValueError(f"bad stride {self.stride} in {self}")
        if self.kind == "winograd":
            if self.m <= 0 or self.r <= 0:
                raise ValueError(f"winograd spec needs m, r > 0, got {self}")
            if self.k1 != self.r or self.k2 != self.r or self.stride != 1:
                raise ValueError(
                    "winograd tile layout is single-round only "
                    f"(k1 == k2 == r, stride 1), got {self}")

    # ----------------------------------------------------- derived geometry
    @property
    def o1(self) -> int:
        if self.padding == "SAME":
            return _ceil(self.h, self.stride)
        return (self.h - self.k1) // self.stride + 1

    @property
    def o2(self) -> int:
        if self.padding == "SAME":
            return _ceil(self.w, self.stride)
        return (self.w - self.k2) // self.stride + 1

    @property
    def t(self) -> int:
        return self.m + self.r - 1

    @property
    def tiles_y(self) -> int:
        return _ceil(self.o1, self.m)

    @property
    def tiles_x(self) -> int:
        return _ceil(self.o2, self.m)

    @property
    def pad_top(self) -> int:
        if self.padding == "VALID":
            return 0
        if self.kind == "winograd":
            return (self.r - 1) // 2
        ph = max((self.o1 - 1) * self.stride + self.k1 - self.h, 0)
        return ph // 2

    @property
    def pad_left(self) -> int:
        if self.padding == "VALID":
            return 0
        if self.kind == "winograd":
            return (self.r - 1) // 2
        pw = max((self.o2 - 1) * self.stride + self.k2 - self.w, 0)
        return pw // 2

    @property
    def base_rank(self) -> int:
        """Rank of one un-batched value in this layout (a leading batch dim
        adds one): nhwc (H, W, C); toeplitz (O1O2, K1K2C); winograd
        (tiles, T, T, C)."""
        return {"nhwc": 3, "toeplitz": 2, "winograd": 4}[self.kind]

    @property
    def layout(self) -> Layout:
        """The §3.3 Layout this spec realizes (cost-model pairing)."""
        return {"nhwc": Layout.TENSOR3D, "toeplitz": Layout.TOEPLITZ,
                "winograd": Layout.WINOGRAD}[self.kind]

    @property
    def key(self) -> str:
        if self.kind == "nhwc":
            return "nhwc"
        if self.kind == "toeplitz":
            return (f"toeplitz[k{self.k1}x{self.k2}s{self.stride}"
                    f"_{self.h}x{self.w}x{self.c}]")
        return f"winograd[F{self.m}x{self.r}_{self.h}x{self.w}x{self.c}]"


NHWC = LayoutSpec()


def is_nhwc(spec: Optional[LayoutSpec]) -> bool:
    return spec is None or spec.kind == "nhwc"


def invertible(spec: LayoutSpec) -> bool:
    """Can NHWC be recovered exactly from this layout?

    Needed wherever another consumer of the same stored value wants a
    different representation (the Table 2 "converting load"). Winograd
    tiles overlap, so every padded pixel survives; a Toeplitz matrix drops
    pixels when windows skip them (stride > kernel) or when VALID windows
    do not cover the input.
    """
    if spec.kind in ("nhwc", "winograd"):
        return True
    if spec.stride > min(spec.k1, spec.k2):
        return False
    if spec.padding == "VALID":
        return ((spec.o1 - 1) * spec.stride + spec.k1 >= spec.h
                and (spec.o2 - 1) * spec.stride + spec.k2 >= spec.w)
    return True


def consumer_spec(algo: Algorithm, conv: ConvMeta) -> Optional[LayoutSpec]:
    """The store format a conv layer running ``algo`` consumes directly —
    the matched-load format of Table 2 — or None when the layer cannot
    consume anything but NHWC (then the edge keeps the round trip).

    kn2row's input layout IS the 3-D tensor, so it "matches" trivially;
    im2col consumes its own Toeplitz matrix; a single-round F(m,r) layer
    (square K == r, stride 1) consumes its pre-gathered tile layout.
    Non-invertible Toeplitz geometries are rejected so a stored format can
    always serve a mismatched sibling at a split via a converting load.
    """
    pad = "SAME" if conv.pad == "same" else "VALID"
    if algo.family is AlgoFamily.KN2ROW:
        return NHWC
    if algo.family is AlgoFamily.IM2COL:
        spec = LayoutSpec("toeplitz", h=conv.h1, w=conv.h2, c=conv.c_in,
                          k1=conv.k1, k2=conv.k2, stride=conv.stride,
                          padding=pad)
        return spec if invertible(spec) else None
    # Winograd: tile layout only for the single-round fast path.
    if conv.k1 != conv.k2 or conv.k1 != algo.r or conv.stride != 1:
        return None
    return LayoutSpec("winograd", h=conv.h1, w=conv.h2, c=conv.c_in,
                      k1=conv.k1, k2=conv.k2, stride=1, padding=pad,
                      m=algo.m, r=algo.r)
