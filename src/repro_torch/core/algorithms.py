"""Convolution algorithm space (§2.1): im2col, kn2row, Winograd F(m,r).

Each algorithm turns a CONV layer into one or more GEMMs; this module captures
(a) which algorithms are applicable to a given layer, (b) the GEMM dimensions
each induces (Eq. 10-12), and (c) the tensor layouts they consume/produce
(§3.3 — needed for the transition matrices).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Optional, Tuple

from repro_torch.core.graph import ConvMeta


class AlgoFamily(enum.Enum):
    IM2COL = "im2col"
    KN2ROW = "kn2row"
    WINOGRAD = "winograd"


class Layout(enum.Enum):
    """Tensor layouts of §3.3 (Table 1)."""
    TOEPLITZ = "toeplitz"       # im2col input
    TENSOR3D = "tensor3d"       # im2col/kn2row output, kn2row input
    WINOGRAD = "winograd"       # scattered (m+r-1)^2 tile layout


@dataclasses.dataclass(frozen=True)
class Algorithm:
    family: AlgoFamily
    m: int = 0   # Winograd output tile
    r: int = 0   # Winograd kernel tile

    def __str__(self) -> str:
        if self.family is AlgoFamily.WINOGRAD:
            return f"winograd(F{self.m}x{self.r})"
        return self.family.value

    @property
    def key(self) -> str:
        return str(self)

    # ------------------------------------------------------------- layouts
    @property
    def input_layout(self) -> Layout:
        return {
            AlgoFamily.IM2COL: Layout.TOEPLITZ,
            AlgoFamily.KN2ROW: Layout.TENSOR3D,
            AlgoFamily.WINOGRAD: Layout.WINOGRAD,
        }[self.family]

    @property
    def output_layout(self) -> Layout:
        # im2col and kn2row both emit the spatial 3D-tensor layout (§3.3);
        # Winograd emits the scattered tile layout.
        if self.family is AlgoFamily.WINOGRAD:
            return Layout.WINOGRAD
        return Layout.TENSOR3D

    # ------------------------------------------------------- applicability
    def applicable(self, conv: ConvMeta) -> bool:
        if self.family is AlgoFamily.WINOGRAD:
            # Paper §6.1.2: Winograd applied on layers with square-shaped
            # kernels; F(m,r) needs stride 1. Kernels wider than r run in
            # ceil(K1K2/r^2) rounds of r×r sub-kernels; kernels *smaller*
            # than r would be zero-padded up to r, wasting multiplies with
            # no accuracy in the cost model — so the menu requires K ≥ r.
            return (conv.k1 == conv.k2 and conv.k1 >= self.r
                    and conv.stride == 1)
        if self.family is AlgoFamily.KN2ROW:
            # kn2row decomposes into K1K2 unit convs; stride>1 handled by
            # strided sampling of the accumulate phase — supported.
            return True
        return True   # im2col is universal

    # --------------------------------------------------------- GEMM shapes
    def gemm_calls(self, conv: ConvMeta) -> List[Tuple[int, int, int]]:
        """The (a, b, c) = (rows(X), depth, cols(W)) GEMM dims induced.

        im2col   (Eq. 2/10):  one GEMM   (O1O2, K1K2*Cin, Cout)
        kn2row   (Eq. 3/11):  K1K2 GEMMs (O1O2, Cin, Cout)
        winograd (Eq. 6/12):  rounds*(m+r-1)^2 GEMMs (H1H2/m^2, Cin, Cout)
        """
        if self.family is AlgoFamily.IM2COL:
            return [(conv.o1 * conv.o2, conv.k1 * conv.k2 * conv.c_in, conv.c_out)]
        if self.family is AlgoFamily.KN2ROW:
            return [(conv.o1 * conv.o2, conv.c_in, conv.c_out)] * (conv.k1 * conv.k2)
        # Winograd: tiles over the *input* map (paper Eq. 12 uses H1H2/m^2).
        tiles = math.ceil(conv.h1 / self.m) * math.ceil(conv.h2 / self.m)
        rounds = math.ceil((conv.k1 * conv.k2) / (self.r * self.r))
        n_gemms = rounds * (self.m + self.r - 1) ** 2
        return [(tiles, conv.c_in, conv.c_out)] * n_gemms

    def multiplies(self, conv: ConvMeta) -> int:
        """Total MXU multiplies under this algorithm (complexity trade-off
        of §2.1: Winograd reduces multiplies, im2col/kn2row match spatial)."""
        return sum(a * b * c for (a, b, c) in self.gemm_calls(conv))


# Default algorithm menu — the paper's three families with the Winograd
# hyper-parameters it evaluates (m=2, r=3) plus the F(4,3) variant discussed
# in §2.1 ("F(4x4, 3x3) ... reduction of multiplications is 4 times").
IM2COL = Algorithm(AlgoFamily.IM2COL)
KN2ROW = Algorithm(AlgoFamily.KN2ROW)
WINO_2_3 = Algorithm(AlgoFamily.WINOGRAD, m=2, r=3)
WINO_4_3 = Algorithm(AlgoFamily.WINOGRAD, m=4, r=3)

DEFAULT_MENU: List[Algorithm] = [IM2COL, KN2ROW, WINO_2_3, WINO_4_3]
PAPER_MENU: List[Algorithm] = [IM2COL, KN2ROW, WINO_2_3]


def menu_for(conv: ConvMeta,
             menu: Optional[List[Algorithm]] = None) -> List[Algorithm]:
    menu = DEFAULT_MENU if menu is None else menu
    out = [a for a in menu if a.applicable(conv)]
    if not out:
        raise ValueError(f"no applicable algorithm for conv {conv}")
    return out
