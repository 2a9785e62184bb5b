"""TPU-adapted DYNAMAP cost model (paper Eq. 9-13, Table 2).

The paper models per-layer execution cycles on a P_SA1×P_SA2 systolic array
(Eq. 9) plus DRAM layout-transition latencies (Table 2, burst-wastage f of
Eq. 13). The TPU adaptation keeps every functional form and re-grounds the
constants:

* The "systolic array" is the virtual array realized by one Pallas GEMM
  block (BM×BN); a step of that array retires BM·BN MACs. Converting steps
  to seconds uses the chip's peak MAC rate, so perfect tiling ⇒ roofline
  compute time, and ceil-division padding reproduces the paper's
  effective-PE-utilization losses (Eq. 14) exactly.
* DDR bandwidth → HBM bandwidth (819 GB/s); the burst-length wastage f()
  becomes the lane-alignment penalty: arrays whose minor dim < 128 lanes
  waste the padded fraction of each VREG-granular transfer.
* The Winograd linear-transform overhead LT runs on the VPU, not the MXU.
* Collective terms (for sharded execution) use the ICI link bandwidth; the
  CNN-side model is single-chip (latency-oriented, batch=1, like the paper).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.algorithms import (Algorithm, AlgoFamily, Layout)
from repro_torch.core.graph import ConvMeta


# ---------------------------------------------------------------------------
# Hardware description (FPGA device meta data → TPU chip meta data).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPUSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9               # bytes/s
    ici_bw: float = 50e9                # bytes/s per link (~3 links/axis usable)
    vmem_bytes: int = 64 * 2 ** 20      # usable VMEM working set per core
    vmem_budget: int = 48 * 2 ** 20     # budget the DSE may claim for GEMM blocks
    mxu: int = 128                      # MXU systolic dimension / lane count
    sublane: int = 8
    vpu_flops: float = 3.9e12           # vector unit, for Winograd transforms
    dtype_bytes: int = 2                # bf16 default; 1 for the paper's int8

    @property
    def peak_macs(self) -> float:
        return self.peak_flops / 2.0


V5E = TPUSpec()
V5E_INT8 = dataclasses.replace(V5E, dtype_bytes=1, peak_flops=394e12,
                               name="tpu-v5e-int8")

# An Alveo-U200-like device (the paper's board) expressed in the same spec:
# 6084 DSPs × 286 MHz × 2 ops ≈ 3.48 TOP/s int8; DDR4 ≈ 19.2 GB/s effective;
# ~4 MB usable on-chip buffering; 64-wide bursts. Used by the benchmarks to
# validate the paper's *own* trade-offs (Table 4 direction) — on this spec
# the FPGA-regime algorithm mixes re-appear.
FPGA_LIKE = TPUSpec(name="alveo-u200-like", peak_flops=3.48e12,
                    hbm_bw=19.2e9, ici_bw=0.0, vmem_bytes=6 * 2 ** 20,
                    vmem_budget=4 * 2 ** 20, mxu=64, sublane=8,
                    vpu_flops=0.2e12, dtype_bytes=1)


class Dataflow(enum.Enum):
    """§3.2: Non-Stationary / Weight-Stationary / Input-Stationary."""
    NS = "NS"
    WS = "WS"
    IS = "IS"


ALL_DATAFLOWS = (Dataflow.NS, Dataflow.WS, Dataflow.IS)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Eq. 9 — GEMM steps on the (virtual) systolic array.
# ---------------------------------------------------------------------------

def gemm_steps(a: int, b: int, c: int, p1: int, p2: int,
               dataflow: Dataflow, i_sa: Optional[int] = None) -> int:
    """Cycle count of a (a,b)x(b,c) GEMM on a p1×p2 array under ``dataflow``.

    Verbatim Eq. 9; I_SA is the one-time initialization overhead which the
    stall-free PE optimizations (§3.2) reduce to a single occurrence.
    """
    if i_sa is None:
        i_sa = max(p1, p2)
    if dataflow is Dataflow.NS:
        return _ceil(a, p1) * _ceil(c, p2) * b + i_sa
    if dataflow is Dataflow.WS:
        return _ceil(b, p1) * _ceil(c, p2) * a + i_sa
    return _ceil(b, p1) * _ceil(a, p2) * c + i_sa


def best_dataflow(a: int, b: int, c: int, p1: int, p2: int) -> Tuple[Dataflow, int]:
    """argmin over Eq. 9 — line 7-8 of Algorithm 1."""
    best = None
    for df in ALL_DATAFLOWS:
        s = gemm_steps(a, b, c, p1, p2, df)
        if best is None or s < best[1]:
            best = (df, s)
    return best


def gemm_utilization(a: int, b: int, c: int, p1: int, p2: int,
                     dataflow: Dataflow) -> float:
    """Effective PE utilization μ of Eq. 14 for one GEMM."""
    steps = gemm_steps(a, b, c, p1, p2, dataflow, i_sa=0)
    return (a * b * c) / (steps * p1 * p2)


# ---------------------------------------------------------------------------
# Per-layer node costs (Eq. 10-12) in seconds.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NodeCost:
    """Decomposed per-layer cost; ``total`` is what enters the PBQP node
    cost vector."""
    compute_s: float          # MXU time (Eq. 9 steps → seconds)
    transform_s: float        # Winograd LT / kn2row pad-accumulate (VPU)
    memory_s: float           # HBM traffic incl. operand re-fetch
    dataflow: Dataflow
    steps: int
    utilization: float

    @property
    def total(self) -> float:
        # HBM streaming overlaps MXU compute on TPU (double-buffered DMA),
        # so the layer is bound by the slower of the two; the VPU transform
        # stage is pipelined with GEMM but its residual exposed cost is
        # modeled additively (paper adds LT inside Eq. 12 the same way).
        return max(self.compute_s, self.memory_s) + self.transform_s


# Per-tile instruction counts of the Winograd data / inverse transforms
# (Lavin & Gray §5; the paper exploits the same ±1, ±1/2 structure as
# shift-adds). Fallback: dense 2×(t×t) constant matmuls.
_WINO_XFORM_OPS = {
    (2, 3): (32, 24),       # F(2x2, 3x3): data 32 ops, inverse 24 ops
    (4, 3): (156, 90),      # F(4x4, 3x3)
}


def _winograd_transform_flops(conv: ConvMeta, m: int, r: int) -> float:
    """Add/shift ops of the B^T d B, A^T M A transforms (G g G^T is
    precomputed once per model and amortized, as in the paper §3.1)."""
    t = m + r - 1
    tiles = math.ceil(conv.h1 / m) * math.ceil(conv.h2 / m)
    rounds = math.ceil((conv.k1 * conv.k2) / (r * r))
    if (m, r) in _WINO_XFORM_OPS:
        per_tile_in, per_tile_out = _WINO_XFORM_OPS[(m, r)]
    else:
        per_tile_in = 2 * (2 * t ** 3)
        per_tile_out = 2 * (2 * t * t * m + 2 * t * m * m)
    return float(rounds) * (tiles * conv.c_in * per_tile_in
                            + tiles * conv.c_out * per_tile_out)


def gemm_hbm_bytes(a: int, b: int, c: int, p1: int, p2: int,
                   dataflow: Dataflow, spec: TPUSpec) -> float:
    """HBM traffic of a tiled GEMM, including operand re-fetch.

    This is the TPU-side counterpart of Eq. 9: block shape determines how
    often each operand panel streams from HBM. Operands that fit whole in
    the VMEM budget are counted once (they stay resident — the FPGA design's
    on-chip Input/Kernel buffers).
    """
    dt = spec.dtype_bytes
    a_bytes, b_bytes, c_bytes = a * b * dt, b * c * dt, a * c * dt
    budget = spec.vmem_budget

    if dataflow is Dataflow.NS:
        # Output-stationary: A row-panels refetched per N-tile, B column-
        # panels refetched per M-tile, C written once.
        ra, rb, rc = _ceil(c, p2), _ceil(a, p1), 1
    elif dataflow is Dataflow.WS:
        # Weight block (K×N tile) resident; A streamed per (K,N) block-row;
        # partial C revisited once per K-tile.
        ra, rb = _ceil(c, p2), 1
        rc = 2 * _ceil(b, p1) - 1
    else:  # IS
        ra, rb = 1, _ceil(a, p2)
        rc = 2 * _ceil(b, p1) - 1

    total = 0.0
    total += a_bytes if a_bytes <= budget else ra * a_bytes
    total += b_bytes if b_bytes <= budget else rb * b_bytes
    total += c_bytes if c_bytes <= budget else rc * c_bytes
    return total


def node_cost(conv: ConvMeta, algo: Algorithm, p1: int, p2: int,
              dataflow: Optional[Dataflow] = None,
              spec: TPUSpec = V5E) -> NodeCost:
    """Latency of executing one CONV layer under (algorithm, dataflow).

    Eq. 10 (im2col), Eq. 11 (kn2row ×K1K2), Eq. 12 (winograd ×(m+r-1)^2
    with LT overhead); cycles/FREQ → steps·(p1·p2)/peak_macs.
    """
    calls = algo.gemm_calls(conv)
    # All calls in one layer share dims, so pick the dataflow once (§5.2).
    a, b, c = calls[0]
    n_calls = len(calls)
    if dataflow is None:
        dataflow, _ = best_dataflow(a, b, c, p1, p2)
    # I_SA is paid once per *layer* thanks to the stall-free PE design; the
    # per-pass overheads are overlapped (§3.2).
    steps = n_calls * gemm_steps(a, b, c, p1, p2, dataflow, i_sa=0)
    steps += max(p1, p2)
    compute_s = steps * (p1 * p2) / spec.peak_macs

    transform_s = 0.0
    if algo.family is AlgoFamily.WINOGRAD:
        transform_s = _winograd_transform_flops(conv, algo.m, algo.r) / spec.vpu_flops
    elif algo.family is AlgoFamily.KN2ROW:
        # Pad-and-Accumulate: K1K2·O1O2·Cout adds, pipelined with GEMM
        # (§3.1) — residual exposed cost modeled on the VPU.
        transform_s = (conv.k1 * conv.k2 * conv.o1 * conv.o2 * conv.c_out
                       ) / spec.vpu_flops

    # HBM traffic: every GEMM call streams its operands (with re-fetch per
    # the block shape); kn2row re-reads the input map per unit conv only if
    # it cannot stay VMEM-resident (the kernel keeps it resident — mirrored
    # here), and Winograd streams the transform-space tiles.
    if algo.family is AlgoFamily.KN2ROW:
        in_bytes = a * b * spec.dtype_bytes
        if in_bytes > spec.vmem_budget:
            mem_bytes = n_calls * gemm_hbm_bytes(a, b, c, p1, p2, dataflow,
                                                 spec)
        else:
            mem_bytes = (gemm_hbm_bytes(a, b, c, p1, p2, dataflow, spec)
                         + (n_calls - 1) * (b * c + a * c) * spec.dtype_bytes)
    else:
        mem_bytes = n_calls * gemm_hbm_bytes(a, b, c, p1, p2, dataflow, spec)
    memory_s = mem_bytes / spec.hbm_bw

    total_macs = n_calls * a * b * c
    util = total_macs / (steps * p1 * p2) if steps else 0.0
    return NodeCost(compute_s=compute_s, transform_s=transform_s,
                    memory_s=memory_s, dataflow=dataflow,
                    steps=steps, utilization=util)


# ---------------------------------------------------------------------------
# Eq. 13 — bandwidth wastage. DDR burst-length → TPU lane alignment.
# ---------------------------------------------------------------------------

def eff_bandwidth(spec: TPUSpec, minor_dim: int) -> float:
    """f(BW, C): transfers whose minor dimension underfills the 128-lane
    VREG granularity waste the padded fraction (Eq. 13's shape, re-grounded)."""
    if minor_dim >= spec.mxu:
        return spec.hbm_bw
    padded = spec.mxu
    return spec.hbm_bw * (minor_dim / padded)


# ---------------------------------------------------------------------------
# Table 2 — layout-transition (store + load) latencies between layers.
# ---------------------------------------------------------------------------

def _store_bytes(src: Algorithm, dst: Algorithm, nxt: ConvMeta,
                 c_out_prev: int, spec: TPUSpec,
                 implicit_im2col: bool = False) -> Tuple[float, float]:
    """Bytes written for the AF_i → AF_{i+1} store and the effective BW.

    Dim convention follows Table 2: H/K/O are the *next* layer's meta data,
    C_out(i) is the producing layer's channel count.
    """
    dt = spec.dtype_bytes
    sf, df_ = src.output_layout, dst.input_layout

    if df_ is Layout.TOEPLITZ:
        if implicit_im2col:
            # Beyond-paper mode: implicit-GEMM conv gathers windows on-chip,
            # so only the 3-D tensor ever hits HBM.
            bytes_ = nxt.h1 * nxt.h2 * c_out_prev * dt
            bw = spec.hbm_bw
        else:
            bytes_ = nxt.o1 * nxt.o2 * nxt.k1 * nxt.k2 * c_out_prev * dt
            bw = spec.hbm_bw
        if sf is Layout.WINOGRAD:
            # Row 5: two-step (Winograd→3D→Toeplitz) with pipelined LTUs;
            # ovhd = pipeline fill of the second LTU.
            return bytes_, bw * 0.9
        return bytes_, bw

    if df_ is Layout.TENSOR3D:
        # Rows 2: one-to-one (or reorder-only) stores of H1H2·C elements.
        return nxt.h1 * nxt.h2 * c_out_prev * dt, spec.hbm_bw

    # df_ is WINOGRAD input layout.
    m = dst.m
    t = dst.m + dst.r - 1
    blow = (t * t) / (m * m)
    bytes_ = nxt.h1 * nxt.h2 * blow * c_out_prev * dt
    if sf is Layout.WINOGRAD:
        # Row 4: scattered→scattered is streaming.
        return bytes_, spec.hbm_bw
    # Row 3: scattered writes, addresses H1H2/m^2 apart → lane wastage f().
    return bytes_, eff_bandwidth(spec, c_out_prev)


@dataclasses.dataclass
class TransitionCalibration:
    """Measured-vs-predicted scale factors for Table 2 transitions.

    The analytical model prices a transition from layout bytes and
    bandwidth; on the machine actually executing the program the realized
    cost can differ (XLA fuses the conversion gather, caches absorb the
    round trip). Benchmarks that measure elided-vs-round-trip wall clock
    (``benchmarks/bench_layout_elision.py``) distill the ratio into scale
    factors keyed by (source layout, destination layout) — ``scale`` > 1
    means transitions cost more than modeled, < 1 less — and pass the
    calibration back into ``transition_cost`` so predicted savings can be
    reported in realized terms.
    """
    scales: Dict[Tuple[Layout, Layout], float] = \
        dataclasses.field(default_factory=dict)
    default: float = 1.0

    def scale(self, src: Layout, dst: Layout) -> float:
        return self.scales.get((src, dst), self.default)


def transition_cost(src: Algorithm, dst: Algorithm, nxt: ConvMeta,
                    c_out_prev: int, spec: TPUSpec = V5E,
                    implicit_im2col: bool = False,
                    extra_s: float = 0.0,
                    on_chip: bool = False,
                    calibration: Optional[TransitionCalibration] = None
                    ) -> float:
    """Table 2 store + load legs in seconds (+ pooling etc. via extra_s).

    ``on_chip=True`` models flow step ⑤: consecutive layers whose combined
    footprint fits in VMEM skip the HBM round trip entirely.
    ``calibration`` rescales the modeled cost by the measured factor for
    this (source layout, destination layout) pair.
    """
    if on_chip:
        return extra_s
    store_bytes, store_bw = _store_bytes(src, dst, nxt, c_out_prev, spec,
                                         implicit_im2col)
    # Load leg is symmetric (§3.3: "the DLT at data-load side performs
    # symmetric operations"): same byte count back in at full/effective BW.
    load_bytes, load_bw = store_bytes, store_bw
    cost = store_bytes / store_bw + load_bytes / load_bw
    if calibration is not None:
        cost *= calibration.scale(src.output_layout, dst.input_layout)
    return cost + extra_s


def fits_on_chip(prev_out_elems: int, next_in_elems: int,
                 spec: TPUSpec = V5E) -> bool:
    """Flow step ⑤: can the producer's output stay resident for the consumer?"""
    return (prev_out_elems + next_in_elems) * spec.dtype_bytes \
        <= spec.vmem_budget


# ---------------------------------------------------------------------------
# Roofline helpers shared with benchmarks / EXPERIMENTS.md.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(flops: float, bytes_hbm: float, bytes_collective: float,
             chips: int = 1, spec: TPUSpec = V5E,
             links_per_chip: float = 1.0) -> Roofline:
    return Roofline(
        compute_s=flops / (chips * spec.peak_flops),
        memory_s=bytes_hbm / (chips * spec.hbm_bw),
        collective_s=(bytes_collective / (chips * links_per_chip * spec.ici_bw)
                      if bytes_collective else 0.0),
    )
