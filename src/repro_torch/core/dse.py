"""Hardware-customization DSE — Algorithm 1 of the paper, TPU-adapted.

The paper sweeps systolic-array shapes (P_SA1, P_SA2) under the FPGA DSP
budget and, for every (layer, algorithm), picks the dataflow ψ minimizing
Eq. 9; the array shape minimizing the empirical total node cost τ_emp wins.

On TPU the array shape becomes the Pallas GEMM block shape (BM, BN): the
resource constraint is the VMEM working set (operand panels + accumulator,
double-buffered) instead of DSPs, and candidate dims are MXU-aligned
multiples of 128.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.algorithms import Algorithm, menu_for
from repro_torch.core.cost_model import (ALL_DATAFLOWS, Dataflow, NodeCost, TPUSpec,
                                   V5E, best_dataflow, node_cost)
from repro_torch.core.graph import ConvMeta, Graph, LayerKind


@dataclasses.dataclass(frozen=True)
class HardwareChoice:
    p1: int                       # BM — rows of the virtual systolic array
    p2: int                       # BN — cols
    k_panel: int                  # K-panel depth used for the VMEM bound
    # ψ[layer, algorithm] → best dataflow (line 8 of Algorithm 1)
    psi: Dict[Tuple[int, str], Dataflow]
    tau_emp: float


def vmem_working_set(p1: int, p2: int, k_panel: int, spec: TPUSpec) -> int:
    """Bytes of VMEM a (p1, p2, k_panel) GEMM block claims.

    Two operand panels (double-buffered) + the f32 accumulator tile. This is
    the TPU analogue of C(P_SA1, P_SA2 | r) ≤ C_FPGA in Algorithm 1 line 4.
    """
    operand = (p1 * k_panel + k_panel * p2) * spec.dtype_bytes * 2
    acc = p1 * p2 * 4
    return operand + acc


def candidate_shapes(spec: TPUSpec, k_panel: int = 512,
                     max_dim: int = 2048) -> List[Tuple[int, int]]:
    dims = [d for d in range(spec.mxu, max_dim + 1, spec.mxu)]
    out = []
    for p1, p2 in itertools.product(dims, dims):
        if vmem_working_set(p1, p2, k_panel, spec) <= spec.vmem_budget:
            out.append((p1, p2))
    return out


def identify_parameters(graph: Graph,
                        menu: Optional[Sequence[Algorithm]] = None,
                        spec: TPUSpec = V5E,
                        k_panel: int = 512,
                        max_dim: int = 2048) -> HardwareChoice:
    """Algorithm 1: sweep (P_SA1, P_SA2); per (layer, algo) keep the best
    dataflow; return the shape minimizing empirical total node cost."""
    convs = graph.conv_nodes()
    best: Optional[HardwareChoice] = None
    for (p1, p2) in candidate_shapes(spec, k_panel, max_dim):
        tau = 0.0
        psi: Dict[Tuple[int, str], Dataflow] = {}
        for node in convs:
            assert node.conv is not None
            for algo in menu_for(node.conv, list(menu) if menu else None):
                nc_best: Optional[NodeCost] = None
                for df in ALL_DATAFLOWS:
                    nc = node_cost(node.conv, algo, p1, p2, df, spec)
                    if nc_best is None or nc.total < nc_best.total:
                        nc_best = nc
                assert nc_best is not None
                psi[(node.id, algo.key)] = nc_best.dataflow
                tau += nc_best.total          # line 10: sum over all algos
        if best is None or tau < best.tau_emp:
            best = HardwareChoice(p1=p1, p2=p2, k_panel=k_panel, psi=psi,
                                  tau_emp=tau)
    assert best is not None
    return best
