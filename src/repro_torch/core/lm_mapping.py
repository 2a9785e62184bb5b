"""DYNAMAP generalized to transformer stacks (DESIGN.md §3).

The paper's machinery — per-node implementation choice + pairwise
transition costs on a series-parallel graph, solved optimally by PBQP — is
architecture-agnostic. Here the "algorithms" are per-layer execution
strategies (attention sharding mode × MoE dispatch algorithm), node costs
are the measured/probed per-layer roofline terms, and transition costs are
the resharding collectives incurred when adjacent layers disagree on the
activation layout (a layout flip between sequence-sharded and head-sharded
activations costs one all-to-all of the residual stream).

This is what drives strategy selection in §Perf: e.g. the measured
command-r-35b numbers (seq: coll 18.0 s / mem 17.0 s; heads: coll 14.1 s /
mem 36.3 s per step) let the PBQP decide per layer — and, because the
transition cost punishes mixing, it correctly returns a homogeneous 'seq'
assignment rather than a greedy per-term mix.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import TPUSpec, V5E
from repro_torch.core.pbqp import PBQP, SolveResult, solve_series_parallel


@dataclasses.dataclass(frozen=True)
class LayerStrategy:
    """One executable strategy for a transformer layer."""
    name: str                      # e.g. "seq", "heads", "seq+sorted_moe"
    compute_s: float               # per-layer roofline terms (seconds)
    memory_s: float
    collective_s: float
    layout: str                    # activation layout it leaves behind

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def transition_cost_s(src_layout: str, dst_layout: str,
                      resid_bytes_per_chip: float,
                      spec: TPUSpec = V5E) -> float:
    """Resharding the (B, S, d) residual stream between layouts = one
    all-to-all of the per-chip shard over the ICI."""
    if src_layout == dst_layout:
        return 0.0
    return resid_bytes_per_chip / spec.ici_bw


def map_layer_strategies(n_layers: int,
                         strategies: Sequence[LayerStrategy],
                         resid_bytes_per_chip: float,
                         spec: TPUSpec = V5E) -> Tuple[Dict[int, str],
                                                       SolveResult]:
    """Optimal per-layer strategy assignment for a chain-of-layers model.

    A transformer stack is the simplest series-parallel graph (a chain), so
    Theorem 4.1 applies directly and the solve is exact in O(L·d²).
    """
    p = PBQP()
    costs = [s.total_s for s in strategies]
    for i in range(n_layers):
        p.add_node(i, costs)
    d = len(strategies)
    t = np.zeros((d, d))
    for a in range(d):
        for b in range(d):
            t[a, b] = transition_cost_s(strategies[a].layout,
                                        strategies[b].layout,
                                        resid_bytes_per_chip, spec)
    for i in range(n_layers - 1):
        p.add_edge(i, i + 1, t)
    res = solve_series_parallel(p)
    assignment = {i: strategies[res.assignment[i]].name
                  for i in range(n_layers)}
    return assignment, res


def strategies_from_probes(probes: Dict[str, Dict[str, float]],
                           n_layers: int,
                           layouts: Optional[Dict[str, str]] = None
                           ) -> List[LayerStrategy]:
    """Build per-layer strategies from whole-model probe terms (seconds per
    step, as produced by launch.roofline) by dividing through the layer
    count."""
    layouts = layouts or {}
    out = []
    for name, terms in probes.items():
        out.append(LayerStrategy(
            name=name,
            compute_s=terms["compute_s"] / n_layers,
            memory_s=terms["memory_s"] / n_layers,
            collective_s=terms["collective_s"] / n_layers,
            layout=layouts.get(name, name)))
    return out
