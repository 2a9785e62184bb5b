"""CNN/DAG graph IR for DYNAMAP.

The paper (§4) models a CNN as G = (V, E, C_v, T_e): vertices are layers,
edges are producer→consumer orderings, C_v are per-vertex cost vectors (one
entry per algorithm-dataflow pair) and T_e are transition-cost matrices.

This module provides the *structural* IR: typed layer nodes, edges, and the
series-parallel machinery (Definition 1, operations (1) and (2)) used both by
the PBQP solver and by the model builders in ``repro_torch.cnn.models``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class LayerKind(enum.Enum):
    INPUT = "input"
    CONV = "conv"
    POOL_MAX = "pool_max"
    POOL_AVG = "pool_avg"
    CONCAT = "concat"
    FC = "fc"
    ADD = "add"          # residual add (ResNet)
    GLOBAL_POOL = "global_pool"
    SOFTMAX = "softmax"
    OUTPUT = "output"


@dataclasses.dataclass(frozen=True)
class ConvMeta:
    """CONV layer meta data exactly as §2.1 defines it.

    Each CONV layer has C_in (C_out) input (output) channels, each channel a
    H1×H2 (O1×O2) feature map; weights are C_in×C_out kernels of size K1×K2.
    """
    c_in: int
    c_out: int
    h1: int
    h2: int
    k1: int
    k2: int
    stride: int = 1
    pad: str = "same"  # "same" | "valid"

    @property
    def o1(self) -> int:
        if self.pad == "same":
            return -(-self.h1 // self.stride)
        return (self.h1 - self.k1) // self.stride + 1

    @property
    def o2(self) -> int:
        if self.pad == "same":
            return -(-self.h2 // self.stride)
        return (self.h2 - self.k2) // self.stride + 1

    @property
    def macs(self) -> int:
        """Multiply-accumulates of spatial convolution (Y_CONV in Eq. 14)."""
        return self.o1 * self.o2 * self.c_in * self.c_out * self.k1 * self.k2

    @property
    def out_elems(self) -> int:
        return self.o1 * self.o2 * self.c_out

    @property
    def in_elems(self) -> int:
        return self.h1 * self.h2 * self.c_in

    @property
    def weight_elems(self) -> int:
        return self.k1 * self.k2 * self.c_in * self.c_out


@dataclasses.dataclass
class LayerNode:
    """One vertex of the CNN graph."""
    id: int
    kind: LayerKind
    name: str = ""
    conv: Optional[ConvMeta] = None
    # Non-conv meta (pooling window / stride, concat arity ...) kept loose:
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind is LayerKind.CONV and self.conv is None:
            raise ValueError(f"CONV node {self.id} requires ConvMeta")
        if not self.name:
            self.name = f"{self.kind.value}_{self.id}"


class Graph:
    """A DAG of LayerNodes.

    Edges are directed (producer → consumer) for execution; the series-parallel
    reduction of §4 operates on the *undirected* skeleton, which we expose via
    ``undirected_adjacency``.
    """

    def __init__(self) -> None:
        self.nodes: Dict[int, LayerNode] = {}
        self.edges: List[Tuple[int, int]] = []
        self._next_id = 0

    # ---------------------------------------------------------------- build
    def add_node(self, kind: LayerKind, name: str = "", conv: Optional[ConvMeta] = None,
                 **attrs: object) -> int:
        nid = self._next_id
        self._next_id += 1
        self.nodes[nid] = LayerNode(id=nid, kind=kind, name=name, conv=conv, attrs=dict(attrs))
        return nid

    def add_edge(self, src: int, dst: int) -> None:
        if src not in self.nodes or dst not in self.nodes:
            raise KeyError(f"edge ({src},{dst}) references unknown node")
        self.edges.append((src, dst))

    def chain(self, node_ids: Sequence[int]) -> None:
        for a, b in zip(node_ids, node_ids[1:]):
            self.add_edge(a, b)

    # ---------------------------------------------------------------- query
    def successors(self, nid: int) -> List[int]:
        return [d for (s, d) in self.edges if s == nid]

    def predecessors(self, nid: int) -> List[int]:
        return [s for (s, d) in self.edges if d == nid]

    def out_degree(self, nid: int) -> int:
        return len(self.successors(nid))

    def in_degree(self, nid: int) -> int:
        return len(self.predecessors(nid))

    def conv_nodes(self) -> List[LayerNode]:
        return [n for n in self.nodes.values() if n.kind is LayerKind.CONV]

    def source(self) -> int:
        srcs = [nid for nid in self.nodes if self.in_degree(nid) == 0]
        if len(srcs) != 1:
            raise ValueError(f"graph must have exactly one source, got {srcs}")
        return srcs[0]

    def sink(self) -> int:
        snks = [nid for nid in self.nodes if self.out_degree(nid) == 0]
        if len(snks) != 1:
            raise ValueError(f"graph must have exactly one sink, got {snks}")
        return snks[0]

    def topo_order(self) -> List[int]:
        indeg = {nid: self.in_degree(nid) for nid in self.nodes}
        ready = sorted([nid for nid, d in indeg.items() if d == 0])
        order: List[int] = []
        while ready:
            nid = ready.pop(0)
            order.append(nid)
            for succ in sorted(self.successors(nid)):
                indeg[succ] -= 1
                if indeg[succ] == 0:
                    ready.append(succ)
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return order

    def undirected_adjacency(self) -> Dict[int, List[Tuple[int, int]]]:
        """node → list of (neighbor, edge_index); parallel edges kept distinct."""
        adj: Dict[int, List[Tuple[int, int]]] = {nid: [] for nid in self.nodes}
        for ei, (s, d) in enumerate(self.edges):
            adj[s].append((d, ei))
            adj[d].append((s, ei))
        return adj


# --------------------------------------------------------------------------
# Series-parallel recognition (Definition 1 of the paper).
# --------------------------------------------------------------------------

def is_series_parallel(graph: Graph, source: Optional[int] = None,
                       sink: Optional[int] = None) -> bool:
    """Check Definition 1 by running the reduction to exhaustion.

    Operations:
      (1) remove a degree-2 vertex (≠ s, t); connect its two neighbors.
      (2) replace a pair of parallel edges with a single edge.

    The graph is series-parallel iff the fixpoint is a single edge (K2).
    """
    s = graph.source() if source is None else source
    t = graph.sink() if sink is None else sink

    # Work on an undirected multigraph: list of frozenset pairs.
    edges: List[Tuple[int, int]] = [(a, b) for (a, b) in graph.edges]
    alive = set(graph.nodes)

    changed = True
    while changed:
        changed = False
        # (2) merge parallel edges first (cheap).
        seen: Dict[frozenset, int] = {}
        merged: List[Tuple[int, int]] = []
        for (a, b) in edges:
            key = frozenset((a, b))
            if key in seen:
                changed = True  # drop duplicate
            else:
                seen[key] = 1
                merged.append((a, b))
        edges = merged

        # (1) eliminate one degree-2 vertex.
        deg: Dict[int, List[Tuple[int, int]]] = {n: [] for n in alive}
        for e in edges:
            deg[e[0]].append(e)
            deg[e[1]].append(e)
        for v in list(alive):
            if v in (s, t):
                continue
            if len(deg[v]) == 2:
                (e1, e2) = deg[v]
                n1 = e1[0] if e1[1] == v else e1[1]
                n2 = e2[0] if e2[1] == v else e2[1]
                if n1 == v or n2 == v:   # self loop — not SP
                    return False
                edges = [e for e in edges if e is not e1 and e is not e2]
                edges.append((n1, n2))
                alive.discard(v)
                changed = True
                break

    return alive == {s, t} and len(edges) == 1


def assert_single_source_sink(graph: Graph) -> Tuple[int, int]:
    return graph.source(), graph.sink()
