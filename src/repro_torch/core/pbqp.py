"""Partitioned Boolean Quadratic Programming (PBQP) solvers.

The DYNAMAP algorithm-mapping problem (Eq. 8):

    minimize  Σ_{i<j} x_i^T T_ij x_j  +  Σ_i x_i^T c_i
    s.t.      x_i ∈ {0,1}^{|c_i|},  ||x_i||_1 == 1

PBQP is NP-complete in general (§4), but Theorems 4.1/4.2 show that on
*series-parallel* graphs the optimum is found in O(N·d²) by the two
optimality-preserving reductions of Definition 1:

  (1) degree-2 vertex elimination:  folding  min_b [ M_ub(a,b) + c_v(b)
      + M_vw(b,c) ]  into a new edge (u,w);
  (2) parallel-edge merge:          T_ij ← T_ij^1 + T_ij^2.

We additionally implement the standard PBQP R0/R1 rules (independent and
degree-1 vertices — these are the "Base step (1)" vertices of the paper's
induction), a brute-force oracle for optimality tests, the greedy baseline
the paper argues against (§6.1.2), and an RN heuristic fallback so that
non-series-parallel graphs still get a (possibly suboptimal) answer instead
of an error.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Assignment = Dict[int, int]


@dataclasses.dataclass
class Edge:
    u: int
    v: int
    m: np.ndarray  # shape (d_u, d_v)

    def oriented(self, a: int, b: int) -> np.ndarray:
        """Matrix oriented so rows index node ``a`` and cols node ``b``."""
        if (a, b) == (self.u, self.v):
            return self.m
        if (a, b) == (self.v, self.u):
            return self.m.T
        raise KeyError((a, b))


class PBQP:
    """A PBQP instance over an undirected multigraph."""

    def __init__(self) -> None:
        self.costs: Dict[int, np.ndarray] = {}
        self.edges: List[Edge] = []

    # ---------------------------------------------------------------- build
    def add_node(self, nid: int, cost: Sequence[float]) -> None:
        c = np.asarray(cost, dtype=np.float64)
        if c.ndim != 1 or c.size == 0:
            raise ValueError(f"node {nid}: cost vector must be 1-D non-empty")
        if nid in self.costs:
            raise KeyError(f"duplicate node {nid}")
        self.costs[nid] = c

    def add_edge(self, u: int, v: int, m: np.ndarray) -> None:
        m = np.asarray(m, dtype=np.float64)
        if u == v:
            raise ValueError("self loops are not valid PBQP edges")
        if m.shape != (self.costs[u].size, self.costs[v].size):
            raise ValueError(
                f"edge ({u},{v}): matrix shape {m.shape} != "
                f"({self.costs[u].size},{self.costs[v].size})")
        self.edges.append(Edge(u, v, m))

    # ---------------------------------------------------------------- util
    def total_cost(self, assignment: Assignment) -> float:
        tot = 0.0
        for nid, c in self.costs.items():
            tot += float(c[assignment[nid]])
        for e in self.edges:
            tot += float(e.m[assignment[e.u], assignment[e.v]])
        return tot

    def copy(self) -> "PBQP":
        p = PBQP()
        p.costs = {k: v.copy() for k, v in self.costs.items()}
        p.edges = [Edge(e.u, e.v, e.m.copy()) for e in self.edges]
        return p

    def _adjacency(self) -> Dict[int, List[Edge]]:
        adj: Dict[int, List[Edge]] = {nid: [] for nid in self.costs}
        for e in self.edges:
            adj[e.u].append(e)
            adj[e.v].append(e)
        return adj


# ----------------------------------------------------------------------------
# Exact solver via series-parallel reduction (Theorems 4.1 / 4.2).
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class SolveResult:
    assignment: Assignment
    cost: float
    reductions: int          # number of reduction operations applied
    exact: bool              # False if the RN heuristic fired


def solve_series_parallel(problem: PBQP,
                          allow_heuristic: bool = True) -> SolveResult:
    """Optimal PBQP on series-parallel graphs in O(N·d²) reductions.

    Reduction loop:
      * parallel-edge merge (operation 2) whenever two edges share endpoints;
      * R0: isolated vertex  → pick argmin of its cost vector;
      * R1: degree-1 vertex  → fold into its neighbor's cost vector;
      * R2: degree-2 vertex  → fold into a new edge between its neighbors
        (operation 1 / base case (1) in the proof of Theorem 4.1);
      * if none applies and nodes remain: the graph is not series-parallel.
        With ``allow_heuristic`` we apply the classic PBQP RN rule (locally
        minimal choice at a max-degree node); otherwise raise.

    Decisions eliminated early are reconstructed by back-substitution, in
    reverse order, exactly as in the constructive proof.
    """
    p = problem.copy()
    # Each entry: (node, reconstruct_fn) where reconstruct_fn(assignment)->choice
    trail: List[Tuple[int, Callable[[Assignment], int]]] = []
    reductions = 0
    exact = True

    def merge_parallel() -> bool:
        nonlocal reductions
        by_pair: Dict[frozenset, List[int]] = {}
        for idx, e in enumerate(p.edges):
            by_pair.setdefault(frozenset((e.u, e.v)), []).append(idx)
        for pair, idxs in by_pair.items():
            if len(idxs) > 1:
                base = p.edges[idxs[0]]
                for other_idx in idxs[1:]:
                    other = p.edges[other_idx]
                    base.m = base.m + other.oriented(base.u, base.v)
                p.edges = [e for i, e in enumerate(p.edges) if i not in set(idxs[1:])]
                reductions += 1
                return True
        return False

    while True:
        if merge_parallel():
            continue

        adj = p._adjacency()
        if not p.costs:
            break

        # R0 — isolated vertex.
        r0 = next((n for n, es in adj.items() if len(es) == 0), None)
        if r0 is not None:
            choice = int(np.argmin(p.costs[r0]))
            trail.append((r0, lambda a, _c=choice: _c))
            del p.costs[r0]
            reductions += 1
            continue

        # R1 — degree-1 vertex v with neighbor u.
        r1 = next((n for n, es in adj.items() if len(es) == 1), None)
        if r1 is not None:
            e = adj[r1][0]
            u = e.v if e.u == r1 else e.u
            m_uv = e.oriented(u, r1)                       # (d_u, d_v)
            folded = m_uv + p.costs[r1][None, :]           # (d_u, d_v)
            best_v = np.argmin(folded, axis=1)             # per u-choice
            p.costs[u] = p.costs[u] + np.min(folded, axis=1)
            p.edges.remove(e)
            del p.costs[r1]
            trail.append((r1, lambda a, _u=u, _bv=best_v: int(_bv[a[_u]])))
            reductions += 1
            continue

        # R2 — degree-2 vertex v with neighbors u, w (operation 1).
        r2 = next((n for n, es in adj.items() if len(es) == 2), None)
        if r2 is not None:
            e1, e2 = adj[r2]
            u = e1.v if e1.u == r2 else e1.u
            w = e2.v if e2.u == r2 else e2.u
            m_uv = e1.oriented(u, r2)                      # (d_u, d_v)
            m_vw = e2.oriented(r2, w)                      # (d_v, d_w)
            # delta[a, b, c] = m_uv[a,b] + c_v[b] + m_vw[b,c]
            delta = (m_uv[:, :, None] + p.costs[r2][None, :, None]
                     + m_vw[None, :, :])                   # (d_u, d_v, d_w)
            best_v = np.argmin(delta, axis=1)              # (d_u, d_w)
            new_m = np.min(delta, axis=1)                  # (d_u, d_w)
            p.edges.remove(e1)
            p.edges.remove(e2)
            del p.costs[r2]
            p.add_edge(u, w, new_m)
            trail.append((r2, lambda a, _u=u, _w=w, _bv=best_v:
                          int(_bv[a[_u], a[_w]])))
            reductions += 1
            continue

        # Two nodes + one edge left → solve exactly and stop.
        if len(p.costs) == 2 and len(p.edges) == 1:
            e = p.edges[0]
            total = (p.costs[e.u][:, None] + p.costs[e.v][None, :] + e.m)
            iu, iv = np.unravel_index(np.argmin(total), total.shape)
            trail.append((e.u, lambda a, _c=int(iu): _c))
            trail.append((e.v, lambda a, _c=int(iv): _c))
            p.edges.clear()
            p.costs.clear()
            break

        if len(p.costs) == 1 and not p.edges:
            nid = next(iter(p.costs))
            choice = int(np.argmin(p.costs[nid]))
            trail.append((nid, lambda a, _c=choice: _c))
            p.costs.clear()
            break

        # Stuck: not series-parallel.
        if not allow_heuristic:
            raise ValueError("graph is not series-parallel; reduction stalled")
        exact = False
        # RN heuristic: pick the max-degree node; choose its locally best
        # option (node cost + best-case contribution of each incident edge),
        # then fold that choice into the neighbors' cost vectors.
        n = max(adj, key=lambda k: len(adj[k]))
        local = p.costs[n].copy()
        for e in adj[n]:
            local += np.min(e.oriented(n, e.v if e.u == n else e.u), axis=1)
        choice = int(np.argmin(local))
        for e in list(adj[n]):
            other = e.v if e.u == n else e.u
            p.costs[other] = p.costs[other] + e.oriented(other, n)[:, choice]
            p.edges.remove(e)
        del p.costs[n]
        trail.append((n, lambda a, _c=choice: _c))
        reductions += 1

    # Back-substitute in reverse elimination order.
    assignment: Assignment = {}
    for nid, fn in reversed(trail):
        assignment[nid] = fn(assignment)

    return SolveResult(assignment=assignment,
                       cost=problem.total_cost(assignment),
                       reductions=reductions,
                       exact=exact)


# ----------------------------------------------------------------------------
# Oracles / baselines.
# ----------------------------------------------------------------------------

def solve_brute_force(problem: PBQP, max_states: int = 5_000_000) -> SolveResult:
    """Exhaustive enumeration — the optimality oracle for tests."""
    nids = sorted(problem.costs)
    dims = [problem.costs[n].size for n in nids]
    n_states = 1
    for d in dims:
        n_states *= d
    if n_states > max_states:
        raise ValueError(f"state space {n_states} exceeds cap {max_states}")
    best: Optional[Assignment] = None
    best_cost = float("inf")
    for combo in itertools.product(*[range(d) for d in dims]):
        a = dict(zip(nids, combo))
        c = problem.total_cost(a)
        if c < best_cost:
            best_cost = c
            best = a
    assert best is not None
    return SolveResult(assignment=best, cost=best_cost, reductions=0, exact=True)


def solve_greedy_node(problem: PBQP) -> SolveResult:
    """The paper's strawman (§6.1.2): per-node argmin of the node cost only,
    ignoring transition costs entirely."""
    a = {nid: int(np.argmin(c)) for nid, c in problem.costs.items()}
    return SolveResult(assignment=a, cost=problem.total_cost(a),
                       reductions=0, exact=False)


def solve_greedy_incremental(problem: PBQP, order: Sequence[int]) -> SolveResult:
    """Greedy in a given (topological) order: each node picks the choice that
    minimizes node cost + transitions to already-assigned neighbors."""
    adj = problem._adjacency()
    a: Assignment = {}
    for nid in order:
        local = problem.costs[nid].copy()
        for e in adj[nid]:
            other = e.v if e.u == nid else e.u
            if other in a:
                local += e.oriented(nid, other)[:, a[other]]
        a[nid] = int(np.argmin(local))
    return SolveResult(assignment=a, cost=problem.total_cost(a),
                       reductions=0, exact=False)
