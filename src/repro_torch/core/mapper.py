"""DYNAMAP end-to-end mapping flow (§5): cost-graph construction + PBQP.

Steps (Figure 7):
  ① Algorithm 1 identifies (P_SA1, P_SA2) and per-(layer, algorithm) dataflow ψ;
  ② the CNN cost graph is constructed (§5.1): conv vertices carry cost vectors
     over algorithm choices; out-degree>1 vertices get a *store-format* split
     vertex v_s; edges carry layout-transition matrices (Table 2);
  ③ the PBQP solver performs the series-parallel node reductions (§4);
  ④-⑥ the result is an ExecutionPlan the executor / codegen consumes.

Construction note: the paper gives v_s a choice vector of size Σ_b'|A_b'|
(one entry per downstream-layer algorithm). We use the equivalent compact
form — v_s chooses among the *distinct input layouts* of downstream
algorithms; store edges pay the layout-conversion write, load edges pay a
matched (streaming) read when layouts agree and a converting read otherwise.
Both formulations price exactly the same store/load legs of Table 2.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.algorithms import (Algorithm, AlgoFamily, DEFAULT_MENU,
                                   IM2COL, KN2ROW, Layout, menu_for)
from repro_torch.core.cost_model import (Dataflow, TPUSpec, TransitionCalibration,
                                   V5E, V5E_INT8, best_dataflow,
                                   eff_bandwidth, fits_on_chip, gemm_steps,
                                   node_cost, transition_cost)
from repro_torch.core.dse import HardwareChoice, identify_parameters
from repro_torch.core.graph import ConvMeta, Graph, LayerKind, LayerNode
from repro_torch.core.layouts import LayoutSpec, NHWC, consumer_spec
from repro_torch.core.pbqp import (PBQP, SolveResult, solve_brute_force,
                             solve_greedy_incremental, solve_greedy_node,
                             solve_series_parallel)


PASSTHROUGH = "passthrough"

# Lowering-time validation sets: fail loudly in ``lower_plan`` instead of
# obscurely at trace time inside a kernel.
EPILOGUES = ("none", "relu", "bias", "bias_relu")
BACKENDS = ("auto", "pallas", "reference", "lax")
PRECISIONS = ("bf16", "int8")


@dataclasses.dataclass
class NodeChoices:
    """The per-vertex choice set entering the PBQP. With quantization on,
    conv vertices carry an (algorithm × precision) cross product: the int8
    replicas of each non-Winograd algorithm appear as extra entries
    (labels ``"<algo>@int8"``) priced under the int8 hardware spec, and
    ``precisions[i]`` names entry i's precision (None ⇒ all bf16)."""
    node_id: int
    kind: LayerKind
    algos: List[Algorithm]          # empty for passthrough nodes
    labels: List[str]
    costs: np.ndarray               # (d,)
    dataflows: List[Optional[Dataflow]]
    precisions: Optional[List[str]] = None


@dataclasses.dataclass
class ExecutionPlan:
    p1: int
    p2: int
    assignment: Dict[int, Algorithm]          # conv node → algorithm
    dataflows: Dict[int, Dataflow]            # conv node → dataflow
    store_formats: Dict[int, Layout]          # split producer → DRAM layout
    total_cost_s: float
    solver: SolveResult
    choices: Dict[int, NodeChoices]
    # conv node → "int8"|"bf16"; empty ⇒ all bf16 (pre-quantization plans).
    precisions: Dict[int, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ConvLowering:
    """Static per-conv-layer binding the compiled overlay closes over:
    everything the Computing Unit needs to execute one layer — algorithm
    wrapper, the Eq. 9 dataflow/(p1, p2) GEMM block binding, the fused
    post-GEMM ``epilogue`` ("none"|"relu"|"bias"|"bias_relu") and the
    ``backend`` the layer runs on ("auto" follows the executor-wide
    use_pallas flag; "pallas"/"reference"/"lax" pin it, letting one
    compiled plan mix tiny-conv jnp/lax layers with big Pallas GEMMs).
    ``in_layout``/``out_layout`` (None = NHWC) realize the plan's DRAM
    store formats: the layer consumes its predecessor's stored format
    directly / emits its consumer's store format (§3.3, Table 2).
    Hashable, so a (graph, lowering) pair keys one jit-compiled program.

    Precision binding: ``precision`` "int8" runs the quantized overlay
    path with the calibrated static per-tensor ``in_scale``; ``out_scale``
    (set only on a fused int8→int8 chain edge) makes the layer requantize
    its fused epilogue output to the consumer's scale and emit int8;
    ``in_quantized`` marks the consumer side of that same edge."""
    algo: Algorithm
    dataflow: Dataflow
    p1: int
    p2: int
    epilogue: str = "relu"
    backend: str = "auto"
    in_layout: Optional[LayoutSpec] = None
    out_layout: Optional[LayoutSpec] = None
    precision: str = "bf16"
    in_scale: Optional[float] = None
    out_scale: Optional[float] = None
    in_quantized: bool = False


@dataclasses.dataclass(frozen=True)
class LayoutTransition:
    """The realized store format of one graph edge.

    ``layout`` is the DRAM representation the producer stores (NHWC unless
    a non-trivial format was chosen); ``elide=True`` means the consumer
    reads that format *directly* (the matched streaming load of Table 2 —
    no NHWC round trip); ``elide=False`` with a non-NHWC layout is the
    converting load (a mismatched sibling at a split); ``reason`` records
    why an edge kept the round trip. ``precision`` is the dtype crossing
    the edge: "int8" only on a fused chain edge whose producer requantizes
    into the consumer's activation scale (both endpoints int8, NHWC)."""
    src: int
    dst: int
    layout: LayoutSpec
    elide: bool
    reason: str = ""
    precision: str = "bf16"


@dataclasses.dataclass
class LoweredProgram:
    """What ``lower_plan`` hands the executor: per-conv bindings plus the
    per-edge layout transitions derived from ``plan.store_formats``.

    ``convs`` maps conv node → ConvLowering; ``transitions`` maps every
    graph edge → LayoutTransition; ``store_specs`` maps producer node →
    the non-NHWC format it stages (split vertices materialize it ONCE and
    fan it out; the executor materializes it for non-conv producers, conv
    producers fuse it via ``ConvLowering.out_layout``). Behaves as a
    mapping over ``convs`` so pre-layout call sites (``lowering[nid]``,
    ``.values()``) keep working.

    ``calibration`` is the transition-cost calibration the program was
    lowered under (None = the uncalibrated analytical model); consumers
    that re-price the program's transitions (``transition_report``) read
    it from here instead of taking a duplicate side-channel argument.
    """
    convs: Dict[int, ConvLowering]
    transitions: Dict[Tuple[int, int], LayoutTransition] = \
        dataclasses.field(default_factory=dict)
    store_specs: Dict[int, LayoutSpec] = dataclasses.field(default_factory=dict)
    calibration: Optional[TransitionCalibration] = None

    # -------------------------------------------------- mapping protocol
    def __getitem__(self, nid: int) -> ConvLowering:
        return self.convs[nid]

    def __contains__(self, nid: int) -> bool:
        return nid in self.convs

    def __iter__(self):
        return iter(self.convs)

    def __len__(self) -> int:
        return len(self.convs)

    def get(self, nid: int, default=None):
        return self.convs.get(nid, default)

    def keys(self):
        return self.convs.keys()

    def values(self):
        return self.convs.values()

    def items(self):
        return self.convs.items()

    # ------------------------------------------------------ observability
    @property
    def elided_edges(self) -> List[Tuple[int, int]]:
        """Edges whose consumer reads a non-NHWC store format directly —
        the transitions the compiled program skips."""
        return sorted((t.src, t.dst) for t in self.transitions.values()
                      if t.elide and t.layout.kind != "nhwc")

    @property
    def quantized_edges(self) -> List[Tuple[int, int]]:
        """Fused precision edges: the producer requantizes into the
        consumer's activation scale and the edge carries int8 bytes."""
        return sorted((t.src, t.dst) for t in self.transitions.values()
                      if t.precision == "int8")


def _validate_lowering(graph: Graph, epilogue: str, backend: str,
                       elide_overrides) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; want one of "
                         f"{EPILOGUES}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of "
                         f"{BACKENDS}")
    if elide_overrides is None:
        return
    edges = set(graph.edges)
    for edge, flag in elide_overrides.items():
        if not (isinstance(edge, tuple) and len(edge) == 2
                and edge in edges):
            raise ValueError(f"elide_overrides key {edge!r} is not an edge "
                             "of the graph")
        if not isinstance(flag, bool):
            raise ValueError(f"elide_overrides[{edge}] must be bool, "
                             f"got {flag!r}")


def _most_common_spec(specs: List[LayoutSpec]) -> Optional[LayoutSpec]:
    """Majority vote with first-seen tie-breaking (deterministic)."""
    counts: Dict[LayoutSpec, int] = {}
    for s in specs:
        counts[s] = counts.get(s, 0) + 1
    best = None
    for s in specs:                      # first-seen order
        if best is None or counts[s] > counts[best]:
            best = s
    return best


def _consumer_want(graph: Graph, base: Dict[int, ConvLowering],
                   v: int) -> Tuple[Optional[LayoutSpec], str]:
    """The store format consumer ``v`` reads directly, or (None, why)."""
    node = graph.nodes[v]
    if node.kind is not LayerKind.CONV:
        return NHWC, ""
    low = base[v]
    if low.backend == "lax":
        return None, "lax backend consumes NHWC"
    spec = consumer_spec(low.algo, node.conv)
    if spec is None:
        return None, f"{low.algo.key} has no directly-consumable format here"
    return spec, ""


def _thread_layouts(graph: Graph, plan: Optional[ExecutionPlan],
                    base: Dict[int, ConvLowering], elide: bool,
                    overrides: Dict[Tuple[int, int], bool]
                    ) -> LoweredProgram:
    """Derive per-edge LayoutTransitions and attach in/out layouts.

    Chain edges store the consumer's own input layout (the Table 2 edge
    cost already prices exactly that store); split producers store ONE
    format — the PBQP's ``plan.store_formats`` pick when available,
    restricted to the fan-out's matching consumers — and siblings that
    want something else pay a converting load (``kernels.layouts.restore``).
    """
    transitions: Dict[Tuple[int, int], LayoutTransition] = {}
    store_specs: Dict[int, LayoutSpec] = {}
    in_layouts: Dict[int, LayoutSpec] = {}
    for u in graph.topo_order():
        succs = sorted(graph.successors(u))
        if not succs:
            continue
        # What each consumer *could* read directly — overrides do not
        # enter this vote, so disabling one edge never reshuffles its
        # siblings' transitions (a per-edge toggle measures that edge and
        # only that edge).
        wants = {v: _consumer_want(graph, base, v) for v in succs}
        if graph.nodes[u].kind is LayerKind.INPUT:
            # The network input arrives in NHWC from outside (the serving
            # engine's staging buffer, the client): there is no producer
            # layer to store a format, and the cost graph prices the input
            # vertex as a 3-D-tensor producer — the first layer always
            # pays its own load-side conversion. (NHWC-consuming layers
            # still match trivially.)
            wants = {v: ((s, why) if s is not None and s.kind == "nhwc"
                         else (None, "network input arrives in NHWC"))
                     for v, (s, why) in wants.items()}
        candidates = [] if not elide else \
            [s for (s, _) in wants.values()
             if s is not None and s.kind != "nhwc"]
        if plan is not None and len(succs) > 1 and u in plan.store_formats:
            # Honor the PBQP's store-format split vertex: only formats of
            # the chosen DRAM layout may be materialized on this fan-out.
            chosen = plan.store_formats[u]
            candidates = ([] if chosen is Layout.TENSOR3D else
                          [s for s in candidates if s.layout is chosen])
        store = _most_common_spec(candidates)
        if (store is not None and len(succs) == 1
                and overrides.get((u, succs[0])) is False):
            # A chain edge's store exists only for its one consumer: the
            # override restores the true NHWC baseline (no materialization
            # at all), not a round trip through the format.
            store = None
        for v in succs:
            want, why = wants[v]
            if not elide:
                want, why = None, "elision disabled"
            elif overrides.get((u, v)) is False:
                want, why = None, "disabled by per-edge override"
            if want is not None and store is not None and want == store:
                transitions[(u, v)] = LayoutTransition(u, v, store, True)
                in_layouts[v] = store
            elif want is not None and want.kind == "nhwc" and store is None:
                # kn2row / non-conv consumers: the 3-D tensor IS their
                # input layout — matched without any conversion.
                transitions[(u, v)] = LayoutTransition(u, v, NHWC, True)
            else:
                if not why:
                    why = ("converting load (store format mismatch)"
                           if store is not None
                           else "store format stays NHWC")
                transitions[(u, v)] = LayoutTransition(
                    u, v, store if store is not None else NHWC, False, why)
        if store is not None:
            store_specs[u] = store
    convs = {
        nid: dataclasses.replace(low, in_layout=in_layouts.get(nid),
                                 out_layout=store_specs.get(nid))
        for nid, low in base.items()
    }
    return LoweredProgram(convs, transitions, store_specs)


def _fuse_precision_edges(graph: Graph, prog: LoweredProgram
                          ) -> LoweredProgram:
    """Skip the f32 round trip on int8→int8 chain edges.

    A single-consumer NHWC edge between two int8 layers carries int8: the
    producer requantizes its fused epilogue output into the consumer's
    activation scale (``out_scale``) and the consumer skips its own input
    quantization (``in_quantized``) — the precision counterpart of layout
    elision, reusing the same LayoutTransition bookkeeping. Fan-outs and
    non-NHWC edges stay f32 (consumers quantize on load).
    """
    convs = dict(prog.convs)
    transitions = dict(prog.transitions)
    for (u, v), tr in prog.transitions.items():
        lu, lv = convs.get(u), convs.get(v)
        if (lu is None or lv is None
                or lu.precision != "int8" or lv.precision != "int8"
                or len(graph.successors(u)) != 1
                or tr.layout.kind != "nhwc"
                or lu.out_layout is not None or lv.in_layout is not None):
            continue
        convs[u] = dataclasses.replace(convs[u], out_scale=lv.in_scale)
        convs[v] = dataclasses.replace(convs[v], in_quantized=True)
        transitions[(u, v)] = dataclasses.replace(tr, precision="int8")
    return LoweredProgram(convs, transitions, prog.store_specs)


def lower_plan(graph: Graph, plan: Optional[ExecutionPlan],
               default_algo: Algorithm = IM2COL, *,
               epilogue: str = "relu",
               backend: str = "auto",
               tuning: Optional[object] = None,
               batch: Optional[int] = None,
               elide: bool = True,
               elide_overrides: Optional[Dict[Tuple[int, int], bool]] = None,
               act_scales: Optional[Dict[int, float]] = None,
               calibration: Optional[TransitionCalibration] = None
               ) -> LoweredProgram:
    """Lower an ExecutionPlan to the static spec consumed at trace time.

    With ``plan=None`` every conv gets ``default_algo`` under the NS
    dataflow on a 128×128 virtual array (the paper's unconfigured overlay).

    ``epilogue``/``backend`` seed every layer's lowering; a ``tuning``
    record (``core.autotune``) overrides the cost-model binding — algorithm,
    dataflow, (p1, p2) blocks and backend — per layer with the *measured*
    winner, keyed by (conv signature, batch bucket). ``batch`` selects the
    bucket the lowered program will serve (None → bucket 1): bindings do
    not rank identically across batch sizes, so a bucketed serving engine
    lowers one spec per bucket. Layers without a record entry keep the
    model-predicted binding.

    The returned ``LoweredProgram`` also carries the realized store format
    of every edge: with ``elide=True`` (default) consumers read matching
    store formats directly and the NHWC round trip survives only where
    producer/consumer layouts disagree; ``elide=False`` lowers the
    layout-agnostic always-round-trip program (the pre-layout baseline,
    kept for benchmarking); ``elide_overrides`` flips individual edges
    (``{(src, dst): False}``), letting the autotuner measure elision
    per edge. Unknown epilogue/backend strings and malformed overrides are
    rejected here, not at trace time.

    Precision: a plan whose ``precisions`` marks a layer "int8" lowers it
    to the quantized overlay path; ``act_scales`` (conv node → calibrated
    per-tensor activation scale, ``core.quant.calibrate_act_scales``) is
    then required for every int8 layer. Int8→int8 single-consumer NHWC
    edges fuse (the producer requantizes straight into the consumer's
    scale and the edge carries int8); every other precision boundary is a
    plain quantize/dequantize at the consumer/producer.

    ``calibration`` rides along on the returned program (it does not
    change the lowering itself): downstream re-pricing —
    ``transition_report`` — reads it from ``LoweredProgram.calibration``,
    the single calibration channel shared with ``map_network``.
    """
    _validate_lowering(graph, epilogue, backend, elide_overrides)
    precisions = (getattr(plan, "precisions", None) or {}) \
        if plan is not None else {}
    base: Dict[int, ConvLowering] = {}
    for node in graph.conv_nodes():
        nid = node.id
        if plan is None:
            low = ConvLowering(default_algo, Dataflow.NS, 128, 128,
                               epilogue, backend)
        else:
            low = ConvLowering(
                plan.assignment.get(nid, default_algo),
                plan.dataflows.get(nid, Dataflow.NS),
                plan.p1, plan.p2, epilogue, backend)
        prec = precisions.get(nid, "bf16")
        if prec not in PRECISIONS:
            raise ValueError(f"conv {nid}: unknown precision {prec!r}; "
                             f"want one of {PRECISIONS}")
        if tuning is not None:
            tuned = tuning.lowering_for(node.conv, batch=batch,
                                        precision=prec)
            if tuned is not None:
                if tuned.backend not in BACKENDS:
                    raise ValueError(
                        f"tuning record binds conv {nid} to unknown "
                        f"backend {tuned.backend!r}; want one of {BACKENDS}")
                low = dataclasses.replace(
                    low, algo=tuned.algo, dataflow=tuned.dataflow,
                    p1=tuned.p1, p2=tuned.p2, backend=tuned.backend)
        if prec == "int8":
            if low.algo.family is AlgoFamily.WINOGRAD:
                raise ValueError(f"conv {nid}: Winograd is bf16-only; an "
                                 "int8 plan entry cannot lower to it")
            if act_scales is None or nid not in act_scales:
                raise ValueError(
                    f"conv {nid} is planned int8 but has no calibrated "
                    "activation scale; pass act_scales from "
                    "core.quant.calibrate_act_scales")
            low = dataclasses.replace(low, precision="int8",
                                      in_scale=float(act_scales[nid]))
        base[nid] = low
    prog = _thread_layouts(graph, plan, base, elide, elide_overrides or {})
    if any(l.precision == "int8" for l in prog.convs.values()):
        prog = _fuse_precision_edges(graph, prog)
    prog.calibration = calibration
    return prog


def _layer_out(node: LayerNode) -> Tuple[int, int, int]:
    """(H, W, C) of a node's output; builders annotate non-conv nodes."""
    if node.conv is not None:
        return (node.conv.o1, node.conv.o2, node.conv.c_out)
    shape = node.attrs.get("out_shape")
    if shape is None:
        raise ValueError(f"node {node.name} missing out_shape annotation")
    h, w, c = shape  # type: ignore[misc]
    return int(h), int(w), int(c)


def _passthrough_cost(node: LayerNode, spec: TPUSpec) -> float:
    """Node cost of non-conv layers (§3.4 pooling module, adds, softmax)."""
    h, w, c = _layer_out(node)
    elems = h * w * c
    if node.kind in (LayerKind.POOL_MAX, LayerKind.POOL_AVG):
        k = int(node.attrs.get("k", 3))
        ops = elems * k * k
        return ops / spec.vpu_flops + elems * spec.dtype_bytes / spec.hbm_bw
    if node.kind in (LayerKind.ADD, LayerKind.SOFTMAX, LayerKind.GLOBAL_POOL):
        return elems / spec.vpu_flops + elems * spec.dtype_bytes / spec.hbm_bw
    if node.kind is LayerKind.FC:
        a = 1
        b = int(node.attrs["in_features"])
        c_ = int(node.attrs["out_features"])
        # FC = single GEMM; dataflow freedom still applies.
        _, steps = best_dataflow(a, b, c_, 128, 128)
        return steps * (128 * 128) / spec.peak_macs \
            + b * c_ * spec.dtype_bytes / spec.hbm_bw
    return 0.0


class CostGraphBuilder:
    """§5.1 — builds the PBQP instance from a CNN graph."""

    def __init__(self, graph: Graph, hw: HardwareChoice,
                 menu: Optional[Sequence[Algorithm]] = None,
                 spec: TPUSpec = V5E,
                 implicit_im2col: bool = False,
                 use_on_chip: bool = True,
                 quantize: bool = False,
                 int8_spec: TPUSpec = V5E_INT8,
                 force_bf16: Sequence[int] = (),
                 calibration: Optional[TransitionCalibration] = None) -> None:
        self.graph = graph
        self.hw = hw
        self.menu = list(menu) if menu is not None else list(DEFAULT_MENU)
        self.spec = spec
        self.implicit_im2col = implicit_im2col
        self.use_on_chip = use_on_chip
        # Measured-vs-predicted transition scales: every edge matrix the
        # builder prices goes through ``transition_cost(calibration=...)``,
        # so a re-solve sees the machine's realized transition costs (the
        # closed-loop re-pricing path — see ``map_network``/``replan``).
        self.calibration = calibration
        # Precision dimension: with ``quantize`` on, every non-Winograd
        # algorithm entry gets an int8 replica priced under ``int8_spec``
        # (the accuracy gate re-solves with demoted layers in
        # ``force_bf16``, which suppresses their int8 entries entirely —
        # so a demoted layer's choice vector is identical to the
        # unquantized build and its assignment is bitwise-stable).
        self.quantize = quantize
        self.int8_spec = int8_spec
        self.force_bf16 = frozenset(force_bf16)
        self.choices: Dict[int, NodeChoices] = {}
        self.split_formats: Dict[int, List[Algorithm]] = {}
        # Virtual store-format vertex id → the producer it splits, so the
        # solved plan can key store_formats by *producer* (what the
        # lowering pipeline needs to materialize the format).
        self.split_producer: Dict[int, int] = {}
        self._next_virtual_id = max(graph.nodes) + 1 if graph.nodes else 0

    # ------------------------------------------------------------- choices
    def _conv_choices(self, node: LayerNode) -> NodeChoices:
        assert node.conv is not None
        menu = menu_for(node.conv, self.menu)
        algos, costs, dfs, labels, precs = [], [], [], [], []
        for algo in menu:
            df = self.hw.psi.get((node.id, algo.key))
            nc = node_cost(node.conv, algo, self.hw.p1, self.hw.p2, df,
                           self.spec)
            algos.append(algo)
            costs.append(nc.total)
            dfs.append(nc.dataflow)
            labels.append(algo.key)
            precs.append("bf16")
        if self.quantize and node.id not in self.force_bf16:
            for algo in menu:
                if algo.family is AlgoFamily.WINOGRAD:
                    continue  # transforms amplify quantization error
                df = self.hw.psi.get((node.id, algo.key))
                nc = node_cost(node.conv, algo, self.hw.p1, self.hw.p2, df,
                               self.int8_spec)
                algos.append(algo)
                costs.append(nc.total)
                dfs.append(nc.dataflow)
                labels.append(f"{algo.key}@int8")
                precs.append("int8")
        return NodeChoices(node.id, node.kind, algos, labels,
                           np.asarray(costs), dfs,
                           precs if self.quantize else None)

    def _pass_choices(self, node: LayerNode) -> NodeChoices:
        return NodeChoices(node.id, node.kind, [], [PASSTHROUGH],
                           np.asarray([_passthrough_cost(node, self.spec)]),
                           [None])

    # ---------------------------------------------------------- transitions
    def _quant_pass_s(self, elems: int) -> float:
        """One elementwise quantize pass on an edge tensor: read the bf16
        activations, write int8 (the dequantize direction is free — the
        int8 producer's accumulator flush emits f32 anyway)."""
        return elems * (self.spec.dtype_bytes
                        + self.int8_spec.dtype_bytes) / self.spec.hbm_bw

    def _edge_matrix(self, src: LayerNode, dst: LayerNode,
                     src_ch: NodeChoices, dst_ch: NodeChoices) -> np.ndarray:
        """Table 2 store+load matrix between two executable vertices.

        Precision boundaries price here: an int8→int8 chain edge moves
        int8 bytes (the fused requantized transfer, ``int8_spec``); a
        bf16→int8 boundary adds the consumer's quantize pass; int8→bf16
        costs nothing extra (the flush emits f32)."""
        sh, sw, sc = _layer_out(src)
        m = np.zeros((len(src_ch.labels), len(dst_ch.labels)))
        elems = sh * sw * sc
        on_chip = False
        if self.use_on_chip and dst.conv is not None:
            on_chip = fits_on_chip(elems, dst.conv.in_elems, self.spec)
        elif self.use_on_chip and dst.conv is None:
            dh, dw, dc = _layer_out(dst)
            on_chip = fits_on_chip(elems, dh * dw * dc, self.spec)

        sp = _precisions_or_default(src_ch)
        dp = _precisions_or_default(dst_ch)
        for i, s_algo in enumerate(_algos_or_default(src_ch)):
            for j, d_algo in enumerate(_algos_or_default(dst_ch)):
                if dst.conv is not None:
                    both_int8 = sp[i] == "int8" and dp[j] == "int8"
                    m[i, j] = transition_cost(
                        s_algo, d_algo, dst.conv, sc,
                        self.int8_spec if both_int8 else self.spec,
                        implicit_im2col=self.implicit_im2col,
                        on_chip=on_chip,
                        calibration=self.calibration)
                    if dp[j] == "int8" and sp[i] != "int8":
                        m[i, j] += self._quant_pass_s(elems)
                else:
                    # Non-conv consumer: 3-D tensor round trip (an int8
                    # producer emits f32 at the boundary — same bytes).
                    bytes_ = elems * self.spec.dtype_bytes
                    m[i, j] = 0.0 if on_chip else 2 * bytes_ / self.spec.hbm_bw
                    if not on_chip and self.calibration is not None:
                        m[i, j] *= self.calibration.scale(
                            s_algo.output_layout, Layout.TENSOR3D)
        return m

    def _split_store_matrix(self, src: LayerNode, src_ch: NodeChoices,
                            formats: List[Algorithm],
                            rep_consumer: Optional[ConvMeta]) -> np.ndarray:
        sh, sw, sc = _layer_out(src)
        m = np.zeros((len(src_ch.labels), len(formats)))
        for i, s_algo in enumerate(_algos_or_default(src_ch)):
            for j, fmt in enumerate(formats):
                if rep_consumer is not None:
                    m[i, j] = 0.5 * transition_cost(
                        s_algo, fmt, rep_consumer, sc, self.spec,
                        implicit_im2col=self.implicit_im2col,
                        calibration=self.calibration)
                else:
                    m[i, j] = sh * sw * sc * self.spec.dtype_bytes \
                        / self.spec.hbm_bw
        return m

    def _split_load_matrix(self, formats: List[Algorithm],
                           src: LayerNode,
                           dst: LayerNode, dst_ch: NodeChoices) -> np.ndarray:
        sh, sw, sc = _layer_out(src)
        m = np.zeros((len(formats), len(dst_ch.labels)))
        dp = _precisions_or_default(dst_ch)
        for i, fmt in enumerate(formats):
            for j, d_algo in enumerate(_algos_or_default(dst_ch)):
                if dst.conv is None:
                    m[i, j] = sh * sw * sc * self.spec.dtype_bytes \
                        / self.spec.hbm_bw
                    continue
                if fmt.input_layout is d_algo.input_layout and \
                        (fmt.family is not AlgoFamily.WINOGRAD or
                         fmt.m == d_algo.m):
                    # Matched format → streaming load (paper's Load(n, n)).
                    m[i, j] = 0.5 * transition_cost(
                        fmt, d_algo, dst.conv, sc, self.spec,
                        implicit_im2col=self.implicit_im2col,
                        calibration=self.calibration)
                else:
                    # Converting load: pay the dst-layout bytes at the
                    # (possibly lane-penalized) effective bandwidth.
                    m[i, j] = transition_cost(
                        fmt, d_algo, dst.conv, sc, self.spec,
                        implicit_im2col=self.implicit_im2col,
                        calibration=self.calibration)
                if dp[j] == "int8":
                    # Fan-out stores stay f32; an int8 consumer pays its
                    # own quantize pass on load.
                    m[i, j] += self._quant_pass_s(sh * sw * sc)
        return m

    # ---------------------------------------------------------------- build
    def build(self) -> Tuple[PBQP, Dict[int, NodeChoices]]:
        g = self.graph
        pbqp = PBQP()
        for nid in g.topo_order():
            node = g.nodes[nid]
            ch = (self._conv_choices(node) if node.kind is LayerKind.CONV
                  else self._pass_choices(node))
            self.choices[nid] = ch
            pbqp.add_node(nid, ch.costs)

        for nid in g.topo_order():
            node = g.nodes[nid]
            succs = g.successors(nid)
            if len(succs) <= 1:
                for s in succs:
                    pbqp.add_edge(nid, s, self._edge_matrix(
                        node, g.nodes[s], self.choices[nid], self.choices[s]))
                continue
            # out-degree > 1 → insert the store-format vertex v_s (§5.1).
            formats: List[Algorithm] = []
            seen = set()
            for s in succs:
                for algo in _algos_or_default(self.choices[s]):
                    key = (algo.input_layout, algo.m)
                    if key not in seen:
                        seen.add(key)
                        formats.append(algo)
            rep = next((g.nodes[s].conv for s in succs
                        if g.nodes[s].conv is not None), None)
            vs = self._next_virtual_id
            self._next_virtual_id += 1
            self.split_producer[vs] = nid
            vs_ch = NodeChoices(vs, LayerKind.CONCAT, formats,
                                [f"store:{a.input_layout.value}" for a in formats],
                                np.zeros(len(formats)),
                                [None] * len(formats))
            self.choices[vs] = vs_ch
            self.split_formats[nid] = formats
            pbqp.add_node(vs, vs_ch.costs)
            pbqp.add_edge(nid, vs, self._split_store_matrix(
                node, self.choices[nid], formats, rep))
            for s in succs:
                pbqp.add_edge(vs, s, self._split_load_matrix(
                    formats, node, g.nodes[s], self.choices[s]))
        return pbqp, self.choices


def _algos_or_default(ch: NodeChoices) -> List[Algorithm]:
    """Passthrough vertices behave as 3-D-tensor producers/consumers, which
    is exactly kn2row's layout (§3.3)."""
    return ch.algos if ch.algos else [KN2ROW]


def _precisions_or_default(ch: NodeChoices) -> List[str]:
    """Entry-wise precisions; vertices without the dimension are bf16."""
    if ch.precisions:
        return ch.precisions
    return ["bf16"] * max(len(ch.labels), 1)


_CAL_UNSET = object()   # sentinel: distinguishes "not passed" from None


def transition_report(graph: Graph, lowered: LoweredProgram,
                      spec: TPUSpec = V5E,
                      calibration=_CAL_UNSET) -> Dict[str, object]:
    """Predicted Table 2 cost of the lowered program's elided transitions
    vs the always-NHWC-round-trip baseline — what the layout bench compares
    against realized wall clock.

    Pricing mirrors the cost graph exactly: an elided edge pays the
    direct store into the consumer's format (½·T) plus the matched
    streaming load (½·T(dst, dst)); the round-trip baseline pays the 3-D
    tensor store (½·T(src, 3D)) plus the converting load into the
    consumer's layout (full T, the ``_split_load_matrix`` convention).

    Calibration comes from ``lowered.calibration`` (set by
    ``lower_plan(calibration=...)``) — the single channel shared with
    ``map_network``. Passing ``calibration=`` here directly is deprecated;
    it still wins over the program's own calibration so existing callers
    price identically, but new code should thread it through
    ``lower_plan``.
    """
    if calibration is _CAL_UNSET:
        calibration = lowered.calibration
    elif calibration is not None:
        warnings.warn(
            "transition_report(calibration=...) is deprecated; pass "
            "calibration to lower_plan(...) and let the LoweredProgram "
            "carry it", DeprecationWarning, stacklevel=2)
    edges = []
    roundtrip_total = elided_total = 0.0
    for (u, v), tr in sorted(lowered.transitions.items()):
        node_v = graph.nodes[v]
        if (not tr.elide or tr.layout.kind == "nhwc"
                or node_v.kind is not LayerKind.CONV):
            continue
        conv = node_v.conv
        dst = lowered[v].algo
        src = lowered.convs[u].algo if u in lowered.convs else KN2ROW
        c_prev = tr.layout.c
        roundtrip = (0.5 * transition_cost(src, KN2ROW, conv, c_prev, spec,
                                           calibration=calibration)
                     + transition_cost(KN2ROW, dst, conv, c_prev, spec,
                                       calibration=calibration))
        elided = (0.5 * transition_cost(src, dst, conv, c_prev, spec,
                                        calibration=calibration)
                  + 0.5 * transition_cost(dst, dst, conv, c_prev, spec,
                                          calibration=calibration))
        roundtrip_total += roundtrip
        elided_total += elided
        edges.append({"src": u, "dst": v, "layout": tr.layout.key,
                      "roundtrip_s": roundtrip, "elided_s": elided,
                      "saving_s": roundtrip - elided})
    return {"edges": edges, "n_elided": len(edges),
            "predicted_roundtrip_s": roundtrip_total,
            "predicted_elided_s": elided_total,
            "predicted_saving_s": roundtrip_total - elided_total}


# ---------------------------------------------------------------------------
# The public flow.
# ---------------------------------------------------------------------------

def map_network(graph: Graph,
                menu: Optional[Sequence[Algorithm]] = None,
                spec: TPUSpec = V5E,
                hw: Optional[HardwareChoice] = None,
                implicit_im2col: bool = False,
                use_on_chip: bool = True,
                solver: str = "sp",
                quantize: bool = False,
                int8_spec: TPUSpec = V5E_INT8,
                force_bf16: Sequence[int] = (),
                calibration: Optional[TransitionCalibration] = None
                ) -> ExecutionPlan:
    """Run the full DYNAMAP flow on a CNN graph. ``solver`` ∈ {sp, brute,
    greedy_node, greedy_incremental} — non-sp solvers exist for the paper's
    baseline comparisons and for optimality tests.

    ``quantize=True`` adds per-layer precision as a joint PBQP dimension:
    each non-Winograd algorithm entry gets an int8 replica priced under
    ``int8_spec`` (2× peak MACs, half the bytes on V5E) with precision-
    boundary conversion costs on the edges, and the solved plan carries a
    ``precisions`` map. ``force_bf16`` pins the listed conv nodes to bf16
    (the accuracy gate's demotion mechanism): a pinned node's choice
    vector is identical to the unquantized build, so demoted layers lower
    bitwise-identically to the all-bf16 plan.

    ``calibration`` (``cost_model.TransitionCalibration``) re-prices every
    edge matrix by the measured/predicted scale of its (source layout,
    destination layout) pair, so a re-solve optimizes against the machine's
    realized transition costs instead of the analytical model — the
    closed-loop half of the DSE (see ``replan`` and
    ``serving.supervisor.PlanSupervisor``). Mapping is deterministic: the
    same graph + spec + calibration always yields the identical plan."""
    if hw is None:
        hw = identify_parameters(graph, menu=menu, spec=spec)
    builder = CostGraphBuilder(graph, hw, menu=menu, spec=spec,
                               implicit_im2col=implicit_im2col,
                               use_on_chip=use_on_chip,
                               quantize=quantize, int8_spec=int8_spec,
                               force_bf16=force_bf16,
                               calibration=calibration)
    pbqp, choices = builder.build()

    if solver == "sp":
        res = solve_series_parallel(pbqp)
    elif solver == "brute":
        res = solve_brute_force(pbqp)
    elif solver == "greedy_node":
        res = solve_greedy_node(pbqp)
    elif solver == "greedy_incremental":
        order = [n for n in sorted(pbqp.costs)]
        res = solve_greedy_incremental(pbqp, order)
    else:
        raise ValueError(f"unknown solver {solver}")

    assignment: Dict[int, Algorithm] = {}
    dataflows: Dict[int, Dataflow] = {}
    store_formats: Dict[int, Layout] = {}
    precisions: Dict[int, str] = {}
    for nid, ch in choices.items():
        pick = res.assignment[nid]
        if ch.kind is LayerKind.CONV and ch.algos:
            assignment[nid] = ch.algos[pick]
            df = ch.dataflows[pick]
            dataflows[nid] = df if df is not None else Dataflow.NS
            if quantize:
                precisions[nid] = _precisions_or_default(ch)[pick]
        elif ch.labels and ch.labels[pick].startswith("store:"):
            # Keyed by the split *producer* (the graph node that stores),
            # not the virtual v_s id — this is what lower_plan consumes.
            store_formats[builder.split_producer[nid]] = \
                ch.algos[pick].input_layout
    return ExecutionPlan(p1=hw.p1, p2=hw.p2, assignment=assignment,
                         dataflows=dataflows, store_formats=store_formats,
                         total_cost_s=res.cost, solver=res, choices=choices,
                         precisions=precisions)


def plan_fingerprint(plan: Optional[ExecutionPlan]):
    """Content fingerprint of the parts of a plan a compiled program closes
    over (bindings + store formats + precisions — solver diagnostics
    excluded). Two plans with equal fingerprints lower and compile
    identically; the executable cache and the hot-swap supervisor both key
    off this."""
    if plan is None:
        return None
    precisions = getattr(plan, "precisions", None) or {}
    return (plan.p1, plan.p2,
            tuple(sorted((n, a.key) for n, a in plan.assignment.items())),
            tuple(sorted((n, d.name) for n, d in plan.dataflows.items())),
            tuple(sorted((n, f.value) for n, f in plan.store_formats.items())),
            tuple(sorted(precisions.items())))


@dataclasses.dataclass(frozen=True)
class ReplanResult:
    """Outcome of one calibrated re-solve against a deployed plan.

    ``plan`` is what should be serving after this decision: the candidate
    when adopted, the deployed plan otherwise. ``changed`` records whether
    the candidate's fingerprint differs at all; ``adopted`` additionally
    requires the candidate to beat the deployed plan's *re-priced* cost by
    more than the hysteresis margin — re-priced meaning the deployed
    assignment evaluated under the SAME calibrated cost graph the
    candidate was solved on, so the comparison is apples to apples."""
    plan: ExecutionPlan
    candidate: ExecutionPlan
    adopted: bool
    changed: bool
    deployed_cost_s: float
    candidate_cost_s: float


def replan(graph: Graph, deployed: ExecutionPlan, *,
           calibration: Optional[TransitionCalibration] = None,
           hysteresis: float = 0.05,
           **map_kwargs) -> ReplanResult:
    """Calibrated PBQP re-solve with a hysteresis adoption gate.

    Re-solves the mapping under ``calibration`` and prices the *deployed*
    assignment on the same calibrated cost graph; the candidate is adopted
    only when it differs AND its solved cost undercuts the deployed plan's
    re-priced cost by more than ``hysteresis`` (fraction, default the
    autotuner's 5%). Perturbing every calibration scale by a factor within
    ``1 ± hysteresis/2`` can shift the deployed/candidate cost ratio by at
    most ~2×(hysteresis/2), so sub-hysteresis measurement noise can never
    flip the deployed plan — the stability property
    ``tests/test_property.py`` checks.

    ``map_kwargs`` must repeat the kwargs the deployed plan was mapped
    with (menu/spec/solver/...): the deployed assignment's choice indices
    are only meaningful on an identically-shaped cost graph."""
    candidate = map_network(graph, calibration=calibration, **map_kwargs)
    builder_kw = {k: v for k, v in map_kwargs.items() if k != "solver"}
    hw = builder_kw.pop("hw", None)
    menu = builder_kw.pop("menu", None)
    spec = builder_kw.pop("spec", V5E)
    if hw is None:
        hw = identify_parameters(graph, menu=menu, spec=spec)
    builder = CostGraphBuilder(graph, hw, menu=menu, spec=spec,
                               calibration=calibration, **builder_kw)
    pbqp, _ = builder.build()
    deployed_cost = pbqp.total_cost(deployed.solver.assignment)
    changed = plan_fingerprint(candidate) != plan_fingerprint(deployed)
    adopted = changed and \
        candidate.total_cost_s < deployed_cost * (1.0 - hysteresis)
    return ReplanResult(plan=candidate if adopted else deployed,
                        candidate=candidate, adopted=adopted,
                        changed=changed,
                        deployed_cost_s=deployed_cost,
                        candidate_cost_s=candidate.total_cost_s)


def evaluate_fixed_mapping(graph: Graph, policy: str,
                           menu: Optional[Sequence[Algorithm]] = None,
                           spec: TPUSpec = V5E,
                           hw: Optional[HardwareChoice] = None,
                           implicit_im2col: bool = False,
                           use_on_chip: bool = True) -> float:
    """Cost of the paper's single-algorithm baselines on the same cost graph:
    bl3 = 'im2col', bl4 = 'kn2row' (where possible, else im2col),
    bl5 = 'winograd' (where applicable, else im2col)."""
    if hw is None:
        hw = identify_parameters(graph, menu=menu, spec=spec)
    builder = CostGraphBuilder(graph, hw, menu=menu, spec=spec,
                               implicit_im2col=implicit_im2col,
                               use_on_chip=use_on_chip)
    pbqp, choices = builder.build()

    assignment: Dict[int, int] = {}
    for nid, ch in choices.items():
        if ch.kind is LayerKind.CONV and ch.algos:
            idx = _pick_for_policy(ch.algos, policy)
        else:
            # Split vertices: choose the best format greedily given the
            # forced conv assignment is uniform — pick matched layout.
            idx = _split_pick(ch, policy)
        assignment[nid] = idx
    return pbqp.total_cost(assignment)


def _pick_for_policy(algos: List[Algorithm], policy: str) -> int:
    fams = [a.family for a in algos]
    if policy == "im2col":
        return fams.index(AlgoFamily.IM2COL)
    if policy == "kn2row":
        if AlgoFamily.KN2ROW in fams:
            return fams.index(AlgoFamily.KN2ROW)
        return fams.index(AlgoFamily.IM2COL)
    if policy == "winograd":
        if AlgoFamily.WINOGRAD in fams:
            return fams.index(AlgoFamily.WINOGRAD)
        return fams.index(AlgoFamily.IM2COL)
    raise ValueError(policy)


def _split_pick(ch: NodeChoices, policy: str) -> int:
    if not ch.labels or not ch.labels[0].startswith("store:"):
        return 0
    want = {"im2col": Layout.TOEPLITZ, "kn2row": Layout.TENSOR3D,
            "winograd": Layout.WINOGRAD}.get(policy, Layout.TENSOR3D)
    for i, a in enumerate(ch.algos):
        if a.input_layout is want:
            return i
    return 0
