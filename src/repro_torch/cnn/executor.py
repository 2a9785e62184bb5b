"""Graph executor: runs a CNN under a DYNAMAP ExecutionPlan.

Every conv dispatches to the same overlay (``overlay.apply_conv``); only
the per-layer binding — algorithm wrapper plus dataflow/(p1, p2) blocks —
differs. Two execution modes, as in the reference:

* ``forward`` — eager: lowers the plan and walks the graph per call.
* ``compile_plan`` — lowers (graph, plan) ONCE into a static
  ``LoweredProgram`` and returns a ``CompiledProgram``: one program per
  (graph, plan, bucket), batched, with params as call arguments. On a
  CUDA device it is the counterpart of the reference's ``jax.jit``
  executable: per input shape and params, the first call walks the
  lowering eagerly (the warm pass), the second captures one walk into a
  CUDA graph, and every later call replays it — no Python dispatch on
  the hot path. On the CPU every call is the eager walk. With a
  ``launch.mesh.DataMesh`` it returns a ``ShardedProgram``: one
  ``CompiledProgram`` per shard on the shard's device, the batch split
  across them and the outputs gathered on the mesh's first device.

Entry points take ``device="cuda"`` by default and raise when CUDA is
absent; the CPU runs only when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import hashlib
import json
import threading
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.cnn import layers as L
from repro_torch.cnn import overlay
from repro_torch.core.algorithms import IM2COL, Algorithm
from repro_torch.core.graph import Graph, LayerKind
from repro_torch.core.layouts import LayoutSpec, is_nhwc
from repro_torch.core.mapper import (ConvLowering, ExecutionPlan,
                                     LoweredProgram, lower_plan,
                                     plan_fingerprint)
from repro_torch.distributed.sharding import (data_shard_count, replicate,
                                              shard_batch)
from repro_torch.kernels.common import device_guard, resolve_device
from repro_torch.kernels.layouts import materialize, restore
from repro_torch.launch.mesh import DataMesh

Params = Dict[int, Dict[str, torch.Tensor]]
Lowering = Union[LoweredProgram, Dict[int, ConvLowering]]


def graph_hash(graph: Graph) -> str:
    """Stable structural hash of a CNN graph: layer kinds, conv signatures,
    non-conv attrs and edges — node *names* are display-only and excluded
    (the reference's hash, so both packages key a graph alike)."""
    h = hashlib.sha256()
    for nid in sorted(graph.nodes):
        node = graph.nodes[nid]
        c = node.conv
        conv_sig = ("-" if c is None else
                    f"{c.c_in}x{c.c_out}_{c.h1}x{c.h2}_{c.k1}x{c.k2}"
                    f"_s{c.stride}_{c.pad}")
        attrs = ";".join(f"{k}={node.attrs[k]!r}" for k in sorted(node.attrs))
        h.update(f"n{nid}|{node.kind.value}|{conv_sig}|{attrs}\n".encode())
    for src, dst in sorted(graph.edges):
        h.update(f"e{src}>{dst}\n".encode())
    return h.hexdigest()[:16]


def _tuning_fingerprint(tuning) -> Optional[str]:
    """Content hash of a ``TuningRecord`` — records are keyed by conv
    signature, not by graph, so the same record object (or an equal reload
    of it) fingerprints equal and lets tenants share tuned programs."""
    if tuning is None:
        return None
    blob = json.dumps(tuning.to_json(), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _mesh_fingerprint(mesh: DataMesh) -> tuple:
    """A mesh's identity: its axis names and its device list, repeats
    included, so a one-device mesh and the unsharded program on the same
    card key apart (the reference's ``_mesh_fingerprint`` differs from
    ``None``) and two meshes over the same devices key alike."""
    return (tuple(mesh.axis_names), tuple(str(d) for d in mesh.devices))


def executable_cache_key(graph: Graph, plan: Optional[ExecutionPlan] = None,
                         *, default_algo: Algorithm = IM2COL,
                         use_pallas: Optional[bool] = None,
                         epilogue: str = "relu",
                         tuning=None,
                         tuning_batch: Optional[int] = None,
                         avg_pool_via: str = "jnp",
                         elide: bool = True,
                         elide_overrides: Optional[Dict[Tuple[int, int],
                                                        bool]] = None,
                         act_scales: Optional[Dict[int, float]] = None,
                         mesh: Optional[DataMesh] = None,
                         device="cuda",
                         dtype: torch.dtype = torch.float32) -> tuple:
    """The ``(graph hash, plan, bucket, device or mesh, options)`` identity
    of one compiled program: everything ``compile_plan`` closes over except
    the params, which are call arguments; ``fault_hook``, a host-side wrapper
    applied outside the cache (so a fault-armed engine and a clean one
    share one program and its captures); and ``donate``, which changes
    nothing on the card (``compile_plan``), so a pipelined engine and a
    synchronous one share one program too. The plan fingerprint carries
    the per-layer precisions and ``act_scales`` the calibrated activation
    scales, so an int8 plan and the bf16 plan of one architecture, or two
    calibrations of one plan, never share a key; the tuning record enters
    by content, so a tuned and an untuned program never share one, and a
    record and its reload from JSON do. ``default_algo`` (the algorithm of
    every conv a plan does not assign) enters by its key and
    ``avg_pool_via`` as given, as in the reference. With a ``mesh`` the
    device slot holds the mesh's fingerprint instead. ``dtype`` (f32 or
    bf16: the params' and inputs' dtype the program takes) closes the key,
    so the f32 and the bf16 ladder of one model never share a program or
    its captures."""
    return (graph_hash(graph), plan_fingerprint(plan), default_algo.key,
            use_pallas, epilogue, _tuning_fingerprint(tuning),
            int(tuning_batch or 1), avg_pool_via, bool(elide),
            (None if elide_overrides is None
             else tuple(sorted(elide_overrides.items()))),
            (str(torch.device(device)) if mesh is None
             else _mesh_fingerprint(mesh)),
            (None if act_scales is None
             else tuple(sorted((int(n), float(s))
                               for n, s in act_scales.items()))),
            str(check_dtype(dtype)))


class ExecutableCache:
    """Cache of compiled overlay programs shared across serving engines:
    ``get_or_compile`` returns the cached callable for a key or builds and
    stores it. Entries are never evicted. Thread-safe (the lock is held
    across the build, so two threads never build one key twice)."""

    def __init__(self) -> None:
        self._store: Dict[tuple, Callable] = {}
        self.hits = 0
        self.misses = 0
        self._lock = threading.RLock()

    def get_or_compile(self, key: tuple,
                       builder: Callable[[], Callable]) -> Callable:
        with self._lock:
            run = self._store.get(key)
            if run is not None:
                self.hits += 1
                return run
            self.misses += 1
            run = builder()
            self._store[key] = run
            return run

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: tuple) -> bool:
        return key in self._store

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._store), "hits": self.hits,
                "misses": self.misses}


class _Staged:
    """One node's output as staged for its consumers: the value in the
    edge's store format plus a lazily-restored NHWC view (computed at most
    once per producer, shared by every mismatched consumer)."""

    __slots__ = ("value", "spec", "_nhwc")

    def __init__(self, value: torch.Tensor,
                 spec: Optional[LayoutSpec] = None) -> None:
        self.value = value
        self.spec = None if is_nhwc(spec) else spec
        self._nhwc = value if self.spec is None else None

    def nhwc(self) -> torch.Tensor:
        if self._nhwc is None:
            self._nhwc = restore(self.value, self.spec)   # converting load
        return self._nhwc

    def in_layout(self, spec: Optional[LayoutSpec]) -> torch.Tensor:
        """The value as a consumer's ``in_layout`` expects it."""
        if is_nhwc(spec):
            return self.nhwc()
        if self.spec == spec:
            return self.value                             # matched load
        return materialize(self.nhwc(), spec)


# The dtypes a CNN program runs in: its params, its input and every
# activation (f32, or bf16 as the reference runs it with bf16 params).
DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(dtype) -> torch.dtype:
    """``dtype`` if a CNN program runs in it (``DTYPES``), else
    ``TypeError``."""
    if dtype not in DTYPES:
        raise TypeError(f"CNN programs run in {DTYPES}, got {dtype}")
    return dtype


def params_dtype(params: Params) -> torch.dtype:
    """The one dtype of every tensor in ``params`` (``DTYPES``); mixed or
    other dtypes raise ``TypeError``."""
    dtypes = {t.dtype for layer in params.values() for t in layer.values()}
    if len(dtypes) != 1:
        raise TypeError(f"params mix dtypes {sorted(map(str, dtypes))}")
    return check_dtype(dtypes.pop())


def init_params(graph: Graph, seed: int = 0, device="cuda", *,
                dtype: torch.dtype = torch.float32,
                conv_bias: bool = True) -> Params:
    """Per-layer parameters ``{nid: {"w", "b"}}`` in ``dtype`` (f32 or
    bf16): He-style normal weights drawn in f32 from a ``torch.Generator``
    seeded with ``seed`` (on the CPU, so the same seed gives the same
    weights on every device, and the bf16 weights are the f32 ones
    rounded) and zero biases. Conv weights are ``(K1, K2, Cin, Cout)``, FC
    ``(in, out)``. ``conv_bias=False`` leaves the convs without ``"b"``
    (the reference's bias-free layout): a ``bias`` epilogue then lowers to
    its bias-free form."""
    dev = resolve_device(device)
    check_dtype(dtype)
    gen = torch.Generator().manual_seed(int(seed))
    params: Params = {}
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        if node.kind is LayerKind.CONV:
            m = node.conv
            fan_in = m.k1 * m.k2 * m.c_in
            w = torch.randn((m.k1, m.k2, m.c_in, m.c_out),
                            generator=gen) / float(np.sqrt(fan_in))
            params[nid] = {"w": w.to(dev, dtype)}
            if conv_bias:
                params[nid]["b"] = torch.zeros((m.c_out,), device=dev,
                                               dtype=dtype)
        elif node.kind is LayerKind.FC:
            fin = int(node.attrs["in_features"])
            fout = int(node.attrs["out_features"])
            w = torch.randn((fin, fout), generator=gen) / float(np.sqrt(fin))
            params[nid] = {"w": w.to(dev, dtype),
                           "b": torch.zeros((fout,), device=dev,
                                            dtype=dtype)}
    return params


def _eval_graph(graph: Graph, lowering: Lowering, params: Params,
                x: torch.Tensor, use_pallas: Optional[bool],
                avg_pool_via: str = "jnp",
                conv_tap: Optional[Callable[[int, torch.Tensor], None]]
                = None) -> torch.Tensor:
    """Walk the graph once. Inter-layer values travel in the store formats
    the ``LoweredProgram`` realized: a producer stages its edge's format
    once (conv layers fuse the conversion via ``out_layout``, non-conv
    producers materialize it here), matched consumers read it directly
    and mismatched consumers restore to NHWC — the converting load.
    An int8 layer gets its precision, calibrated scales and whether its
    input edge already carries int8 from the lowering. ``avg_pool_via``
    picks the AvgPool form (``layers.avg_pool``): ``"overlay"`` runs each
    POOL_AVG node as a conv on the im2col kernel, as ``use_pallas`` says.

    ``conv_tap`` (the calibration hook) is called with ``(nid,
    nhwc_input)`` for every conv node."""
    batched = x.ndim == 4
    store_specs: Dict[int, LayoutSpec] = getattr(lowering, "store_specs", {})
    values: Dict[int, _Staged] = {}

    def _stage(nid: int, y: torch.Tensor) -> None:
        spec = store_specs.get(nid)
        values[nid] = _Staged(materialize(y, spec), spec)

    for nid in graph.topo_order():
        node = graph.nodes[nid]
        preds = graph.predecessors(nid)
        if node.kind is LayerKind.INPUT:
            _stage(nid, x)
            continue
        if node.kind is LayerKind.CONV:
            low = lowering[nid]
            m = node.conv
            pad = "SAME" if m.pad == "same" else "VALID"
            epi = low.epilogue
            bias = params[nid].get("b") if epi.startswith("bias") else None
            if epi.startswith("bias") and bias is None:
                # Bias-free params under a bias-carrying lowering.
                epi = "relu" if epi.endswith("relu") else "none"
            in_layout = getattr(low, "in_layout", None)
            out_layout = getattr(low, "out_layout", None)
            if conv_tap is not None:
                conv_tap(nid, values[preds[0]].nhwc())
            xin = values[preds[0]].in_layout(in_layout)
            y = overlay.apply_conv(
                xin, params[nid]["w"], low.algo, low.dataflow, low.p1, low.p2,
                stride=m.stride, padding=pad, use_pallas=use_pallas,
                backend=None if low.backend == "auto" else low.backend,
                epilogue=epi, bias=bias, in_layout=in_layout,
                out_layout=out_layout,
                precision=low.precision, in_scale=low.in_scale,
                out_scale=low.out_scale, in_quantized=low.in_quantized)
            if not epi.endswith("relu"):
                # CONV→ReLU graph semantics; ReLU commutes with the
                # linear-gather store formats.
                y = L.relu(y)
            values[nid] = _Staged(y, out_layout)
            continue
        ins = [values[p].nhwc() for p in preds]
        if node.kind is LayerKind.POOL_MAX:
            pad = "SAME" if node.attrs.get("pad", "same") == "same" else "VALID"
            y = L.max_pool(ins[0], int(node.attrs["k"]),
                           int(node.attrs["stride"]), pad)
        elif node.kind is LayerKind.POOL_AVG:
            pad = "SAME" if node.attrs.get("pad", "same") == "same" else "VALID"
            y = L.avg_pool(ins[0], int(node.attrs["k"]),
                           int(node.attrs["stride"]), pad, via=avg_pool_via,
                           use_pallas=use_pallas)
        elif node.kind is LayerKind.CONCAT:
            y = torch.cat(ins, dim=-1)
        elif node.kind is LayerKind.ADD:
            y = L.relu(sum(ins))
        elif node.kind is LayerKind.GLOBAL_POOL:
            gap = L.global_avg_pool(ins[0])          # (C,) or (B, C)
            y = (gap[:, None, None, :] if batched
                 else gap[None, None, :])
        elif node.kind is LayerKind.FC:
            flat = (ins[0].reshape(ins[0].shape[0], -1) if batched
                    else ins[0].reshape(-1))
            y = L.fc(flat, params[nid]["w"], params[nid]["b"])
        elif node.kind is LayerKind.SOFTMAX:
            y = torch.softmax(ins[0], dim=-1)
        elif node.kind is LayerKind.OUTPUT:
            y = ins[0]
        else:
            raise ValueError(f"unhandled node kind {node.kind}")
        _stage(nid, y)
    return values[graph.sink()].nhwc()


def input_dtype(x) -> torch.dtype:
    """The dtype a walk takes ``x`` in: bf16 for a bf16 tensor, else f32
    (numpy holds no bf16 here)."""
    bf16 = torch.is_tensor(x) and x.dtype == torch.bfloat16
    return torch.bfloat16 if bf16 else torch.float32


def _as_input(x, device: Optional[torch.device]) -> torch.Tensor:
    """A numpy array or tensor as a tensor of ``input_dtype`` on
    ``device`` (None: where it lies)."""
    x = torch.as_tensor(x, dtype=input_dtype(x))
    return x if device is None else x.to(device)


def _typed_input(x, device: Optional[torch.device],
                 dtype: torch.dtype) -> torch.Tensor:
    """``_as_input`` for params of ``dtype``, as the reference types the
    input of its walk: f32 over f32 params; f32 or bf16 over bf16 params,
    an f32 image kept in f32 (the reference promotes it, and the walk runs
    f32 through the overlay's dtype rule, the weights widened exactly).
    Numpy arrays and tensors of dtypes outside ``DTYPES`` become f32; a
    bf16 input over f32 params raises ``TypeError``."""
    x = _as_input(x, device)
    if x.dtype != dtype and x.dtype != torch.float32:
        raise TypeError(f"input of dtype {x.dtype} for params of {dtype}")
    return x


def forward(graph: Graph, params: Params, x,
            plan: Optional[ExecutionPlan] = None, *,
            default_algo: Algorithm = IM2COL,
            use_pallas: Optional[bool] = None,
            epilogue: str = "relu",
            tuning=None,
            tuning_batch: Optional[int] = None,
            elide: bool = True,
            elide_overrides: Optional[Dict[Tuple[int, int], bool]] = None,
            act_scales: Optional[Dict[int, float]] = None,
            conv_tap: Optional[Callable[[int, torch.Tensor], None]] = None,
            device="cuda") -> torch.Tensor:
    """Eager inference. ``x``: (H, W, C) single image or (B, H, W, C)
    batch. Each call re-lowers the plan — use ``compile_plan`` for the
    serving path. Convs the plan does not assign (every conv when
    ``plan=None``) run ``default_algo``; AvgPool runs the ``"jnp"`` way,
    as in the reference's eager forward. ``tuning`` (a
    ``core.autotune.TuningRecord``) binds each conv to its winner
    measured at bucket ``tuning_batch``;
    ``elide_overrides`` flips individual edges' elision. ``act_scales``
    supplies calibrated activation scales for int8 layers;
    ``conv_tap(nid, nhwc_input)`` observes every conv input
    (calibration)."""
    dev = resolve_device(device)
    lowering = lower_plan(graph, plan, default_algo, epilogue=epilogue,
                          tuning=tuning, batch=tuning_batch, elide=elide,
                          elide_overrides=elide_overrides,
                          act_scales=act_scales)
    with torch.inference_mode():
        return _eval_graph(graph, lowering, params,
                           _typed_input(x, dev, params_dtype(params)),
                           use_pallas, conv_tap=conv_tap)


class _Capture:
    """One captured forward: the CUDA graph and the static input and
    output buffers it reads and writes."""

    __slots__ = ("graph", "static_in", "static_out")

    def __init__(self, graph: "torch.cuda.CUDAGraph", static_in: torch.Tensor,
                 static_out: torch.Tensor) -> None:
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out


def capture_key(params: Params, x) -> Tuple[tuple, str, str, tuple]:
    """The capture-table key of one call: ``x``'s shape, its dtype as the
    walk takes it (``input_dtype``), the params' dtype (``params_dtype``)
    and the ``data_ptr()`` of every parameter tensor, in sorted node-id
    (then name) order. A CUDA graph binds pointers and dtypes, so two
    params dicts of different tensors need two captures, a new dict of the
    same tensors reuses one, and an f32 and a bf16 walk never share one:
    a bf16 program captures once per input dtype, as the reference's jit
    compiles once per input shape and dtype."""
    return (tuple(int(d) for d in x.shape), str(input_dtype(x)),
            str(params_dtype(params)),
            tuple(t.data_ptr() for nid in sorted(params)
                  for _, t in sorted(params[nid].items())))


# One capture stream per card (device index -> stream), made at its first
# capture.
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def capture_forward(graph: Graph, lowering: Lowering, params: Params,
                    x: torch.Tensor, use_pallas: Optional[bool],
                    avg_pool_via: str = "jnp") -> _Capture:
    """Capture one ``_eval_graph`` of ``x`` into a CUDA graph, reading a
    static copy of ``x`` and writing a static output (both in the graph's
    memory pool with every intermediate). Nothing runs: the caller
    replays. Every lazily built index table the walk reads must exist
    already (an eager walk at the same shape builds them), since a copy
    from pageable host memory cannot be captured. The capture is
    thread-local (``capture_error_mode="thread_local"``): CUDA forbids the
    calls that could break it (allocations, event queries, waits) to the
    capturing thread only, so a program may be captured on a compile
    thread while a serving thread replays other programs, queries their
    events and allocates. The capture stream is one of ``x``'s card
    (``torch.cuda.graph``'s default is one stream for the process, on the
    card of its first capture, and a shard on another card would then
    launch into that card's legacy stream while the capture runs).
    Raises for a tensor off the card: the CPU never captures, and a failed
    capture raises — no caller carries on with the eager walk."""
    if x.device.type != "cuda":
        raise ValueError(f"capture_forward: CUDA graphs capture CUDA "
                         f"tensors only, got {x.device}")
    stream = _CAPTURE_STREAMS.get(x.device.index)
    if stream is None:
        stream = _CAPTURE_STREAMS[x.device.index] = torch.cuda.Stream(
            device=x.device)
    static_in = torch.empty_like(x)
    static_in.copy_(x)
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph, stream=stream,
                          capture_error_mode="thread_local"):
        static_out = _eval_graph(graph, lowering, params, static_in,
                                 use_pallas, avg_pool_via)
    return _Capture(cuda_graph, static_in, static_out)


class CompiledProgram:
    """``compile_plan``'s callable: ``run(params, x) -> logits`` over one
    static lowering (``run.lowering``).

    On the CPU every call walks the lowering eagerly. On a CUDA device
    each capture key (``capture_key``: ``x``'s shape and the params'
    pointers) goes through three stages, as the reference compiles once
    per input shape:

    1. first call: the eager walk (the warm pass: it loads the kernel
       libraries and builds every cached index table and grid size);
    2. second call: ``capture_forward``, then one replay;
    3. later calls: ``x`` is copied into the static input
       (``non_blocking``: a pinned host ``x`` must stay unchanged until
       the device is done), the graph replays, and the static output is
       cloned out, so a returned tensor is never overwritten by the next
       replay.

    The capture table is guarded by a lock, and each call's copy, replay
    and clone are enqueued under it, because ``ExecutableCache`` hands one
    program to many engines; calls that share a program must share a
    stream. A capture is held, with its memory pool, for the program's
    lifetime; ``captures`` maps each key to its capture (None after the
    warm pass only).

    ``dtype`` (f32 or bf16) is the program's: its params must all be of
    it. Its input is f32 or, for a bf16 program, bf16 (``_typed_input``:
    numpy arrays are f32; a bf16 input to an f32 program raises
    ``TypeError``), and the capture key holds the input's dtype, so a
    bf16 program captures one walk per input dtype. A bf16 input walks in
    bf16 and returns bf16 logits, but for a plan that carries int8
    layers: those emit f32, every layer downstream of them runs in f32
    (``overlay``'s dtype rule) and the logits are f32, as the reference's
    are. An f32 input to a bf16 program walks in f32 on the exactly
    widened weights and returns f32 logits, as the reference promotes it.
    A capture keeps whatever dtype the eager walk gave: the static output
    is the walk's own tensor, and each replay's clone has its dtype."""

    def __init__(self, graph: Graph, lowering: Lowering,
                 use_pallas: Optional[bool], device: torch.device,
                 avg_pool_via: str = "jnp",
                 dtype: torch.dtype = torch.float32) -> None:
        self.graph = graph
        self.lowering = lowering
        self.use_pallas = use_pallas
        self.avg_pool_via = avg_pool_via
        self.device = device
        self.dtype = check_dtype(dtype)
        self.captures: Dict[tuple, Optional[_Capture]] = {}
        self._lock = threading.Lock()

    def __call__(self, params: Params, x) -> torch.Tensor:
        dtype = params_dtype(params)
        if dtype != self.dtype:
            raise TypeError(f"params of {dtype} for a program compiled for "
                            f"{self.dtype}")
        with torch.inference_mode():
            if self.device.type != "cuda":
                return _eval_graph(self.graph, self.lowering, params,
                                   _typed_input(x, self.device, self.dtype),
                                   self.use_pallas, self.avg_pool_via)
            key = capture_key(params, x)
            with self._lock:
                if key not in self.captures:
                    out = _eval_graph(self.graph, self.lowering, params,
                                      _typed_input(x, self.device, self.dtype),
                                      self.use_pallas, self.avg_pool_via)
                    self.captures[key] = None
                    return out
                entry = self.captures[key]
                if entry is None:
                    entry = self.captures[key] = capture_forward(
                        self.graph, self.lowering, params,
                        _typed_input(x, self.device, self.dtype),
                        self.use_pallas, self.avg_pool_via)
                else:
                    entry.static_in.copy_(_typed_input(x, None, self.dtype),
                                          non_blocking=True)
                entry.graph.replay()
                return entry.static_out.clone()


class ShardedProgram:
    """``compile_plan(mesh=...)``'s callable: ``run(params, x) -> logits``
    over one static lowering (``run.lowering``) split across a
    ``DataMesh`` — the reference's jitted program with its batch sharded
    over the mesh's data axis and its params replicated.

    It holds one ``CompiledProgram`` per shard (``shards``), all on the
    same lowering, shard ``i`` on ``mesh.devices[i]``, each with its own
    captures: each shard captures on its own device, into its own memory
    pool, under its own capture key, so two shards on one card hold two
    captures. ``x`` must be batched ``(B, H, W, C)`` with ``B`` a multiple
    of ``data_shards`` (``ValueError`` otherwise). ``params`` is one params
    tuple per shard, as ``distributed.sharding.replicate`` returns it (the
    engine replicates once), or one dict, which is replicated on every call
    as the reference's jit transfers unplaced params on every call.

    A call first enqueues every shard, each under its device's guard: the
    copy of its rows in, its replay (or eager pass, or capture) and the
    clone of its output. Only then are the outputs gathered in shard order
    on ``mesh.devices[0]``; no shard waits on another on the host. A copy
    from another card is ordered by PyTorch after the work of both cards'
    current streams, so the first device's stream, after the gather,
    follows every shard's copy-in, replay and clone."""

    def __init__(self, graph: Graph, lowering: Lowering,
                 use_pallas: Optional[bool], mesh: DataMesh,
                 avg_pool_via: str = "jnp",
                 dtype: torch.dtype = torch.float32) -> None:
        self.graph = graph
        self.lowering = lowering
        self.use_pallas = use_pallas
        self.mesh = mesh
        self.data_shards = data_shard_count(mesh)
        self.device = mesh.devices[0]
        self.dtype = check_dtype(dtype)
        self.shards = tuple(CompiledProgram(graph, lowering, use_pallas, d,
                                            avg_pool_via, dtype)
                            for d in mesh.devices)

    def __call__(self, params, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = _as_input(x, None)
        xs = shard_batch(x, self.mesh)
        shard_params = (params if isinstance(params, tuple)
                        else replicate(params, self.mesh))
        if len(shard_params) != len(self.shards):
            raise ValueError(f"{len(shard_params)} params sets for "
                             f"{len(self.shards)} shards")
        outs = []
        for prog, p, xi in zip(self.shards, shard_params, xs):
            with device_guard(prog.device):
                outs.append(prog(p, xi))
        if len(outs) == 1:
            return outs[0]
        with torch.inference_mode(), device_guard(self.device):
            return torch.cat([o.to(self.device, non_blocking=True)
                              for o in outs])


def compile_plan(graph: Graph, plan: Optional[ExecutionPlan] = None, *,
                 default_algo: Algorithm = IM2COL,
                 use_pallas: Optional[bool] = None,
                 epilogue: str = "relu",
                 tuning=None,
                 tuning_batch: Optional[int] = None,
                 avg_pool_via: str = "jnp",
                 elide: bool = True,
                 elide_overrides: Optional[Dict[Tuple[int, int], bool]] = None,
                 mesh=None,
                 donate: bool = False,
                 fault_hook: Optional[Callable[[], None]] = None,
                 cache: Optional[ExecutableCache] = None,
                 act_scales: Optional[Dict[int, float]] = None,
                 device="cuda",
                 dtype: torch.dtype = torch.float32) -> Callable:
    """Lower (graph, plan) once into a static overlay program.

    Returns ``run(params, x) -> logits``, a ``CompiledProgram`` (wrapped
    when ``fault_hook`` is given), with
    ``x``: (H, W, C) or (B, H, W, C) (numpy or tensor; moved to
    ``device``). The topology, every per-layer algorithm and
    dataflow/(p1, p2) binding and every edge's store format are resolved
    *now* by ``lower_plan``; the returned callable only walks that static
    lowering, and on a CUDA device captures the walk once per input shape
    and params as a CUDA graph and replays it. With ``plan=None`` every
    conv runs ``default_algo`` (IM2COL unless given) under the NS (128,
    128) binding, as do convs a plan leaves out. ``avg_pool_via="overlay"``
    runs every AvgPool as a K×K conv on the im2col kernel (§3.4,
    ``layers.avg_pool``); the default ``"jnp"`` is the pooling path.
    Both enter the cache key. ``elide=True``
    (default) lets consumers read matching store formats directly — im2col
    chains reuse the Toeplitz buffer — and ``elide=False`` compiles the
    always-NHWC-round-trip baseline; ``elide_overrides`` (``{(src, dst):
    False}``, from ``core.autotune.tune_elision``) flips individual edges.
    A ``tuning`` record (``core.autotune``) replaces cost-model bindings
    with measured winners — algorithm, dataflow, (p1, p2) and backend per
    layer, so one program may mix the kernels, the plain oracles and
    cuDNN; ``tuning_batch`` names the batch bucket the program serves,
    whose winners bind it (None: bucket 1), part of its cache identity
    with the record's content and the overrides. ``cache`` (an
    ``ExecutableCache``) shares programs across callers. ``act_scales``
    ({conv node id: activation scale}, from
    ``core.quant.calibrate_act_scales``) feeds the plan's int8 layers their
    calibrated per-tensor input scales; it enters the cache key, and a
    plan with no int8 layer ignores it.

    ``donate=True`` is the reference's donated batched input, which its
    pipelined engine asks for. It is taken for the reference's API and
    changes nothing, not even the cache key: the capture's static input
    buffer, into which each call copies ``x``, already plays the donated
    buffer's part, so no per-call input buffer stays live.
    ``fault_hook`` (robustness testing) is a zero-arg callable invoked
    before each call, the outermost wrapper, applied outside the cache:
    injected dispatch faults surface at the call, as a
    launch error would, and a hooked and an unhooked caller share one
    program. ``fault_hook=None`` adds no wrapper.

    ``mesh`` (a ``launch.mesh.DataMesh`` of ``device``'s type) returns a
    ``ShardedProgram`` instead: the batch splits across the mesh's data
    axis, one ``CompiledProgram`` per shard on its device, params
    replicated, outputs gathered on the mesh's first device (``.mesh``,
    ``.data_shards``). ``tuning_batch`` is then the per-chip batch, whose
    winners bind every shard. Another object raises ``TypeError``.

    ``dtype`` (f32 or bf16) is the program's (``CompiledProgram``): bf16
    params (``init_params(dtype=torch.bfloat16)``) run the reference's
    bf16 path, every im2col, kn2row and Winograd conv on the bf16
    kernels, which sum in f32 and round once per kernel, as the
    reference's do. A gated plan of bf16 params (int8 layers from
    ``plan_mixed_precision``) runs its int8 layers on the int8 kernels
    and every layer downstream of one in f32, and returns f32 logits, as
    the reference's does. It enters the cache key."""
    if mesh is not None and not isinstance(mesh, DataMesh):
        raise TypeError(f"compile_plan(mesh=...) takes a launch.mesh."
                        f"DataMesh, got {type(mesh).__name__}")
    dev = resolve_device(device)
    if mesh is not None and mesh.devices[0].type != dev.type:
        raise ValueError(f"mesh devices {mesh.devices} are not of "
                         f"device={str(dev)!r}")

    def build() -> Union[CompiledProgram, ShardedProgram]:
        lowering = lower_plan(
            graph, plan, default_algo, epilogue=epilogue, tuning=tuning,
            batch=tuning_batch, elide=elide, elide_overrides=elide_overrides,
            act_scales=act_scales)
        if mesh is None:
            return CompiledProgram(graph, lowering, use_pallas, dev,
                                   avg_pool_via, dtype)
        return ShardedProgram(graph, lowering, use_pallas, mesh, avg_pool_via,
                              dtype)

    if cache is None:
        return _with_fault_hook(build(), fault_hook)
    key = executable_cache_key(graph, plan, default_algo=default_algo,
                               use_pallas=use_pallas,
                               epilogue=epilogue, tuning=tuning,
                               tuning_batch=tuning_batch,
                               avg_pool_via=avg_pool_via, elide=elide,
                               elide_overrides=elide_overrides,
                               act_scales=act_scales, mesh=mesh, device=dev,
                               dtype=dtype)
    return _with_fault_hook(cache.get_or_compile(key, build), fault_hook)


def _with_fault_hook(run: Callable, fault_hook: Optional[Callable[[], None]]
                     ) -> Callable:
    """Outermost wrapper: call ``fault_hook()`` before each invocation of
    ``run``, keeping a sharded program's ``mesh`` and ``data_shards`` on
    the wrapper. No hook, no wrapper (the common path stays the program
    itself)."""
    if fault_hook is None:
        return run

    def hooked(params: Params, x) -> torch.Tensor:
        fault_hook()
        return run(params, x)

    for attr in ("mesh", "data_shards"):
        if hasattr(run, attr):
            setattr(hooked, attr, getattr(run, attr))
    return hooked
