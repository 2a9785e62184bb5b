"""Graph executor: runs a CNN under a DYNAMAP ExecutionPlan.

Every conv dispatches to the same overlay (``overlay.apply_conv``); only
the per-layer binding — algorithm wrapper plus dataflow/(p1, p2) blocks —
differs. Two execution modes, as in the reference:

* ``forward`` — eager: lowers the plan and walks the graph per call.
* ``compile_plan`` — lowers (graph, plan) ONCE into a static
  ``LoweredProgram`` and returns a callable that walks it: one program per
  (graph, plan, bucket), batched, with params as call arguments. Eager
  torch needs no tracing; CUDA-graph capture comes in a later slice.

Entry points take ``device="cuda"`` by default and raise when CUDA is
absent; the CPU runs only when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.cnn import layers as L
from repro_torch.cnn import overlay
from repro_torch.core.graph import Graph, LayerKind
from repro_torch.core.layouts import LayoutSpec, is_nhwc
from repro_torch.core.mapper import (ConvLowering, ExecutionPlan,
                                     LoweredProgram, lower_plan,
                                     plan_fingerprint)
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.layouts import materialize, restore

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


def executable_cache_key(graph: Graph, plan: Optional[ExecutionPlan] = None,
                         *, use_pallas: Optional[bool] = None,
                         epilogue: str = "relu",
                         tuning_batch: Optional[int] = None,
                         elide: bool = True,
                         device="cuda") -> tuple:
    """The ``(graph hash, plan, bucket, device, options)`` identity of one
    compiled program: everything ``compile_plan`` closes over except the
    params, which are call arguments."""
    return (graph_hash(graph), plan_fingerprint(plan), use_pallas, epilogue,
            int(tuning_batch or 1), bool(elide), str(torch.device(device)))


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


def init_params(graph: Graph, seed: int = 0, device="cuda") -> Params:
    """Per-layer f32 parameters ``{nid: {"w", "b"}}``: He-style normal
    weights from a ``torch.Generator`` seeded with ``seed`` (drawn on the
    CPU, so the same seed gives the same weights on every device) and zero
    biases. Conv weights are ``(K1, K2, Cin, Cout)``, FC ``(in, out)``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    params: Params = {}
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        if node.kind is LayerKind.CONV:
            m = node.conv
            fan_in = m.k1 * m.k2 * m.c_in
            w = torch.randn((m.k1, m.k2, m.c_in, m.c_out),
                            generator=gen) / float(np.sqrt(fan_in))
            params[nid] = {"w": w.to(dev),
                           "b": torch.zeros((m.c_out,), device=dev)}
        elif node.kind is LayerKind.FC:
            fin = int(node.attrs["in_features"])
            fout = int(node.attrs["out_features"])
            w = torch.randn((fin, fout), generator=gen) / float(np.sqrt(fin))
            params[nid] = {"w": w.to(dev),
                           "b": torch.zeros((fout,), device=dev)}
    return params


def _eval_graph(graph: Graph, lowering: Lowering, params: Params,
                x: torch.Tensor, use_pallas: Optional[bool]) -> torch.Tensor:
    """Walk the graph once. Inter-layer values travel in the store formats
    the ``LoweredProgram`` realized: a producer stages its edge's format
    once (conv layers fuse the conversion via ``out_layout``, non-conv
    producers materialize it here), matched consumers read it directly
    and mismatched consumers restore to NHWC — the converting load."""
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
            xin = values[preds[0]].in_layout(in_layout)
            y = overlay.apply_conv(
                xin, params[nid]["w"], low.algo, low.dataflow, low.p1, low.p2,
                stride=m.stride, padding=pad, use_pallas=use_pallas,
                backend=None if low.backend == "auto" else low.backend,
                epilogue=epi, bias=bias, in_layout=in_layout,
                out_layout=out_layout)
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
                           int(node.attrs["stride"]), pad)
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


def _as_input(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as an f32 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def forward(graph: Graph, params: Params, x,
            plan: Optional[ExecutionPlan] = None, *,
            use_pallas: Optional[bool] = None,
            epilogue: str = "relu",
            elide: bool = True,
            device="cuda") -> torch.Tensor:
    """Eager inference. ``x``: (H, W, C) single image or (B, H, W, C)
    batch. Each call re-lowers the plan — use ``compile_plan`` for the
    serving path."""
    dev = resolve_device(device)
    lowering = lower_plan(graph, plan, epilogue=epilogue, elide=elide)
    with torch.inference_mode():
        return _eval_graph(graph, lowering, params, _as_input(x, dev),
                           use_pallas)


def compile_plan(graph: Graph, plan: Optional[ExecutionPlan] = None, *,
                 use_pallas: Optional[bool] = None,
                 epilogue: str = "relu",
                 tuning_batch: Optional[int] = None,
                 elide: bool = True,
                 mesh=None,
                 donate: bool = False,
                 fault_hook: Optional[Callable[[], None]] = None,
                 cache: Optional[ExecutableCache] = None,
                 device="cuda") -> Callable[[Params, object], torch.Tensor]:
    """Lower (graph, plan) once into a static overlay program.

    Returns ``run(params, x) -> logits`` with ``x``: (H, W, C) or
    (B, H, W, C) (numpy or tensor; moved to ``device``). The topology,
    every per-layer algorithm and dataflow/(p1, p2) binding and every
    edge's store format are resolved *now* by ``lower_plan``; the returned
    callable only walks that static lowering. With ``plan=None`` every
    conv is im2col under the NS (128, 128) binding. ``elide=True``
    (default) lets consumers read matching store formats directly — im2col
    chains reuse the Toeplitz buffer — and ``elide=False`` compiles the
    always-NHWC-round-trip baseline. ``tuning_batch`` names the batch
    bucket the program serves, part of its cache identity. ``cache`` (an
    ``ExecutableCache``) shares programs across callers.

    ``mesh``, ``donate`` and ``fault_hook`` belong to later slices of the
    port and raise ``NotImplementedError`` when set."""
    for name, value in (("mesh", mesh), ("donate", donate),
                        ("fault_hook", fault_hook)):
        if value:
            raise NotImplementedError(
                f"compile_plan({name}=...) is not ported yet")
    dev = resolve_device(device)

    def build() -> Callable[[Params, object], torch.Tensor]:
        lowering = lower_plan(graph, plan, epilogue=epilogue, elide=elide)

        def run(params: Params, x) -> torch.Tensor:
            with torch.inference_mode():
                return _eval_graph(graph, lowering, params,
                                   _as_input(x, dev), use_pallas)

        run.lowering = lowering
        return run

    if cache is None:
        return build()
    key = executable_cache_key(graph, plan, use_pallas=use_pallas,
                               epilogue=epilogue, tuning_batch=tuning_batch,
                               elide=elide, device=dev)
    return cache.get_or_compile(key, build)
