"""Measured per-layer autotuning of overlay bindings — the reference's
``core/autotune.py`` with the measurement done on the card.

DYNAMAP's DSE picks each layer's algorithm, dataflow and (p1, p2) block
binding from the *analytical* cost model (Eq. 9/13). This module closes
the loop: for every conv layer it benchmarks candidate ``(algorithm,
dataflow, p1, p2, backend)`` bindings **on the device**, caches the
winners in a JSON tuning record keyed by the layer's conv signature and
batch bucket, and ``core.mapper.lower_plan`` consumes that record to
override the cost-model binding per layer — including mixing the Hopper
kernels ("pallas"), the plain torch oracles ("reference") and cuDNN
("lax") inside one compiled program.

On a CUDA device a candidate is timed the way a compiled plan runs it
(``cnn.executor.CompiledProgram``): after eager warm-up calls, one
``overlay.apply_conv`` call is captured into a CUDA graph, and the
replays are timed between CUDA events. On the CPU the call is timed with
the host clock, as the reference does. Nothing carries on another way: a
failed capture raises, and a "pallas" candidate on the CPU raises.

Typical use::

    plan = map_network(graph)                     # model-predicted plan
    record = autotune_graph(graph, plan)          # measure on this device
    record.save("tuning.json")
    run = compile_plan(graph, plan, tuning=record)  # measured bindings

The record format is the reference's (version 2, keys "sig@bN[#int8]"):
a record saved by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.algorithms import (IM2COL, Algorithm, AlgoFamily,
                                         menu_for)
from repro_torch.core.cost_model import ALL_DATAFLOWS, Dataflow
from repro_torch.core.graph import ConvMeta, Graph
from repro_torch.core.mapper import ConvLowering, ExecutionPlan
from repro_torch.core.quant import no_tf32
from repro_torch.kernels.common import resolve_device

# The reference's backend names: "lax" is the vendor convolution
# (``F.conv2d``, cuDNN on the card) and contributes one candidate per
# layer, "reference" the plain torch oracle of each algorithm, "pallas"
# the hand-written Hopper kernels.
BACKENDS = ("lax", "reference", "pallas")

# Version 2: entries are keyed by (conv signature, batch bucket) —
# "sig@bN" — instead of the bare signature; version-1 blobs are migrated
# on load (their entries become bucket-1 entries, or bucket meta["batch"]
# when the record was measured at a batch size).
RECORD_VERSION = 2


def conv_key(conv: ConvMeta) -> str:
    """Shape signature identifying a conv layer for tuning purposes: two
    layers with the same signature induce identical GEMMs, so they share a
    measured winner."""
    return (f"c{conv.c_in}x{conv.c_out}_h{conv.h1}x{conv.h2}"
            f"_k{conv.k1}x{conv.k2}_s{conv.stride}_{conv.pad}")


def record_key(conv: ConvMeta, batch: Optional[int] = None,
               precision: str = "bf16") -> str:
    """Full tuning-record key: conv signature plus the batch bucket the
    binding was measured at. ``batch=None`` (the single-image setting)
    records as bucket 1 — a batch-1 tick and a single image induce the
    same per-image GEMMs. Non-bf16 measurements append a ``#<precision>``
    suffix ("sig@bN#int8"): bindings do not rank identically across
    precisions (int8 moves half the bytes), so int8 layers only ever
    adopt bindings measured at int8 — bf16 keys are unchanged, keeping
    old records valid."""
    key = f"{conv_key(conv)}@b{int(batch or 1)}"
    return key if precision == "bf16" else f"{key}#{precision}"


def parse_record_key(key: str) -> Tuple[str, int, str]:
    """Inverse of ``record_key``: "sig@bN[#prec]" → (sig, N, prec)."""
    base, _, prec = key.partition("#")
    sig, _, bucket = base.rpartition("@b")
    if not sig or not bucket.isdigit():
        raise ValueError(f"unparseable record key {key!r}")
    return sig, int(bucket), prec or "bf16"


def algo_from_key(key: str) -> Algorithm:
    """Inverse of ``Algorithm.key`` ("im2col", "winograd(F2x3)", ...)."""
    for fam in AlgoFamily:
        if key == fam.value:
            return Algorithm(fam)
    if key.startswith("winograd(F"):
        m, r = key[len("winograd(F"):-1].split("x")
        return Algorithm(AlgoFamily.WINOGRAD, m=int(m), r=int(r))
    raise ValueError(f"unparseable algorithm key {key!r}")


@dataclasses.dataclass(frozen=True)
class Binding:
    """One candidate configuration of the overlay for a layer."""
    algo_key: str
    dataflow: str                  # Dataflow name: NS | WS | IS
    p1: int
    p2: int
    backend: str                   # reference | pallas

    @property
    def algo(self) -> Algorithm:
        return algo_from_key(self.algo_key)

    def label(self) -> str:
        return (f"{self.algo_key}|{self.dataflow}|{self.p1}x{self.p2}"
                f"|{self.backend}")


@dataclasses.dataclass
class LayerTuning:
    """Measured winner for one (conv signature, batch bucket)."""
    binding: Binding
    measured_s: float
    # (label, seconds) for every candidate tried — kept for analysis.
    candidates: List[Tuple[str, float]]
    # Batch bucket the measurement ran at (1 = single image).
    batch: int = 1
    # Precision the candidates were measured at ("bf16" | "int8").
    precision: str = "bf16"


class TuningRecord:
    """(conv signature, batch bucket) → measured best binding; JSON
    round-trippable. Entry keys are ``record_key`` strings ("sig@bN")."""

    def __init__(self, entries: Optional[Dict[str, LayerTuning]] = None,
                 meta: Optional[Dict[str, object]] = None) -> None:
        self.entries: Dict[str, LayerTuning] = dict(entries or {})
        self.meta: Dict[str, object] = dict(meta or {})

    # ------------------------------------------------------------ lookup
    def buckets_for(self, conv: ConvMeta,
                    precision: str = "bf16") -> List[int]:
        """Batch buckets this record has measured for ``conv`` at the
        given precision, ascending."""
        sig = conv_key(conv)
        out = []
        for key in self.entries:
            k_sig, bucket, prec = parse_record_key(key)
            if k_sig == sig and prec == precision:
                out.append(bucket)
        return sorted(out)

    def lookup(self, conv: ConvMeta, batch: Optional[int] = None,
               precision: str = "bf16") -> Optional[LayerTuning]:
        """The entry measured at ``batch`` (bucket-matched). Without an
        exact bucket match, fall back to the largest tuned bucket below the
        requested one (closest smaller workload), else the smallest above —
        so a batch-1-only record still serves every bucket, just without
        per-bucket specialization. Entries never cross precisions: an int8
        layer with no int8 measurement runs its model-predicted binding."""
        want = int(batch or 1)
        hit = self.entries.get(record_key(conv, want, precision))
        if hit is not None:
            return hit
        buckets = self.buckets_for(conv, precision)
        if not buckets:
            return None
        below = [b for b in buckets if b < want]
        pick = below[-1] if below else buckets[0]
        return self.entries[record_key(conv, pick, precision)]

    def lowering_for(self, conv: ConvMeta, batch: Optional[int] = None,
                     precision: str = "bf16") -> Optional[ConvLowering]:
        """The measured binding as a ConvLowering fragment (epilogue and
        precision/scales are the caller's concern — tuning only overrides
        the execution binding)."""
        hit = self.lookup(conv, batch, precision)
        if hit is None:
            return None
        b = hit.binding
        return ConvLowering(b.algo, Dataflow[b.dataflow], b.p1, b.p2,
                            backend=b.backend)

    # ------------------------------------------------------------ persist
    def to_json(self) -> Dict[str, object]:
        return {
            "version": RECORD_VERSION,
            "meta": self.meta,
            "entries": {
                key: {
                    "binding": dataclasses.asdict(t.binding),
                    "measured_s": t.measured_s,
                    "candidates": [[lbl, s] for lbl, s in t.candidates],
                    "batch": t.batch,
                    "precision": t.precision,
                }
                for key, t in self.entries.items()
            },
        }

    @classmethod
    def from_json(cls, blob: Dict[str, object]) -> "TuningRecord":
        version = blob.get("version")
        if version not in (1, RECORD_VERSION):
            raise ValueError(f"tuning record version {version} "
                             f"!= {RECORD_VERSION}")
        meta = dict(blob.get("meta", {}))                  # type: ignore
        # v1 records were keyed by bare signature; the whole record was
        # measured at one batch size (meta["batch"], None = single image).
        v1_bucket = int(meta.get("batch") or 1) if version == 1 else None
        entries = {}
        for key, ent in blob.get("entries", {}).items():   # type: ignore
            if version == 1:
                key = f"{key}@b{v1_bucket}"
                bucket = v1_bucket
                precision = "bf16"
            else:
                bucket = int(ent.get("batch", parse_record_key(key)[1]))
                precision = str(ent.get("precision",
                                        parse_record_key(key)[2]))
            entries[key] = LayerTuning(
                binding=Binding(**ent["binding"]),
                measured_s=float(ent["measured_s"]),
                candidates=[(lbl, float(s)) for lbl, s in ent["candidates"]],
                batch=bucket,
                precision=precision,
            )
        return cls(entries, meta)

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.to_json(), indent=2))

    @classmethod
    def load(cls, path) -> "TuningRecord":
        return cls.from_json(json.loads(Path(path).read_text()))

    # -------------------------------------------------------------- merge
    def merge(self, other: "TuningRecord") -> int:
        """Fold ``other``'s entries into this record, keeping existing
        entries on key conflicts (this record's measurements are the
        incumbents — remeasure and overwrite explicitly if you want the
        challenger). Because keys are (conv signature, bucket) — never
        graph identity — this is how tuning transfers across models: a
        fleet can pool the records of every tenant and each engine sees
        the union of all measured winners. Returns the number of entries
        adopted. ``meta`` keys absent here are copied over too."""
        adopted = 0
        for key, tuned in other.entries.items():
            if key not in self.entries:
                self.entries[key] = tuned
                adopted += 1
        for k, v in other.meta.items():
            if k == "buckets":
                mine = set(self.meta.get("buckets", []))
                self.meta["buckets"] = sorted(mine | set(v))
            else:
                self.meta.setdefault(k, v)
        return adopted


def refresh_from_service(record: "TuningRecord", graph: Graph,
                         service_emas: Dict[int, float], *,
                         precisions: Optional[Dict[int, str]] = None,
                         min_improvement: float = 0.05
                         ) -> Dict[int, float]:
    """Live-refresh a record's measured costs from serving-tier EMAs.

    The serving engine keeps one service-time EMA per batch bucket (the
    measured wall time of a tick); the record predicts the same tick as
    the sum of its per-layer measured winners. When the live EMA diverges
    from that prediction by more than ``min_improvement`` (the autotuner's
    5% hysteresis — sub-hysteresis noise never churns the record), every
    ``(signature, bucket)`` entry measured at that exact bucket is
    rescaled by the live/recorded ratio — ``measured_s`` and the stored
    candidate times alike — so consumers of recorded costs (re-tune
    baselines, operator dashboards, the hot-swap supervisor's decision
    inputs) see them in live terms. Bindings are untouched: a uniform
    per-bucket scale cannot re-rank candidates measured together; flipping
    a winner requires a real re-measurement (``tune_layer``).

    ``precisions`` (conv node id → "bf16"|"int8") mirrors the deployed
    plan so the prediction sums the entries the engine actually lowers
    with. Returns the applied scale per bucket (empty = nothing diverged
    or nothing measured); applied scales accumulate in
    ``record.meta["live_refresh"]`` with the tick counts they came from.
    """
    precisions = precisions or {}
    applied: Dict[int, float] = {}
    for bucket, ema in sorted(service_emas.items()):
        if ema is None or ema <= 0.0:
            continue
        expected = 0.0
        exact_keys = []
        for node in graph.conv_nodes():
            prec = precisions.get(node.id, "bf16")
            hit = record.lookup(node.conv, batch=bucket, precision=prec)
            if hit is None:
                continue
            expected += hit.measured_s
            key = record_key(node.conv, bucket, prec)
            if key in record.entries:
                exact_keys.append(key)
        if expected <= 0.0 or not exact_keys:
            continue
        ratio = float(ema) / expected
        if abs(ratio - 1.0) <= min_improvement:
            continue                      # within hysteresis: hold steady
        for key in set(exact_keys):
            ent = record.entries[key]
            ent.measured_s *= ratio
            ent.candidates = [(lbl, s * ratio) for lbl, s in ent.candidates]
        applied[bucket] = ratio
    if applied:
        log = dict(record.meta.get("live_refresh", {}))
        for bucket, ratio in applied.items():
            log[str(bucket)] = round(
                float(log.get(str(bucket), 1.0)) * ratio, 6)
        record.meta["live_refresh"] = log
    return applied


# ---------------------------------------------------------------------------
# Candidate generation.
# ---------------------------------------------------------------------------

def candidate_bindings(conv: ConvMeta,
                       p1p2: Sequence[Tuple[int, int]] = ((128, 128),),
                       dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
                       backends: Sequence[str] = BACKENDS,
                       menu: Optional[Sequence[Algorithm]] = None
                       ) -> List[Binding]:
    """The search space for one layer (the reference's, in its order).

    The reference backend ignores dataflow/(p1, p2) — the binding only
    shapes the kernel's schedule — so it contributes one candidate per
    applicable algorithm; the kernel backend sweeps the full cross
    product; the lax backend ignores the algorithm too (cuDNN picks its
    own conv strategy) and contributes exactly one candidate.
    """
    algos = menu_for(conv, list(menu) if menu is not None else None)
    out: List[Binding] = []
    if "lax" in backends:
        out.append(Binding(algos[0].key, Dataflow.NS.name, 128, 128, "lax"))
    for algo in algos:
        if "reference" in backends:
            out.append(Binding(algo.key, Dataflow.NS.name, 128, 128,
                               "reference"))
        if "pallas" in backends:
            for df in dataflows:
                for (p1, p2) in p1p2:
                    out.append(Binding(algo.key, df.name, p1, p2, "pallas"))
    return out


# ---------------------------------------------------------------------------
# Measurement.
# ---------------------------------------------------------------------------

def _host_min_s(call, reps: int) -> float:
    """The fastest of ``reps`` calls of ``call`` by the host clock, in
    seconds (the CPU's measurement, as the reference times)."""
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return best


def _replay_min_s(graph: "torch.cuda.CUDAGraph", reps: int) -> float:
    """Replay ``graph`` once to warm, then ``reps`` times, each between
    two CUDA events; the fastest replay in seconds."""
    graph.replay()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(max(1, reps))]
    for start, end in pairs:
        start.record()
        graph.replay()
        end.record()
    pairs[-1][1].synchronize()
    return min(start.elapsed_time(end) for start, end in pairs) / 1e3


def benchmark_binding(conv: ConvMeta, binding: Binding, *,
                      reps: int = 3, warmup: int = 1,
                      batch: Optional[int] = None,
                      precision: str = "bf16",
                      seed: int = 0,
                      device="cuda") -> float:
    """Time one overlay call for ``conv`` under ``binding`` on the actual
    device; returns the best (min) of ``reps`` timed runs in seconds.

    On a CUDA device the call runs as it does inside a compiled plan: the
    ``warmup`` eager calls load the kernel libraries and build every
    cached index table (none of which a capture may do), one call is then
    captured into a CUDA graph, replayed once to warm, and each of
    ``reps`` replays is timed between CUDA events; the graph and its
    memory pool are dropped before returning. On the CPU each call
    is timed with the host clock. ``batch`` measures the batched overlay
    path (B, H, W, C) — bindings do not rank identically at batch 1 and
    batch 8, so tune at the batch you serve. ``precision="int8"``
    measures the quantized overlay path (a synthetic activation scale —
    timing is scale-independent). TF32 is off for the calls whatever the
    caller's flags say, so cuDNN ("lax") and the plain oracles are timed
    at the plan's f32 precision. A "pallas" binding on the CPU raises.
    """
    from repro_torch.cnn import overlay   # deferred: overlay imports kernels

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    shape = (conv.h1, conv.h2, conv.c_in)
    if batch is not None:
        shape = (batch,) + shape
    x = torch.randn(shape, generator=gen, device=dev)
    w = torch.randn((conv.k1, conv.k2, conv.c_in, conv.c_out),
                    generator=gen, device=dev) \
        / (conv.k1 * conv.k2 * conv.c_in) ** .5
    pad = "SAME" if conv.pad == "same" else "VALID"
    quant_kw = {} if precision == "bf16" else dict(
        precision=precision, in_scale=3.0 / 127.0)

    def run() -> torch.Tensor:
        return overlay.apply_conv(
            x, w, binding.algo, Dataflow[binding.dataflow],
            binding.p1, binding.p2, stride=conv.stride, padding=pad,
            backend=binding.backend, epilogue="relu", **quant_kw)

    with torch.inference_mode(), no_tf32():
        for _ in range(max(1, warmup)):
            run()                       # build, load and fill the caches
        if dev.type != "cuda":
            return _host_min_s(run, reps)
        # A private memory pool per capture, as ``capture_forward``'s: a
        # pool shared through ``graph_pool_handle`` cannot be captured into
        # again once every graph in it is gone (the caching allocator
        # asserts), and ``torch.cuda.graph`` empties the cache on entry,
        # which frees the dropped candidate's pool.
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        try:
            return _replay_min_s(graph, reps)
        finally:
            del out, graph


def tune_layer(conv: ConvMeta, *,
               p1p2: Sequence[Tuple[int, int]] = ((128, 128),),
               dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
               backends: Sequence[str] = BACKENDS,
               menu: Optional[Sequence[Algorithm]] = None,
               reps: int = 3,
               batch: Optional[int] = None,
               precision: str = "bf16",
               baseline: Optional[Binding] = None,
               min_improvement: float = 0.05,
               device="cuda") -> LayerTuning:
    """Benchmark every candidate binding for one conv; return the winner.

    With a ``baseline`` (the plan's own binding), a challenger must beat it
    by more than ``min_improvement`` (fractional) or the baseline is kept:
    at μs layer scales launch jitter can crown a spurious winner, and the
    hysteresis guarantees a tuned plan never regresses below the
    model-predicted binding by chasing noise. ``precision="int8"`` measures
    the quantized path; Winograd candidates are dropped (the overlay
    rejects int8 Winograd).
    """
    results: List[Tuple[str, float]] = []
    base_s: Optional[float] = None
    if baseline is not None:
        base_s = benchmark_binding(conv, baseline, reps=reps, batch=batch,
                                   precision=precision, device=device)
        results.append((baseline.label(), base_s))
    best: Optional[Tuple[Binding, float]] = None
    for cand in candidate_bindings(conv, p1p2, dataflows, backends, menu):
        if baseline is not None and cand == baseline:
            continue
        if precision == "int8" \
                and cand.algo.family is AlgoFamily.WINOGRAD:
            continue
        s = benchmark_binding(conv, cand, reps=reps, batch=batch,
                              precision=precision, device=device)
        results.append((cand.label(), s))
        if best is None or s < best[1]:
            best = (cand, s)
    if best is None or (base_s is not None
                        and best[1] >= base_s * (1 - min_improvement)):
        if baseline is None or base_s is None:
            raise ValueError(f"no candidate binding to tune for {conv}")
        best = (baseline, base_s)
    return LayerTuning(binding=best[0], measured_s=best[1],
                       candidates=results, batch=int(batch or 1),
                       precision=precision)


def signature_coverage(graph: Graph, record: TuningRecord,
                       buckets: Sequence[int] = (1,)
                       ) -> Dict[str, List[str]]:
    """How well ``record`` covers ``graph``'s unique conv signatures at
    the given batch ``buckets`` — the cross-model reuse report: before
    registering a new tenant, this says which of its layers ride existing
    measured winners and which would fall back or run untuned.

    Returns record keys ("sig@bN") partitioned into ``exact`` (entry
    measured at that bucket), ``fallback`` (served by a neighboring
    bucket's entry via ``lookup``'s bucket fallback) and ``missing`` (no
    entry for the signature at all — the model's untuned layers)."""
    out: Dict[str, List[str]] = {"exact": [], "fallback": [], "missing": []}
    seen = set()
    for node in graph.conv_nodes():
        for bucket in buckets:
            key = record_key(node.conv, bucket)
            if key in seen:
                continue
            seen.add(key)
            if key in record.entries:
                out["exact"].append(key)
            elif record.lookup(node.conv, bucket) is not None:
                out["fallback"].append(key)
            else:
                out["missing"].append(key)
    for keys in out.values():
        keys.sort()
    return out


def autotune_graph(graph: Graph, plan: Optional[ExecutionPlan] = None, *,
                   p1p2: Optional[Sequence[Tuple[int, int]]] = None,
                   dataflows: Sequence[Dataflow] = ALL_DATAFLOWS,
                   backends: Sequence[str] = BACKENDS,
                   menu: Optional[Sequence[Algorithm]] = None,
                   reps: int = 3,
                   batch: Optional[int] = None,
                   precision: str = "bf16",
                   record: Optional[TuningRecord] = None,
                   skip_known: bool = True,
                   baseline_backend: str = "reference",
                   min_improvement: float = 0.05,
                   verbose: bool = False,
                   device="cuda") -> TuningRecord:
    """Measure every *unique* conv signature in ``graph`` and record the
    fastest binding for each.

    ``plan`` (if given) plays two roles: it seeds the (p1, p2) candidate
    list with the DSE's Eq. 9 choice, and its per-layer binding (under
    ``baseline_backend``) becomes the hysteresis baseline a challenger must
    beat by ``min_improvement`` — so a tuned plan can only diverge from the
    model's prediction where the device measurably disagrees. Passing an
    existing ``record`` makes tuning incremental: (signature, bucket) pairs
    already recorded are skipped (``skip_known=True``). Entries land under
    batch bucket ``batch`` (None → bucket 1, measured on a single image).
    ``meta["backend"]`` names the device in the reference's words: "gpu"
    for a CUDA device, "cpu" for the CPU.
    """
    dev = resolve_device(device)
    if p1p2 is None:
        p1p2 = [(128, 128)]
        if plan is not None and (plan.p1, plan.p2) not in p1p2:
            p1p2.append((plan.p1, plan.p2))
    record = record if record is not None else TuningRecord()
    record.meta.setdefault("backend", "gpu" if dev.type == "cuda" else "cpu")
    record.meta.setdefault("reps", reps)
    record.meta.setdefault("min_improvement", min_improvement)
    bucket = int(batch or 1)
    buckets = set(record.meta.get("buckets", []))
    buckets.add(bucket)
    record.meta["buckets"] = sorted(buckets)

    seen: Dict[str, Tuple[ConvMeta, Optional[Binding]]] = {}
    for node in graph.conv_nodes():
        key = record_key(node.conv, bucket, precision)
        if key in seen:
            continue
        baseline = None
        if plan is not None and node.id in plan.assignment:
            algo = plan.assignment[node.id]
            if not (precision == "int8"
                    and algo.family is AlgoFamily.WINOGRAD):
                baseline = Binding(algo.key, plan.dataflows[node.id].name,
                                   plan.p1, plan.p2, baseline_backend)
        seen[key] = (node.conv, baseline)

    for key, (conv, baseline) in seen.items():
        if skip_known and key in record.entries:
            continue
        t0 = time.perf_counter()
        tuned = tune_layer(conv, p1p2=p1p2, dataflows=dataflows,
                           backends=backends, menu=menu, reps=reps,
                           batch=batch, precision=precision,
                           baseline=baseline,
                           min_improvement=min_improvement, device=dev)
        record.entries[key] = tuned
        if verbose:
            print(f"autotune {key}: {tuned.binding.label()} "
                  f"{tuned.measured_s * 1e6:.0f}us "
                  f"({len(tuned.candidates)} candidates, "
                  f"{time.perf_counter() - t0:.1f}s)")
    return record


def _program_s(run, params, x: torch.Tensor, reps: int) -> float:
    """The fastest of ``reps`` timed calls of a compiled program, in
    seconds. On a CUDA device the program warms through its eager pass,
    its capture and one replay, and then its captured graph's replays are
    timed between CUDA events; on the CPU each call is timed with the host
    clock after one warm call."""
    if x.device.type != "cuda":
        run(params, x)                               # warm
        return _host_min_s(lambda: run(params, x), reps)
    from repro_torch.cnn.executor import capture_key     # deferred
    run(params, x)                                   # the eager warm pass
    run(params, x)                                   # capture, one replay
    return _replay_min_s(run.captures[capture_key(params, x)].graph, reps)


def tune_elision(graph: Graph, plan: Optional[ExecutionPlan] = None, *,
                 params=None, batch: Optional[int] = None,
                 default_algo: Optional[Algorithm] = None,
                 epilogue: str = "relu",
                 tuning: Optional[TuningRecord] = None,
                 use_pallas: Optional[bool] = None,
                 reps: int = 3, min_improvement: float = 0.05,
                 record: Optional[TuningRecord] = None,
                 verbose: bool = False,
                 device="cuda") -> Dict[Tuple[int, int], bool]:
    """Measure per-edge layout-transition elision on this device.

    The lowering elides every transition the plan's store formats allow;
    this closes the measurement loop the same way ``tune_layer`` does for
    bindings: starting from the all-elided compiled program, each elided
    edge is compiled again with its transition forced back to the NHWC
    round trip, and the override is kept only when it beats the all-elided
    baseline by ``min_improvement`` (hysteresis — elision toggles are
    never flipped on noise). Each program is timed as it serves (on the
    card: replays of its CUDA graph) and dropped, with its capture and
    memory pool, before the next is built, with TF32 off as in
    ``benchmark_binding``. ``use_pallas=None`` follows the device, as
    ``compile_plan`` does; ``default_algo`` (None: IM2COL) binds the convs
    the plan does not assign. Returns the ``elide_overrides`` dict
    for ``lower_plan``/``compile_plan``; with a ``record``, the overrides
    are also stored under ``record.meta["elision_overrides"]`` (JSON-safe
    ``[[src, dst, flag], ...]``).
    """
    from repro_torch.cnn.executor import compile_plan, init_params  # deferred
    from repro_torch.core.mapper import lower_plan

    default_algo = IM2COL if default_algo is None else default_algo
    dev = resolve_device(device)
    if params is None:
        params = init_params(graph, seed=0, device=dev)
    shape = tuple(graph.nodes[graph.source()].attrs["out_shape"])
    if batch is not None:
        shape = (batch,) + shape
    x = torch.randn(shape, generator=torch.Generator(device=dev)
                    .manual_seed(1), device=dev)

    def measure(overrides: Optional[Dict[Tuple[int, int], bool]]) -> float:
        run = compile_plan(graph, plan, default_algo=default_algo,
                           use_pallas=use_pallas,
                           epilogue=epilogue, tuning=tuning,
                           tuning_batch=batch, elide_overrides=overrides,
                           device=dev)
        # Returning drops ``run``, and with it its capture and memory
        # pool, before the next program is built.
        with no_tf32():
            return _program_s(run, params, x, reps)

    lowered = lower_plan(graph, plan, default_algo, epilogue=epilogue,
                         tuning=tuning, batch=batch)
    base_s = measure(None)
    overrides: Dict[Tuple[int, int], bool] = {}
    for edge in lowered.elided_edges:
        s = measure({edge: False})
        if s < base_s * (1 - min_improvement):
            overrides[edge] = False
        if verbose:
            kept = "round-trip" if overrides.get(edge) is False else "elided"
            print(f"tune_elision {edge}: {s * 1e6:.0f}us vs "
                  f"{base_s * 1e6:.0f}us elided → {kept}")
    if record is not None:
        record.meta["elision_overrides"] = \
            [[src, dst, flag] for (src, dst), flag in sorted(overrides.items())]
    return overrides


def elision_overrides_from_meta(record: TuningRecord
                                ) -> Dict[Tuple[int, int], bool]:
    """Inverse of the ``tune_elision(record=...)`` meta stash."""
    raw = record.meta.get("elision_overrides", [])
    return {(int(src), int(dst)): bool(flag) for src, dst, flag in raw}


def autotune_buckets(graph: Graph, plan: Optional[ExecutionPlan] = None, *,
                     buckets: Sequence[int] = (1, 2, 4, 8),
                     record: Optional[TuningRecord] = None,
                     verbose: bool = False,
                     **kwargs) -> TuningRecord:
    """Tune every unique conv signature at every serving batch bucket.

    One record holds all buckets; ``lower_plan(..., tuning=record,
    batch=bucket)`` then binds each bucket's program to the winner
    measured at that batch size (the serving engine compiles one program
    per bucket — see ``serving.cnn_engine``). Bucket 1 is measured on a
    single image, matching the paper's no-batch low-latency setting;
    larger buckets measure the batched (B, H, W, C) overlay path.

    ``kwargs`` forward to ``autotune_graph`` (backends, reps, dataflows,
    device, ...); tuning stays incremental across calls via ``record``.
    """
    record = record if record is not None else TuningRecord()
    for bucket in sorted(set(int(b) for b in buckets)):
        record = autotune_graph(graph, plan,
                                batch=None if bucket == 1 else bucket,
                                record=record, verbose=verbose, **kwargs)
    return record
