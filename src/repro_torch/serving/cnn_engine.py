"""Bucketed dynamic-batching CNN serving engine over compiled overlay
programs — the synchronous engine of the reference.

One overlay program is compiled per *batch bucket* (powers of two up to
``batch_size``) and ticks are scheduled against a per-request latency SLO:

* ``step()`` picks the smallest bucket covering the queue. While the
  oldest request still has deadline budget (``slo_s`` minus the bucket's
  measured service time), the tick *waits* to fill a larger bucket; once
  the budget is spent — or the largest bucket fills — it dispatches,
  zero-padding any empty tail slots;
* with ``slo_s=None`` every tick dispatches immediately through the
  smallest covering bucket.

One host staging buffer sized for the largest bucket is allocated once
(page-locked on a CUDA device); a dispatch copies its leading rows to the
device, and only stale slots left by a previous larger tick are
re-zeroed. A tick blocks until the device is done
(``torch.cuda.synchronize``) before its results are copied to the host.

Pipelined ticks, bounded admission, deadline shedding, fault injection,
degrade mode, meshes, tuning records, int8 calibration and plan hot-swap
are later slices of the port: their options, and ``swap_plan``, raise
``NotImplementedError``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.cnn.executor import compile_plan
from repro_torch.core.graph import Graph
from repro_torch.core.mapper import ExecutionPlan
from repro_torch.kernels.common import resolve_device

OUTCOME_COMPLETED = "completed"

# Every program fuses the conv bias and ReLU (the reference engine's
# default lowering).
EPILOGUE = "bias_relu"
# Requests kept in the ``RequestTrace`` log behind ``stats()``.
TRACE_WINDOW = 2048


def batch_buckets(max_batch: int) -> List[int]:
    """Power-of-two bucket ladder up to ``max_batch`` (inclusive — a
    non-power-of-two cap becomes the top bucket)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


@dataclasses.dataclass
class CNNRequest:
    rid: int
    image: np.ndarray                  # (H, W, C)
    # Stamped at submit() (engine clock) unless the caller provides it.
    t_submit: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class RequestTrace:
    """Per-request lifecycle accounting (engine-clock timestamps; the
    service leg is the tick's measured wall time, so with a virtual clock
    latency combines simulated queueing with real service time)."""
    rid: int
    t_submit: float
    t_dispatch: float
    t_done: float
    bucket: int
    queue_s: float
    service_s: float
    latency_s: float
    slo_ok: bool
    outcome: str = OUTCOME_COMPLETED


class CNNServingEngine:
    """Batches single-image requests through per-bucket compiled plans.

    ``batch_size`` caps the largest bucket of the power-of-two ladder.
    ``slo_s`` is the per-request latency objective driving the tick
    scheduler; ``clock`` injects a time source (tests and trace replays
    pass a virtual clock). ``warmup=True`` runs two padded ticks per bucket
    at construction to prime the per-bucket service-time estimates.
    ``device`` is where the programs run (``"cuda"`` by default; raises
    when CUDA is absent). ``params`` must already live on that device.
    """

    def __init__(self, graph: Graph, params, plan: Optional[ExecutionPlan],
                 batch_size: int = 8,
                 slo_s: Optional[float] = None,
                 tuning=None,
                 clock: Callable[[], float] = time.monotonic,
                 warmup: bool = False,
                 mesh=None,
                 pipeline_depth: int = 1,
                 max_queue: Optional[int] = None,
                 shed_deadline: bool = False,
                 fault_plan=None,
                 degrade=None,
                 act_scales: Optional[Dict[int, float]] = None,
                 device="cuda") -> None:
        later = {"mesh": mesh, "max_queue": max_queue,
                 "shed_deadline": shed_deadline, "fault_plan": fault_plan,
                 "degrade": degrade, "tuning": tuning,
                 "act_scales": act_scales}
        for name, value in later.items():
            if value:
                raise NotImplementedError(
                    f"CNNServingEngine({name}=...) is not ported yet")
        if pipeline_depth != 1:
            raise NotImplementedError(
                "CNNServingEngine(pipeline_depth>1) is not ported yet")
        self.device = resolve_device(device)
        self.graph = graph
        self.params = params
        self.plan = plan
        self.buckets = batch_buckets(batch_size)
        self.b = self.buckets[-1]              # largest bucket
        self.slo_s = slo_s
        self.queue: List[CNNRequest] = []
        self.done: Dict[int, np.ndarray] = {}
        self._clock = clock
        # The graph's input node pins the only image shape the compiled
        # programs accept — validate against it, never against traffic.
        src = graph.nodes[graph.source()]
        self._shape = tuple(int(d) for d in src.attrs["out_shape"])
        self._runs = self.compile_ladder(plan, warm=False)
        # One staging buffer for the largest bucket, allocated ONCE;
        # _filled counts the leading slots the last tick staged, so only
        # slots a smaller dispatch would leak are re-zeroed.
        self._staging = torch.zeros(
            (self.b,) + self._shape, dtype=torch.float32,
            pin_memory=self.device.type == "cuda")
        self._batch_buf = self._staging.numpy()
        self._filled = 0
        # Measured per-bucket service time (EMA) — the scheduler's estimate
        # of how much deadline budget a dispatch will consume.
        self._svc: Dict[int, Optional[float]] = {b: None for b in self.buckets}
        self.dispatches: Dict[int, int] = {b: 0 for b in self.buckets}
        self.last_tick: Optional[Dict[str, object]] = None
        self.request_log: Deque[RequestTrace] = \
            collections.deque(maxlen=TRACE_WINDOW)
        self.submitted_total = 0
        self.served_total = 0
        self.slo_violations = 0
        self._rids: set = set()
        if warmup:
            self._warmup()

    # ------------------------------------------------------------ intake
    def submit(self, req: CNNRequest) -> str:
        """Enqueue one request; returns ``"queued"``. Images are cast to
        f32 and validated against the graph's (H, W, C) input shape here,
        so a bad request never crashes a tick; a ``rid`` already queued or
        completed raises."""
        img = np.asarray(req.image, dtype=np.float32)
        if img.shape != self._shape:
            raise ValueError(
                f"request {req.rid}: image shape {img.shape} != "
                f"graph input shape {self._shape}")
        if req.rid in self._rids:
            raise ValueError(f"request {req.rid}: duplicate rid")
        req.image = img
        if req.t_submit is None:
            req.t_submit = self._clock()
        self._rids.add(req.rid)
        self.submitted_total += 1
        self.queue.append(req)
        return "queued"

    # --------------------------------------------------------- scheduling
    def covering_bucket(self, n: int) -> int:
        """Smallest bucket holding ``n`` requests (the largest bucket for
        any overflow — excess requests wait for the next tick)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.b

    def service_estimate(self, bucket: int) -> float:
        """Expected service time of one ``bucket`` dispatch. Unmeasured
        buckets borrow the largest measured smaller bucket's time, else 0
        (the scheduler then waits the full SLO)."""
        est = self._svc.get(bucket)
        if est is not None:
            return est
        known = [b for b in self._svc
                 if self._svc[b] is not None and b < bucket]
        return self._svc[max(known)] if known else 0.0

    def next_dispatch_at(self) -> Optional[float]:
        """Engine-clock time at which ``step()`` will dispatch without new
        arrivals — None when the queue is empty."""
        if not self.queue:
            return None
        oldest = self.queue[0]
        if self.slo_s is None or len(self.queue) >= self.b:
            return oldest.t_submit          # dispatch immediately
        bucket = self.covering_bucket(len(self.queue))
        wait = max(0.0, self.slo_s - self.service_estimate(bucket))
        return oldest.t_submit + wait

    def dispatch_due(self, now: float) -> bool:
        """True when ``step(now)`` would dispatch rather than wait: a full
        largest bucket, or the oldest request's SLO wait budget is spent."""
        if not self.queue:
            return False
        if len(self.queue) >= self.b:
            return True
        at = self.next_dispatch_at()
        return at is None or now >= at

    # ------------------------------------------------------------- serve
    def step(self, now: Optional[float] = None, flush: bool = False) -> int:
        """One engine tick: dispatch the smallest covering bucket, or wait
        (return 0) while the oldest request has deadline budget left;
        ``flush=True`` dispatches unconditionally. Results are in ``done``
        on return. Returns the number of requests dispatched."""
        if not self.queue:
            return 0
        if now is None:
            now = self._clock()
        if not flush and not self.dispatch_due(now):
            return 0
        return self._dispatch_tick(now)

    def _dispatch_tick(self, now: float) -> int:
        bucket = self.covering_bucket(len(self.queue))
        batch, self.queue = self.queue[:bucket], self.queue[bucket:]
        self._stage(batch)
        t_launch = time.perf_counter()
        out = self._runs[bucket](self.params,
                                 self._staging[:bucket].to(self.device))
        self.dispatches[bucket] += 1
        self._complete(bucket, batch, now, t_launch, out)
        return len(batch)

    def _stage(self, batch: List[CNNRequest]) -> np.ndarray:
        """Pack ``batch`` into the staging buffer, zeroing only slots still
        holding images a previous tick staged there — a smaller bucket
        after a larger one must not leak stale images into its tail."""
        x = self._batch_buf
        for i, req in enumerate(batch):
            x[i] = req.image
        if self._filled > len(batch):
            x[len(batch):self._filled] = 0
        self._filled = len(batch)
        return x

    def _complete(self, bucket: int, reqs: List[CNNRequest], t_dispatch: float,
                  t_launch: float, out: torch.Tensor) -> None:
        """Wait for the device, unpack results into ``done``, update the
        bucket's service EMA and write ``RequestTrace`` records."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        arr = out.cpu().numpy()
        service = max(time.perf_counter() - t_launch, 1e-9)
        for i, req in enumerate(reqs):
            self.done[req.rid] = arr[i]
        prev = self._svc[bucket]
        self._svc[bucket] = (service if prev is None
                             else 0.5 * prev + 0.5 * service)
        self.served_total += len(reqs)
        t_done = t_dispatch + service
        for req in reqs:
            queue_s = max(0.0, t_dispatch - req.t_submit)
            latency_s = queue_s + service
            slo_ok = self.slo_s is None or latency_s <= self.slo_s
            if not slo_ok:
                self.slo_violations += 1
            self.request_log.append(RequestTrace(
                rid=req.rid, t_submit=req.t_submit, t_dispatch=t_dispatch,
                t_done=t_done, bucket=bucket, queue_s=queue_s,
                service_s=service, latency_s=latency_s, slo_ok=slo_ok))
        self.last_tick = {"bucket": bucket, "served": len(reqs),
                          "wall_s": service, "now": t_dispatch}

    def drain(self) -> Dict[int, np.ndarray]:
        """Every dispatched result (ticks complete synchronously)."""
        return self.done

    def run_until_done(self, max_ticks: int = 1000) -> Dict[int, np.ndarray]:
        """Drain the queue, ignoring SLO waits (shutdown/offline replay)."""
        for _ in range(max_ticks):
            if self.step(flush=True) == 0:
                break
        return self.drain()

    # ------------------------------------------------------ observability
    def stats(self) -> Dict[str, object]:
        """Snapshot of the request accounting: totals, per-bucket dispatch
        counts and service EMAs, SLO violations, and latency / queue-wait
        aggregates over the ``request_log`` window. Pure read."""
        def _agg(vals: List[float]) -> Optional[Dict[str, float]]:
            if not vals:
                return None
            arr = np.asarray(vals)
            return {"mean_ms": float(arr.mean()) * 1e3,
                    "p50_ms": float(np.percentile(arr, 50)) * 1e3,
                    "p99_ms": float(np.percentile(arr, 99)) * 1e3,
                    "max_ms": float(arr.max()) * 1e3}

        window = list(self.request_log)
        return {
            "submitted": self.submitted_total,
            "served": self.served_total,
            "queued": len(self.queue),
            "slo_s": self.slo_s,
            "slo_violations": self.slo_violations,
            "dispatches": dict(self.dispatches),
            "service_ema_s": {b: s for b, s in self._svc.items()
                              if s is not None},
            "window": len(window),
            "latency": _agg([t.latency_s for t in window]),
            "queue_wait": _agg([t.queue_s for t in window]),
            "device": str(self.device),
        }

    # ----------------------------------------------------- bucket ladder
    def swap_plan(self, *args, **kwargs) -> None:
        """Online plan hot-swap is a later slice of the port."""
        raise NotImplementedError(
            "CNNServingEngine.swap_plan is not ported yet")

    def compile_ladder(self, plan: Optional[ExecutionPlan],
                       warm: bool = True) -> Dict[int, Callable]:
        """One compiled program per bucket for ``plan`` under this engine's
        options; ``warm=True`` runs each once on an all-zeros batch."""
        runs = {
            bucket: compile_plan(self.graph, plan, epilogue=EPILOGUE,
                                 tuning_batch=bucket, device=self.device)
            for bucket in self.buckets
        }
        if warm:
            for bucket, run in runs.items():
                self._run_blocking(run, bucket)
        return runs

    def _run_blocking(self, run: Callable, bucket: int) -> None:
        x = torch.zeros((bucket,) + self._shape, dtype=torch.float32,
                        device=self.device)
        run(self.params, x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warmup(self) -> None:
        """Prime the service estimates: two all-zeros dispatches per bucket,
        the second's wall time is the estimate."""
        for bucket in self.buckets:
            for _ in range(2):
                t0 = time.perf_counter()
                self._run_blocking(self._runs[bucket], bucket)
                wall = time.perf_counter() - t0
            self._svc[bucket] = wall
