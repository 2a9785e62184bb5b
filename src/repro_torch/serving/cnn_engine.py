"""Bucketed dynamic-batching CNN serving engine over compiled overlay
programs — the reference's engine, pipelined and robust, on the card.

One overlay program is compiled per *batch bucket* (powers of two up to
``batch_size``, or the ascending ``buckets`` given) and ticks are
scheduled against a per-request latency SLO:

* ``step()`` picks the smallest bucket covering the queue. While the
  oldest request still has deadline budget (``slo_s`` minus the bucket's
  measured service time), the tick *waits* to fill a larger bucket; once
  the budget is spent — or the largest bucket fills — it dispatches,
  zero-padding any empty tail slots;
* with ``slo_s=None`` every tick dispatches immediately through the
  smallest covering bucket.

Host staging buffers sized for the largest bucket are allocated once,
one per pipeline slot (page-locked on a CUDA device); a dispatch hands
its buffer's leading rows to the bucket's program, which copies them
into its captured graph's static input (``executor.CompiledProgram``:
the first dispatch of a bucket walks the program eagerly, the second
captures it, later ones replay), and only stale slots left by a previous
larger tick are re-zeroed.

Pipelined execution (``pipeline_depth >= 2``) makes the tick loop
asynchronous: ``step()`` enqueues the tick's copy in, replay and the copy
of its logits into the slot's pinned host output buffer, records one
CUDA event after them and returns, so the host packs tick N+1 while the
card computes tick N. Completion happens lazily: at the start of the
next ``step()`` for ticks whose event has fired (``Event.query``, which
never blocks), when the pipeline is full and the oldest tick's buffers
must be reclaimed, on ``drain()``, or when a requester ``poll()``s for
its result; it waits on that tick's own event only
(``Event.synchronize``), never on the whole device, so later in-flight
ticks stay in flight and their device time stays out of this tick's
service time. Staging and output buffers rotate across
``pipeline_depth`` slots, so the buffers a tick reads and writes are
never rewritten before the tick retires; each result is copied out of
its slot's buffer. All ticks share one stream, so one capture per bucket
serves every slot: tick N+1's copy into the static input is enqueued
after tick N's replay and clone. On the CPU a program returns its logits
when it returns, and a tick is ready once its injected device delay has
passed. ``pipeline_depth=1`` (default) completes every tick inside its
``step()`` with the same scheduling, outputs and accounting.

Robustness (overload + faults) — every request ends in exactly one
outcome, and the four counters conserve (``completed + rejected_full +
shed_deadline + failed + pending == submitted``):

* **bounded admission** — ``max_queue=N`` rejects at ``submit()`` once
  the queue holds N requests (outcome ``rejected_full``);
* **deadline shedding** — ``shed_deadline=True`` (with an ``slo_s``)
  drops queued requests whose deadline is unmeetable even by the
  cheapest bucket's measured service estimate (outcome
  ``shed_deadline``);
* **fault-injected tick retry** — a ``distributed.fault.FaultPlan``
  fails or delays planned ticks, at dispatch or at completion (host
  emulation: a real CUDA error is sticky and cannot be retried);
  dispatch runs in a bounded retry-with-backoff loop (``max_retries``,
  ``retry_backoff_s``) replaying from the tick's staging buffer, and a
  tick that exhausts its retries fails its requests cleanly (outcome
  ``failed``; pipeline slot and buffers reclaimed, service EMAs
  untouched, later ticks unaffected);
* **graceful degradation** — ``degrade=DegradeConfig(...)`` arms a
  hysteresis controller: sustained queue pressure or consecutive
  service-time spikes (``distributed.fault.robust_zscore``) switch the
  scheduler to dispatch-immediately smallest-bucket mode until the queue
  stays below the exit watermark for ``exit_ticks`` ticks.

All four default OFF. An int8 plan is served with its calibrated
``act_scales`` (``core.quant.plan_mixed_precision``), which every bucket
program takes; ``stats()["precision"]`` reports the plan's precision
mix. A ``tuning`` record (``core.autotune.autotune_buckets``) binds each
bucket's program to the winners measured at that bucket
(``compile_plan(..., tuning=record, tuning_batch=bucket)``), falling back
to a neighbouring bucket's entry where the record has none.

Data-parallel serving: with ``mesh=`` (a ``launch.mesh.DataMesh``) every
bucket program is a ``ShardedProgram`` — params are replicated on the
mesh once, at construction, each bucket's batch splits across the mesh's
data shards, and the ladder is built in multiples of the shard count.
Tuning lookups key off the *per-chip* batch (``bucket // data_shards``),
so a record tuned on one card binds a sharded engine unchanged.

Plan hot-swap: ``compile_ladder(plan)`` compiles (and, warmed, captures)
a new bucket ladder without touching the engine, so it may run on a
background thread, and ``swap_plan`` installs it between ticks on the
serving thread — in-flight ticks retire on the programs they were
dispatched on, and the queue, the ledger and the service estimates carry
over. ``cache=`` (an ``executor.ExecutableCache``) shares bucket programs
across engines: tenants of one architecture share each program and hold
one capture each, since a capture binds its params' pointers.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.cnn.executor import (_with_fault_hook, check_dtype,
                                      compile_plan, params_dtype)
from repro_torch.core.algorithms import IM2COL, Algorithm
from repro_torch.core.graph import Graph
from repro_torch.core.mapper import ExecutionPlan
from repro_torch.distributed.fault import (DeviceFault, FaultPlan,
                                           robust_zscore)
from repro_torch.distributed.sharding import data_shard_count, replicate
from repro_torch.kernels.common import device_guard, resolve_device
from repro_torch.launch.mesh import DataMesh

# The four terminal request outcomes (RequestTrace.outcome).
OUTCOME_COMPLETED = "completed"
OUTCOME_REJECTED = "rejected_full"
OUTCOME_SHED = "shed_deadline"
OUTCOME_FAILED = "failed"

# The reference engine's defaults: every program fuses the conv bias and
# ReLU, and the ``RequestTrace`` log behind ``stats()`` keeps this many
# requests.
EPILOGUE = "bias_relu"
TRACE_WINDOW = 2048


def batch_buckets(max_batch: int, shard: int = 1) -> List[int]:
    """Power-of-two bucket ladder up to ``max_batch`` (inclusive — a
    non-power-of-two cap becomes the top bucket). ``shard`` > 1 builds the
    mesh-sharded ladder: every bucket is a multiple of the data-shard
    count (``shard``, ``2*shard``, ``4*shard``, ...), so each bucket's
    padded batch splits evenly across the mesh. The cap itself must
    divide."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if shard < 1:
        raise ValueError(f"shard must be >= 1, got {shard}")
    if max_batch % shard:
        raise ValueError(
            f"max_batch {max_batch} is not a multiple of the data-shard "
            f"count {shard}; the top bucket could not be placed on the mesh")
    out = []
    b = shard
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
    latency combines simulated queueing with real service time).
    ``outcome`` is the request's terminal state: ``completed`` requests
    carry the full submit→dispatch→done timeline; ``rejected_full`` /
    ``shed_deadline`` / ``failed`` records stamp the decision time into
    ``t_dispatch`` / ``t_done`` with ``service_s == 0`` and ``bucket``
    the tick's bucket for failures, 0 otherwise."""
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


@dataclasses.dataclass(frozen=True)
class DegradeConfig:
    """Hysteresis thresholds for the overload degrade mode.

    Enter when the queue reaches ``enter_queue`` (default: 3× the top
    bucket) OR the last ``straggler_patience`` completed ticks were all
    service-time spikes (``robust_zscore`` over the trailing ``window``
    tick history exceeding ``straggler_k``). While active, ``step()``
    dispatches immediately through the smallest covering bucket. Exit
    after the queue has stayed at or below ``exit_queue`` (default: the
    top bucket) with no fresh spike for ``exit_ticks`` consecutive ticks;
    the two watermarks are separate so the mode cannot flap."""
    enter_queue: Optional[int] = None
    exit_queue: Optional[int] = None
    exit_ticks: int = 3
    straggler_k: float = 4.0
    straggler_patience: int = 2
    window: int = 32


@dataclasses.dataclass
class InflightTick:
    """One dispatched-but-not-retired tick: its logits on the device,
    the event recorded after their copy into the slot's host buffer
    (None on the CPU), and everything completion needs to unpack them
    and write traces. ``buf_index`` is the pipeline slot whose staging
    and output buffers the tick holds until it retires; ``run`` is the
    bucket program it was dispatched on, which completion-surfaced fault
    replays re-run."""
    bucket: int
    reqs: List[CNNRequest]
    out: Optional[torch.Tensor]
    t_dispatch: float                  # engine clock at dispatch
    t_launch_pc: float                 # perf_counter at dispatch
    t_launched_pc: float               # perf_counter after dispatch returned
    ready_at_pc: float                 # t_launch_pc + injected device delay
    buf_index: int
    tick_idx: int = 0                  # global dispatch index (FaultPlan key)
    fault: object = None               # planned TickFault for this tick
    attempt: int = 0                   # dispatch attempts already burned
    run: object = None                 # program the tick dispatched on
    event: object = None               # torch.cuda.Event after the readback


class CNNServingEngine:
    """Batches single-image requests through per-bucket compiled plans.

    ``batch_size`` caps the largest bucket of the power-of-two ladder;
    ``buckets`` overrides the ladder (e.g. ``(2, 8)``). ``slo_s`` is the
    per-request latency objective driving the tick scheduler; ``clock``
    injects a time source (tests and trace replays pass a virtual clock).
    ``warmup=True`` runs three all-zeros ticks per bucket at construction
    (the eager warm pass, the capture and a replay) to prime the
    per-bucket service-time estimates. ``device`` is where the programs
    run (``"cuda"`` by default; raises when CUDA is absent). ``params``
    must already live on that device. ``mesh`` (a ``launch.mesh.DataMesh``
    of ``device``'s type) serves data-parallel, as the module docstring
    says; the engine's device is then the mesh's first, where results are
    gathered and read back. ``act_scales`` ({conv node id:
    activation scale}) feeds the plan's int8 layers, in every bucket
    program; ``tuning`` (a ``core.autotune.TuningRecord``) binds each
    bucket's program to the winners measured at that bucket;
    ``default_algo`` is the algorithm of every conv the plan does not
    assign (all of them with ``plan=None``), in every bucket program,
    swapped-in ladders included. ``cache`` (an
    ``ExecutableCache``) shares the bucket programs with every engine
    compiling through it; the fault hook wraps outside the cached program.

    ``pipeline_depth`` >= 2 keeps up to that many ticks in flight, with
    results landing in ``done`` lazily — on later ``step()`` calls, on
    ``drain()``, or via ``poll(rid)``. ``device_delay_s`` makes every
    tick ready only that long after its dispatch (a test and bench hook
    emulating a slower device). ``max_queue``, ``shed_deadline``,
    ``fault_plan`` (with ``max_retries`` re-dispatches after
    ``retry_backoff_s``, doubling per attempt) and ``degrade`` are the
    robustness options of the module docstring. ``submit()`` returns the
    admission verdict (``"queued"`` or ``"rejected_full"``) and raises
    ``ValueError`` on a rid already live in the engine.

    ``use_pallas`` (None: the device decides, so a card runs the kernels),
    ``epilogue`` (the lowering's fused epilogue) and ``trace_window`` (the
    requests ``request_log`` keeps) are the reference engine's options,
    with its defaults (``use_pallas`` aside: the reference's is False).
    ``dtype`` (f32, or bf16 as
    ``init_params(dtype=torch.bfloat16)`` gives the params, which must
    match it) is the dtype every bucket program runs in and the staging
    buffers hold: images are cast to it at ``submit`` (rounded to nearest
    even) and the pinned buffers are filled through torch, since numpy
    holds no bf16 where ``ml_dtypes`` is absent. Results come back as f32
    numpy rows in either dtype, widening bf16 logits exactly (the
    reference returns them in its engine dtype).
    """

    def __init__(self, graph: Graph, params, plan: Optional[ExecutionPlan],
                 batch_size: int = 8,
                 buckets: Optional[Sequence[int]] = None,
                 slo_s: Optional[float] = None,
                 tuning=None,
                 default_algo: Algorithm = IM2COL,
                 clock: Callable[[], float] = time.monotonic,
                 warmup: bool = False,
                 mesh=None,
                 pipeline_depth: int = 1,
                 device_delay_s: float = 0.0,
                 max_queue: Optional[int] = None,
                 shed_deadline: bool = False,
                 fault_plan: Optional[FaultPlan] = None,
                 max_retries: int = 2,
                 retry_backoff_s: float = 0.0,
                 degrade: Optional[DegradeConfig] = None,
                 cache=None,
                 act_scales: Optional[Dict[int, float]] = None,
                 use_pallas: Optional[bool] = None,
                 epilogue: str = EPILOGUE,
                 trace_window: int = TRACE_WINDOW,
                 dtype: torch.dtype = torch.float32,
                 device="cuda") -> None:
        if mesh is not None and not isinstance(mesh, DataMesh):
            raise TypeError(f"CNNServingEngine(mesh=...) takes a launch."
                            f"mesh.DataMesh, got {type(mesh).__name__}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.device = resolve_device(device)
        self.dtype = check_dtype(dtype)
        if params_dtype(params) != self.dtype:
            raise TypeError(f"params of {params_dtype(params)} for an "
                            f"engine of {self.dtype}")
        self.use_pallas = use_pallas
        self.epilogue = epilogue
        self.mesh = mesh
        if mesh is not None:
            if mesh.devices[0].type != self.device.type:
                raise ValueError(f"mesh devices {mesh.devices} are not of "
                                 f"device={str(self.device)!r}")
            self.device = mesh.devices[0]
            self.data_shards = data_shard_count(mesh)
            # Replicate params across the mesh ONCE: each tick's shards
            # then read tensors already on their cards.
            params = replicate(params, mesh)
        else:
            self.data_shards = 1
        # Every card a tick runs on (distinct, mesh order): warm passes
        # and blocking dispatches wait for each of them.
        self._devices = (tuple(dict.fromkeys(mesh.devices))
                         if mesh is not None else (self.device,))
        self.graph = graph
        self.params = params
        self.plan = plan
        self.tuning = tuning
        self.default_algo = default_algo
        self.cache = cache
        # Deployment history (stats()["plan"]): engine-lifetime, so
        # reset() keeps it.
        self.plan_swaps = 0
        self.plan_rollbacks = 0
        self.pipeline_depth = int(pipeline_depth)
        self.device_delay_s = float(device_delay_s)
        self.max_queue = max_queue
        self.shed_deadline = bool(shed_deadline)
        self.fault_plan = fault_plan
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        # Per-layer precision map of the served plan (empty: all bf16),
        # surfaced by stats()["precision"].
        self.act_scales = act_scales
        self.precisions = dict(getattr(plan, "precisions", None) or {}) \
            if plan is not None else {}
        self.buckets = (sorted(set(int(b) for b in buckets)) if buckets
                        else batch_buckets(batch_size, self.data_shards))
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        bad = [b for b in self.buckets if b % self.data_shards]
        if bad:
            raise ValueError(
                f"buckets {bad} are not multiples of the mesh's data-shard "
                f"count {self.data_shards} — their padded batches could "
                "not be placed")
        self.b = self.buckets[-1]              # largest bucket
        self.slo_s = slo_s
        self.queue: List[CNNRequest] = []
        self.done: Dict[int, np.ndarray] = {}
        self._clock = clock
        # The graph's input node pins the only image shape the compiled
        # programs accept — validate against it, never against traffic.
        src = graph.nodes[graph.source()]
        self._shape = tuple(int(d) for d in src.attrs["out_shape"])
        # The fault hook reads the (tick index, attempt) context the
        # dispatch path sets around each call; warm-up never sets one, so
        # it can neither consume nor trip planned faults.
        self._fault_ctx: tuple = (None, 0)
        # In-flight dispatches, oldest first (completion is FIFO: the
        # stream runs ticks in dispatch order).
        self._inflight: Deque[InflightTick] = collections.deque()
        self._runs = self.compile_ladder(plan, act_scales=act_scales,
                                         warm=False)
        # One staging buffer per pipeline slot, sized for the largest
        # bucket and allocated ONCE; _filled counts, per buffer, the
        # leading slots the last tick staged there, so only slots a
        # smaller dispatch would leak are re-zeroed. Each slot's host
        # output buffer is allocated at its first tick (its shape is the
        # program's output's).
        self._pin = self.device.type == "cuda"
        self._stagings = [torch.zeros((self.b,) + self._shape,
                                      dtype=self.dtype,
                                      pin_memory=self._pin)
                          for _ in range(self.pipeline_depth)]
        # The same memory as numpy arrays where numpy can hold the dtype
        # (f32); the tensors themselves in bf16.
        self._batch_bufs = [s.numpy() if self.dtype == torch.float32 else s
                            for s in self._stagings]
        self._filled = [0] * self.pipeline_depth
        self._host_outs: List[Optional[torch.Tensor]] = \
            [None] * self.pipeline_depth
        self._buf_cursor = 0
        self._last_buf_index = 0
        # Serial-device completion model: a tick's service time is its
        # completion minus max(its launch, the previous completion).
        self._last_ready_pc = float("-inf")
        self._last_done = float("-inf")        # engine-clock completion
        # Overlap accounting: device-busy time that elapsed while the
        # host was NOT blocked waiting on it (stats()["pipeline"]).
        self._overlap_s = 0.0
        self._device_busy_s = 0.0
        self._dispatched_ticks = 0
        self._completed_ticks = 0
        # Measured per-bucket service time (EMA) — the scheduler's estimate
        # of how much deadline budget a dispatch will consume.
        self._svc: Dict[int, Optional[float]] = {b: None for b in self.buckets}
        self.dispatches: Dict[int, int] = {b: 0 for b in self.buckets}
        self.last_tick: Optional[Dict[str, object]] = None
        self.request_log: Deque[RequestTrace] = \
            collections.deque(maxlen=trace_window)
        self.submitted_total = 0
        self.served_total = 0
        self.slo_violations = 0
        # Robustness accounting (all zero and inert with the options off).
        self.rejected_total = 0
        self.shed_total = 0
        self.failed_total = 0
        self.retries_total = 0
        self.failed_ticks = 0
        self.queue_high_water = 0
        self.failed: Dict[int, int] = {}       # rid -> faulted tick index
        self.shed_rids: Set[int] = set()
        self._pending_rids: Set[int] = set()   # queued, not yet dispatched
        self._inflight_rids: Set[int] = set()  # dispatched, not retired
        # Global dispatch index (FaultPlan key): every tick that consumes
        # requests burns one, whether or not its launch ever succeeds.
        self._tick_seq = 0
        self._degrade_cfg = degrade
        self._degrade_active = False
        self._degrade_entries = 0
        self._degrade_exits = 0
        self._degrade_calm = 0                 # consecutive calm ticks
        self._spikes_total = 0
        self._spike_streak = 0
        if degrade is not None:
            self._enter_q = (degrade.enter_queue
                             if degrade.enter_queue is not None
                             else 3 * self.b)
            self._exit_q = (degrade.exit_queue
                            if degrade.exit_queue is not None else self.b)
            if self._exit_q >= self._enter_q:
                raise ValueError(
                    f"degrade exit_queue {self._exit_q} must be below "
                    f"enter_queue {self._enter_q} (hysteresis)")
            self._svc_hist: Deque[float] = \
                collections.deque(maxlen=degrade.window)
        if warmup:
            self._warmup()

    @property
    def _staging(self) -> torch.Tensor:
        """The first slot's staging buffer (the synchronous engine's
        only one)."""
        return self._stagings[0]

    @property
    def _batch_buf(self):
        """``_staging`` as a numpy array (the same memory; the tensor
        itself in bf16)."""
        return self._batch_bufs[0]

    # ------------------------------------------------------------ intake
    def submit(self, req: CNNRequest) -> str:
        """Enqueue one request; returns the admission verdict —
        ``"queued"``, or ``"rejected_full"`` when ``max_queue`` is set
        and already reached (counted and traced). Images are cast to the
        engine's dtype (an f32 numpy array, or a bf16 tensor) and validated
        against the graph's (H, W, C) input shape here, so a bad request
        never crashes a tick; a ``rid`` already live anywhere in the engine
        (queued, in flight, completed or failed) raises."""
        img = np.asarray(req.image, dtype=np.float32)
        if img.shape != self._shape:
            raise ValueError(
                f"request {req.rid}: image shape {img.shape} != "
                f"graph input shape {self._shape}")
        if (req.rid in self._pending_rids or req.rid in self._inflight_rids
                or req.rid in self.done or req.rid in self.failed):
            raise ValueError(
                f"request {req.rid}: duplicate rid — already "
                + ("queued" if req.rid in self._pending_rids else
                   "in flight" if req.rid in self._inflight_rids else
                   "completed" if req.rid in self.done else "failed"))
        req.image = (img if self.dtype == torch.float32
                     else torch.from_numpy(img).to(self.dtype))
        if req.t_submit is None:
            req.t_submit = self._clock()
        self.submitted_total += 1
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return self._record_rejection(req)
        self.queue.append(req)
        self._pending_rids.add(req.rid)
        self.queue_high_water = max(self.queue_high_water, len(self.queue))
        return "queued"

    def reject(self, req: CNNRequest) -> str:
        """Externally imposed admission rejection (a queue cap above the
        engine): the request is counted as submitted and rejected in this
        engine's ledger without entering the queue, and its rid may be
        resubmitted."""
        if req.t_submit is None:
            req.t_submit = self._clock()
        self.submitted_total += 1
        return self._record_rejection(req)

    def _record_rejection(self, req: CNNRequest) -> str:
        self.rejected_total += 1
        self.request_log.append(RequestTrace(
            rid=req.rid, t_submit=req.t_submit,
            t_dispatch=req.t_submit, t_done=req.t_submit,
            bucket=0, queue_s=0.0, service_s=0.0, latency_s=0.0,
            slo_ok=False, outcome=OUTCOME_REJECTED))
        return OUTCOME_REJECTED

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
        if (self.slo_s is None or self._degrade_active
                or len(self.queue) >= self.b):
            return oldest.t_submit          # dispatch immediately
        bucket = self.covering_bucket(len(self.queue))
        wait = max(0.0, self.slo_s - self.service_estimate(bucket))
        return oldest.t_submit + wait

    def oldest_deadline(self) -> Optional[float]:
        """Deadline of the oldest queued request (``t_submit + slo_s``, or
        bare ``t_submit`` with no SLO) — None when the queue is empty. The
        multi-model scheduler steps tenants in this order."""
        if not self.queue:
            return None
        oldest = self.queue[0]
        if self.slo_s is None:
            return oldest.t_submit
        return oldest.t_submit + self.slo_s

    def dispatch_due(self, now: float) -> bool:
        """True when ``step(now)`` would dispatch rather than wait: a full
        largest bucket, active degrade mode, or the oldest request's SLO
        wait budget is spent."""
        if not self.queue:
            return False
        if len(self.queue) >= self.b or self._degrade_active:
            return True
        at = self.next_dispatch_at()
        return at is None or now >= at

    # ------------------------------------------------------------- serve
    def step(self, now: Optional[float] = None, flush: bool = False) -> int:
        """One engine tick: retire in-flight ticks that are ready, advance
        the degrade controller, shed hopeless requests, then dispatch the
        smallest covering bucket or wait (return 0) while the oldest
        request has deadline budget left; ``flush=True`` dispatches
        unconditionally. Returns the number of requests dispatched (a
        tick that fails after its retries still consumed them). At depth 1
        results are in ``done`` on return."""
        if self._inflight:
            self._reap()
        if self._degrade_cfg is not None:
            self._degrade_update()
        if not self.queue:
            return 0
        if now is None:
            now = self._clock()
        if self.shed_deadline and self.slo_s is not None:
            self._shed_hopeless(now)
            if not self.queue:
                return 0
        if not flush and not self.dispatch_due(now):
            return 0
        return self._dispatch_tick(now)

    def _dispatch_tick(self, now: float) -> int:
        """Carve the covering bucket off the queue, stage, launch (with
        fault retry), and either complete synchronously or enqueue the
        in-flight tick. Always dispatches."""
        bucket = self.covering_bucket(len(self.queue))
        batch, self.queue = self.queue[:bucket], self.queue[bucket:]
        for req in batch:
            self._pending_rids.discard(req.rid)
            self._inflight_rids.add(req.rid)
        if len(self._inflight) >= self.pipeline_depth:
            # Pipeline full: the next slot's buffers still belong to the
            # oldest in-flight tick — retire it to reclaim them.
            self._complete(self._inflight.popleft())
        idx = self._stage(batch)
        tick_idx = self._tick_seq
        self._tick_seq += 1
        fault = (self.fault_plan.get(tick_idx)
                 if self.fault_plan is not None else None)
        t_launch = time.perf_counter()
        out, attempt = self._launch(bucket, idx, tick_idx, fault)
        event = (self._readback(idx, bucket, out) if out is not None
                 else None)
        tick = InflightTick(bucket=bucket, reqs=batch, out=out,
                            t_dispatch=now, t_launch_pc=t_launch,
                            t_launched_pc=time.perf_counter(),
                            ready_at_pc=(t_launch + self.device_delay_s
                                         + (fault.delay_s if fault else 0.0)),
                            buf_index=idx, tick_idx=tick_idx, fault=fault,
                            attempt=attempt, run=self._runs[bucket],
                            event=event)
        if out is None:
            # Launch retries exhausted: the requests get their terminal
            # outcome and the slot goes back to the next tick (no launch
            # read its staging buffer or wrote its host output). Else the
            # next tick would stage into a slot an in-flight tick holds.
            self._buf_cursor = idx
            self._fail_tick(tick)
            return len(batch)
        self.dispatches[bucket] += 1
        self._dispatched_ticks += 1
        if self.pipeline_depth == 1:
            self._complete(tick)
        else:
            self._inflight.append(tick)
        return len(batch)

    def _launch(self, bucket: int, idx: int, tick_idx: int, fault) -> tuple:
        """Call the bucket program on slot ``idx``'s staging rows under
        the fault context, retrying dispatch-surfaced ``DeviceFault``s with
        bounded backoff. Returns ``(logits, attempts burned)`` —
        ``(None, n)`` when retries are exhausted."""
        x = self._stagings[idx][:bucket]
        attempt = 0
        while True:
            try:
                self._fault_ctx = (tick_idx, attempt)
                return self._runs[bucket](self.params, x), attempt
            except DeviceFault:
                if attempt >= self.max_retries:
                    return None, attempt
                self.retries_total += 1
                self._backoff_sleep(attempt)
                attempt += 1
            finally:
                self._fault_ctx = (None, 0)

    def _readback(self, idx: int, bucket: int, out: torch.Tensor):
        """On the card: enqueue the copy of a tick's logits into slot
        ``idx``'s pinned host buffer and return the event recorded after
        it. On the CPU the logits are already on the host: None."""
        if self.device.type != "cuda":
            return None
        host = self._host_outs[idx]
        if host is None:
            host = self._host_outs[idx] = torch.empty(
                (self.b,) + tuple(out.shape[1:]), dtype=out.dtype,
                pin_memory=self._pin)
        # On the engine's card (the mesh's first, where a sharded tick's
        # outputs were gathered): its stream already follows every shard's
        # copy-in, so one event per tick frees the tick's staging slot too.
        with device_guard(self.device):
            host[:bucket].copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return event

    def _fault_hook(self) -> None:
        """Per-call dispatch hook threaded through ``compile_plan`` when a
        ``fault_plan`` is armed: raises for planned dispatch-surfaced
        failures of the current (tick, attempt) context. Delays do not
        sleep here — they ride ``ready_at_pc``."""
        tick_idx, attempt = self._fault_ctx
        fault = self.fault_plan.get(tick_idx)
        if (fault is not None and fault.at_dispatch
                and attempt < fault.failures):
            raise DeviceFault(
                f"injected dispatch fault: tick {tick_idx} "
                f"attempt {attempt}")

    def _backoff_sleep(self, attempt: int) -> None:
        """Exponential backoff between retry attempts (base doubles per
        burned attempt; base 0.0 retries immediately)."""
        delay = self.retry_backoff_s * (2 ** attempt)
        if delay > 0:
            time.sleep(delay)

    def _shed_hopeless(self, now: float) -> None:
        """Drop queued requests whose SLO is unmeetable even by an
        immediate smallest-bucket dispatch; with no measured estimate yet
        (0.0) nothing is shed."""
        floor = self.service_estimate(self.buckets[0])
        if floor <= 0.0:
            return
        keep: List[CNNRequest] = []
        for req in self.queue:
            if (now - req.t_submit) + floor > self.slo_s:
                self.shed_total += 1
                self.shed_rids.add(req.rid)
                self._pending_rids.discard(req.rid)
                queue_s = max(0.0, now - req.t_submit)
                self.request_log.append(RequestTrace(
                    rid=req.rid, t_submit=req.t_submit, t_dispatch=now,
                    t_done=now, bucket=0, queue_s=queue_s, service_s=0.0,
                    latency_s=queue_s, slo_ok=False, outcome=OUTCOME_SHED))
            else:
                keep.append(req)
        if len(keep) != len(self.queue):
            self.queue = keep

    def _degrade_update(self) -> None:
        """Advance the degrade hysteresis one tick: enter on queue
        pressure or a sustained spike streak; exit only after
        ``exit_ticks`` consecutive calm ticks at or below the exit
        watermark."""
        cfg = self._degrade_cfg
        q = len(self.queue)
        if not self._degrade_active:
            if (q >= self._enter_q
                    or self._spike_streak >= cfg.straggler_patience):
                self._degrade_active = True
                self._degrade_entries += 1
                self._degrade_calm = 0
        else:
            if q <= self._exit_q and self._spike_streak == 0:
                self._degrade_calm += 1
                if self._degrade_calm >= cfg.exit_ticks:
                    self._degrade_active = False
                    self._degrade_exits += 1
                    self._degrade_calm = 0
            else:
                self._degrade_calm = 0

    # --------------------------------------------------- staging buffers
    def _stage(self, batch: List[CNNRequest]) -> int:
        """Pack ``batch`` into the next slot's staging buffer and return
        the slot. Rotation guarantees the slot's previous tick has
        retired (pipeline depth == slot count, and only a tick that
        launched keeps its slot)."""
        idx = self._buf_cursor
        self._buf_cursor = (idx + 1) % len(self._batch_bufs)
        self._last_buf_index = idx
        self._pack(idx, batch)
        return idx

    def _pack(self, idx: int, batch: List[CNNRequest]) -> None:
        """Write ``batch`` into staging buffer ``idx``, zeroing only slots
        still holding images an earlier tick staged there — a smaller
        bucket after a larger one must not leak stale images into its
        padded tail."""
        x = self._stagings[idx]
        for i, req in enumerate(batch):
            x[i] = torch.as_tensor(req.image)
        if self._filled[idx] > len(batch):
            x[len(batch):self._filled[idx]] = 0
        self._filled[idx] = len(batch)

    # ------------------------------------------------------- completion
    def _reap(self) -> None:
        """Retire in-flight ticks that are already done, without blocking
        (FIFO: a tick that is not done holds back the ones after it)."""
        while self._inflight:
            head = self._inflight[0]
            if time.perf_counter() < head.ready_at_pc:
                break
            if head.event is not None and not head.event.query():
                break
            self._complete(self._inflight.popleft())

    def _complete(self, tick: InflightTick) -> None:
        """Blocking completion of one tick: wait for its own event, replay
        planned completion-surfaced faults from its staging buffer under
        the retry budget (exhaustion fails the tick cleanly), copy its
        rows into ``done``, update the bucket's service EMA from the
        device-completion time and write ``RequestTrace`` records."""
        t_block = time.perf_counter()
        if tick.event is not None:
            tick.event.synchronize()
        remaining = tick.ready_at_pc - time.perf_counter()
        if remaining > 0:
            time.sleep(remaining)           # emulated device still busy
        fault = tick.fault
        if fault is not None and not fault.at_dispatch:
            while tick.attempt < fault.failures:
                if tick.attempt >= self.max_retries:
                    self._fail_tick(tick)
                    return
                self.retries_total += 1
                self._backoff_sleep(tick.attempt)
                tick.attempt += 1
                # Replay from the slot's staging buffer — rotation
                # guarantees it still holds exactly this tick's images —
                # on the program the tick was dispatched on.
                x = self._stagings[tick.buf_index][:tick.bucket]
                try:
                    self._fault_ctx = (tick.tick_idx, tick.attempt)
                    tick.out = tick.run(self.params, x)
                finally:
                    self._fault_ctx = (None, 0)
                tick.event = self._readback(tick.buf_index, tick.bucket,
                                            tick.out)
                if tick.event is not None:
                    tick.event.synchronize()
        t_ready = time.perf_counter()
        # Serial-device occupancy: this tick could only start once the
        # previous one finished.
        start = max(tick.t_launch_pc, self._last_ready_pc)
        service = max(t_ready - start, 1e-9)
        self._last_ready_pc = t_ready
        # Overlap: the part of this tick's device time that elapsed
        # between its dispatch returning and the host waiting on it.
        free_from = max(tick.t_launched_pc, start)
        self._overlap_s += min(max(t_block - free_from, 0.0), service)
        self._device_busy_s += service
        self._completed_ticks += 1
        rows = (tick.out if tick.event is None
                else self._host_outs[tick.buf_index][:tick.bucket])
        rows = rows.to(torch.float32).numpy()
        for i, req in enumerate(tick.reqs):
            # A copy: the slot's buffer is rewritten by a later tick.
            self.done[req.rid] = rows[i].copy()
            self._inflight_rids.discard(req.rid)
        prev = self._svc[tick.bucket]
        self._svc[tick.bucket] = (service if prev is None
                                  else 0.5 * prev + 0.5 * service)
        self.served_total += len(tick.reqs)
        if self._degrade_cfg is not None:
            self._observe_service(service)
        # Engine-clock completion: pipelined ticks finish no earlier than
        # the previous tick's completion (the serial device again).
        if self.pipeline_depth > 1:
            t_done = max(tick.t_dispatch, self._last_done) + service
        else:
            t_done = tick.t_dispatch + service
        self._last_done = t_done
        for req in tick.reqs:
            queue_s = max(0.0, tick.t_dispatch - req.t_submit)
            latency_s = queue_s + (t_done - tick.t_dispatch)
            slo_ok = self.slo_s is None or latency_s <= self.slo_s
            if not slo_ok:
                self.slo_violations += 1
            self.request_log.append(RequestTrace(
                rid=req.rid, t_submit=req.t_submit,
                t_dispatch=tick.t_dispatch, t_done=t_done,
                bucket=tick.bucket, queue_s=queue_s, service_s=service,
                latency_s=latency_s, slo_ok=slo_ok))
        self.last_tick = {"bucket": tick.bucket, "served": len(tick.reqs),
                          "wall_s": service, "now": tick.t_dispatch,
                          "per_chip_batch": tick.bucket // self.data_shards}

    def _observe_service(self, service: float) -> None:
        """Feed one completed tick's service time to the degrade
        controller's spike detector (robust z-score against the trailing
        history; only consecutive spikes count toward entry)."""
        cfg = self._degrade_cfg
        if len(self._svc_hist) >= 5:
            if robust_zscore(service, self._svc_hist) > cfg.straggler_k:
                self._spikes_total += 1
                self._spike_streak += 1
            else:
                self._spike_streak = 0
        self._svc_hist.append(service)

    def _fail_tick(self, tick: InflightTick) -> None:
        """Terminal failure of one tick after its retries: every request
        gets outcome ``failed``, the slot returns to the pool, and the
        service EMA and spike history are left untouched (a failed tick
        measured no service time)."""
        self.failed_ticks += 1
        wall = max(time.perf_counter() - tick.t_launch_pc, 1e-9)
        if tick.out is not None:
            # The device was occupied by the doomed attempts: later
            # ticks' service accounting must not start before now.
            self._last_ready_pc = max(self._last_ready_pc,
                                      time.perf_counter())
        t_done = tick.t_dispatch
        for req in tick.reqs:
            self._inflight_rids.discard(req.rid)
            self.failed[req.rid] = tick.tick_idx
            queue_s = max(0.0, tick.t_dispatch - req.t_submit)
            self.request_log.append(RequestTrace(
                rid=req.rid, t_submit=req.t_submit,
                t_dispatch=tick.t_dispatch, t_done=t_done,
                bucket=tick.bucket, queue_s=queue_s, service_s=0.0,
                latency_s=queue_s, slo_ok=False, outcome=OUTCOME_FAILED))
        self.failed_total += len(tick.reqs)
        self.last_tick = {"bucket": tick.bucket, "served": 0,
                          "wall_s": wall, "now": tick.t_dispatch,
                          "per_chip_batch": tick.bucket // self.data_shards,
                          "failed": True}

    def drain(self) -> Dict[int, np.ndarray]:
        """Retire every in-flight tick (blocking, in dispatch order) so
        ``done`` holds all dispatched results; never dispatches."""
        while self._inflight:
            self._complete(self._inflight.popleft())
        return self.done

    def poll(self, rid: int) -> Optional[np.ndarray]:
        """The result for ``rid``, retiring in-flight ticks (oldest first)
        until its tick retires. ``None`` — with no side effects — when
        ``rid`` is not in flight: never submitted, still queued, rejected,
        shed or failed."""
        if rid in self.done:
            return self.done[rid]
        while rid in self._inflight_rids and self._inflight:
            self._complete(self._inflight.popleft())
        return self.done.get(rid)

    def reset(self) -> None:
        """Drop queued and served request state and the accounting (trace
        replays reuse one warmed engine). In-flight ticks are retired
        first. Programs, buffers, the service estimates, the spike history
        and the plan's swap and rollback counts are kept; degrade mode
        stands down and the fault plan re-applies from dispatch index 0."""
        self.drain()
        self.queue.clear()
        self.done.clear()
        self.dispatches = {b: 0 for b in self.buckets}
        self.last_tick = None
        self.request_log.clear()
        self.submitted_total = 0
        self.served_total = 0
        self.slo_violations = 0
        self._last_done = float("-inf")
        self._overlap_s = 0.0
        self._device_busy_s = 0.0
        self._dispatched_ticks = 0
        self._completed_ticks = 0
        self.rejected_total = 0
        self.shed_total = 0
        self.failed_total = 0
        self.retries_total = 0
        self.failed_ticks = 0
        self.queue_high_water = 0
        self.failed.clear()
        self.shed_rids.clear()
        self._pending_rids.clear()
        self._inflight_rids.clear()
        self._degrade_active = False
        self._degrade_entries = 0
        self._degrade_exits = 0
        self._degrade_calm = 0
        self._spikes_total = 0
        self._spike_streak = 0
        self._tick_seq = 0

    def run_until_done(self, max_ticks: int = 1000) -> Dict[int, np.ndarray]:
        """Drain the queue, ignoring SLO waits (shutdown/offline replay),
        then retire every in-flight tick."""
        for _ in range(max_ticks):
            if self.step(flush=True) == 0:
                break
        return self.drain()

    # ------------------------------------------------------ observability
    def stats(self) -> Dict[str, object]:
        """Snapshot of the request accounting: totals, per-bucket dispatch
        counts and service EMAs, SLO violations, latency / queue-wait
        aggregates over the completed requests of the ``request_log``
        window, the pipeline's in-flight and overlap counters, the plan's
        swaps and rollbacks, its precision mix and the robustness ledger.
        Pure read (it never retires a tick)."""
        def _agg(vals: List[float]) -> Optional[Dict[str, float]]:
            if not vals:
                return None
            arr = np.asarray(vals)
            return {"mean_ms": float(arr.mean()) * 1e3,
                    "p50_ms": float(np.percentile(arr, 50)) * 1e3,
                    "p99_ms": float(np.percentile(arr, 99)) * 1e3,
                    "max_ms": float(arr.max()) * 1e3}

        window = [t for t in self.request_log
                  if t.outcome == OUTCOME_COMPLETED]
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
            "pipeline": {
                "depth": self.pipeline_depth,
                "inflight": len(self._inflight),
                "dispatched_ticks": self._dispatched_ticks,
                "completed_ticks": self._completed_ticks,
                "device_busy_s": self._device_busy_s,
                "overlap_s": self._overlap_s,
                # ~0 synchronous, → 1 when packing hides behind compute.
                "overlap_ratio": (self._overlap_s / self._device_busy_s
                                  if self._device_busy_s > 0 else 0.0),
            },
            # How each bucket splits across the mesh (None: a single-device
            # engine). The service EMAs above are wall times of the
            # sharded dispatch.
            "sharding": None if self.mesh is None else {
                "data_shards": self.data_shards,
                "mesh_devices": int(self.mesh.size),
                "per_chip_batch": {b: b // self.data_shards
                                   for b in self.buckets},
            },
            # Hot-swaps of the served plan and rollbacks to the previous
            # one, over the engine's lifetime.
            "plan": {
                "swaps": self.plan_swaps,
                "rollbacks": self.plan_rollbacks,
            },
            "precision": {
                "mix": {
                    "int8": sum(1 for p in self.precisions.values()
                                if p == "int8"),
                    "bf16": (sum(1 for p in self.precisions.values()
                                 if p != "int8")
                             + sum(1 for n in self.graph.conv_nodes()
                                   if n.id not in self.precisions)),
                },
                "int8_layers": sorted(
                    n for n, p in self.precisions.items() if p == "int8"),
                "calibrated": self.act_scales is not None,
            },
            # Outcomes sum + pending (queued + riding an in-flight tick)
            # == submitted, always.
            "robustness": {
                "max_queue": self.max_queue,
                "shed_deadline": self.shed_deadline,
                "outcomes": {
                    OUTCOME_COMPLETED: self.served_total,
                    OUTCOME_REJECTED: self.rejected_total,
                    OUTCOME_SHED: self.shed_total,
                    OUTCOME_FAILED: self.failed_total,
                },
                "pending": (len(self.queue)
                            + sum(len(t.reqs) for t in self._inflight)),
                "retries": self.retries_total,
                "failed_ticks": self.failed_ticks,
                "queue_high_water": self.queue_high_water,
                "degrade": {
                    "enabled": self._degrade_cfg is not None,
                    "active": self._degrade_active,
                    "entries": self._degrade_entries,
                    "exits": self._degrade_exits,
                    "straggler_spikes": self._spikes_total,
                },
            },
        }

    # ----------------------------------------------------- plan hot-swap
    def compile_ladder(self, plan: Optional[ExecutionPlan],
                       act_scales: Optional[Dict[int, float]] = None,
                       warm: bool = True) -> Dict[int, Callable]:
        """One compiled program per bucket for ``plan`` (and its int8
        layers' ``act_scales``) under this engine's options — the default
        algorithm, the tuning record's winners at that bucket's per-chip batch, the mesh,
        donation at depth >= 2, the shared ``cache`` and the fault hook
        when a plan is armed — the call the
        constructor makes, so a ladder compiled here and swapped in serves
        as a fresh engine on ``plan`` would.

        Pure with respect to engine state: it reads the engine's options
        and params and writes nothing of the engine's (not the queue, the
        in-flight ticks or the staging buffers), so it may run on a
        background thread while the serving thread ticks, and hand its
        ladder to ``swap_plan`` there. ``warm=True`` runs each program on
        an all-zeros batch of its own on the device, outside the fault
        hook (a warm call is no dispatch): on the card twice, the eager
        warm pass and the CUDA-graph capture under this engine's params,
        so a swapped-in ladder replays from its first served tick, whose
        wall time feeds the service estimates and a supervisor's
        probation; on the CPU once. Under a mesh every shard is warmed and
        captured on its own card, and every card is waited for."""
        programs = {
            bucket: compile_plan(self.graph, plan,
                                 default_algo=self.default_algo,
                                 use_pallas=self.use_pallas,
                                 epilogue=self.epilogue, tuning=self.tuning,
                                 tuning_batch=bucket // self.data_shards,
                                 mesh=self.mesh,
                                 donate=self.pipeline_depth > 1,
                                 cache=self.cache, act_scales=act_scales,
                                 device=self.device, dtype=self.dtype)
            for bucket in self.buckets
        }
        if warm:
            passes = 2 if self.device.type == "cuda" else 1
            for bucket, run in programs.items():
                x = torch.zeros((bucket,) + self._shape, dtype=self.dtype,
                                device=self.device)
                for _ in range(passes):
                    run(self.params, x)
            self._sync_devices()
        hook = self._fault_hook if self.fault_plan is not None else None
        return {bucket: _with_fault_hook(run, hook)
                for bucket, run in programs.items()}

    def swap_plan(self, plan: Optional[ExecutionPlan],
                  runs: Optional[Dict[int, Callable]] = None, *,
                  act_scales: Optional[Dict[int, float]] = None,
                  rollback: bool = False) -> tuple:
        """Deploy a new plan between ticks: the bucket ladder (``runs``,
        or ``compile_ladder(plan, act_scales)`` when None) and the
        plan-derived state (``plan``, ``precisions``, ``act_scales``) are
        replaced in one step on the serving thread, so every dispatch
        before this call ran on the old ladder and every one after runs on
        the new. A ladder missing a bucket raises ``ValueError``.

        Everything else is kept: the outcome ledger (a swap is no request
        outcome), queued requests, in-flight ticks (each holds the program
        it was dispatched on and retires on it, completion-fault replays
        included) and the per-bucket service estimates. Returns
        ``(old_plan, old_runs, old_act_scales)``, which re-arm the previous
        deployment; ``rollback=True`` books the swap as a rollback."""
        if runs is None:
            runs = self.compile_ladder(plan, act_scales=act_scales)
        missing = [b for b in self.buckets if b not in runs]
        if missing:
            raise ValueError(
                f"swap_plan ladder is missing buckets {missing} — a "
                "partial ladder would strand those buckets on the old "
                "plan; compile via compile_ladder(plan)")
        old = (self.plan, self._runs, self.act_scales)
        self.plan = plan
        self._runs = {b: runs[b] for b in self.buckets}
        self.act_scales = act_scales
        self.precisions = dict(getattr(plan, "precisions", None) or {}) \
            if plan is not None else {}
        if rollback:
            self.plan_rollbacks += 1
        else:
            self.plan_swaps += 1
        return old

    def _run_blocking(self, run: Callable, bucket: int) -> None:
        """Dispatch ``run`` on an all-zeros batch from the first slot's
        staging buffer, as a tick does, and wait for it. In-flight ticks
        retire first: one of them may still be reading that buffer."""
        self.drain()
        self._pack(0, [])
        run(self.params, self._stagings[0][:bucket])
        self._sync_devices()

    def _sync_devices(self) -> None:
        """Wait for the current stream of every card the engine's ticks
        run on (nothing on the CPU)."""
        for dev in self._devices:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    def _warmup(self) -> None:
        """Prime the service estimates: three all-zeros dispatches per
        bucket — the eager warm pass, the capture and a replay — and the
        last one's wall time, a replay's as every later tick runs, is the
        estimate (the injected device delay is left out)."""
        for bucket in self.buckets:
            for _ in range(3):
                t0 = time.perf_counter()
                self._run_blocking(self._runs[bucket], bucket)
                wall = time.perf_counter() - t0
            self._svc[bucket] = wall
