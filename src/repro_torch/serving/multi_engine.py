"""Multi-tenant CNN serving: one engine process, many registered models
— the reference's multi-model engine, over the port's engine.

``CNNServingEngine`` assumes one graph per process; serving a fleet that
way means one process per model, each with its own compile cache and its
own greedy tick loop — no coordination over the shared device, and every
tenant recompiles executables an identical architecture next door already
built. f-CNNx (arXiv 1805.10174) makes the FPGA version of this argument:
co-scheduled CNNs need a *joint* resource mapping, not per-model greedy
scheduling. This module is that layer on top of ``CNNServingEngine``:

* ``register_model(name, graph, params, plan, slo_s=...)`` builds one
  ``CNNServingEngine`` per tenant, all sharing this engine's clock and
  one ``ExecutableCache`` — tenants whose graphs hash equal (same
  architecture, any params) share every ``(graph, plan, bucket, mesh)``
  bucket program instead of recompiling, because compiled programs take
  params as call arguments and close over nothing model-specific. On the
  card each tenant's params get a CUDA-graph capture of their own in the
  shared program (a capture binds its params' pointers), on every shard
  of a mesh.
* ``submit(model, req)`` routes to the tenant's own bounded admission
  (its ``max_queue``), after a *global* queue cap across all tenants —
  a globally rejected request still lands in the tenant's own outcome
  ledger (``CNNServingEngine.reject``), so per-tenant conservation
  (``completed + rejected_full + shed_deadline + failed + pending ==
  submitted``) holds with or without the global cap.
* ``step(now)`` is the joint tick scheduler: tenants are ranked by the
  deadline of their oldest queued request (``oldest_deadline``) and
  stepped in that order; each tenant's own wait policy
  (``dispatch_due``) and housekeeping (reap / shed / degrade) run
  unchanged, and successive ticks within one joint step see a clock
  advanced by the measured wall time of the ticks before them — the
  serial-device accounting virtual-clock replays rely on. An optional
  ``global_budget_s`` caps the wall time one joint step may spend:
  once the budget would be exceeded, remaining due tenants are skipped
  until the next step (their housekeeping waits with them — the cost
  of not dispatching is also not paying the bookkeeping).

Per-tenant SLOs, outcome ledgers, robustness knobs (``max_queue``,
``shed_deadline``, ``fault_plan``, ``degrade``) and ``stats()`` all keep
their single-model semantics — the joint layer only decides *which*
tenant ticks next, never how a tenant ticks.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.cnn.executor import ExecutableCache
from repro_torch.serving.cnn_engine import CNNRequest, CNNServingEngine


class MultiModelEngine:
    """Joint deadline-ordered tick scheduler over per-model engines.

    ``cache`` defaults to a fresh ``ExecutableCache`` shared by every
    registered tenant (pass one in to share across MultiModelEngine
    instances too). ``global_max_queue`` bounds the *sum* of tenant
    queues — submissions past it are rejected into the owning tenant's
    ledger. ``global_budget_s`` caps the measured wall time one
    ``step()`` may spend dispatching across tenants (the first due
    tick always runs: a budget smaller than any single tick must not
    starve the engine). ``clock`` is shared by all tenants so joint
    deadline ordering compares like timestamps.
    """

    def __init__(self,
                 clock: Callable[[], float] = time.monotonic,
                 global_budget_s: Optional[float] = None,
                 global_max_queue: Optional[int] = None,
                 cache: Optional[ExecutableCache] = None) -> None:
        if global_max_queue is not None and global_max_queue < 1:
            raise ValueError(
                f"global_max_queue must be >= 1, got {global_max_queue}")
        if global_budget_s is not None and global_budget_s <= 0:
            raise ValueError(
                f"global_budget_s must be > 0, got {global_budget_s}")
        self._clock = clock
        self.global_budget_s = global_budget_s
        self.global_max_queue = global_max_queue
        self.cache = cache if cache is not None else ExecutableCache()
        self.engines: Dict[str, CNNServingEngine] = {}
        self._order: List[str] = []        # registration order (tiebreak)
        self.last_step: Optional[Dict[str, object]] = None

    # ---------------------------------------------------------- tenants
    def register_model(self, name: str, graph, params, plan,
                       slo_s: Optional[float] = None,
                       **engine_kwargs) -> CNNServingEngine:
        """Build and register one tenant engine. The engine shares this
        multi-engine's clock and executable cache; every other
        ``CNNServingEngine`` knob passes through ``engine_kwargs``
        (``buckets``, ``max_queue``, ``fault_plan``, ``warmup``,
        ``device`` — the card unless the caller asks for the CPU, ...).
        ``pipeline_depth`` must stay 1: the joint scheduler charges each
        tick's measured wall time to the shared virtual clock, which an
        asynchronously retiring tick would misreport."""
        if name in self.engines:
            raise ValueError(f"model {name!r} already registered")
        for k in ("clock", "cache"):
            if k in engine_kwargs:
                raise ValueError(
                    f"{k!r} is owned by MultiModelEngine — every tenant "
                    "shares the joint clock and executable cache")
        if int(engine_kwargs.get("pipeline_depth", 1)) != 1:
            raise ValueError(
                "multi-model tenants must use pipeline_depth=1: joint "
                "virtual-time accounting assumes synchronous ticks")
        eng = CNNServingEngine(graph, params, plan, slo_s=slo_s,
                               clock=self._clock, cache=self.cache,
                               **engine_kwargs)
        self.engines[name] = eng
        self._order.append(name)
        return eng

    def model_names(self) -> List[str]:
        return list(self._order)

    def swap_plan(self, model: str, plan, runs=None, *,
                  act_scales=None, rollback: bool = False) -> tuple:
        """Hot-swap one tenant's deployed plan
        (``CNNServingEngine.swap_plan`` on that tenant, between joint
        ticks). Tenant isolation holds by construction: the shared
        ``ExecutableCache`` never evicts, so compiling the new ladder can
        only *add* entries (other tenants' executables stay resident),
        and every other tenant's ladder, ledger, queue, and EMAs are
        untouched (``tests/test_torch_multi_model.py`` pins this)."""
        return self._engine(model).swap_plan(
            plan, runs, act_scales=act_scales, rollback=rollback)

    def _engine(self, model: str) -> CNNServingEngine:
        try:
            return self.engines[model]
        except KeyError:
            raise KeyError(
                f"unknown model {model!r}; registered: {self._order}"
            ) from None

    # ------------------------------------------------------------ intake
    def submit(self, model: str, req: CNNRequest) -> str:
        """Route one request to its tenant. The global queue cap is
        checked first; past it the request is rejected *into the
        tenant's ledger* so per-tenant conservation survives the global
        policy. Otherwise the tenant's own admission (its ``max_queue``)
        decides. Returns the admission verdict."""
        eng = self._engine(model)
        if (self.global_max_queue is not None
                and self.queued_total() >= self.global_max_queue):
            return eng.reject(req)
        return eng.submit(req)

    def queued_total(self) -> int:
        """Requests currently queued across all tenants (the quantity
        the global cap bounds; in-flight and done are not queued)."""
        return sum(len(eng.queue) for eng in self.engines.values())

    # ------------------------------------------------------------- serve
    def next_dispatch_at(self) -> Optional[float]:
        """Earliest engine-clock time any tenant would dispatch without
        new arrivals — None when every queue is empty. Trace replays use
        this as the joint wake-up."""
        times = [eng.next_dispatch_at() for eng in self.engines.values()]
        times = [t for t in times if t is not None]
        return min(times) if times else None

    def _deadline_rank(self, now: float):
        """Tenant names ranked for this joint step: earliest oldest-
        request deadline first, empty queues last, registration order
        breaking ties."""
        def key(item):
            idx, name = item
            d = self.engines[name].oldest_deadline()
            return (d is None, d if d is not None else 0.0, idx)
        return [name for _, name in
                sorted(enumerate(self._order), key=lambda it: key(it))]

    def step(self, now: Optional[float] = None, flush: bool = False) -> int:
        """One joint tick round: step tenants in deadline order, each
        seeing the shared clock advanced by the measured wall time of
        the ticks dispatched before it this round (the device is serial
        — tenant B's tick cannot start until tenant A's finished). Each
        tenant's own ``step`` applies its wait policy and housekeeping
        unchanged, so a not-yet-due tenant contributes 0 and loses
        nothing. Under ``global_budget_s``, once at least one tick ran,
        a due tenant whose estimated next tick would blow the budget is
        skipped until the next round (``flush=True`` ignores the
        budget: drains must terminate). Returns total requests
        dispatched; details land in ``last_step``."""
        if now is None:
            now = self._clock()
        served, ticks, spent = 0, 0, 0.0
        skipped: List[str] = []
        for name in self._deadline_rank(now):
            eng = self.engines[name]
            if (not flush and self.global_budget_s is not None
                    and ticks > 0 and eng.queue
                    and eng.dispatch_due(now + spent)):
                est = eng.service_estimate(
                    eng.covering_bucket(len(eng.queue)))
                if spent + est > self.global_budget_s:
                    skipped.append(name)
                    continue
            n = eng.step(now=now + spent, flush=flush)
            if n:
                served += n
                ticks += 1
                if eng.last_tick is not None:
                    spent += float(eng.last_tick["wall_s"])
        self.last_step = {"served": served, "ticks": ticks,
                          "wall_s": spent, "skipped": tuple(skipped)}
        return served

    # ----------------------------------------------------------- results
    def poll(self, model: str, rid: int) -> Optional[np.ndarray]:
        return self._engine(model).poll(rid)

    def drain(self) -> Dict[str, Dict[int, np.ndarray]]:
        """Retire everything in flight, per tenant. Queued requests are
        NOT dispatched — ``run_until_done`` is the drain-the-world
        loop."""
        return {name: self.engines[name].drain() for name in self._order}

    def run_until_done(self, max_ticks: int = 1000
                       ) -> Dict[str, Dict[int, np.ndarray]]:
        """Flush joint rounds until every tenant queue is empty, then
        drain. Returns each tenant's ``done`` map."""
        for _ in range(max_ticks):
            if not any(eng.queue for eng in self.engines.values()):
                break
            self.step(flush=True)
        else:
            raise RuntimeError(f"queues not drained in {max_ticks} rounds")
        self.drain()
        return {name: dict(self.engines[name].done)
                for name in self._order}

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, object]:
        """Joint view: per-model ``CNNServingEngine.stats()`` under
        ``"models"`` (unchanged schema), shared-cache counters under
        ``"cache"``, and the joint scheduler's knobs/aggregates under
        ``"global"``."""
        models = {name: self.engines[name].stats() for name in self._order}
        return {
            "models": models,
            "cache": self.cache.stats(),
            "global": {
                "models": len(self._order),
                "submitted": sum(e.submitted_total
                                 for e in self.engines.values()),
                "queued": self.queued_total(),
                "global_max_queue": self.global_max_queue,
                "global_budget_s": self.global_budget_s,
                "last_step": self.last_step,
            },
        }
