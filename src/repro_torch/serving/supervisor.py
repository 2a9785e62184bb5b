"""Closed-loop plan supervision: measure → calibrate → re-solve → hot-swap
— the reference's supervisor, over the port's engine and planner.

DYNAMAP's DSE is a one-shot offline step; this module turns it into a
control loop. A ``PlanSupervisor`` rides shotgun on a
``CNNServingEngine``: it watches the engine's per-bucket service EMAs and
tick wall times, distills them (plus any directly-observed transition
measurements) into a ``TransitionCalibration``, periodically re-solves the
PBQP with calibrated edge prices (``core.mapper.replan``), compiles the
winning plan's bucket ladder — optionally on a background thread, through
the engine's shared ``ExecutableCache`` — and swaps it in atomically
between ticks (``CNNServingEngine.swap_plan``). A probation window after
every swap re-arms the previous ladder if the new plan's first N measured
ticks regress.

State machine::

    MONITOR --(calibrated re-solve adopts a cheaper plan)--> COMPILING
    COMPILING --(ladder ready, next tick boundary)--> PROBATION (swap)
    PROBATION --(first N ticks healthy)--> MONITOR (new baseline)
    PROBATION --(median tick regression > rollback_factor)--> MONITOR
               (old ladder re-armed, cooldown before the next attempt)

Every decision input is injectable — the engine clock, the calibration
(``observe_calibration`` / ``calibration_source``), the fault plan — so
the whole loop is deterministic under test: an injected service-time
shift provably flips the deployed plan
(``tests/test_torch_plan_hotswap.py``).

On the card a compiled ladder is warmed by ``compile_ladder``: each bucket
program's eager pass and its CUDA-graph capture under the engine's params
run where the ladder is compiled — on the compile thread under
``background=True``, its captures thread-local
(``executor.capture_forward``) so the serving thread keeps replaying,
querying its events and allocating meanwhile — and no served tick pays
a capture. A compile that fails on that thread raises on the serving
thread at its next ``tick()``.

Calibration attribution: live tick-time inflation (current EMA vs. the
EMA snapshot latched at deployment) is attributed to layout transitions as
a single multiplicative knob — the paper's DDR-contention regime, where
memory-system pressure hits the store/load legs first. That single-knob
inference is deliberately conservative; feeding measured per-layout-pair
ratios via ``observe_calibration`` (e.g. distilled from
``transition_report`` vs. realized wall clock) overrides it with real
per-pair scales, and both compose multiplicatively.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from repro_torch.core.autotune import refresh_from_service
from repro_torch.core.cost_model import TransitionCalibration
from repro_torch.core.graph import Graph
from repro_torch.core.mapper import ReplanResult, replan
from repro_torch.serving.cnn_engine import CNNServingEngine

# Supervisor states (stats()["state"]).
MONITOR = "monitor"
COMPILING = "compiling"
PROBATION = "probation"


class PlanSupervisor:
    """Drives the closed re-mapping loop for one serving engine.

    Call ``tick()`` once after every ``engine.step()`` from the serving
    loop (the replay helpers' ``on_tick`` hook does exactly this). All
    supervisor work happens on the serving thread except ladder
    compilation, which runs on a daemon thread when ``background=True``
    — the swap itself always lands between ticks on the serving thread,
    so no tick ever observes a half-deployed ladder.

    ``map_kwargs`` must repeat the kwargs the engine's deployed plan was
    mapped with (``hw=``, ``use_on_chip=``, ...): ``replan`` prices the
    deployed assignment on the re-built cost graph, which must be
    congruent. Serving-tier re-solves typically want
    ``use_on_chip=False``: bucketed ticks multiply every activation by
    the batch size, so the single-image on-chip-residency assumption that
    zeroes edge costs offline does not hold under traffic.

    ``check_every`` counts *completed* ticks between re-solve checks;
    ``hysteresis`` gates both inflation detection and plan adoption (the
    autotuner's 5% default); ``rollback_ticks``/``rollback_factor``
    define probation: after a swap, the median of the first N measured
    tick services (per bucket, vs. the freshest pre-swap walls of the
    same buckets) above the factor re-arms the old ladder. ``refresh_tuning`` also live-refreshes
    the engine's tuning record from the same EMAs
    (``core.autotune.refresh_from_service``) at every check."""

    def __init__(self, engine: CNNServingEngine, graph: Graph, *,
                 map_kwargs: Optional[Dict[str, object]] = None,
                 check_every: int = 8,
                 hysteresis: float = 0.05,
                 rollback_ticks: int = 6,
                 rollback_factor: float = 1.5,
                 cooldown_checks: int = 4,
                 settle_checks: int = 1,
                 background: bool = False,
                 calibration_source: Optional[
                     Callable[[], Optional[TransitionCalibration]]] = None,
                 refresh_tuning: bool = True,
                 on_swap: Optional[Callable[[ReplanResult], None]] = None
                 ) -> None:
        if engine.plan is None:
            raise ValueError(
                "PlanSupervisor needs an engine serving a solved "
                "ExecutionPlan — a default-lowered (plan=None) engine has "
                "no deployed assignment to re-price")
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        if rollback_ticks < 1:
            raise ValueError(
                f"rollback_ticks must be >= 1, got {rollback_ticks}")
        self.engine = engine
        self.graph = graph
        self.map_kwargs = dict(map_kwargs or {})
        self.check_every = int(check_every)
        self.hysteresis = float(hysteresis)
        self.rollback_ticks = int(rollback_ticks)
        self.rollback_factor = float(rollback_factor)
        self.cooldown_checks = int(cooldown_checks)
        self.settle_checks = int(settle_checks)
        self.background = bool(background)
        self.calibration_source = calibration_source
        self.refresh_tuning = bool(refresh_tuning)
        self.on_swap = on_swap

        self.state = MONITOR
        self.checks = 0
        self.swaps = 0
        self.rollbacks = 0
        self.last_replan: Optional[ReplanResult] = None
        self.refresh_scales: Dict[int, float] = {}
        # Pre-shift EMA baseline: latched lazily per bucket as EMAs first
        # appear, re-latched after every accepted deployment — inflation
        # is always measured against the currently-deployed plan's own
        # steady state.
        self._baseline_svc: Dict[int, float] = {}
        self._baseline_disp: Dict[int, int] = {}
        # Sticky environment scale: each check folds the fresh
        # EMA-vs-baseline ratio in multiplicatively and re-latches, so the
        # stepwise ratios telescope to the cumulative shift since launch —
        # the inference survives swaps (the environment didn't change back
        # just because the plan did) and decays the same way when the
        # machine recovers.
        self._inferred_scale = 1.0
        # Settle windows: for the first ``settle_checks`` checks after
        # startup and after every deployment change, EMA movement is
        # attributable to the engine itself (JIT convergence, the new
        # plan's different steady state) rather than the environment —
        # those checks only re-latch baselines instead of folding the
        # ratio into the sticky scale or re-solving.
        self._settle = self.settle_checks
        self._observed: Optional[TransitionCalibration] = None
        self._ticks_since_check = 0
        self._seen_completed = engine._completed_ticks
        self._cooldown = 0
        # COMPILING handoff: the (replan result, compiled ladder) pair the
        # next tick() installs; under background compile the thread fills
        # it and the serving thread polls.
        self._pending_result: Optional[ReplanResult] = None
        self._pending_runs: Optional[Dict[int, Callable]] = None
        self._compile_thread: Optional[threading.Thread] = None
        self._compile_error: Optional[BaseException] = None
        # PROBATION bookkeeping: previous deployment for rollback plus the
        # post-swap tick samples measured so far.
        self._prev_deploy: Optional[tuple] = None
        self._probation_samples: list = []
        self._swap_snapshot: Dict[int, float] = {}
        # Last measured wall per bucket under the *deployed* plan, tagged
        # with its completed-tick index. The swap snapshot is built from
        # these (freshness-gated), not from the EMAs: after an environment
        # shift the EMA still carries pre-shift history, and comparing
        # post-swap ticks against that stale mixture reads a genuinely
        # better plan as a regression (false rollback). The last walls of
        # the final check window are exactly the old plan measured in the
        # current environment — the honest comparator.
        self._recent_wall: Dict[int, tuple] = {}

    # ------------------------------------------------------- calibration
    def observe_calibration(self,
                            cal: Optional[TransitionCalibration]) -> None:
        """Feed directly-measured transition scales (e.g. distilled from
        ``transition_report`` predictions vs. realized layout-bench wall
        clock). Replaces the previous observation; composes
        multiplicatively with the live-inflation inference."""
        self._observed = cal

    def _latch_baselines(self) -> None:
        for b, ema in self.engine._svc.items():
            if ema is not None and b not in self._baseline_svc:
                self._baseline_svc[b] = ema
                self._baseline_disp[b] = self.engine.dispatches.get(b, 0)

    def _inflation(self) -> float:
        """Median live-EMA / baseline-EMA ratio over *trafficked* buckets
        (those with dispatches since their baseline latched — a bucket no
        tick has exercised carries a frozen EMA whose ratio of exactly 1.0
        would otherwise drown the signal from the buckets actually
        serving). 1.0 when nothing is measurable yet."""
        ratios = sorted(
            self.engine._svc[b] / base
            for b, base in self._baseline_svc.items()
            if self.engine._svc.get(b) is not None and base > 0.0
            and self.engine.dispatches.get(b, 0)
            != self._baseline_disp.get(b, 0))
        if not ratios:
            return 1.0
        return ratios[len(ratios) // 2]

    def _update_inferred(self) -> None:
        """Fold the fresh inflation reading into the sticky scale and
        re-latch baselines — only when it moved beyond hysteresis in
        either direction, so sub-hysteresis noise neither churns the
        calibration nor accumulates through repeated re-latching."""
        med = self._inflation()
        if abs(med - 1.0) > self.hysteresis:
            self._inferred_scale = max(self._inferred_scale * med, 1e-3)
            self._baseline_svc = {}
            self._baseline_disp = {}
            self._latch_baselines()

    def current_calibration(self) -> Optional[TransitionCalibration]:
        """The calibration the next re-solve will price edges with:
        directly-observed per-pair scales (if any) times the sticky
        single-knob environment scale. None = nothing measured yet — the
        analytical model stands."""
        if self.calibration_source is not None:
            return self.calibration_source()
        r = self._inferred_scale
        base = self._observed
        if base is None:
            return None if r == 1.0 else TransitionCalibration(default=r)
        if r == 1.0:
            return base
        return TransitionCalibration(
            scales={k: v * r for k, v in base.scales.items()},
            default=base.default * r)

    # -------------------------------------------------------------- loop
    def tick(self, now: Optional[float] = None) -> None:
        """One supervision step; call after every ``engine.step()``.
        Cheap when idle: until ``check_every`` new ticks completed, this
        only samples counters."""
        self._latch_baselines()
        delta = self.engine._completed_ticks - self._seen_completed
        self._seen_completed = self.engine._completed_ticks
        last = self.engine.last_tick
        if delta > 0 and self.state != PROBATION \
                and last and not last.get("failed"):
            self._recent_wall[last["bucket"]] = (
                float(last["wall_s"]), self.engine._completed_ticks)

        if self.state == COMPILING:
            self._poll_compile()
            return
        if self.state == PROBATION:
            if delta > 0:
                self._observe_probation()
            return

        if delta <= 0:
            return
        self._ticks_since_check += delta
        if self._ticks_since_check < self.check_every:
            return
        self._ticks_since_check = 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        self._check()

    def _check(self) -> None:
        """One MONITOR-state decision: live-refresh the tuning record,
        re-solve under the current calibration, and start compiling when
        the candidate clears the hysteresis gate."""
        self.checks += 1
        eng = self.engine
        if self._settle > 0:
            self._settle -= 1
            self._baseline_svc = {}
            self._baseline_disp = {}
            self._latch_baselines()
            return
        self._update_inferred()
        emas = {b: s for b, s in eng._svc.items() if s is not None}
        if self.refresh_tuning and eng.tuning is not None and emas:
            applied = refresh_from_service(
                eng.tuning, self.graph, emas,
                precisions=eng.precisions,
                min_improvement=self.hysteresis)
            for b, r in applied.items():
                self.refresh_scales[b] = \
                    round(self.refresh_scales.get(b, 1.0) * r, 6)
        result = replan(self.graph, eng.plan,
                        calibration=self.current_calibration(),
                        hysteresis=self.hysteresis, **self.map_kwargs)
        self.last_replan = result
        if not result.adopted:
            return
        self.state = COMPILING
        if self.background:
            self._compile_thread = threading.Thread(
                target=self._compile_target, args=(result,), daemon=True)
            self._compile_thread.start()
        else:
            self._pending_runs = eng.compile_ladder(result.plan,
                                                    act_scales=None)
            self._pending_result = result
            self._poll_compile()

    def _compile_target(self, result: ReplanResult) -> None:
        """Background-thread body: compile the candidate ladder through
        the shared cache, then hand it to the serving thread. Only the
        publication order matters — runs before result — because
        ``_poll_compile`` keys readiness off ``_pending_result``. A failure
        is handed over the same way, and re-raised there."""
        try:
            runs = self.engine.compile_ladder(result.plan, act_scales=None)
        except BaseException as err:
            self._compile_error = err
            return
        self._pending_runs = runs
        self._pending_result = result

    def _poll_compile(self) -> None:
        """Install a finished ladder at the next tick boundary (the caller
        is between ticks by construction)."""
        if self._compile_error is not None:
            err, self._compile_error = self._compile_error, None
            self._compile_thread = None
            self.state = MONITOR
            raise RuntimeError("compiling the re-solved plan's ladder "
                               "failed on the compile thread") from err
        if self._pending_result is None:
            return
        result, runs = self._pending_result, self._pending_runs
        self._pending_result = self._pending_runs = None
        self._compile_thread = None
        eng = self.engine
        # Freshness gate: only buckets measured within the last check
        # window — the evidence that triggered this adoption — qualify as
        # probation comparators (see _recent_wall above).
        fresh_after = eng._completed_ticks - self.check_every
        self._swap_snapshot = {b: w for b, (w, at)
                               in self._recent_wall.items()
                               if at >= fresh_after}
        self._prev_deploy = eng.swap_plan(result.plan, runs)
        self.swaps += 1
        self._probation_samples = []
        self.state = PROBATION
        if self.on_swap is not None:
            self.on_swap(result)

    def _observe_probation(self) -> None:
        """Sample the newest completed tick against the freshest pre-swap
        wall of its bucket; after ``rollback_ticks`` samples, a median
        regression beyond ``rollback_factor`` re-arms the previous
        ladder. Failed ticks contribute no sample (a fault is not a plan
        regression — the fault injector must not trip rollbacks), and
        neither do ticks whose bucket has no fresh pre-swap comparator
        (a stale wall from before the environment shifted would read a
        better plan as a regression)."""
        last = self.engine.last_tick
        if not last or last.get("failed"):
            return
        base = self._swap_snapshot.get(last["bucket"])
        if base is not None and base > 0.0:
            self._probation_samples.append(float(last["wall_s"]) / base)
        if len(self._probation_samples) < self.rollback_ticks:
            return
        samples = sorted(self._probation_samples)
        med = samples[len(samples) // 2]
        if med > self.rollback_factor:
            old_plan, old_runs, old_scales = self._prev_deploy
            self.engine.swap_plan(old_plan, old_runs,
                                  act_scales=old_scales, rollback=True)
            self.rollbacks += 1
            self._cooldown = self.cooldown_checks
        else:
            # Healthy deployment: the new plan's steady state becomes the
            # inflation baseline (re-latched lazily from fresh EMAs).
            self._baseline_svc = {}
            self._baseline_disp = {}
        self._prev_deploy = None
        self._probation_samples = []
        self._ticks_since_check = 0
        self._settle = self.settle_checks
        self.state = MONITOR

    # ------------------------------------------------------ observability
    def stats(self) -> Dict[str, object]:
        cal = self.current_calibration()
        last = self.last_replan
        return {
            "state": self.state,
            "checks": self.checks,
            "swaps": self.swaps,
            "rollbacks": self.rollbacks,
            "cooldown": self._cooldown,
            "settle": self._settle,
            "inflation": self._inflation(),
            "inferred_scale": self._inferred_scale,
            "calibration_default": None if cal is None else cal.default,
            "tuning_refresh_scales": dict(self.refresh_scales),
            "last_replan": None if last is None else {
                "changed": last.changed,
                "adopted": last.adopted,
                "deployed_cost_s": last.deployed_cost_s,
                "candidate_cost_s": last.candidate_cost_s,
            },
        }
