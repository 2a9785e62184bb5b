"""Poisson arrival traces and the replay disciplines that push them
through ``CNNServingEngine`` — the reference's serving-bench trace
machinery (``benchmarks/_trace.py``), with the same API:

* ``poisson_trace`` — deterministic Poisson arrivals and images per seed.
* ``replay_robust`` — virtual-clock discrete events for
  robustness-armed engines at depth 1: arrivals carry synthetic
  timestamps, every tick runs the real program and its measured wall
  time advances the clock; every request is tracked to its terminal
  outcome, and the loop ends on outcome conservation.
* ``replay_wallclock`` — real-clock events: arrivals are released as
  real time passes and the engine runs free, so a pipelined engine's
  host packing and device compute overlap. The only replay that can
  observe ``pipeline_depth`` > 1.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.cnn_engine import (OUTCOME_COMPLETED,
                                            OUTCOME_FAILED,
                                            OUTCOME_REJECTED, OUTCOME_SHED,
                                            CNNRequest, CNNServingEngine)

Trace = List[Tuple[float, np.ndarray]]


def poisson_trace(rate_rps: float, n: int, shape: Tuple[int, ...],
                  seed: int) -> Trace:
    """``n`` arrivals at ``rate_rps`` (exponential gaps, the first at
    t=0) with standard-normal images of ``shape``, all from ``seed``."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    times = np.cumsum(gaps) - gaps[0]  # first arrival at t=0
    imgs = rng.standard_normal((n,) + shape).astype(np.float32)
    return [(float(times[i]), imgs[i]) for i in range(n)]


def replay_robust(
    eng: CNNServingEngine, trace: Trace,
    on_tick: Optional[Callable[[float], None]] = None,
) -> Tuple[Dict[int, str], Dict[int, float], float]:
    """Shed-aware virtual-clock replay for robustness-armed engines at
    ``pipeline_depth == 1``: arrivals are submitted at their trace
    timestamps, the engine's scheduler decides dispatches, and each
    tick's measured wall time advances the clock. Every rid is tracked
    to its terminal outcome (submit verdicts catch
    ``rejected_full``; the engine's ``shed_rids``, ``failed`` and
    ``done`` the rest; a failed tick still advances the clock by its
    measured wall time). Returns ``(outcomes, done_at, makespan)``.
    ``on_tick(now)``, if given, fires after every ``eng.step``."""
    n = len(trace)
    outcomes: Dict[int, str] = {}
    done_at: Dict[int, float] = {}
    i, now = 0, 0.0
    while True:
        while i < n and trace[i][0] <= now + 1e-12:
            verdict = eng.submit(
                CNNRequest(rid=i, image=trace[i][1], t_submit=trace[i][0]))
            if verdict == OUTCOME_REJECTED:
                outcomes[i] = OUTCOME_REJECTED
            i += 1
        served = eng.step(now=now)
        if on_tick is not None:
            on_tick(now)
        for rid in eng.shed_rids:
            outcomes.setdefault(rid, OUTCOME_SHED)
        for rid in eng.failed:
            outcomes.setdefault(rid, OUTCOME_FAILED)
        if served:
            wall = float(eng.last_tick["wall_s"])
            for rid in eng.done:
                if rid not in outcomes:
                    outcomes[rid] = OUTCOME_COMPLETED
                    done_at[rid] = now + wall
            now += wall  # the engine is busy while a tick runs
            continue
        if i >= n and not eng.queue:
            break
        nxt = []
        if i < n:
            nxt.append(trace[i][0])
        at = eng.next_dispatch_at()
        if at is not None:
            nxt.append(at)
        assert nxt, "robust replay stalled with requests outstanding"
        now = max(now, min(nxt))
    assert len(outcomes) == n, \
        f"replay lost requests: {n - len(outcomes)} unaccounted"
    makespan = (max(done_at.values()) - trace[0][0]) if done_at else 0.0
    return outcomes, done_at, makespan


def replay_wallclock(eng: CNNServingEngine,
                     trace: Trace) -> Tuple[np.ndarray, float]:
    """Real-clock replay: arrivals are released as wall time passes and
    the engine ticks continuously, so a pipelined engine's dispatch of
    tick N+1 overlaps tick N's device compute. Each request is stamped
    with its trace arrival time (seconds from the replay's start, the
    clock ``step`` is given), so its latency runs from arrival, not from
    when the host loop noticed it. Returns (the latencies of
    the last ``n`` records of the engine's ``RequestTrace`` log — every
    outcome's, so a caller that sheds or rejects filters the log itself
    — and the real makespan). The engine should be
    warmed, and is ``reset()``-safe to reuse across calls."""
    n = len(trace)
    t0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter() - t0
        while i < n and trace[i][0] <= now:
            eng.submit(CNNRequest(rid=i, image=trace[i][1],
                                  t_submit=trace[i][0]))
            i += 1
        # Once every arrival is in, flush: the remaining ticks drain
        # back to back rather than wait on SLO budgets.
        dispatched = eng.step(now=now, flush=i >= n)
        if i >= n and not eng.queue:
            break
        if not dispatched and i < n:
            time.sleep(min(1e-3, max(0.0, trace[i][0] - now)))
    eng.drain()
    makespan = time.perf_counter() - t0
    lat = np.array([t.latency_s for t in eng.request_log][-n:])
    return lat, makespan
