"""Fault tolerance — the reference's ``distributed/fault.py`` whole: its
serving-path primitives

* ``DeviceFault`` / ``TickFault`` / ``FaultPlan`` — seeded,
  deterministic fault injection. ``CNNServingEngine(fault_plan=...)``
  consults the plan by global dispatch index: a planned fault fails a
  tick's first N attempts (surfacing either at dispatch or at completion,
  like a real asynchronous device fault) or delays its readiness (a
  straggling device). The engine wraps dispatch in a bounded
  retry-with-backoff loop; a tick that exhausts its retries fails its
  requests cleanly. A real CUDA error is sticky (the context is lost), so
  faults stay emulated on the host, as in the reference.
* ``robust_zscore`` — the median/MAD statistic the engine's degrade
  controller applies to tick service times to spot spikes.

and its multi-host control-plane logic, pure Python:

* ``StragglerMonitor`` — per-host step-time tracking over that
  statistic; persistent offenders are proposed for eviction.
* ``HealthTracker`` — heartbeat bookkeeping; hosts that miss
  ``max_missed`` beats are declared dead.
* ``ElasticPlanner`` — the largest valid (data, model) mesh the
  surviving hosts hold, the model (TP) axis kept whole.
* ``run_with_retries`` — the bounded-retry supervisor loop of the train
  driver (run a step; on failure restore from the last commit and
  replay). As in the reference it counts steps from 0 whatever step the
  restored state holds.

``FaultPlan.seeded`` draws from ``random.Random`` in the reference's
order, so one seed gives both packages the same schedule.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "DeviceFault", "TickFault", "FaultPlan", "robust_zscore",
    "StragglerMonitor", "HealthTracker", "HostState", "MeshPlan",
    "ElasticPlanner", "run_with_retries",
]


class DeviceFault(RuntimeError):
    """An injected (or emulated) device-side failure of one dispatch
    attempt. The serving engine's retry loop catches exactly this type —
    deterministic injection never masks real bugs, which still
    propagate."""


@dataclasses.dataclass(frozen=True)
class TickFault:
    """Fault schedule for ONE tick (one global dispatch index).

    ``failures`` consecutive attempts fail before the tick can succeed;
    whether each failure surfaces at *dispatch* (the launch call raises)
    or at *completion* (the asynchronous result turns out bad when waited
    on) is picked by ``at_dispatch``. ``delay_s`` postpones the tick's
    device readiness without failing it — a straggler, visible to the
    engine's service-time EMAs and its degrade controller's spike
    detector."""
    failures: int = 0
    delay_s: float = 0.0
    at_dispatch: bool = False


class FaultPlan:
    """Deterministic fault schedule keyed by global dispatch index.

    Build one explicitly (``FaultPlan({3: TickFault(failures=1)})``), or
    generate one reproducibly with ``FaultPlan.seeded``. The engine asks
    ``get(tick_index)`` once per dispatched tick; warm-up ticks never
    consume indices."""

    def __init__(self, faults: Mapping[int, TickFault]) -> None:
        self.faults: Dict[int, TickFault] = {
            int(k): v for k, v in faults.items()}

    def get(self, tick_index: Optional[int]) -> Optional[TickFault]:
        if tick_index is None:
            return None
        return self.faults.get(tick_index)

    def __len__(self) -> int:
        return len(self.faults)

    def offset(self, n: int) -> "FaultPlan":
        """A copy of this plan shifted ``n`` dispatch indices later
        (negative ``n`` shifts earlier; faults pushed below index 0
        drop)."""
        return FaultPlan({k + n: v for k, v in self.faults.items()
                          if k + n >= 0})

    @classmethod
    def seeded(cls, seed: int, n_ticks: int,
               fail_rate: float = 0.0, failures: int = 1,
               delay_rate: float = 0.0, delay_s: float = 0.0,
               at_dispatch: bool = False) -> "FaultPlan":
        """Reproducible random plan over the first ``n_ticks`` dispatch
        indices: each tick independently fails (``fail_rate``, with
        ``failures`` consecutive bad attempts) and/or straggles
        (``delay_rate`` × ``delay_s``). Same seed, same plan."""
        rng = random.Random(seed)
        faults: Dict[int, TickFault] = {}
        for t in range(n_ticks):
            fail = rng.random() < fail_rate
            lag = rng.random() < delay_rate
            if fail or lag:
                faults[t] = TickFault(failures=failures if fail else 0,
                                      delay_s=delay_s if lag else 0.0,
                                      at_dispatch=at_dispatch)
        return cls(faults)


def robust_zscore(value: float, samples: Sequence[float]) -> float:
    """Median/MAD z-score of ``value`` against ``samples``, in MAD units
    (no 1.4826 normal-consistency factor): a threshold ``k`` means
    exactly ``value > median + k * MAD``."""
    ts = sorted(samples)
    n = len(ts)
    if n == 0:
        return 0.0
    med = ts[n // 2]
    mad = sorted(abs(t - med) for t in ts)[n // 2] or 1e-9
    return (value - med) / mad


# ------------------------------------------------------------ health plane
@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float
    missed: int = 0
    alive: bool = True


class HealthTracker:
    def __init__(self, n_hosts: int, beat_interval_s: float = 10.0,
                 max_missed: int = 3) -> None:
        now = 0.0
        self.hosts = {i: HostState(i, now) for i in range(n_hosts)}
        self.interval = beat_interval_s
        self.max_missed = max_missed

    def beat(self, host_id: int, t: float) -> None:
        h = self.hosts[host_id]
        h.last_beat = t
        h.missed = 0

    def sweep(self, t: float) -> List[int]:
        """Advance the failure detector; returns newly-dead host ids."""
        newly_dead = []
        for h in self.hosts.values():
            if not h.alive:
                continue
            h.missed = int((t - h.last_beat) // self.interval)
            if h.missed >= self.max_missed:
                h.alive = False
                newly_dead.append(h.host_id)
        return newly_dead

    def alive_hosts(self) -> List[int]:
        return [h.host_id for h in self.hosts.values() if h.alive]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    pods: int = 1

    @property
    def devices(self) -> int:
        return self.data * self.model * self.pods


class ElasticPlanner:
    """Re-mesh policy: model (TP) axis is load-bearing — weights are
    sharded across it — so it is preserved; the data axis shrinks to the
    largest power-of-two supported by surviving hosts. Batch is kept by
    raising per-device microbatches (noted in the plan)."""

    def __init__(self, devices_per_host: int, model_axis: int) -> None:
        self.devices_per_host = devices_per_host
        self.model_axis = model_axis

    def plan(self, n_alive_hosts: int, global_batch: int
             ) -> Tuple[MeshPlan, Dict[str, int]]:
        total = n_alive_hosts * self.devices_per_host
        if total < self.model_axis:
            raise RuntimeError(
                f"{total} devices cannot host model axis {self.model_axis}")
        data = total // self.model_axis
        # largest power of two ≤ data (keeps collectives ring-friendly)
        data = 2 ** int(math.log2(data)) if data else 1
        plan = MeshPlan(data=data, model=self.model_axis)
        micro_scale = max(1, global_batch // max(plan.data, 1))
        return plan, {"microbatch_per_device": micro_scale,
                      "dropped_devices": total - plan.devices}


class StragglerMonitor:
    """Robust per-host step-time tracking over ``robust_zscore``: a host
    is an offender when its step time's z-score against the cohort
    exceeds ``k`` for ``patience`` consecutive steps."""

    def __init__(self, n_hosts: int, k: float = 4.0, patience: int = 3):
        self.k = k
        self.patience = patience
        self.offense: Dict[int, int] = {i: 0 for i in range(n_hosts)}

    def observe(self, step_times: Dict[int, float]) -> List[int]:
        ts = list(step_times.values())
        evict = []
        for host, t in step_times.items():
            if robust_zscore(t, ts) > self.k:
                self.offense[host] = self.offense.get(host, 0) + 1
                if self.offense[host] >= self.patience:
                    evict.append(host)
            else:
                self.offense[host] = 0
        return evict


def run_with_retries(step_fn: Callable[[int], None],
                     save_fn: Callable[[int], None],
                     restore_fn: Callable[[], int],
                     n_steps: int,
                     checkpoint_every: int = 50,
                     max_restarts: int = 3,
                     failure_injector: Optional[Callable[[int], None]] = None
                     ) -> Dict[str, int]:
    """Bounded-retry supervisor: run ``n_steps``; on exception restore +
    replay from the last commit; give up past ``max_restarts``.

    ``restore_fn`` returns the step to resume from (last committed + 1).
    ``failure_injector(step)`` may raise to simulate node loss (tests).
    Steps count from 0 on every call, as the reference's do: a driver that
    resumed from a checkpoint replays data steps 0, 1, ... while the
    learning-rate schedule goes on from the restored optimizer step.
    """
    restarts = 0
    step = 0
    while step < n_steps:
        try:
            if failure_injector is not None:
                failure_injector(step)
            step_fn(step)
            if (step + 1) % checkpoint_every == 0:
                save_fn(step + 1)
            step += 1
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            step = restore_fn()
    return {"completed": step, "restarts": restarts}
