"""Fault injection for the serving tick loop — the reference's
``distributed/fault.py`` serving-path primitives:

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

``FaultPlan.seeded`` draws from ``random.Random`` in the reference's
order, so one seed gives both packages the same schedule.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, Mapping, Optional, Sequence

__all__ = ["DeviceFault", "TickFault", "FaultPlan", "robust_zscore"]


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
