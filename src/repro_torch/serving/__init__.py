"""Serving: the bucketed SLO engine over compiled overlay programs,
pipelined and robust, with plan hot-swap; the multi-tenant engine; the
plan supervisor; and the Poisson trace replays that load them."""
from repro_torch.serving.multi_engine import MultiModelEngine
from repro_torch.serving.supervisor import (COMPILING, MONITOR, PROBATION,
                                            PlanSupervisor)
