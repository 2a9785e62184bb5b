"""The port's plan hot-swap and plan supervisor, on the CPU, against the
reference's.

Twins of the reference's ``tests/test_plan_hotswap.py`` on the port, at
its size (``vgg16(res=8, scale=0.05)``, params from the reference's
``init_params`` through ``params_from_jax``, plans A and B as its
``plans`` fixture builds them): calibrated re-pricing (``replan``), the
single calibration channel, ``CNNServingEngine.swap_plan`` bit for bit
across the swap boundary (in-flight ticks and completion-fault replays on
the ladder they were dispatched on, the ledger under swap x faults,
partial ladders rejected) and ``serving.supervisor.PlanSupervisor``:
a shift that flips the plan exactly once, probation rollback under fault
injection, and the background compile.

Parity: every planner decision is held to the reference's (fingerprints
and modeled costs equal), and the swap and supervisor scenarios run on
both packages through one ``FakeClock`` script on the same numpy images,
with both engines' ``time`` module replaced by ``FakeTime`` — its
``perf_counter`` moves only when an engine sleeps out its injected
device delay, so every measured service time, and with it every decision
the supervisor makes, is exactly the same on both sides. Swaps,
rollbacks, supervisor states and ``stats()``, plan fingerprints and
per-rid outcomes must be equal; outputs within rtol 2e-2 / atol 2e-3.
The background compile is waited for by joining the compile thread,
never by a tick budget.

Port-only: ``compile_ladder(warm=True)`` leaves the engine's queue,
in-flight ticks and staging buffers as they were, ``swap_plan`` without
a ladder keeps in-flight ticks in flight, and the supervisor runs through
``serving/replay.py::replay_robust(on_tick=sup.tick)``.
"""
import types

import jax
import numpy as np
import pytest
import torch

from benchmarks._trace import replay_robust as jax_replay_robust
from repro.cnn.executor import ExecutableCache as JaxCache
from repro.cnn.executor import init_params as jax_init_params
from repro.cnn.models import vgg16 as jax_vgg16
from repro.core.cost_model import TransitionCalibration as JaxCalibration
from repro.core.dse import identify_parameters as jax_identify
from repro.core.mapper import map_network as jax_map_network
from repro.core.mapper import plan_fingerprint as jax_fingerprint
from repro.core.mapper import replan as jax_replan
from repro.distributed.fault import FaultPlan as JaxFaultPlan
from repro.distributed.fault import TickFault as JaxTickFault
from repro.serving import cnn_engine as jax_engine_mod
from repro.serving.supervisor import PlanSupervisor as JaxSupervisor
from repro_torch.bridge import params_from_jax
from repro_torch.cnn.executor import ExecutableCache
from repro_torch.cnn.models import vgg16
from repro_torch.core.cost_model import TransitionCalibration
from repro_torch.core.dse import identify_parameters
from repro_torch.core.mapper import (lower_plan, map_network,
                                     plan_fingerprint, replan,
                                     transition_report)
from repro_torch.distributed.fault import FaultPlan, TickFault
from repro_torch.serving import cnn_engine as engine_mod
from repro_torch.serving.cnn_engine import (OUTCOME_FAILED, CNNRequest,
                                            CNNServingEngine)
from repro_torch.serving.replay import poisson_trace, replay_robust
from repro_torch.serving.supervisor import (COMPILING, MONITOR, PROBATION,
                                            PlanSupervisor)

RNG = np.random.default_rng(21)
N_IMAGES = 64
IMAGES = [np.asarray(RNG.standard_normal((8, 8, 3)), np.float32)
          for _ in range(N_IMAGES)]
PLAN_TOL = dict(rtol=2e-2, atol=2e-3)


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


class FakeTime:
    """Stands in for an engine module's ``time``: ``perf_counter`` moves
    only by what the engine sleeps, so a tick's measured service time is
    exactly its injected device delay."""

    def __init__(self) -> None:
        self.t = 0.0

    def perf_counter(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += max(float(s), 0.0)

    monotonic = perf_counter


@pytest.fixture
def fake_time(monkeypatch):
    """Both engines on a ``FakeTime`` of their own."""
    monkeypatch.setattr(engine_mod, "time", FakeTime())
    monkeypatch.setattr(jax_engine_mod, "time", FakeTime())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread keeps a tiny forward at its ~1.5 ms when the
    suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    g = vgg16(res=8, scale=0.05)
    jg = jax_vgg16(res=8, scale=0.05)
    np_params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jg, jax.random.PRNGKey(0)))
    return g, identify_parameters(g), params_from_jax(np_params, "cpu"), \
        jg, jax_identify(jg), np_params


@pytest.fixture(scope="module")
def plans(tiny):
    """Plan A: the uncalibrated PBQP winner. Plan B: the winner when every
    transition is measured 6x more expensive than modeled — a genuinely
    different assignment. The reference's plans, beside them, must
    fingerprint equal."""
    g, hw, _, jg, jhw, _ = tiny
    pa = map_network(g, hw=hw, use_on_chip=False)
    pb = map_network(g, hw=hw, use_on_chip=False,
                     calibration=TransitionCalibration(default=6.0))
    assert plan_fingerprint(pa) != plan_fingerprint(pb)
    ja = jax_map_network(jg, hw=jhw, use_on_chip=False)
    jb = jax_map_network(jg, hw=jhw, use_on_chip=False,
                         calibration=JaxCalibration(default=6.0))
    assert plan_fingerprint(pa) == jax_fingerprint(ja)
    assert plan_fingerprint(pb) == jax_fingerprint(jb)
    return pa, pb, ja, jb


@pytest.fixture(scope="module")
def cache():
    return ExecutableCache()


@pytest.fixture(scope="module")
def sides(tiny, plans):
    """Everything a scenario needs, per package: its graph, hw, params,
    plans A and B, shared cache, classes and fingerprint."""
    g, hw, params, jg, jhw, np_params = tiny
    pa, pb, ja, jb = plans
    port = types.SimpleNamespace(
        graph=g, hw=hw, params=params, plan_a=pa, plan_b=pb,
        cache=ExecutableCache(), engine=CNNServingEngine, request=CNNRequest,
        supervisor=PlanSupervisor, cal=TransitionCalibration,
        fault_plan=FaultPlan, tick_fault=TickFault,
        fingerprint=plan_fingerprint, replay=replay_robust,
        kw=dict(device="cpu"))
    ref = types.SimpleNamespace(
        graph=jg, hw=jhw, params=np_params, plan_a=ja, plan_b=jb,
        cache=JaxCache(), engine=jax_engine_mod.CNNServingEngine,
        request=jax_engine_mod.CNNRequest, supervisor=JaxSupervisor,
        cal=JaxCalibration, fault_plan=JaxFaultPlan, tick_fault=JaxTickFault,
        fingerprint=jax_fingerprint, replay=jax_replay_robust, kw={})
    return port, ref


def conserved(eng) -> bool:
    rb = eng.stats()["robustness"]
    return (sum(rb["outcomes"].values()) + rb["pending"]
            == eng.submitted_total)


def submit_batch(eng, clock, start_rid, n=4, request=CNNRequest):
    """Submit n requests with fresh rids; images cycle through the fixed
    pool, so any two engines fed the same rid range see the same bits."""
    for i in range(n):
        rid = start_rid + i
        eng.submit(request(rid=rid, image=IMAGES[rid % N_IMAGES],
                           t_submit=clock.t))
    return start_rid + n


def port_engine(tiny, plan, cache, clock, **kw):
    g, _, params = tiny[:3]
    return CNNServingEngine(g, params, plan, batch_size=4, clock=clock,
                            cache=cache, device="cpu", **kw)


def reference_outputs(tiny, plan, cache, n, **engine_kwargs):
    """Serve IMAGES[:n] to completion on a single fixed plan."""
    clock = FakeClock()
    eng = port_engine(tiny, plan, cache, clock, **engine_kwargs)
    rid = 0
    while rid < n:
        rid = submit_batch(eng, clock, rid)
        eng.step(flush=True)
        clock.t += 1.0
    eng.run_until_done()
    assert set(eng.done) == set(range(n))
    return dict(eng.done)


def outcomes(eng):
    """Per rid: bucket, dispatch time, service time and outcome."""
    return {t.rid: (t.bucket, t.t_dispatch, t.service_s, t.outcome)
            for t in eng.request_log}


def assert_outputs_agree(ours, ref):
    assert sorted(ours.done) == sorted(ref.done)
    for rid in ours.done:
        np.testing.assert_allclose(ours.done[rid], np.asarray(ref.done[rid]),
                                   **PLAN_TOL)


# ---------------------------------------------------------------------------
# Calibrated re-pricing (replan) semantics, against the reference planner.
# ---------------------------------------------------------------------------

def _same_result(ours, ref):
    assert (ours.changed, ours.adopted) == (ref.changed, ref.adopted)
    assert plan_fingerprint(ours.plan) == jax_fingerprint(ref.plan)
    assert ours.deployed_cost_s == ref.deployed_cost_s
    assert ours.candidate_cost_s == ref.candidate_cost_s


class TestCalibratedReplan:
    def test_uncalibrated_replan_is_a_fixed_point(self, tiny, plans):
        g, hw, _, jg, jhw, _ = tiny
        pa, _, ja, _ = plans
        r = replan(g, pa, calibration=None, hw=hw, use_on_chip=False)
        assert not r.changed and not r.adopted
        assert plan_fingerprint(r.plan) == plan_fingerprint(pa)
        assert r.candidate_cost_s == pytest.approx(r.deployed_cost_s)
        _same_result(r, jax_replan(jg, ja, calibration=None, hw=jhw,
                                   use_on_chip=False))

    def test_measured_shift_flips_and_clears_hysteresis(self, tiny, plans):
        g, hw, _, jg, jhw, _ = tiny
        pa, pb, ja, _ = plans
        r = replan(g, pa, calibration=TransitionCalibration(default=6.0),
                   hw=hw, use_on_chip=False)
        assert r.changed and r.adopted
        assert plan_fingerprint(r.plan) == plan_fingerprint(pb)
        assert r.candidate_cost_s < r.deployed_cost_s * 0.95
        _same_result(r, jax_replan(
            jg, ja, calibration=JaxCalibration(default=6.0), hw=jhw,
            use_on_chip=False))

    def test_reverting_inside_hysteresis_is_held(self, tiny, plans):
        """After recovery plan A prices cheaper than deployed B, but by
        less than the 5% gate, so B is held."""
        g, hw, _, jg, jhw, _ = tiny
        _, pb, _, jb = plans
        r = replan(g, pb, calibration=None, hw=hw, use_on_chip=False)
        assert r.changed and not r.adopted
        margin = 1.0 - r.candidate_cost_s / r.deployed_cost_s
        assert 0.0 < margin < 0.05
        _same_result(r, jax_replan(jg, jb, calibration=None, hw=jhw,
                                   use_on_chip=False))

    def test_resolve_is_deterministic(self, tiny):
        g, hw, _, jg, jhw, _ = tiny
        cal = TransitionCalibration(default=3.7)
        fps = {plan_fingerprint(map_network(g, hw=hw, use_on_chip=False,
                                            calibration=cal))
               for _ in range(3)}
        assert len(fps) == 1
        assert fps == {jax_fingerprint(jax_map_network(
            jg, hw=jhw, use_on_chip=False,
            calibration=JaxCalibration(default=3.7)))}

    def test_sub_hysteresis_perturbation_never_churns(self, tiny):
        """Per-pair scale noise within 1±2% — under half the 5% gate —
        never triggers adoption, on either package."""
        from repro.core.algorithms import Layout as JaxLayout
        from repro_torch.core.algorithms import Layout
        g, hw, _, jg, jhw, _ = tiny
        deployed = map_network(g, hw=hw, use_on_chip=False,
                               calibration=TransitionCalibration(default=2.0))
        jdeployed = jax_map_network(jg, hw=jhw, use_on_chip=False,
                                    calibration=JaxCalibration(default=2.0))
        rng = np.random.default_rng(99)
        pairs = [(a, b) for a in Layout for b in Layout]
        for _ in range(20):
            noise = {p: 2.0 * (1.0 + rng.uniform(-0.02, 0.02))
                     for p in pairs}
            r = replan(g, deployed, calibration=TransitionCalibration(
                scales=noise, default=2.0), hw=hw, use_on_chip=False)
            assert not r.adopted
            jnoise = {(JaxLayout(a.value), JaxLayout(b.value)): s
                      for (a, b), s in noise.items()}
            _same_result(r, jax_replan(
                jg, jdeployed, calibration=JaxCalibration(
                    scales=jnoise, default=2.0), hw=jhw, use_on_chip=False))


class TestCalibrationSingleChannel:
    """One ``calibration=`` kwarg through ``map_network``/``lower_plan``;
    the old ``transition_report`` side-channel is deprecated but prices
    identically."""

    def test_lowered_program_carries_calibration(self, tiny, plans):
        g = tiny[0]
        pa = plans[0]
        cal = TransitionCalibration(default=3.0)
        low = lower_plan(g, pa, calibration=cal)
        assert low.calibration is cal
        assert lower_plan(g, pa).calibration is None

    def test_both_routes_price_identically(self, tiny, plans):
        g = tiny[0]
        pa = plans[0]
        cal = TransitionCalibration(default=3.0)
        rep_new = transition_report(g, lower_plan(g, pa, calibration=cal))
        with pytest.warns(DeprecationWarning, match="deprecated"):
            rep_old = transition_report(g, lower_plan(g, pa),
                                        calibration=cal)
        assert rep_new["predicted_roundtrip_s"] == \
            rep_old["predicted_roundtrip_s"]
        assert rep_new["predicted_elided_s"] == rep_old["predicted_elided_s"]
        assert [e["saving_s"] for e in rep_new["edges"]] == \
            [e["saving_s"] for e in rep_old["edges"]]
        rep_uncal = transition_report(g, lower_plan(g, pa))
        assert rep_uncal["predicted_roundtrip_s"] != \
            rep_new["predicted_roundtrip_s"]

    def test_explicit_kwarg_wins_over_carried(self, tiny, plans):
        g = tiny[0]
        pa = plans[0]
        low = lower_plan(g, pa,
                         calibration=TransitionCalibration(default=3.0))
        with pytest.warns(DeprecationWarning):
            rep = transition_report(
                g, low, calibration=TransitionCalibration(default=1.0))
        rep_uncal = transition_report(g, lower_plan(g, pa))
        assert rep["predicted_roundtrip_s"] == \
            rep_uncal["predicted_roundtrip_s"]


# ---------------------------------------------------------------------------
# Atomic hot-swap: bitwise equivalence across the boundary.
# ---------------------------------------------------------------------------

def swap_script(side, n_before=3, n_after=3, depth=1, faults=None,
                max_retries=2):
    """Serve ``n_before`` ticks of four requests on plan A, swap to plan B
    between ticks, serve ``n_after`` more and finish; returns the
    engine."""
    clock = FakeClock()
    kw = dict(side.kw)
    if faults is not None:
        kw.update(fault_plan=faults, max_retries=max_retries,
                  retry_backoff_s=0.0)
    eng = side.engine(side.graph, side.params, side.plan_a, batch_size=4,
                      clock=clock, cache=side.cache, pipeline_depth=depth,
                      **kw)
    rid = 0
    for _ in range(n_before):
        rid = submit_batch(eng, clock, rid, request=side.request)
        eng.step(flush=True)
        clock.t += 1.0
    eng.swap_plan(side.plan_b)
    for _ in range(n_after):
        rid = submit_batch(eng, clock, rid, request=side.request)
        eng.step(flush=True)
        clock.t += 1.0
    eng.run_until_done()
    return eng


class TestSwapBitwise:
    def test_outputs_bitwise_across_swap_boundary(self, tiny, plans, cache,
                                                  sides, fake_time):
        pa, pb = plans[:2]
        ref_a = reference_outputs(tiny, pa, cache, 24)
        ref_b = reference_outputs(tiny, pb, cache, 24)
        assert any(not np.array_equal(ref_a[r], ref_b[r])
                   for r in range(24))
        eng = swap_script(sides[0])
        for r in range(12):
            assert np.array_equal(eng.done[r], ref_a[r])
        for r in range(12, 24):
            assert np.array_equal(eng.done[r], ref_b[r])
        assert conserved(eng)
        assert eng.stats()["plan"] == {"swaps": 1, "rollbacks": 0}
        ref = swap_script(sides[1])
        assert outcomes(eng) == outcomes(ref)
        assert eng.stats()["plan"] == ref.stats()["plan"]
        assert_outputs_agree(eng, ref)

    def test_inflight_ticks_retire_on_old_ladder(self, tiny, plans, cache):
        """pipeline_depth=2: a tick dispatched before the swap but retired
        after it gives plan-A bits — its program was pinned at dispatch."""
        pa, pb = plans[:2]
        ref_a = reference_outputs(tiny, pa, cache, 16)
        ref_b = reference_outputs(tiny, pb, cache, 16)
        clock = FakeClock()
        eng = port_engine(tiny, pa, cache, clock, pipeline_depth=2)
        rid = submit_batch(eng, clock, 0, n=8)
        eng.step(flush=True)
        eng.step(flush=True)
        assert eng.stats()["pipeline"]["inflight"] >= 1
        assert eng._inflight_rids
        eng.swap_plan(pb)
        rid = submit_batch(eng, clock, rid, n=8)
        eng.step(flush=True)
        eng.step(flush=True)
        eng.run_until_done()
        for r in range(8):
            assert np.array_equal(eng.done[r], ref_a[r])
        for r in range(8, 16):
            assert np.array_equal(eng.done[r], ref_b[r])
        assert conserved(eng)

    def test_completion_fault_replays_on_pinned_executable(
            self, tiny, plans, cache, sides, fake_time):
        """A completion-surfaced fault on an in-flight tick replays on the
        tick's pinned (old-ladder) program even when the swap landed
        between dispatch and replay."""
        pa, pb = plans[:2]
        ref_a = reference_outputs(tiny, pa, cache, 8)
        clock = FakeClock()
        eng = port_engine(tiny, pa, cache, clock, pipeline_depth=2,
                          max_retries=2, retry_backoff_s=0.0,
                          fault_plan=FaultPlan({1: TickFault(failures=1)}))
        submit_batch(eng, clock, 0, n=8)
        eng.step(flush=True)
        eng.step(flush=True)
        eng.swap_plan(pb)
        eng.run_until_done()
        assert eng.retries_total >= 1
        for r in range(8):
            assert np.array_equal(eng.done[r], ref_a[r])
        assert conserved(eng)

    def test_ledger_conserved_under_swap_x_faults(self, sides, fake_time):
        """``FaultPlan.offset`` pins "the first post-swap tick fails hard"
        to dispatch index 2; the ledger stays conserved through the swap
        and the terminal failure, as on the reference."""
        results = []
        for side in sides:
            faults = side.fault_plan({0: side.tick_fault(failures=5)})
            eng = swap_script(side, n_before=2, n_after=2,
                              faults=faults.offset(2), max_retries=1)
            rb = eng.stats()["robustness"]
            assert rb["outcomes"][OUTCOME_FAILED] == 4
            assert set(range(8, 12)).isdisjoint(eng.done)
            assert set(eng.done) == set(range(8)) | set(range(12, 16))
            assert conserved(eng)
            results.append(eng)
        ours, ref = results
        assert outcomes(ours) == outcomes(ref)
        assert ours.stats()["robustness"] == ref.stats()["robustness"]
        assert_outputs_agree(ours, ref)

    def test_fault_plan_offset_semantics(self):
        f = TickFault(failures=1)
        p = FaultPlan({0: f, 3: f})
        assert set(p.offset(2).faults) == {2, 5}
        assert set(p.offset(-1).faults) == {2}
        assert p.offset(0).faults == p.faults
        assert p.offset(2).faults[2] is f
        jf = JaxTickFault(failures=1)
        jp = JaxFaultPlan({0: jf, 3: jf})
        for k in (2, -1, 0):
            assert set(p.offset(k).faults) == set(jp.offset(k).faults)

    def test_swap_rejects_partial_ladder_and_counts(self, tiny, plans,
                                                    cache):
        pa, pb = plans[:2]
        eng = port_engine(tiny, pa, cache, FakeClock())
        runs = eng.compile_ladder(pb, warm=False)
        some_bucket = next(iter(runs))
        partial = {b: r for b, r in runs.items() if b != some_bucket}
        with pytest.raises(ValueError, match="missing buckets"):
            eng.swap_plan(pb, partial)
        old_plan, old_runs, old_scales = eng.swap_plan(pb, runs)
        assert plan_fingerprint(old_plan) == plan_fingerprint(pa)
        eng.swap_plan(old_plan, old_runs, act_scales=old_scales,
                      rollback=True)
        assert eng.stats()["plan"] == {"swaps": 1, "rollbacks": 1}
        eng.reset()
        assert eng.stats()["plan"] == {"swaps": 1, "rollbacks": 1}


# ---------------------------------------------------------------------------
# Port-only: a pure compile_ladder, and a swap that compiles in flight.
# ---------------------------------------------------------------------------

def _engine_state(eng):
    """What ``compile_ladder`` must leave as it was."""
    return dict(
        inflight=[(t.tick_idx, t.buf_index, t.bucket, [r.rid for r in t.reqs])
                  for t in eng._inflight],
        inflight_rids=set(eng._inflight_rids),
        queue=[r.rid for r in eng.queue], done=set(eng.done),
        stagings=[s.clone() for s in eng._stagings],
        filled=list(eng._filled), cursor=eng._buf_cursor,
        svc=dict(eng._svc), dispatches=dict(eng.dispatches),
        completed=eng._completed_ticks, runs=dict(eng._runs),
        plan=plan_fingerprint(eng.plan), swaps=eng.stats()["plan"])


def _assert_same_state(before, after):
    stagings = (before.pop("stagings"), after.pop("stagings"))
    assert before == after
    assert all(torch.equal(a, b) for a, b in zip(*stagings))


def _pipelined_with_ticks_in_flight(tiny, pa, cache):
    """A depth-2 engine on FakeTime with two ticks in flight (their
    device delay has not passed) and four requests queued."""
    clock = FakeClock()
    eng = port_engine(tiny, pa, cache, clock, pipeline_depth=2,
                      device_delay_s=1.0)
    submit_batch(eng, clock, 0, n=8)
    eng.step(flush=True)
    eng.step(flush=True)
    submit_batch(eng, clock, 8, n=4)
    assert len(eng._inflight) == 2 and len(eng.queue) == 4
    return eng


def test_compile_ladder_is_pure(tiny, plans, cache, fake_time):
    """``compile_ladder(warm=True)`` — what the supervisor's compile
    thread runs while the serving thread ticks — touches no engine state:
    the in-flight ticks stay in flight, and the queue, the staging
    buffers, the estimates and the ladder stay as they were. Its programs
    serve plan B."""
    pa, pb = plans[:2]
    eng = _pipelined_with_ticks_in_flight(tiny, pa, cache)
    before = _engine_state(eng)
    runs = eng.compile_ladder(pb, warm=True)
    _assert_same_state(before, _engine_state(eng))
    assert sorted(runs) == eng.buckets
    assert all(run is not eng._runs[b] for b, run in runs.items())
    ref_b = reference_outputs(tiny, pb, cache, 4)
    got = runs[4](tiny[2], np.stack(IMAGES[:4])).numpy()
    assert all(np.array_equal(got[r], ref_b[r]) for r in range(4))
    eng.run_until_done()
    ref_a = reference_outputs(tiny, pa, cache, 12)
    assert all(np.array_equal(eng.done[r], ref_a[r]) for r in range(12))


def test_swap_plan_without_a_ladder_keeps_ticks_in_flight(tiny, plans,
                                                          cache, fake_time):
    """``swap_plan(plan)`` compiles its ladder itself; the ticks in flight
    at the swap stay in flight across it, retire on plan A, and the queued
    requests dispatched after it are served on plan B."""
    pa, pb = plans[:2]
    eng = _pipelined_with_ticks_in_flight(tiny, pa, cache)
    before = _engine_state(eng)
    eng.swap_plan(pb)
    after = _engine_state(eng)
    for key in ("inflight", "inflight_rids", "queue", "done", "filled",
                "cursor", "svc", "dispatches", "completed"):
        assert before[key] == after[key], key
    assert all(torch.equal(a, b) for a, b in zip(before["stagings"],
                                                 after["stagings"]))
    assert after["plan"] == plan_fingerprint(pb)
    assert after["swaps"] == {"swaps": 1, "rollbacks": 0}
    eng.run_until_done()
    ref_a = reference_outputs(tiny, pa, cache, 12)
    ref_b = reference_outputs(tiny, pb, cache, 12)
    assert all(np.array_equal(eng.done[r], ref_a[r]) for r in range(8))
    assert all(np.array_equal(eng.done[r], ref_b[r]) for r in range(8, 12))
    assert conserved(eng)


# ---------------------------------------------------------------------------
# The supervisor loop, end to end, on both packages.
# ---------------------------------------------------------------------------

def supervised(side, **sup_kw):
    """A warmed plan-A engine on a FakeClock (4 ms injected device delay)
    under a ``PlanSupervisor``; returns (engine, supervisor, clock)."""
    clock = FakeClock()
    engine_kw = sup_kw.pop("engine_kw", {})
    eng = side.engine(side.graph, side.params, side.plan_a, batch_size=4,
                      clock=clock, cache=side.cache, warmup=True,
                      **engine_kw, **side.kw)
    eng.device_delay_s = 0.004
    sup = side.supervisor(eng, side.graph,
                          map_kwargs=dict(hw=side.hw, use_on_chip=False),
                          **sup_kw)
    return eng, sup, clock


def drive(side, eng, sup, clock, rid, n_ticks, trail):
    """``n_ticks`` ticks of four requests, ``sup.tick()`` after each;
    appends (state, swaps, rollbacks, plan fingerprint) per tick."""
    for _ in range(n_ticks):
        rid = submit_batch(eng, clock, rid, request=side.request)
        eng.step(flush=True)
        sup.tick()
        clock.t += 1.0
        trail.append((sup.state, sup.swaps, sup.rollbacks,
                      side.fingerprint(eng.plan)))
    return rid


def assert_same_run(ours, ref):
    """The port's (engine, supervisor, trail) against the reference's."""
    (eng, sup, trail), (reng, rsup, rtrail) = ours, ref
    assert trail == rtrail
    assert sup.stats() == rsup.stats()
    assert eng.stats()["plan"] == reng.stats()["plan"]
    assert eng.stats()["robustness"] == reng.stats()["robustness"]
    assert outcomes(eng) == outcomes(reng)
    assert_outputs_agree(eng, reng)


class TestSupervisorLoop:
    def test_requires_solved_plan(self, tiny):
        g, _, params = tiny[:3]
        eng = CNNServingEngine(g, params, None, batch_size=4,
                               clock=FakeClock(), device="cpu")
        with pytest.raises(ValueError, match="no deployed assignment"):
            PlanSupervisor(eng, g)

    def test_shift_flips_plan_deterministically(self, sides, fake_time):
        """Injected service shift → inferred calibration → adopted re-solve
        → compile → one swap → healthy probation; after recovery the
        sticky scale telescopes back to ~1 and the new plan is held inside
        hysteresis — the same trajectory, tick by tick, as the
        reference's."""
        runs = []
        for side in sides:
            swapped = []
            eng, sup, clock = supervised(side, check_every=4,
                                         rollback_ticks=3,
                                         on_swap=swapped.append)
            fp_a = side.fingerprint(side.plan_a)
            trail = []
            rid = drive(side, eng, sup, clock, 0, 8, trail)
            assert sup.swaps == 0 and sup.state == MONITOR
            eng.device_delay_s = 0.024                  # 6x service shift
            rid = drive(side, eng, sup, clock, rid, 24, trail)
            assert sup.swaps == 1 and sup.rollbacks == 0
            assert sup.state == MONITOR                 # probation passed
            assert side.fingerprint(eng.plan) != fp_a
            assert 3.0 < sup._inferred_scale < 10.0
            assert len(swapped) == 1 and swapped[0].adopted
            flipped = side.fingerprint(eng.plan)
            assert flipped == side.fingerprint(side.plan_b)
            eng.device_delay_s = 0.004                  # recovery
            drive(side, eng, sup, clock, rid, 28, trail)
            assert sup.swaps == 1 and sup.rollbacks == 0
            assert 0.5 < sup._inferred_scale < 1.5
            assert side.fingerprint(eng.plan) == flipped
            assert sup.last_replan is not None and \
                not sup.last_replan.adopted
            assert conserved(eng)
            assert eng.stats()["plan"] == {"swaps": 1, "rollbacks": 0}
            assert sup.stats()["state"] == MONITOR and \
                sup.stats()["swaps"] == 1
            runs.append((eng, sup, trail))
        assert PROBATION in {s for s, *_ in runs[0][2]}
        assert_same_run(*runs)

    def test_probation_rollback_under_fault_injection(self, sides,
                                                      fake_time):
        """A swap whose new ladder regresses is rolled back after N
        measured ticks, and the faulted first post-swap tick contributes
        no probation sample."""
        runs = []
        for side in sides:
            box = {}

            def regress(_result, box=box):
                box["eng"].device_delay_s = 0.2     # the new plan is slow
            eng, sup, clock = supervised(
                side, check_every=3, rollback_ticks=3, rollback_factor=5.0,
                cooldown_checks=2,
                calibration_source=lambda side=side: side.cal(default=6.0),
                on_swap=regress,
                engine_kw=dict(max_retries=0, fault_plan=side.fault_plan(
                    {6: side.tick_fault(failures=5)})))
            box["eng"] = eng
            trail, rid = [], 0
            for _ in range(40):
                rid = drive(side, eng, sup, clock, rid, 1, trail)
                if sup.rollbacks:
                    break
            assert sup.swaps == 1 and sup.rollbacks == 1
            assert side.fingerprint(eng.plan) == \
                side.fingerprint(side.plan_a)
            assert eng.stats()["plan"] == {"swaps": 1, "rollbacks": 1}
            assert sup.state == MONITOR
            assert sup._cooldown == 2
            assert eng.failed_total == 4
            assert conserved(eng)
            runs.append((eng, sup, trail))
        assert_same_run(*runs)

    def test_background_compile_swaps_at_tick_boundary(self, sides,
                                                       fake_time):
        """background=True: the ladder compiles on a daemon thread while
        serving continues; the test joins that thread (no tick budget),
        and the swap lands at the next tick boundary on the serving
        thread, as on the reference."""
        runs = []
        for side in sides:
            eng, sup, clock = supervised(
                side, check_every=2, rollback_ticks=2, settle_checks=0,
                background=True,
                calibration_source=lambda side=side: side.cal(default=6.0))
            trail, rid = [], 0
            rid = drive(side, eng, sup, clock, rid, 2, trail)
            assert sup.state == COMPILING and sup.swaps == 0
            sup._compile_thread.join()
            rid = drive(side, eng, sup, clock, rid, 1, trail)
            assert sup.state == PROBATION and sup.swaps == 1
            assert sup._compile_thread is None
            drive(side, eng, sup, clock, rid, 2, trail)
            assert sup.state == MONITOR and sup.swaps == 1
            assert side.fingerprint(eng.plan) == \
                side.fingerprint(side.plan_b)
            assert conserved(eng)
            runs.append((eng, sup, trail))
        assert_same_run(*runs)


def test_background_compile_failure_raises_on_the_serving_thread(
        tiny, plans, fake_time, monkeypatch):
    """A ladder that fails to compile on the compile thread (on the card:
    a failed capture) is no silent stall in COMPILING: the serving
    thread's next ``tick()`` raises it, and nothing is swapped."""
    eng, sup, clock = supervised(
        types.SimpleNamespace(engine=CNNServingEngine, graph=tiny[0],
                              params=tiny[2], plan_a=plans[0],
                              cache=ExecutableCache(), hw=tiny[1],
                              supervisor=PlanSupervisor,
                              kw=dict(device="cpu")),
        check_every=2, settle_checks=0, background=True,
        calibration_source=lambda: TransitionCalibration(default=6.0))

    def broken(*args, **kwargs):
        raise RuntimeError("capture failed")
    monkeypatch.setattr(eng, "compile_ladder", broken)
    rid = 0
    for _ in range(2):
        rid = submit_batch(eng, clock, rid)
        eng.step(flush=True)
        sup.tick()
    assert sup.state == COMPILING
    sup._compile_thread.join()
    with pytest.raises(RuntimeError, match="compile thread") as info:
        sup.tick()
    assert "capture failed" in str(info.value.__cause__)
    assert sup.state == MONITOR and sup.swaps == 0
    assert eng.stats()["plan"] == {"swaps": 0, "rollbacks": 0}


def test_supervisor_through_replay_robust(sides, fake_time):
    """The supervisor rides ``replay_robust(on_tick=sup.tick)``: on a
    Poisson trace the re-solve adopts plan B and swaps once, every request
    completes, and outcomes, completion times and makespan equal the
    reference's replay of the same trace."""
    trace = poisson_trace(400.0, 40, (8, 8, 3), seed=5)
    runs = []
    for side in sides:
        eng, sup, _ = supervised(
            side, check_every=3, rollback_ticks=2, settle_checks=0,
            calibration_source=lambda side=side: side.cal(default=6.0))
        got = side.replay(eng, trace, on_tick=sup.tick)
        out, done_at, _ = got
        assert sorted(out) == list(range(40))
        assert set(out.values()) == {"completed"}
        assert sup.swaps == 1 and sup.rollbacks == 0
        assert side.fingerprint(eng.plan) == side.fingerprint(side.plan_b)
        assert sup.state == MONITOR
        runs.append((eng, sup, got))
    (eng, sup, got), (reng, rsup, want) = runs
    assert got == want
    assert sup.stats() == rsup.stats()
    assert outcomes(eng) == outcomes(reng)
    assert_outputs_agree(eng, reng)
