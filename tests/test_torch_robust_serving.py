"""The port's robust ``CNNServingEngine`` (overload and faults), on the
CPU, against the reference's.

Twins of the reference's ``tests/test_robust_serving.py`` run on the
port's engine with the reference's tiny graph (``vgg16(res=8,
scale=0.05)``, params from the reference's ``init_params`` through
``params_from_jax``): bounded admission, deadline shedding, fault
injection with bounded retry, the degrade controller and the
``stats()["robustness"]`` schema. Throughout, every submitted request ends
in exactly one outcome and ``completed + rejected_full + shed_deadline +
failed + pending == submitted``.

Parity: the reference's engine and the port's serve one scripted trace
under a ``FakeClock`` with the same ``FaultPlan``, ``max_queue``,
``shed_deadline`` and ``degrade``, their service estimates pinned to the
same values before every step and the degrade controller's spike
threshold out of reach, so no decision reads either side's real timing.
They must give the same per-rid outcomes, buckets and counters, the same
``stats()`` keys and results
within rtol 2e-2 / atol 2e-3. The port's ``FaultPlan.seeded`` and
``robust_zscore`` equal the reference's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.cnn.executor import init_params as jax_init_params
from repro.cnn.models import vgg16 as jax_vgg16
from repro.distributed.fault import FaultPlan as JaxFaultPlan
from repro.distributed.fault import TickFault as JaxTickFault
from repro.distributed.fault import robust_zscore as jax_robust_zscore
from repro.serving.cnn_engine import CNNRequest as JaxRequest
from repro.serving.cnn_engine import CNNServingEngine as JaxEngine
from repro.serving.cnn_engine import DegradeConfig as JaxDegradeConfig
from repro_torch.bridge import params_from_jax
from repro_torch.cnn.executor import _with_fault_hook
from repro_torch.cnn.models import vgg16
from repro_torch.distributed.fault import FaultPlan, TickFault, robust_zscore
from repro_torch.serving.cnn_engine import (OUTCOME_COMPLETED, OUTCOME_FAILED,
                                            OUTCOME_REJECTED, OUTCOME_SHED,
                                            CNNRequest, CNNServingEngine,
                                            DegradeConfig)

RNG = np.random.default_rng(7)
PLAN_TOL = dict(rtol=2e-2, atol=2e-3)


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Ticks here are timed against injected delays of tens of ms: one
    intra-op thread keeps a tiny forward at its ~1.5 ms when the suite's
    workers share the cores (oversubscribed, it took ~50 ms)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    jg = jax_vgg16(res=8, scale=0.05)
    np_params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(jg, jax.random.PRNGKey(0)))
    return vgg16(res=8, scale=0.05), params_from_jax(np_params, "cpu"), \
        jg, np_params


def img():
    return np.asarray(RNG.standard_normal((8, 8, 3)), np.float32)


def engine(tiny, **kw):
    g, params, _, _ = tiny
    return CNNServingEngine(g, params, None, device="cpu", **kw)


def submit_n(eng, n, start_rid=0, imgs=None, t=None):
    reqs = [CNNRequest(rid=start_rid + i,
                       image=imgs[i] if imgs is not None else img(),
                       t_submit=t)
            for i in range(n)]
    return [eng.submit(r) for r in reqs], reqs


def conserved(eng) -> bool:
    rb = eng.stats()["robustness"]
    return (sum(rb["outcomes"].values()) + rb["pending"]
            == eng.submitted_total)


# ----------------------------------------------------------- fault plans


def test_fault_plan_seeded_deterministic():
    mk = lambda: FaultPlan.seeded(seed=9, n_ticks=200, fail_rate=0.3,  # noqa
                                  failures=2, delay_rate=0.2, delay_s=0.5)
    a, b = mk(), mk()
    assert a.faults == b.faults and len(a) > 0
    assert FaultPlan.seeded(seed=10, n_ticks=200,
                            fail_rate=0.3).faults != a.faults
    assert a.get(None) is None
    assert FaultPlan({}).get(0) is None


def test_robust_zscore_is_median_mad():
    samples = [1.0, 1.0, 2.0, 3.0, 3.0]       # median 2, MAD 1
    assert robust_zscore(2.0, samples) == 0.0
    assert robust_zscore(5.0, samples) == pytest.approx(3.0)
    assert robust_zscore(1.0, []) == 0.0


# ------------------------------------------------------------- admission


def test_submit_verdicts_and_bounded_admission(tiny):
    eng = engine(tiny, batch_size=2, max_queue=2)
    verdicts, _ = submit_n(eng, 3)
    assert verdicts == ["queued", "queued", OUTCOME_REJECTED]
    assert eng.rejected_total == 1 and len(eng.queue) == 2
    rej = [t for t in eng.request_log if t.outcome == OUTCOME_REJECTED]
    assert [t.rid for t in rej] == [2]
    assert rej[0].service_s == 0.0 and not rej[0].slo_ok
    assert conserved(eng)
    eng.run_until_done()
    assert set(eng.done) == {0, 1} and conserved(eng)
    assert eng.submit(CNNRequest(rid=2, image=img())) == "queued"
    eng.run_until_done()
    assert 2 in eng.done


def test_duplicate_rid_rejected_at_submit(tiny):
    eng = engine(tiny, batch_size=2)
    eng.submit(CNNRequest(rid=0, image=img()))
    with pytest.raises(ValueError, match="duplicate rid — already queued"):
        eng.submit(CNNRequest(rid=0, image=img()))
    eng.run_until_done()
    with pytest.raises(ValueError,
                       match="duplicate rid — already completed"):
        eng.submit(CNNRequest(rid=0, image=img()))
    feng = engine(tiny, batch_size=2, max_retries=0,
                  fault_plan=FaultPlan({0: TickFault(failures=5)}))
    feng.submit(CNNRequest(rid=7, image=img()))
    feng.run_until_done()
    assert 7 in feng.failed
    with pytest.raises(ValueError, match="duplicate rid — already failed"):
        feng.submit(CNNRequest(rid=7, image=img()))


def test_reject_counts_an_external_rejection(tiny):
    """``reject()`` books a request as submitted and rejected without
    queueing it; the rid may come back."""
    eng = engine(tiny, batch_size=2)
    assert eng.reject(CNNRequest(rid=3, image=img())) == OUTCOME_REJECTED
    assert eng.rejected_total == 1 and eng.submitted_total == 1
    assert not eng.queue and conserved(eng)
    assert eng.submit(CNNRequest(rid=3, image=img())) == "queued"


# -------------------------------------------------------------- shedding


def test_deadline_shedding_vs_completion(tiny):
    clk = FakeClock()
    eng = engine(tiny, batch_size=2, slo_s=0.05, shed_deadline=True,
                 clock=clk, warmup=True)
    eng.submit(CNNRequest(rid=0, image=img(), t_submit=0.0))
    eng.submit(CNNRequest(rid=1, image=img(), t_submit=0.1))
    clk.t = 0.1
    eng.step(now=0.1, flush=True)
    assert eng.shed_rids == {0} and eng.shed_total == 1
    assert 0 not in eng.done and 1 in eng.done
    traces = {t.rid: t for t in eng.request_log}
    assert traces[0].outcome == OUTCOME_SHED
    assert traces[0].service_s == 0.0
    assert traces[0].latency_s == pytest.approx(0.1)
    assert traces[1].outcome == OUTCOME_COMPLETED and traces[1].slo_ok
    assert conserved(eng)


def test_no_shed_without_measured_floor(tiny):
    eng = engine(tiny, batch_size=2, slo_s=1e-6, shed_deadline=True,
                 clock=FakeClock())
    eng.submit(CNNRequest(rid=0, image=img(), t_submit=0.0))
    eng.step(now=100.0, flush=True)
    assert eng.shed_total == 0 and 0 in eng.done


# ------------------------------------------------------- retry + failure


def test_completion_fault_retry_recovers_bitwise(tiny):
    im = img()
    clean = engine(tiny, batch_size=2)
    clean.submit(CNNRequest(rid=0, image=im))
    clean.run_until_done()
    eng = engine(tiny, batch_size=2, max_retries=2,
                 fault_plan=FaultPlan({0: TickFault(failures=2)}))
    eng.submit(CNNRequest(rid=0, image=im))
    eng.run_until_done()
    assert eng.retries_total == 2 and eng.failed_ticks == 0
    assert np.array_equal(eng.done[0], clean.done[0])
    assert conserved(eng)


def test_dispatch_fault_retry_and_exhaustion(tiny):
    ok = engine(tiny, batch_size=2, max_retries=1,
                fault_plan=FaultPlan(
                    {0: TickFault(failures=1, at_dispatch=True)}))
    ok.submit(CNNRequest(rid=0, image=img()))
    ok.run_until_done()
    assert ok.retries_total == 1 and 0 in ok.done

    eng = engine(tiny, batch_size=2, max_retries=1,
                 fault_plan=FaultPlan(
                     {0: TickFault(failures=5, at_dispatch=True)}))
    submit_n(eng, 2)
    assert eng.step(now=0.0, flush=True) == 2
    assert eng.failed == {0: 0, 1: 0} and eng.failed_ticks == 1
    assert eng.dispatches[2] == 0
    traces = {t.rid: t for t in eng.request_log}
    assert all(traces[r].outcome == OUTCOME_FAILED for r in (0, 1))
    assert conserved(eng)
    submit_n(eng, 2, start_rid=2)
    eng.run_until_done()
    assert set(eng.done) == {2, 3} and conserved(eng)


def test_hook_not_threaded_without_plan(tiny):
    """No hook, no wrapper: a default engine's programs are the unhooked
    ``CompiledProgram``s themselves."""
    sentinel = object()
    assert _with_fault_hook(sentinel, None) is sentinel
    calls = []
    hooked = _with_fault_hook(lambda p, x: (p, x),
                              lambda: calls.append(1))
    assert hooked(1, 2) == (1, 2) and len(calls) == 1
    eng = engine(tiny, batch_size=2)
    assert all(type(run).__name__ == "CompiledProgram"
               for run in eng._runs.values())


def test_failed_tick_does_not_pollute_service_ema(tiny):
    eng = engine(tiny, batch_size=2, warmup=True, max_retries=0,
                 fault_plan=FaultPlan({0: TickFault(failures=5,
                                                    delay_s=0.2)}))
    ema_before = dict(eng.stats()["service_ema_s"])
    submit_n(eng, 2)
    eng.run_until_done()
    assert eng.failed_ticks == 1
    assert eng.stats()["service_ema_s"] == ema_before


# --------------------------------------------- pipelined faults (depth 2)


def test_depth2_faulted_inflight_drain(tiny):
    imgs = [img() for _ in range(6)]
    clean = engine(tiny, batch_size=2, pipeline_depth=2, warmup=True)
    submit_n(clean, 6, imgs=imgs)
    clean.run_until_done()
    eng = engine(tiny, batch_size=2, pipeline_depth=2, warmup=True,
                 max_retries=1, device_delay_s=0.05,
                 fault_plan=FaultPlan({1: TickFault(failures=5,
                                                    delay_s=0.2)}))
    ema_before = dict(eng.stats()["service_ema_s"])[2]
    submit_n(eng, 6, imgs=imgs)
    assert eng.step(now=0.0, flush=True) == 2
    assert eng.step(now=0.0, flush=True) == 2
    assert len(eng._inflight) == 2
    assert eng.step(now=0.0, flush=True) == 2
    eng.drain()
    assert set(eng.done) == {0, 1, 4, 5}
    assert eng.failed == {2: 1, 3: 1}
    assert eng.retries_total == 1 and eng.failed_ticks == 1
    assert len(eng._inflight) == 0
    for r in eng.done:
        assert np.array_equal(eng.done[r], clean.done[r])
    assert eng.stats()["service_ema_s"][2] < 0.1
    assert ema_before < 0.1
    assert conserved(eng)


def test_depth2_reset_with_faulted_inflight_and_plan_rewind(tiny):
    eng = engine(tiny, batch_size=2, pipeline_depth=2, warmup=True,
                 max_retries=0, device_delay_s=0.05,
                 fault_plan=FaultPlan({1: TickFault(failures=5)}))
    submit_n(eng, 4)
    eng.step(now=0.0, flush=True)
    eng.step(now=0.0, flush=True)
    assert len(eng._inflight) == 2
    eng.reset()
    assert len(eng._inflight) == 0 and eng.submitted_total == 0
    assert not eng.failed and not eng.done and not eng._inflight_rids
    assert conserved(eng)
    submit_n(eng, 4)
    eng.run_until_done()
    assert set(eng.done) == {0, 1} and eng.failed == {2: 1, 3: 1}
    assert conserved(eng)


# ------------------------------------------------------------------ poll


def test_poll_unknown_rid_has_no_side_effects(tiny):
    eng = engine(tiny, batch_size=2, pipeline_depth=2, warmup=True,
                 device_delay_s=0.05)
    submit_n(eng, 5)
    eng.step(now=0.0, flush=True)
    eng.step(now=0.0, flush=True)
    assert len(eng._inflight) == 2 and len(eng.queue) == 1
    assert eng.poll(99) is None
    assert eng.poll(4) is None
    assert len(eng._inflight) == 2
    assert eng.poll(0) is not None
    assert len(eng._inflight) == 1
    eng.run_until_done()


def test_poll_failed_rid_returns_none(tiny):
    eng = engine(tiny, batch_size=2, pipeline_depth=2, max_retries=0,
                 fault_plan=FaultPlan({0: TickFault(failures=5)}))
    submit_n(eng, 2)
    eng.step(now=0.0, flush=True)
    eng.drain()
    assert 0 in eng.failed
    assert eng.poll(0) is None


# --------------------------------------------------------------- degrade


def test_degrade_config_validation(tiny):
    with pytest.raises(ValueError, match="hysteresis"):
        engine(tiny, batch_size=2,
               degrade=DegradeConfig(enter_queue=2, exit_queue=2))


def test_degrade_enter_exit_hysteresis(tiny):
    clk = FakeClock()
    eng = engine(tiny, batch_size=4, slo_s=10.0, warmup=True, clock=clk,
                 degrade=DegradeConfig(enter_queue=3, exit_queue=1,
                                       exit_ticks=2))
    submit_n(eng, 1, t=0.0)
    assert eng.step(now=0.0) == 0
    submit_n(eng, 2, start_rid=1, t=0.0)
    assert eng.step(now=0.0) == 3
    rb = eng.stats()["robustness"]["degrade"]
    assert rb["active"] and rb["entries"] == 1
    submit_n(eng, 1, start_rid=3, t=0.0)
    assert eng.step(now=0.0) == 1
    assert eng.step(now=0.0) == 0
    assert eng.step(now=0.0) == 0
    rb = eng.stats()["robustness"]["degrade"]
    assert not rb["active"] and rb["exits"] == 1
    submit_n(eng, 1, start_rid=4, t=100.0)
    assert eng.step(now=100.0) == 0
    eng.run_until_done()
    assert conserved(eng)


def test_degrade_straggler_spike_entry(tiny):
    """A straggler tick enters degrade mode. Its delay (0.5 s) stands far
    above the spread of a loaded host's tick times, which the robust
    z-score divides by."""
    eng = engine(tiny, batch_size=1, warmup=True,
                 fault_plan=FaultPlan({6: TickFault(delay_s=0.5)}),
                 degrade=DegradeConfig(enter_queue=100, exit_queue=10,
                                       straggler_k=3.0,
                                       straggler_patience=1))
    for i in range(7):
        eng.submit(CNNRequest(rid=i, image=img()))
        eng.step(flush=True)
    assert eng._spike_streak >= 1
    eng.step()
    rb = eng.stats()["robustness"]["degrade"]
    assert rb["active"] and rb["straggler_spikes"] >= 1
    assert conserved(eng)


# ----------------------------------------------------------------- stats


def test_stats_robustness_schema_and_conservation(tiny):
    eng = engine(tiny, batch_size=2, max_queue=8)
    rb = eng.stats()["robustness"]
    assert set(rb) == {"max_queue", "shed_deadline", "outcomes",
                       "pending", "retries", "failed_ticks",
                       "queue_high_water", "degrade"}
    assert set(rb["outcomes"]) == {OUTCOME_COMPLETED, OUTCOME_REJECTED,
                                   OUTCOME_SHED, OUTCOME_FAILED}
    assert set(rb["degrade"]) == {"enabled", "active", "entries", "exits",
                                  "straggler_spikes"}
    assert rb["max_queue"] == 8 and not rb["degrade"]["enabled"]
    submit_n(eng, 3)
    rb = eng.stats()["robustness"]
    assert rb["pending"] == 3 and rb["queue_high_water"] == 3
    assert conserved(eng)
    eng.run_until_done()
    rb = eng.stats()["robustness"]
    assert rb["outcomes"][OUTCOME_COMPLETED] == 3 and rb["pending"] == 0
    assert conserved(eng)


def test_latency_window_excludes_non_completed(tiny):
    eng = engine(tiny, batch_size=2, max_queue=1)
    verdicts, _ = submit_n(eng, 2)
    assert verdicts[1] == OUTCOME_REJECTED
    eng.run_until_done()
    s = eng.stats()
    assert len(eng.request_log) == 2 and s["window"] == 1
    assert s["latency"]["p99_ms"] > 0


def test_default_engine_unchanged_by_robustness_plumbing(tiny):
    eng = engine(tiny, batch_size=4, slo_s=0.5, clock=FakeClock(),
                 warmup=True)
    submit_n(eng, 6, t=0.0)
    eng.step(now=0.0)
    eng.run_until_done()
    assert set(eng.done) == set(range(6))
    assert all(t.outcome == OUTCOME_COMPLETED for t in eng.request_log)
    rb = eng.stats()["robustness"]
    assert rb["max_queue"] is None and not rb["shed_deadline"]
    assert rb["outcomes"][OUTCOME_COMPLETED] == 6
    assert rb["retries"] == 0 and rb["failed_ticks"] == 0
    assert conserved(eng)


# ------------------------------------------------- parity with the reference

SEEDED_ARGS = [dict(fail_rate=0.3, failures=2, delay_rate=0.2, delay_s=0.5),
               dict(fail_rate=0.1, at_dispatch=True),
               dict(delay_rate=0.5, delay_s=0.01)]


@pytest.mark.parametrize("seed", range(10))
def test_fault_plan_seeded_matches_reference(seed):
    for kw in SEEDED_ARGS:
        ours = FaultPlan.seeded(seed, 300, **kw)
        ref = JaxFaultPlan.seeded(seed, 300, **kw)
        assert {k: (f.failures, f.delay_s, f.at_dispatch)
                for k, f in ours.faults.items()} == \
            {k: (f.failures, f.delay_s, f.at_dispatch)
             for k, f in ref.faults.items()}
        assert len(ours) == len(ref) > 0
        shifted, ref_shifted = ours.offset(-3), ref.offset(-3)
        assert sorted(shifted.faults) == sorted(ref_shifted.faults)


def test_robust_zscore_matches_reference():
    rng = np.random.default_rng(11)
    for n in (0, 1, 2, 5, 6, 31, 32):
        samples = list(rng.exponential(1e-3, size=n))
        for value in rng.exponential(2e-3, size=8):
            assert abs(robust_zscore(value, samples)
                       - jax_robust_zscore(value, samples)) <= 1e-12
    assert robust_zscore(1.0, [2.0] * 7) == jax_robust_zscore(1.0, [2.0] * 7)


PINNED = {1: 0.01, 2: 0.012, 4: 0.02}
SLO_S = 0.1
# (clock time, requests submitted then, flush). With the estimates pinned,
# waits end 0.08-0.09 s after the oldest arrival and a queued request is
# shed once 0.09 s old: every reading is far from both.
SCRIPT = [(0.0, 3, False), (0.05, 2, False), (0.5, 0, False),
          (1.0, 7, False), (1.0, 0, False), (1.3, 4, True), (2.0, 1, False),
          (2.01, 3, False), (2.02, 0, True), (3.0, 6, False),
          (3.001, 0, False), (3.002, 0, False), (3.003, 0, False),
          (3.004, 0, False), (4.0, 2, True)]
FAULTS = {0: dict(failures=1), 1: dict(failures=3, at_dispatch=True),
          3: dict(failures=1, at_dispatch=True, delay_s=0.01),
          4: dict(failures=4), 6: dict(delay_s=0.02)}


def drive(eng, request_cls, clock, images):
    """Serve SCRIPT, pinning the service estimates before every step.
    Returns each rid's verdict at submit and how many each step
    dispatched."""
    rid, verdicts, dispatched = 0, {}, []
    for now, n_new, flush in SCRIPT:
        clock.t = now
        for _ in range(n_new):
            verdicts[rid] = eng.submit(request_cls(rid=rid,
                                                   image=images[rid]))
            rid += 1
        eng._svc.update(PINNED)
        dispatched.append(eng.step(now=now, flush=flush))
    while True:
        eng._svc.update(PINNED)
        if eng.step(now=10.0, flush=True) == 0:
            break
    eng.drain()
    return verdicts, dispatched


def outcomes(eng):
    return {t.rid: (t.outcome, t.bucket, t.t_submit, t.t_dispatch)
            for t in eng.request_log}


@pytest.mark.parametrize("depth", [1, 2])
def test_robust_engine_matches_reference_engine(tiny, depth):
    g, params, jg, np_params = tiny
    n = sum(k for _, k, _ in SCRIPT)
    images = [img() for _ in range(n)]
    kw = dict(batch_size=4, slo_s=SLO_S, pipeline_depth=depth, max_queue=5,
              shed_deadline=True, max_retries=2)
    clock, jclock = FakeClock(), FakeClock()
    ours = CNNServingEngine(
        g, params, None, clock=clock, device="cpu",
        fault_plan=FaultPlan({k: TickFault(**f) for k, f in FAULTS.items()}),
        degrade=DegradeConfig(enter_queue=5, exit_queue=1, exit_ticks=2,
                              straggler_k=1e12), **kw)
    ref = JaxEngine(
        jg, np_params, None, clock=jclock,
        fault_plan=JaxFaultPlan({k: JaxTickFault(**f)
                                 for k, f in FAULTS.items()}),
        degrade=JaxDegradeConfig(enter_queue=5, exit_queue=1, exit_ticks=2,
                                 straggler_k=1e12), **kw)
    got = drive(ours, CNNRequest, clock, images)
    want = drive(ref, JaxRequest, jclock, images)
    assert got == want
    # Per rid: outcome, bucket, submit and dispatch time — the dispatch
    # sequence with it. (At depth 2 the log's order also reads when each
    # side's device finished, so only depth 1 compares it.)
    assert outcomes(ours) == outcomes(ref)
    if depth == 1:
        assert [t.rid for t in ours.request_log] == \
            [t.rid for t in ref.request_log]
    assert len(outcomes(ours)) == n
    assert ours.dispatches == ref.dispatches
    s, r = ours.stats(), ref.stats()
    assert set(s) == set(r)
    assert s["plan"] == r["plan"] == {"swaps": 0, "rollbacks": 0}
    for block in ("pipeline", "robustness"):
        assert set(s[block]) == set(r[block]), block
    assert set(s["robustness"]["degrade"]) == \
        set(r["robustness"]["degrade"])
    rb, rr = s["robustness"], r["robustness"]
    assert rb == rr
    # Every mechanism ran: rejections, sheds, recovered and exhausted
    # faults, a degrade entry and exit.
    out = rb["outcomes"]
    assert out[OUTCOME_REJECTED] and out[OUTCOME_SHED] and \
        out[OUTCOME_FAILED] and out[OUTCOME_COMPLETED]
    assert rb["retries"] and rb["failed_ticks"] == 2
    assert rb["degrade"]["entries"] and rb["degrade"]["exits"]
    assert rb["pending"] == 0 and sum(out.values()) == n
    for key in ("submitted", "served", "queued", "window"):
        assert s[key] == r[key], key
    assert (ours.retries_total, ours.failed_ticks, ours.shed_total,
            ours.rejected_total, ours.queue_high_water, ours.failed,
            ours.shed_rids) == (ref.retries_total, ref.failed_ticks,
                                ref.shed_total, ref.rejected_total,
                                ref.queue_high_water, ref.failed,
                                ref.shed_rids)
    assert sorted(ours.done) == sorted(ref.done)
    for rid in ours.done:
        np.testing.assert_allclose(ours.done[rid], np.asarray(ref.done[rid]),
                                   **PLAN_TOL)
