"""The port's pipelined ``CNNServingEngine`` (``pipeline_depth >= 2``), on
the CPU, against the reference's pipelined engine.

Twins of the reference's ``tests/test_pipelined_serving.py`` run on the
port's engine with the reference's tiny graph (``vgg16(res=8,
scale=0.05)``, params from the reference's ``init_params`` through
``params_from_jax``): depth 1 stays synchronous, deeper ticks retire
lazily and bit-equal to depth 1's, ``poll`` keeps the rid → result
mapping, timestamps stay monotone, stale slots are zeroed per rotating
buffer and ``stats()["pipeline"]`` reports depth, in-flight and overlap.
Results are held against the reference's eager forward at its whole-plan
tolerance (rtol 2e-2, atol 2e-3).

Parity: both engines serve one scripted trace under a ``FakeClock`` at
depths 1, 2 and 4, with their service estimates pinned to the same values
before every step, so no decision reads either side's real timing; they
must dispatch the same buckets in the same order and agree on every
result.

The card's completion path is driven here with a fake CUDA event: ``_reap``
only queries, ``_complete`` waits on its own tick's event, and nothing on
the pipelined path calls ``torch.cuda.synchronize``. The port's Poisson
traces equal the reference bench's, and its replays account for every
request.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.executor import forward as jax_forward
from repro.cnn.executor import init_params as jax_init_params
from repro.cnn.models import vgg16 as jax_vgg16
from repro.serving.cnn_engine import CNNRequest as JaxRequest
from repro.serving.cnn_engine import CNNServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.cnn.models import vgg16
from repro_torch.distributed.fault import FaultPlan, TickFault
from repro_torch.serving.cnn_engine import (OUTCOME_REJECTED, CNNRequest,
                                            CNNServingEngine)
from repro_torch.serving.replay import (poisson_trace, replay_robust,
                                        replay_wallclock)

RNG = np.random.default_rng(23)
PLAN_TOL = dict(rtol=2e-2, atol=2e-3)


class FakeClock:
    """Deterministic injectable time source (engine clock only — the
    pipeline's readiness bookkeeping runs on perf_counter regardless)."""

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


def reference_logits(tiny, image):
    _, _, jg, np_params = tiny
    return np.asarray(jax_forward(jg, np_params, jnp.asarray(image)))


def submit_n(eng, n, start_rid=0, imgs=None):
    reqs = [CNNRequest(rid=start_rid + i,
                       image=imgs[i] if imgs is not None else img())
            for i in range(n)]
    for r in reqs:
        eng.submit(r)
    return reqs


# ------------------------------------------------------------ validation


def test_depth_validation(tiny):
    with pytest.raises(ValueError, match="pipeline_depth"):
        engine(tiny, batch_size=2, pipeline_depth=0)


def test_depth1_is_synchronous(tiny):
    eng = engine(tiny, batch_size=2)
    assert eng.pipeline_depth == 1
    submit_n(eng, 2)
    assert eng.step(now=0.0) == 2
    assert len(eng._inflight) == 0
    assert set(eng.done) == {0, 1}
    assert eng.stats()["pipeline"]["inflight"] == 0


# ------------------------------------------------------------ async results


def test_async_outputs_match_reference_and_sync(tiny):
    n = 10
    imgs = [img() for _ in range(n)]
    outs = {}
    for depth in (1, 3):
        eng = engine(tiny, batch_size=4, pipeline_depth=depth)
        submit_n(eng, n, imgs=imgs)
        done = eng.run_until_done()
        assert set(done) == set(range(n))
        outs[depth] = dict(done)
    for r in range(n):
        assert np.array_equal(outs[1][r], outs[3][r])
        np.testing.assert_allclose(outs[3][r],
                                   reference_logits(tiny, imgs[r]),
                                   **PLAN_TOL)


def test_step_returns_before_completion_then_drain(tiny):
    eng = engine(tiny, buckets=(2,), pipeline_depth=2, warmup=True)
    submit_n(eng, 2)
    assert eng.step(now=0.0, flush=True) == 2
    assert len(eng._inflight) == 1
    assert 0 not in eng.done            # launched, not yet retired
    done = eng.drain()
    assert len(eng._inflight) == 0
    assert set(done) == {0, 1}


def test_pipeline_depth_bounds_inflight(tiny):
    eng = engine(tiny, buckets=(1,), pipeline_depth=2, warmup=True)
    submit_n(eng, 5)
    for _ in range(5):
        assert eng.step(now=0.0, flush=True) == 1
        assert len(eng._inflight) <= 2
    eng.drain()
    assert set(eng.done) == set(range(5))


def test_poll_out_of_order_preserves_mapping(tiny):
    """An injected device delay holds the ticks in flight; poll() on the
    newest retires all three, and each rid keeps its own image's
    logits."""
    n = 6
    imgs = [img() for _ in range(n)]
    eng = engine(tiny, buckets=(2,), pipeline_depth=3, device_delay_s=0.2,
                 warmup=True)
    submit_n(eng, n, imgs=imgs)
    for _ in range(3):
        eng.step(now=0.0, flush=True)
    assert len(eng._inflight) == 3
    out5 = eng.poll(5)
    assert out5 is not None and len(eng._inflight) == 0
    assert set(eng.done) == set(range(n))
    for r in range(n):
        np.testing.assert_allclose(eng.done[r],
                                   reference_logits(tiny, imgs[r]),
                                   **PLAN_TOL)
    assert eng.poll(99) is None


# ------------------------------------------------------------ timestamps


def test_trace_timestamps_monotonic(tiny):
    clock = FakeClock()
    eng = engine(tiny, buckets=(2,), pipeline_depth=4, clock=clock,
                 warmup=True)
    for i in range(8):
        clock.t = 0.1 * i
        eng.submit(CNNRequest(rid=i, image=img()))
    clock.t = 1.0
    while eng.queue:
        eng.step(flush=True)
    eng.drain()
    assert len(eng.request_log) == 8
    for tr in eng.request_log:
        assert tr.t_submit <= tr.t_dispatch <= tr.t_done
        assert tr.queue_s >= 0.0 and tr.service_s > 0.0
        assert tr.latency_s == pytest.approx(tr.t_done - tr.t_submit)
    dones = [tr.t_done for tr in eng.request_log]
    assert dones == sorted(dones)


# ------------------------------------------------------------ staging


def test_rotating_buffers_and_stale_slot_zeroing(tiny):
    eng = engine(tiny, batch_size=4, pipeline_depth=2, warmup=True)
    assert len(eng._batch_bufs) == 2 and len(eng._stagings) == 2
    assert eng._batch_buf is eng._batch_bufs[0]
    assert eng._staging is eng._stagings[0]
    imgs = [img() for _ in range(8)]
    submit_n(eng, 8, imgs=imgs)
    eng.step(now=0.0, flush=True)       # bucket 4 → buffer 0 full
    eng.step(now=0.0, flush=True)       # bucket 4 → buffer 1 full
    eng.drain()
    eng.submit(CNNRequest(rid=8, image=imgs[0]))
    eng.step(now=0.0, flush=True)
    eng.drain()
    used = eng._batch_bufs[eng._last_buf_index]
    assert np.array_equal(used[0], imgs[0])
    assert not used[1:4].any()
    other = eng._batch_bufs[1 - eng._last_buf_index]
    assert other[1:4].any()


# ------------------------------------------------------------ stats


def test_pipeline_stats_block(tiny):
    eng = engine(tiny, buckets=(2,), pipeline_depth=2, warmup=True)
    p0 = eng.stats()["pipeline"]
    assert p0["depth"] == 2
    assert p0["inflight"] == p0["dispatched_ticks"] == 0
    assert p0["overlap_ratio"] == 0.0
    submit_n(eng, 4)
    eng.step(now=0.0, flush=True)
    assert eng.stats()["pipeline"]["inflight"] == 1
    eng.step(now=0.0, flush=True)
    eng.drain()
    p = eng.stats()["pipeline"]
    assert p["inflight"] == 0
    assert p["dispatched_ticks"] == p["completed_ticks"] == 2
    assert p["device_busy_s"] > 0.0
    assert 0.0 <= p["overlap_ratio"] <= 1.0
    eng.reset()
    p2 = eng.stats()["pipeline"]
    assert p2["dispatched_ticks"] == p2["completed_ticks"] == 0
    assert p2["device_busy_s"] == 0.0


def test_reset_with_inflight_drains_first(tiny):
    eng = engine(tiny, buckets=(2,), pipeline_depth=2, warmup=True)
    submit_n(eng, 2)
    eng.step(now=0.0, flush=True)
    assert len(eng._inflight) == 1
    eng.reset()
    assert len(eng._inflight) == 0
    assert eng.stats()["submitted"] == 0 and not eng.done


def test_warmup_primes_emas_at_depth2(tiny):
    eng = engine(tiny, batch_size=2, pipeline_depth=2, warmup=True)
    emas = eng.stats()["service_ema_s"]
    assert set(emas) == {1, 2}
    assert all(v > 0.0 for v in emas.values())


def test_device_delay_inflates_service_ema(tiny):
    """The injected delay enters the tick's service time and its EMA in
    full. Both engines' estimates are pinned first, so the check reads no
    warm-up timing (a loaded host's forward can outlast the delay)."""
    delay = 0.05
    fast = engine(tiny, buckets=(1,), warmup=True)
    slow = engine(tiny, buckets=(1,), device_delay_s=delay, warmup=True)
    for eng in (fast, slow):
        eng._svc[1] = 0.01
        submit_n(eng, 1)
        eng.step(now=0.0, flush=True)
    svc = {eng: eng.last_tick["wall_s"] for eng in (fast, slow)}
    assert svc[slow] >= delay
    for eng in (fast, slow):
        assert eng.stats()["service_ema_s"][1] == pytest.approx(
            0.5 * 0.01 + 0.5 * svc[eng])
    assert (slow.stats()["service_ema_s"][1]
            >= 0.5 * 0.01 + 0.5 * delay)


# ------------------------------------------- depth against depth, the port


@pytest.mark.parametrize("depth", [2, 4])
def test_deeper_pipelines_equal_depth1_bit_for_bit(tiny, depth):
    """Waves of buckets 4, 4, 2, 1, 1, 4 (a bucket twice and three times
    in a row, so ticks of one program are in flight together): the same
    dispatches as depth 1 and the same bits."""
    waves = (4, 4, 2, 1, 1, 3)
    imgs = [img() for _ in range(sum(waves))]
    runs = {}
    for d in (1, depth):
        eng = engine(tiny, batch_size=4, pipeline_depth=d)
        rid, inflight = 0, []
        for n in waves:
            submit_n(eng, n, start_rid=rid, imgs=imgs[rid:rid + n])
            rid += n
            eng.step(now=0.0, flush=True)
            inflight.append(len(eng._inflight))
        eng.run_until_done()
        runs[d] = (dict(eng.done), [(t.rid, t.bucket)
                                    for t in eng.request_log], inflight)
    assert runs[depth][1] == runs[1][1]
    assert [b for _, b in runs[1][1]] == [4] * 8 + [2] * 2 + [1, 1] + [4] * 3
    assert min(runs[depth][2]) >= 1 and max(runs[1][2]) == 0
    for r in range(len(imgs)):
        assert np.array_equal(runs[depth][0][r], runs[1][0][r])


# ------------------------------------------------- parity with the reference

PINNED = {1: 0.01, 2: 0.012, 4: 0.02}
SLO_S = 0.1
# (clock time, requests submitted then, flush): waits end SLO_S minus the
# pinned estimate after the oldest arrival, far from every reading.
SCRIPT = [(0.0, 1, False), (0.01, 2, False), (0.5, 0, False),
          (0.6, 5, False), (0.61, 0, False), (1.0, 2, True),
          (1.5, 1, False), (2.0, 3, False), (2.5, 0, True)]


def drive(eng, request_cls, clock, images):
    """Serve SCRIPT, pinning the service estimates before every step;
    returns whether each scripted step dispatched."""
    rid, dispatched = 0, []
    for now, n_new, flush in SCRIPT:
        clock.t = now
        for _ in range(n_new):
            eng.submit(request_cls(rid=rid, image=images[rid]))
            rid += 1
        eng._svc.update(PINNED)
        dispatched.append(eng.step(now=now, flush=flush))
    while True:
        eng._svc.update(PINNED)
        if eng.step(now=10.0, flush=True) == 0:
            break
    eng.drain()
    return dispatched


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipelined_engine_matches_reference_engine(tiny, depth):
    g, params, jg, np_params = tiny
    n = sum(k for _, k, _ in SCRIPT)
    images = [img() for _ in range(n)]
    clock, jclock = FakeClock(), FakeClock()
    ours = CNNServingEngine(g, params, None, batch_size=4, slo_s=SLO_S,
                            clock=clock, pipeline_depth=depth, device="cpu")
    ref = JaxEngine(jg, np_params, None, batch_size=4, slo_s=SLO_S,
                    clock=jclock, pipeline_depth=depth)
    got = drive(ours, CNNRequest, clock, images)
    want = drive(ref, JaxRequest, jclock, images)
    assert got == want == [0, 0, 3, 4, 0, 3, 0, 4, 0]
    assert ours.dispatches == ref.dispatches
    log = [(t.rid, t.bucket, t.t_submit, t.t_dispatch, t.outcome)
           for t in ours.request_log]
    assert log == [(t.rid, t.bucket, t.t_submit, t.t_dispatch, t.outcome)
                   for t in ref.request_log]
    s, r = ours.stats(), ref.stats()
    assert set(s) == set(r)
    assert s["plan"] == r["plan"] == {"swaps": 0, "rollbacks": 0}
    assert set(s["pipeline"]) == set(r["pipeline"])
    for key in ("submitted", "served", "queued", "dispatches", "window"):
        assert s[key] == r[key], key
    for key in ("depth", "inflight", "dispatched_ticks", "completed_ticks"):
        assert s["pipeline"][key] == r["pipeline"][key], key
    assert sorted(ours.done) == sorted(ref.done) == list(range(n))
    for rid in range(n):
        np.testing.assert_allclose(ours.done[rid], np.asarray(ref.done[rid]),
                                   **PLAN_TOL)


# ----------------------------------------- the card's path, with a fake event


class _FakeEvent:
    """Stands in for ``torch.cuda.Event``: fires when the test says so or
    when waited on, and records every query and wait."""

    def __init__(self, log):
        self.log = log
        self.fired = False
        self.recorded = False
        log["made"].append(self)

    def record(self):
        self.recorded = True

    def query(self):
        self.log["queries"].append(self)
        return self.fired

    def synchronize(self):
        self.log["waits"].append(self)
        self.fired = True


@pytest.fixture
def fake_events(monkeypatch):
    log = {"made": [], "queries": [], "waits": []}

    def no_device_sync(*args, **kwargs):
        raise AssertionError("torch.cuda.synchronize on the serving path")

    monkeypatch.setattr(torch.cuda, "Event", lambda: _FakeEvent(log))
    monkeypatch.setattr(torch.cuda, "synchronize", no_device_sync)
    return log


def test_card_path_retires_ticks_by_their_own_events(tiny, fake_events):
    """On the card each tick's logits are copied into its slot's host
    buffer and an event is recorded after them. ``_reap`` only queries
    (a later tick's event firing retires nothing before the head), and
    ``_complete`` — forced by a full pipeline, by ``step`` once the head
    fired, or by ``poll`` — waits on its own tick's event only."""
    log = fake_events
    imgs = [img() for _ in range(6)]
    eng = engine(tiny, buckets=(2,), pipeline_depth=2, warmup=True)
    eng.device = torch.device("cuda")
    submit_n(eng, 2, imgs=imgs[:2])
    eng.step(now=0.0, flush=True)
    (e0,) = log["made"]
    assert e0.recorded and log["waits"] == [] and 0 not in eng.done
    submit_n(eng, 2, start_rid=2, imgs=imgs[2:4])
    eng.step(now=0.0, flush=True)                  # reaps nothing
    e0_, e1 = log["made"]
    assert e0_ is e0 and log["queries"] == [e0] and log["waits"] == []
    assert len(eng._inflight) == 2
    e1.fired = True                                # a later tick is done
    assert eng.step(now=0.0) == 0
    assert len(eng._inflight) == 2 and log["waits"] == []
    submit_n(eng, 2, start_rid=4, imgs=imgs[4:6])
    eng.step(now=0.0, flush=True)                  # full: retires tick 0
    assert log["waits"] == [e0] and set(eng.done) == {0, 1}
    e2 = log["made"][2]
    assert eng.step(now=0.0) == 0                  # head (tick 1) fired
    assert log["waits"] == [e0, e1] and set(eng.done) == {0, 1, 2, 3}
    assert eng.poll(5) is not None
    assert log["waits"] == [e0, e1, e2] and not eng._inflight
    hosts = eng._host_outs
    assert all(h is not None and h.shape[0] == 2 for h in hosts)
    for r in range(6):
        # A copy of the slot's row, not a view the next tick rewrites.
        assert not np.shares_memory(eng.done[r], hosts[0].numpy())
        assert not np.shares_memory(eng.done[r], hosts[1].numpy())
        np.testing.assert_allclose(eng.done[r],
                                   reference_logits(tiny, imgs[r]),
                                   **PLAN_TOL)


def test_card_path_failed_dispatch_gives_its_slot_back(tiny, fake_events):
    """Depth 2: tick 0 carries a completion fault and its event has not
    fired; tick 1 exhausts its dispatch retries; tick 2 must stage into
    the slot tick 1 gave back, not into tick 0's, whose staging buffer a
    completion replay reads again and whose host output buffer tick 0's
    completion reads. Every surviving result is bit-equal to a clean
    engine's."""
    log = fake_events
    imgs = [img() for _ in range(6)]
    clean = engine(tiny, buckets=(2,), pipeline_depth=2)
    submit_n(clean, 6, imgs=imgs)
    clean.run_until_done()
    eng = engine(tiny, buckets=(2,), pipeline_depth=2, max_retries=1,
                 fault_plan=FaultPlan({
                     0: TickFault(failures=1),
                     1: TickFault(failures=5, at_dispatch=True)}))
    eng.device = torch.device("cuda")
    for k in range(3):
        submit_n(eng, 2, start_rid=2 * k, imgs=imgs[2 * k:2 * k + 2])
        assert eng.step(now=0.0, flush=True) == 2
    e0 = log["made"][0]
    assert not e0.fired and log["waits"] == []
    assert [t.tick_idx for t in eng._inflight] == [0, 2]
    assert [t.buf_index for t in eng._inflight] == [0, 1]
    eng.drain()
    assert eng.failed == {2: 1, 3: 1} and eng.retries_total == 2
    assert set(eng.done) == {0, 1, 4, 5}
    for r in eng.done:
        assert np.array_equal(eng.done[r], clean.done[r]), r


def test_card_path_depth1_waits_each_tick_at_once(tiny, fake_events):
    """Depth 1: each tick waits on its own event inside its ``step``."""
    log = fake_events
    eng = engine(tiny, buckets=(2,), warmup=True)
    eng.device = torch.device("cuda")
    for k in range(3):
        submit_n(eng, 2, start_rid=2 * k)
        eng.step(now=0.0, flush=True)
        assert log["waits"] == log["made"] and len(log["made"]) == k + 1
        assert set(eng.done) == set(range(2 * k + 2))


# ------------------------------------------------------- the trace replays


@pytest.mark.parametrize("seed", [0, 42])
def test_poisson_trace_matches_reference(seed):
    from benchmarks._trace import poisson_trace as jax_poisson_trace
    ours = poisson_trace(250.0, 30, (8, 8, 3), seed)
    ref = jax_poisson_trace(250.0, 30, (8, 8, 3), seed)
    assert [t for t, _ in ours] == [t for t, _ in ref]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(ours, ref))
    assert ours[0][0] == 0.0


@pytest.mark.parametrize("depth", [1, 2])
def test_replay_wallclock_serves_every_request(tiny, depth):
    """The wall-clock replay drains a trace through a warmed engine
    (twice, with ``reset()`` between) and reads one latency per request,
    each measured from the request's trace arrival time."""
    eng = engine(tiny, batch_size=4, slo_s=0.02, pipeline_depth=depth,
                 warmup=True)
    trace = poisson_trace(400.0, 24, (8, 8, 3), seed=3)
    for _ in range(2):
        eng.reset()
        lat, makespan = replay_wallclock(eng, trace)
        assert len(lat) == 24 and np.isfinite(lat).all() and lat.min() >= 0
        assert makespan >= trace[-1][0]
        assert eng.stats()["served"] == 24 and not eng._inflight
        log = list(eng.request_log)[-24:]
        assert {t.rid: t.t_submit for t in log} == {
            i: trace[i][0] for i in range(24)}
        for t in log:
            assert t.latency_s == pytest.approx(t.t_done - t.t_submit)


def test_replay_robust_gives_every_request_one_outcome(tiny):
    """Outcomes of the shed-aware replay agree with the engine's own
    ledger: rejections at submit, one exhausted fault, the rest completed
    or shed. The SLO sits far above any tick's wall time here, so which
    tick the fault hits never depends on how fast the host runs."""
    eng = engine(tiny, batch_size=2, slo_s=0.5, warmup=True, max_queue=3,
                 shed_deadline=True, max_retries=0,
                 fault_plan=FaultPlan({1: TickFault(failures=1)}))
    trace = [(0.001 * (i // 4), img()) for i in range(24)]
    ticks = []
    outcomes, done_at, makespan = replay_robust(
        eng, trace, on_tick=lambda now: ticks.append(now))
    assert sorted(outcomes) == list(range(24)) and ticks == sorted(ticks)
    rb = eng.stats()["robustness"]
    for name, count in rb["outcomes"].items():
        assert sum(o == name for o in outcomes.values()) == count, name
    assert rb["outcomes"][OUTCOME_REJECTED] > 0 and eng.failed_ticks == 1
    assert set(done_at) == set(eng.done)
    assert makespan >= 0 and rb["pending"] == 0
