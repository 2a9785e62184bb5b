"""The port's synchronous ``CNNServingEngine`` against the reference engine.

Both engines serve the same request trace on reduced GoogleNet under the
same virtual clock and SLO. Wait/dispatch decisions happen at clock
readings tens of seconds from every deadline, so the engines' real service
times (measured separately on each side; the reference's first call per
bucket includes its compile) cannot change a decision: both must dispatch the same buckets, and every result must
agree at the reference's whole-plan tolerance (rtol 2e-2, atol 2e-3).
"""
import numpy as np
import pytest
import torch

from repro.cnn.models import googlenet as jax_googlenet
from repro.core.dse import identify_parameters as jax_identify
from repro.core.mapper import map_network as jax_map_network
from repro.serving.cnn_engine import CNNRequest as JaxRequest
from repro.serving.cnn_engine import CNNServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.cnn.executor import compile_plan
from repro_torch.cnn.models import googlenet
from repro_torch.core.dse import identify_parameters
from repro_torch.core.mapper import map_network
from repro_torch.serving.cnn_engine import (CNNRequest, CNNServingEngine,
                                            batch_buckets)

PLAN_TOL = dict(rtol=2e-2, atol=2e-3)
SLO_S = 100.0


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def _np_params(graph, seed):
    rng = np.random.default_rng(seed)
    params = {}
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        if node.conv is not None:
            m = node.conv
            shape, fan_in, fan_out = ((m.k1, m.k2, m.c_in, m.c_out),
                                      m.k1 * m.k2 * m.c_in, m.c_out)
        elif "in_features" in node.attrs:
            fan_in = int(node.attrs["in_features"])
            fan_out = int(node.attrs["out_features"])
            shape = (fan_in, fan_out)
        else:
            continue
        params[nid] = {
            "w": (rng.standard_normal(shape) / np.sqrt(fan_in)
                  ).astype(np.float32),
            "b": rng.normal(0, 0.05, (fan_out,)).astype(np.float32)}
    return params


@pytest.fixture(scope="module")
def served():
    g = googlenet(res=56, scale=0.25)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    jg = jax_googlenet(res=56, scale=0.25)
    jplan = jax_map_network(jg, hw=jax_identify(jg, max_dim=512))
    np_params = _np_params(jg, seed=5)
    return g, plan, jg, jplan, np_params


# (clock time, requests submitted then, whether step() must dispatch).
# Waits end SLO_S minus the bucket's service estimate after the oldest
# arrival; the estimates (the reference's include its first-call compile)
# stay far below the gaps between these readings.
TRACE = [(0.0, 2, False), (10.0, 1, False), (105.0, 0, True),
         (110.0, 1, False), (215.0, 0, True), (300.0, 4, True),
         (300.0, 0, False), (400.0, 2, False), (505.0, 0, True),
         (600.0, 1, False)]


def _replay(engine, request_cls, clock, images):
    rid = 0
    decisions = []
    for now, n_new, _ in TRACE:
        clock.t = now
        for _ in range(n_new):
            engine.submit(request_cls(rid=rid, image=images[rid]))
            rid += 1
        decisions.append(engine.step(now=now) > 0)
    engine.run_until_done()
    return decisions


def test_engine_matches_reference_engine(served):
    g, plan, jg, jplan, np_params = served
    n = sum(k for _, k, _ in TRACE)
    images = np.random.default_rng(6).standard_normal(
        (n, 56, 56, 3)).astype(np.float32)
    clock, jclock = FakeClock(), FakeClock()
    ours = CNNServingEngine(g, params_from_jax(np_params, "cpu"), plan,
                            batch_size=4, slo_s=SLO_S, clock=clock,
                            device="cpu")
    ref = JaxEngine(jg, np_params, jplan, batch_size=4, slo_s=SLO_S,
                    clock=jclock)
    got = _replay(ours, CNNRequest, clock, images)
    want = _replay(ref, JaxRequest, jclock, images)
    assert got == want == [d for _, _, d in TRACE]
    assert ours.dispatches == ref.dispatches == {1: 2, 2: 1, 4: 2}
    s, r = ours.stats(), ref.stats()
    # (SLO violations are left out: a request's latency adds its tick's
    # measured service time, which differs between the two engines.)
    for key in ("submitted", "served", "queued", "dispatches", "window"):
        assert s[key] == r[key], key
    assert sorted(ours.done) == sorted(ref.done) == list(range(n))
    for rid in range(n):
        np.testing.assert_allclose(ours.done[rid], np.asarray(ref.done[rid]),
                                   **PLAN_TOL)
    ours_log = [(t.rid, t.bucket, t.t_submit, t.t_dispatch, t.queue_s)
                for t in ours.request_log]
    ref_log = [(t.rid, t.bucket, t.t_submit, t.t_dispatch, t.queue_s)
               for t in ref.request_log]
    assert ours_log == ref_log


# ------------------------------------------------------- port-only checks
@pytest.fixture(scope="module")
def tiny(served):
    g, plan, _, _, np_params = served
    return g, plan, params_from_jax(np_params, "cpu")


def _img(seed):
    return np.random.default_rng(seed).standard_normal(
        (56, 56, 3)).astype(np.float32)


def test_batch_buckets_ladder():
    assert batch_buckets(8) == [1, 2, 4, 8]
    assert batch_buckets(6) == [1, 2, 4, 6]
    assert batch_buckets(1) == [1]
    with pytest.raises(ValueError):
        batch_buckets(0)


def test_stale_slots_are_zeroed_and_results_match_forward(tiny):
    """A smaller tick after a larger one must not leak stale images into
    its padded tail, and every served result equals a lone forward."""
    g, plan, params = tiny
    eng = CNNServingEngine(g, params, plan, batch_size=4, device="cpu")
    for rid in range(3):
        eng.submit(CNNRequest(rid=rid, image=_img(rid)))
    assert eng.step(flush=True) == 3
    assert eng.dispatches[4] == 1
    eng.submit(CNNRequest(rid=3, image=_img(3)))
    assert eng.step(flush=True) == 1
    assert eng.dispatches[1] == 1
    assert not eng._batch_buf[1:].any()
    run = compile_plan(g, plan, epilogue="bias_relu", device="cpu")
    for rid in range(4):
        want = run(params, _img(rid)[None])[0]
        np.testing.assert_allclose(eng.done[rid], want.numpy(), **PLAN_TOL)


def test_slo_waits_then_dispatches_and_stats(tiny):
    g, plan, params = tiny
    clock = FakeClock()
    eng = CNNServingEngine(g, params, plan, batch_size=4, slo_s=5.0,
                           clock=clock, device="cpu")
    assert eng.step() == 0                              # empty queue
    eng.submit(CNNRequest(rid=0, image=_img(0)))
    assert eng.next_dispatch_at() == 5.0
    assert not eng.dispatch_due(4.0) and eng.dispatch_due(5.0)
    assert eng.step(now=1.0) == 0
    clock.t = 6.0
    assert eng.step() == 1
    st = eng.stats()
    assert st["served"] == st["submitted"] == 1 and st["queued"] == 0
    assert st["dispatches"] == {1: 1, 2: 0, 4: 0}
    assert st["latency"]["max_ms"] >= 6000.0       # queued 6 s on the clock
    assert st["slo_violations"] == 1
    assert set(st["service_ema_s"]) == {1}


def test_warmup_primes_service_estimates(tiny):
    g, plan, params = tiny
    eng = CNNServingEngine(g, params, plan, batch_size=2, warmup=True,
                           device="cpu")
    assert all(eng.service_estimate(b) > 0 for b in eng.buckets)
    assert eng.covering_bucket(2) == 2 and eng.covering_bucket(9) == 2


def test_submit_validates_requests(tiny):
    g, plan, params = tiny
    eng = CNNServingEngine(g, params, plan, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="image shape"):
        eng.submit(CNNRequest(rid=0, image=np.zeros((8, 8, 3))))
    eng.submit(CNNRequest(rid=1, image=_img(1)))
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(CNNRequest(rid=1, image=_img(1)))
    assert torch.is_tensor(eng._staging) and eng._staging.shape[0] == 2
