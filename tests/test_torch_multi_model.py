"""The port's multi-tenant serving tier, on the CPU, against the
reference's.

Twins of the reference's ``tests/test_multi_model.py`` on the port, at its
size (``vgg16(res=8, scale=0.05)``, params from the reference's
``init_params`` through ``params_from_jax``): the shared-program cache
(``graph_hash`` equal to the reference's, ``executable_cache_key``,
``ExecutableCache`` — identical architectures share compiled programs,
differing ones never collide), the cross-model tuning-reuse helpers
(``TuningRecord.merge``, ``signature_coverage``) and
``serving.multi_engine.MultiModelEngine``: per-tenant outcome
conservation under joint serving, deadline-ordered tenant ticks, the
global queue cap rejecting into the owning tenant's ledger, the global
per-step wall budget and hot-swap isolation between tenants.

Parity: one scripted multi-tenant run — staggered arrivals, two SLOs, a
global queue cap and wall budget, a hot-swap of one tenant's plan —
goes through both packages' ``MultiModelEngine`` on one ``FakeClock``
with both engines' ``time`` module replaced by a ``FakeTime`` whose
``perf_counter`` moves only by the injected device delay, so every tick's
wall time is the same on both sides. Each joint step's ``last_step``
record, the tenant order it stepped, per-rid outcomes, ``stats()`` (the
cache block included) must be equal; results within rtol 2e-2 / atol
2e-3.
"""
import jax
import numpy as np
import pytest
import torch

from repro.cnn.executor import graph_hash as jax_graph_hash
from repro.cnn.executor import init_params as jax_init_params
from repro.cnn.models import vgg16 as jax_vgg16
from repro.core.autotune import Binding as JaxBinding
from repro.core.autotune import LayerTuning as JaxLayerTuning
from repro.core.autotune import TuningRecord as JaxTuningRecord
from repro.core.autotune import record_key as jax_record_key
from repro.core.autotune import signature_coverage as jax_coverage
from repro.core.cost_model import TransitionCalibration as JaxCalibration
from repro.core.dse import identify_parameters as jax_identify
from repro.core.mapper import map_network as jax_map_network
from repro.serving import cnn_engine as jax_engine_mod
from repro.serving.multi_engine import MultiModelEngine as JaxMulti
from repro_torch.bridge import params_from_jax
from repro_torch.cnn.executor import (ExecutableCache, compile_plan,
                                      executable_cache_key, forward,
                                      graph_hash)
from repro_torch.cnn.models import vgg16
from repro_torch.core.autotune import (Binding, LayerTuning, TuningRecord,
                                       record_key, signature_coverage)
from repro_torch.core.cost_model import TransitionCalibration
from repro_torch.core.dse import identify_parameters
from repro_torch.core.mapper import map_network, plan_fingerprint
from repro_torch.serving import cnn_engine as engine_mod
from repro_torch.serving.cnn_engine import (OUTCOME_REJECTED, CNNRequest,
                                            CNNServingEngine)
from repro_torch.serving.multi_engine import MultiModelEngine

RNG = np.random.default_rng(13)
PLAN_TOL = dict(rtol=2e-2, atol=2e-3)


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


class FakeTime:
    """Stands in for an engine module's ``time``: ``perf_counter`` moves
    only by what the engine sleeps, so a tick's measured wall time is
    exactly its injected device delay."""

    def __init__(self) -> None:
        self.t = 0.0

    def perf_counter(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += max(float(s), 0.0)

    monotonic = perf_counter


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread keeps a tiny forward at its ~1.5 ms when the
    suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_params(jg, seed):
    return jax.tree_util.tree_map(
        np.asarray, jax_init_params(jg, jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def tiny():
    """The port's graph and seed-0/seed-1 params (from the reference's
    ``init_params``), with the reference's graph and numpy params."""
    jg = jax_vgg16(res=8, scale=0.05)
    npa, npb = _np_params(jg, 0), _np_params(jg, 1)
    return (vgg16(res=8, scale=0.05), params_from_jax(npa, "cpu"),
            params_from_jax(npb, "cpu"), jg, npa, npb)


def img():
    return np.asarray(RNG.standard_normal((8, 8, 3)), np.float32)


def conserved(eng) -> bool:
    rb = eng.stats()["robustness"]
    return (sum(rb["outcomes"].values()) + rb["pending"]
            == eng.submitted_total)


# ---------------------------------------------------------------------------
# Graph hashing + the program cache.
# ---------------------------------------------------------------------------

class TestGraphHash:
    def test_independent_builds_hash_equal(self):
        assert graph_hash(vgg16(res=8, scale=0.05)) == \
            graph_hash(vgg16(res=8, scale=0.05)) == \
            jax_graph_hash(jax_vgg16(res=8, scale=0.05))

    def test_structural_difference_changes_hash(self):
        base = graph_hash(vgg16(res=8, scale=0.05))
        assert graph_hash(vgg16(res=8, scale=0.1)) != base     # widths
        assert graph_hash(vgg16(res=16, scale=0.05)) != base   # resolution
        assert graph_hash(vgg16(res=16, scale=0.05)) == \
            jax_graph_hash(jax_vgg16(res=16, scale=0.05))

    def test_cache_key_differs_for_differing_graphs(self, tiny):
        g = tiny[0]
        other = vgg16(res=8, scale=0.1)
        for bucket in (1, 2, 4):
            assert executable_cache_key(g, None, tuning_batch=bucket,
                                        device="cpu") != \
                executable_cache_key(other, None, tuning_batch=bucket,
                                     device="cpu")

    def test_cache_key_distinguishes_buckets_and_options(self, tiny):
        """Buckets and epilogues enter the key. Unlike the reference's,
        donation does not: it changes nothing on the card, so a pipelined
        and a synchronous engine share one program (and its captures)."""
        g = tiny[0]
        k = executable_cache_key(g, None, tuning_batch=2, device="cpu")
        assert executable_cache_key(g, None, tuning_batch=4,
                                    device="cpu") != k
        assert executable_cache_key(g, None, tuning_batch=2,
                                    epilogue="relu", device="cpu") != \
            executable_cache_key(g, None, tuning_batch=2,
                                 epilogue="bias_relu", device="cpu")
        cache = ExecutableCache()
        assert compile_plan(g, None, tuning_batch=2, donate=True,
                            cache=cache, device="cpu") is \
            compile_plan(g, None, tuning_batch=2, cache=cache, device="cpu")


class TestExecutableCache:
    def test_identical_graphs_share_executable(self, tiny):
        g = tiny[0]
        cache = ExecutableCache()
        g2 = vgg16(res=8, scale=0.05)        # independent build, same arch
        r1 = compile_plan(g, None, cache=cache, device="cpu")
        r2 = compile_plan(g2, None, cache=cache, device="cpu")
        assert r1 is r2
        assert cache.stats() == {"entries": 1, "hits": 1, "misses": 1}

    def test_shared_executable_private_params(self, tiny):
        g, pa, pb = tiny[:3]
        cache = ExecutableCache()
        run = compile_plan(g, None, cache=cache, device="cpu")
        x = img()[None]
        ya, yb = run(pa, x).numpy(), run(pb, x).numpy()
        assert not np.allclose(ya, yb)       # params are call args
        np.testing.assert_allclose(
            ya, forward(g, pa, x, device="cpu").numpy(), rtol=1e-4,
            atol=1e-4)

    def test_differing_graphs_get_separate_entries(self, tiny):
        g = tiny[0]
        cache = ExecutableCache()
        compile_plan(g, None, cache=cache, device="cpu")
        compile_plan(vgg16(res=8, scale=0.1), None, cache=cache,
                     device="cpu")
        assert len(cache) == 2
        assert cache.misses == 2 and cache.hits == 0

    def test_engines_share_bucket_ladder_through_cache(self, tiny):
        g, pa, pb = tiny[:3]
        cache = ExecutableCache()
        ea = CNNServingEngine(g, pa, None, batch_size=4, cache=cache,
                              device="cpu")
        misses_after_a = cache.misses
        eb = CNNServingEngine(vgg16(res=8, scale=0.05), pb, None,
                              batch_size=4, cache=cache, device="cpu")
        assert cache.misses == misses_after_a    # B compiled nothing
        assert cache.hits >= len(ea.buckets)
        for b in ea.buckets:
            assert ea._runs[b] is eb._runs[b]


# ---------------------------------------------------------------------------
# Cross-model tuning reuse.
# ---------------------------------------------------------------------------

def _entry(conv, bucket, measured_s=1e-3, binding=Binding,
           layer_tuning=LayerTuning, key=record_key):
    b = binding("im2col", "NS", 64, 64, "reference")
    return key(conv, bucket), layer_tuning(b, measured_s, [], batch=bucket)


class TestTuningReuse:
    def test_signature_coverage_partition(self, tiny):
        g, jg = tiny[0], tiny[3]
        conv = next(iter(g.conv_nodes())).conv
        key, ent = _entry(conv, 2)
        rec = TuningRecord({key: ent})
        cov = signature_coverage(g, rec, buckets=(2, 4))
        assert cov["exact"] == [key]
        assert cov["fallback"] == [record_key(conv, 4)]
        assert cov["missing"]
        total = sum(len(v) for v in cov.values())
        assert total == len({record_key(n.conv, b)
                             for n in g.conv_nodes() for b in (2, 4)})
        jconv = next(iter(jg.conv_nodes())).conv
        jkey, jent = _entry(jconv, 2, binding=JaxBinding,
                            layer_tuning=JaxLayerTuning, key=jax_record_key)
        assert jkey == key
        assert cov == jax_coverage(jg, JaxTuningRecord({jkey: jent}),
                                   buckets=(2, 4))

    def test_identical_signatures_same_key(self):
        c1 = next(iter(vgg16(res=8, scale=0.05).conv_nodes())).conv
        c2 = next(iter(vgg16(res=8, scale=0.05).conv_nodes())).conv
        assert record_key(c1, 4) == record_key(c2, 4)

    def test_merge_keeps_incumbents_adopts_new(self, tiny):
        g = tiny[0]
        convs = [n.conv for n in g.conv_nodes()]
        k0, e0 = _entry(convs[0], 2, measured_s=1e-3)
        mine = TuningRecord({k0: e0}, meta={"buckets": [2]})
        k0b, e0b = _entry(convs[0], 2, measured_s=9e-3)
        k1, e1 = _entry(convs[-1], 4, measured_s=2e-3)
        theirs = TuningRecord({k0b: e0b, k1: e1},
                              meta={"buckets": [2, 4], "backend": "cpu"})
        assert mine.merge(theirs) == 1
        assert mine.entries[k0].measured_s == 1e-3   # incumbent kept
        assert mine.entries[k1].measured_s == 2e-3   # challenger adopted
        assert mine.meta["buckets"] == [2, 4]
        assert mine.meta["backend"] == "cpu"


# ---------------------------------------------------------------------------
# MultiModelEngine.
# ---------------------------------------------------------------------------

def _multi(tiny, clock=None, **kw):
    g, pa, pb = tiny[:3]
    multi = MultiModelEngine(clock=clock or FakeClock(), **kw)
    multi.register_model("a", g, pa, None, batch_size=4, device="cpu")
    multi.register_model("b", g, pb, None, batch_size=4, device="cpu")
    return multi, pa, pb


class TestMultiModelEngine:
    def test_joint_serving_conserves_and_isolates(self, tiny):
        g = tiny[0]
        multi, pa, pb = _multi(tiny)
        imgs = {n: [img() for _ in range(3)] for n in ("a", "b")}
        for name in ("a", "b"):
            for i, im in enumerate(imgs[name]):
                assert multi.submit(name, CNNRequest(
                    rid=i, image=im, t_submit=0.0)) == "queued"
        done = multi.run_until_done()
        for name, params in (("a", pa), ("b", pb)):
            assert sorted(done[name]) == [0, 1, 2]
            assert conserved(multi.engines[name])
            ref = forward(g, params, imgs[name][0][None], device="cpu")
            np.testing.assert_allclose(done[name][0], ref[0].numpy(),
                                       rtol=1e-4, atol=1e-4)

    def test_registration_shares_cache(self, tiny):
        multi, *_ = _multi(tiny)
        st = multi.stats()
        assert st["cache"]["hits"] >= len(multi.engines["a"].buckets)
        assert st["cache"]["entries"] == len(multi.engines["a"].buckets)
        assert st["global"]["models"] == 2

    def test_deadline_order_across_tenants(self, tiny):
        clk = FakeClock()
        multi, *_ = _multi(tiny, clock=clk)
        multi.engines["a"].slo_s = 1.0
        multi.engines["b"].slo_s = 0.1     # tighter SLO: due first
        multi.submit("a", CNNRequest(rid=0, image=img(), t_submit=0.0))
        multi.submit("b", CNNRequest(rid=0, image=img(), t_submit=0.0))
        assert multi.engines["b"].oldest_deadline() < \
            multi.engines["a"].oldest_deadline()
        assert multi._deadline_rank(5.0) == ["b", "a"]
        multi.step(now=5.0, flush=True)
        tb = multi.engines["b"].request_log[-1]
        ta = multi.engines["a"].request_log[-1]
        assert tb.t_dispatch <= ta.t_dispatch

    def test_global_queue_cap_rejects_into_tenant_ledger(self, tiny):
        multi, *_ = _multi(tiny, global_max_queue=2)
        assert multi.submit("a", CNNRequest(
            rid=0, image=img(), t_submit=0.0)) == "queued"
        assert multi.submit("b", CNNRequest(
            rid=0, image=img(), t_submit=0.0)) == "queued"
        verdict = multi.submit("a", CNNRequest(
            rid=1, image=img(), t_submit=0.0))
        assert verdict == OUTCOME_REJECTED
        ea = multi.engines["a"]
        assert ea.submitted_total == 2 and ea.rejected_total == 1
        assert ea.request_log[-1].outcome == OUTCOME_REJECTED
        multi.run_until_done()
        assert all(conserved(e) for e in multi.engines.values())

    def test_global_budget_limits_ticks_per_step(self, tiny):
        multi, *_ = _multi(tiny, global_budget_s=1e-12)
        for name in ("a", "b"):
            multi.engines[name]._warmup()   # prime service estimates
            multi.submit(name, CNNRequest(rid=0, image=img(),
                                          t_submit=0.0))
        multi.step(now=5.0)
        assert multi.last_step["ticks"] == 1
        assert len(multi.last_step["skipped"]) == 1
        multi.step(now=5.0)
        assert multi.last_step["ticks"] == 1
        assert multi.queued_total() == 0
        assert all(conserved(e) for e in multi.engines.values())

    def test_flush_ignores_budget(self, tiny):
        multi, *_ = _multi(tiny, global_budget_s=1e-12)
        for name in ("a", "b"):
            multi.submit(name, CNNRequest(rid=0, image=img(),
                                          t_submit=0.0))
        multi.step(now=5.0, flush=True)
        assert multi.last_step["ticks"] == 2
        assert multi.last_step["skipped"] == ()

    def test_duplicate_registration_raises(self, tiny):
        g, params = tiny[:2]
        multi = MultiModelEngine(clock=FakeClock())
        multi.register_model("a", g, params, None, batch_size=4,
                             device="cpu")
        with pytest.raises(ValueError, match="already registered"):
            multi.register_model("a", g, params, None, batch_size=4,
                                 device="cpu")

    def test_reserved_kwargs_and_pipelining_rejected(self, tiny):
        g, params = tiny[:2]
        multi = MultiModelEngine(clock=FakeClock())
        with pytest.raises(ValueError, match="clock"):
            multi.register_model("a", g, params, None, clock=FakeClock(),
                                 device="cpu")
        with pytest.raises(ValueError, match="cache"):
            multi.register_model("a", g, params, None,
                                 cache=ExecutableCache(), device="cpu")
        with pytest.raises(ValueError, match="pipeline_depth"):
            multi.register_model("a", g, params, None, pipeline_depth=2,
                                 device="cpu")
        assert multi.model_names() == []

    def test_unknown_model_raises(self, tiny):
        g, params = tiny[:2]
        multi = MultiModelEngine(clock=FakeClock())
        multi.register_model("a", g, params, None, batch_size=4,
                             device="cpu")
        with pytest.raises(KeyError, match="unknown model"):
            multi.submit("nope", CNNRequest(rid=0, image=img()))

    def test_stats_schema(self, tiny):
        multi, *_ = _multi(tiny)
        multi.submit("a", CNNRequest(rid=0, image=img(), t_submit=0.0))
        multi.run_until_done()
        st = multi.stats()
        assert set(st) == {"models", "cache", "global"}
        assert set(st["models"]) == {"a", "b"}
        assert st["models"]["a"]["submitted"] == 1
        assert "robustness" in st["models"]["a"]
        assert st["global"]["submitted"] == 1
        assert st["global"]["queued"] == 0

    def test_swap_isolation_across_tenants(self, tiny):
        """Hot-swapping tenant a's plan evicts none of b's programs (the
        shared cache never evicts — a swap only adds) and leaves b's
        ladder, ledger, estimates, queue and results as they were; b's
        later results equal a solo engine's bit for bit."""
        g, pa, pb = tiny[:3]
        hw = identify_parameters(g)
        plan_a = map_network(g, hw=hw, use_on_chip=False)
        plan_b = map_network(g, hw=hw, use_on_chip=False,
                             calibration=TransitionCalibration(default=6.0))
        assert plan_fingerprint(plan_a) != plan_fingerprint(plan_b)
        multi = MultiModelEngine(clock=FakeClock())
        multi.register_model("a", g, pa, plan_a, batch_size=4, device="cpu")
        multi.register_model("b", g, pb, plan_a, batch_size=4, device="cpu")
        images = [img() for _ in range(8)]
        for name in ("a", "b"):
            for i in range(4):
                multi.submit(name, CNNRequest(rid=i, image=images[i],
                                              t_submit=0.0))
        multi.step(now=1.0, flush=True)

        eng_b = multi.engines["b"]
        b_runs = eng_b._runs
        b_ledger = dict(eng_b.stats()["robustness"]["outcomes"])
        b_emas = dict(eng_b._svc)
        b_done = {r: v.copy() for r, v in eng_b.done.items()}
        cache_entries = multi.cache.stats()["entries"]

        old = multi.swap_plan("a", plan_b)
        assert plan_fingerprint(old[0]) == plan_fingerprint(plan_a)
        assert plan_fingerprint(multi.engines["a"].plan) == \
            plan_fingerprint(plan_b)
        assert eng_b._runs is b_runs
        assert plan_fingerprint(eng_b.plan) == plan_fingerprint(plan_a)
        assert dict(eng_b.stats()["robustness"]["outcomes"]) == b_ledger
        assert dict(eng_b._svc) == b_emas
        assert set(eng_b.done) == set(b_done) and all(
            np.array_equal(eng_b.done[r], v) for r, v in b_done.items())
        assert multi.cache.stats()["entries"] >= cache_entries
        assert multi.engines["a"].stats()["plan"]["swaps"] == 1
        assert eng_b.stats()["plan"]["swaps"] == 0

        for name in ("a", "b"):
            for i in range(4, 8):
                multi.submit(name, CNNRequest(rid=i, image=images[i],
                                              t_submit=2.0))
        multi.run_until_done()
        assert all(conserved(e) for e in multi.engines.values())
        assert set(multi.engines["a"].done) == set(range(8))
        assert set(eng_b.done) == set(range(8))
        solo = CNNServingEngine(g, pb, plan_a, batch_size=4,
                                clock=FakeClock(), device="cpu")
        for i, image in enumerate(images):
            solo.submit(CNNRequest(rid=i, image=image, t_submit=0.0))
        solo.run_until_done()
        assert all(np.array_equal(eng_b.done[r], solo.done[r])
                   for r in range(8))

        with pytest.raises(KeyError, match="unknown model"):
            multi.swap_plan("nope", plan_b)


# ---------------------------------------------------------------------------
# Parity: one scripted multi-tenant run on both packages.
# ---------------------------------------------------------------------------

# (clock time, tenant, requests) arrivals, then steps at these clock times.
ARRIVALS = [(0.0, "a", 3), (0.0, "b", 2), (0.05, "c", 4), (0.1, "b", 6),
            (0.3, "a", 5), (0.3, "c", 1), (0.35, "b", 4), (0.6, "a", 2),
            (0.6, "b", 2), (0.6, "c", 3)]
STEP_AT = [0.0, 0.05, 0.12, 0.2, 0.3, 0.36, 0.5, 0.6, 0.61, 0.9, 1.5, 2.0,
           3.0]
SWAP_AT = 0.3          # tenant a swaps to plan B before this step


def _joint_script(multi, request, plan_b, images):
    """Serve ``ARRIVALS`` through ``multi`` stepping at ``STEP_AT`` (a swap
    of tenant a before the step at ``SWAP_AT``), then flush; returns the
    submit verdicts and each step's (tenant order, last_step)."""
    verdicts, steps, k, rid = [], [], 0, {}
    for now in STEP_AT:
        while k < len(ARRIVALS) and ARRIVALS[k][0] <= now:
            t, name, n = ARRIVALS[k]
            for _ in range(n):
                r = rid.get(name, 0)
                rid[name] = r + 1
                verdicts.append(multi.submit(name, request(
                    rid=r, image=images[(name, r)], t_submit=t)))
            k += 1
        if now == SWAP_AT:
            multi.swap_plan("a", plan_b)
        order = multi._deadline_rank(now)
        multi.step(now=now)
        steps.append((order, dict(multi.last_step)))
    multi.run_until_done()
    return verdicts, steps


@pytest.mark.parametrize("budget", [None, 0.008])
def test_multi_engine_matches_reference(tiny, budget, monkeypatch):
    """Three tenants (a and b one architecture on seed-0 and seed-1
    params, c a wider VGG16), SLOs 0.2 / 0.5 / 0.1 s, 5 ms of injected
    device time per tick, a global queue cap of 10 (and an 8 ms wall
    budget per joint step): every step's tenant order and ``last_step``
    record, every submit verdict, per-rid outcomes, the per-tenant and
    global stats and the cache's counters equal the reference's."""
    monkeypatch.setattr(engine_mod, "time", FakeTime())
    monkeypatch.setattr(jax_engine_mod, "time", FakeTime())
    g, pa, pb, jg, npa, npb = tiny
    gc, jgc = vgg16(res=8, scale=0.1), jax_vgg16(res=8, scale=0.1)
    npc = _np_params(jgc, 2)
    rng = np.random.default_rng(4)
    images = {(name, r): rng.standard_normal((8, 8, 3)).astype(np.float32)
              for name in "abc" for r in range(16)}
    slo = {"a": 0.2, "b": 0.5, "c": 0.1}
    plan_b = map_network(g, hw=identify_parameters(g), use_on_chip=False,
                         calibration=TransitionCalibration(default=6.0))
    jplan_b = jax_map_network(jg, hw=jax_identify(jg), use_on_chip=False,
                              calibration=JaxCalibration(default=6.0))
    sides = []
    for multi_cls, graphs, params, request, pb_, kw in (
            (MultiModelEngine, (g, g, gc),
             (pa, pb, params_from_jax(npc, "cpu")), CNNRequest, plan_b,
             dict(device="cpu")),
            (JaxMulti, (jg, jg, jgc), (npa, npb, npc),
             jax_engine_mod.CNNRequest, jplan_b, {})):
        multi = multi_cls(clock=FakeClock(), global_max_queue=10,
                          global_budget_s=budget)
        for name, graph, p in zip("abc", graphs, params):
            eng = multi.register_model(name, graph, p, None, batch_size=4,
                                       slo_s=slo[name], **kw)
            eng.device_delay_s = 0.005
        sides.append((multi, _joint_script(multi, request, pb_, images)))
    (ours, (verdicts, steps)), (ref, (rverdicts, rsteps)) = sides
    assert verdicts == rverdicts and OUTCOME_REJECTED in verdicts
    assert steps == rsteps
    assert any(len(order) == 3 and len(set(order)) == 3
               for order, _ in steps)
    if budget is not None:
        assert any(st["skipped"] for _, st in steps)
    st, rst = ours.stats(), ref.stats()
    assert st["global"] == rst["global"]
    assert st["cache"] == rst["cache"]
    for name in "abc":
        e, r = ours.engines[name], ref.engines[name]
        log = [(t.rid, t.bucket, t.t_submit, t.t_dispatch, t.t_done,
                t.outcome) for t in e.request_log]
        assert log == [(t.rid, t.bucket, t.t_submit, t.t_dispatch, t.t_done,
                        t.outcome) for t in r.request_log]
        assert st["models"][name]["robustness"] == \
            rst["models"][name]["robustness"]
        assert st["models"][name]["plan"] == rst["models"][name]["plan"]
        assert st["models"][name]["dispatches"] == \
            rst["models"][name]["dispatches"]
        assert conserved(e)
        assert sorted(e.done) == sorted(r.done)
        for rid in e.done:
            np.testing.assert_allclose(e.done[rid], np.asarray(r.done[rid]),
                                       **PLAN_TOL)
    assert ours.engines["a"].stats()["plan"]["swaps"] == 1
