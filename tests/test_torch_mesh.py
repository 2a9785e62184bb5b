"""The port's data-parallel mesh path against the reference's.

Twins of ``tests/test_sharded_serving.py`` on the same numpy inputs:

- the sharded bucket ladder against the reference's ``batch_buckets``;
- the mesh helpers (``launch.mesh``, ``distributed.sharding``);
- one-device meshes: the port's mesh-1 programs and engines against the
  reference's mesh-1 ones on its CPU, rtol 1e-4 / atol 1e-5, with
  ``stats()["sharding"]`` and ``last_tick`` equal to the reference's;
- the reference's 8-device cases, which it runs only under
  ``--xla_force_host_platform_device_count=8``, here on meshes that name
  the CPU 2, 4 or 8 times (``DataMesh``): each sharded output against the
  reference's *unsharded* program (the reference asserts its sharded one
  equals it) at rtol 1e-4 / atol 1e-5, the divisibility error, ladder
  validation, stale-slot zeroing, stats accounting and the per-chip
  tuning lookup (a spy on ``overlay.apply_conv``'s backends);
- the cache key (a mesh-1 program keys apart from the unsharded one) and
  tenants of one mesh sharing programs;
- per-shard captures, with the capture faked on the CPU;
- the supervisor's tuning refresh under a 2-shard mesh, which rescales
  the entries of the *sharded* bucket as the reference's does;
- ``tools/check_mesh.py`` (the real-card check) on CPU meshes.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.executor import compile_plan as jax_compile_plan
from repro.cnn.executor import forward as jax_forward
from repro.cnn.executor import init_params as jax_init_params
from repro.cnn.models import vgg16 as jax_vgg16
from repro.core.autotune import TuningRecord as JaxRecord
from repro.core.autotune import refresh_from_service as jax_refresh
from repro.distributed.sharding import data_axes as jax_data_axes
from repro.distributed.sharding import data_shard_count as jax_shard_count
from repro.launch.mesh import make_data_mesh as jax_make_data_mesh
from repro.serving.cnn_engine import CNNRequest as JaxRequest
from repro.serving.cnn_engine import CNNServingEngine as JaxEngine
from repro.serving.cnn_engine import batch_buckets as jax_batch_buckets
from repro_torch.bridge import params_from_jax
from repro_torch.cnn import executor, overlay
from repro_torch.cnn.executor import (ExecutableCache, ShardedProgram,
                                      _eval_graph, compile_plan,
                                      executable_cache_key, forward)
from repro_torch.cnn.models import vgg16
from repro_torch.core.autotune import (Binding, LayerTuning, TuningRecord,
                                       record_key)
from repro_torch.core.dse import identify_parameters
from repro_torch.core.mapper import map_network
from repro_torch.distributed.sharding import (data_axes, data_shard_count,
                                              replicate, shard_batch)
from repro_torch.launch.mesh import DataMesh, make_data_mesh
from repro_torch.serving.cnn_engine import (CNNRequest, CNNServingEngine,
                                            batch_buckets)
from repro_torch.serving.multi_engine import MultiModelEngine
from repro_torch.serving.supervisor import PlanSupervisor


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores, and
    torch's thread pool, oversubscribed, wakes slower than the small CPU
    ops it would split (on an eight-core host, a reduced GoogleNet's max
    pool took ~16 ms on eight threads, ~0.03 ms on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=1e-4, atol=1e-5)
PLAN_TOL = dict(rtol=2e-2, atol=2e-3)
CPU = dict(device="cpu")


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def cpu_mesh(n: int) -> DataMesh:
    """``n`` shards, every one on the CPU."""
    return DataMesh(("cpu",) * n)


@pytest.fixture(scope="module")
def tiny():
    """The reference's tiny VGG16 (8², scale 0.05) in both packages, one
    set of weights: (port graph, port params, reference graph, reference
    params)."""
    jg = jax_vgg16(res=8, scale=0.05)
    jparams = jax_init_params(jg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return vgg16(res=8, scale=0.05), params_from_jax(np_params, **CPU), \
        jg, jparams


def imgs(n, seed=23):
    return np.random.default_rng(seed).standard_normal(
        (n, 8, 8, 3)).astype(np.float32)


def submit_n(eng, n, start_rid=0, request_cls=CNNRequest, images=None):
    images = imgs(n, seed=100 + start_rid) if images is None else images
    reqs = [request_cls(rid=start_rid + i, image=img)
            for i, img in enumerate(images)]
    for r in reqs:
        eng.submit(r)
    return reqs


def jax_logits(tiny, image):
    _, _, jg, jparams = tiny
    return np.asarray(jax_forward(jg, jparams, jnp.asarray(image)))


# ------------------------------------------------------- the bucket ladder
def _ladder(fn, cap, shard):
    try:
        return fn(cap, shard)
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("cap", [8, 24])
@pytest.mark.parametrize("shard", range(1, 9))
def test_sharded_bucket_ladder_matches_reference(cap, shard):
    """Every (cap, shard) of the reference's ladder: the same buckets, or
    the same error."""
    assert _ladder(batch_buckets, cap, shard) == \
        _ladder(jax_batch_buckets, cap, shard)


@pytest.mark.parametrize("cap, shard, match", [
    (6, 4, "multiple"), (8, 0, "shard"), (0, 1, "max_batch")])
def test_sharded_bucket_ladder_errors(cap, shard, match):
    for fn in (batch_buckets, jax_batch_buckets):
        with pytest.raises(ValueError, match=match):
            fn(cap, shard)
    assert _ladder(batch_buckets, cap, shard) == \
        _ladder(jax_batch_buckets, cap, shard)


def test_sharded_bucket_ladder():
    assert batch_buckets(8) == batch_buckets(8, 1) == [1, 2, 4, 8]
    assert batch_buckets(8, 2) == [2, 4, 8]
    assert batch_buckets(8, 4) == [4, 8]
    assert batch_buckets(8, 8) == [8]
    assert batch_buckets(24, 4) == [4, 8, 16, 24]


# ------------------------------------------------------------ mesh helpers
def test_mesh_helpers():
    mesh = make_data_mesh(1, **CPU)
    jmesh = jax_make_data_mesh(1)
    assert mesh.axis_names == tuple(jmesh.axis_names) == ("data",)
    assert data_axes(mesh) == jax_data_axes(jmesh) == ("data",)
    assert data_shard_count(mesh) == jax_shard_count(jmesh) == 1
    assert mesh.devices == (torch.device("cpu", 0),)
    assert mesh.shape == {"data": 1} and mesh.size == 1
    assert make_data_mesh(**CPU) == mesh
    for n in (0, 2):
        with pytest.raises(ValueError, match="n_devices"):
            make_data_mesh(n, **CPU)
    with pytest.raises(ValueError, match="n_devices"):
        jax_make_data_mesh(jax.device_count() + 1)


def test_data_mesh_may_repeat_a_device():
    mesh = DataMesh(("cpu", "cpu:0", torch.device("cpu")))
    assert mesh.devices == (torch.device("cpu", 0),) * 3
    assert data_shard_count(mesh) == mesh.size == 3
    assert mesh.shape == {"data": 3}
    with pytest.raises(ValueError, match="at least one"):
        DataMesh(())
    with pytest.raises(ValueError, match="mix"):
        DataMesh(("cpu", "meta"))


def test_replicate_and_shard_batch(tiny):
    """Shards on one device share one params dict, whose tensors are the
    caller's when they already live there; the batch splits into views in
    shard order."""
    _, params, _, _ = tiny
    mesh = cpu_mesh(4)
    reps = replicate(params, mesh)
    assert len(reps) == 4 and all(r is reps[0] for r in reps)
    assert all(reps[0][n][k] is t for n, d in params.items()
               for k, t in d.items())
    x = torch.as_tensor(imgs(8))
    parts = shard_batch(x, mesh)
    assert [p.shape[0] for p in parts] == [2, 2, 2, 2]
    assert all(p.data_ptr() == x[2 * i].data_ptr()
               for i, p in enumerate(parts))
    assert torch.equal(torch.cat(shard_batch(imgs(8), mesh)), x)
    with pytest.raises(ValueError, match="batched"):
        shard_batch(x[0], mesh)
    with pytest.raises(ValueError, match="data shards"):
        shard_batch(x[:6], mesh)


# -------------------------------------------- one-device meshes, both sides
@pytest.mark.parametrize("bucket", [1, 2, 4])
def test_mesh1_compiled_plan_matches_reference(tiny, bucket):
    """The mesh-1 program against the reference's mesh-1 program, and bit
    for bit against the port's unsharded program."""
    g, params, jg, jparams = tiny
    run_m = compile_plan(g, None, mesh=make_data_mesh(1, **CPU), **CPU)
    run_s = compile_plan(g, None, **CPU)
    jrun_m = jax_compile_plan(jg, None, mesh=jax_make_data_mesh(1))
    assert isinstance(run_m, ShardedProgram)
    assert run_m.data_shards == jrun_m.data_shards == 1
    x = imgs(bucket, seed=bucket)
    got = run_m(params, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(jrun_m(jparams, x)),
                               **TOL)
    assert torch.equal(got, run_s(params, x))
    with pytest.raises(ValueError, match="batched"):
        run_m(params, x[0])                        # mesh mode needs (B,…)
    with pytest.raises(ValueError, match="batched"):
        jrun_m(jparams, x[0])


def _dispatch_trail(eng, request_cls, clock):
    """Three requests, one tick; then a padded tick of one."""
    clock.t = 1.0
    reqs = submit_n(eng, 3, request_cls=request_cls, images=imgs(3, seed=7))
    assert eng.step(now=1.0) == 3
    first = dict(eng.last_tick)
    clock.t = 2.0
    reqs += submit_n(eng, 1, start_rid=3, request_cls=request_cls,
                     images=imgs(1, seed=8))
    assert eng.step(now=2.0, flush=True) == 1
    return reqs, [first, dict(eng.last_tick)]


def test_mesh1_engine_serves_and_accounts(tiny):
    """The mesh-1 engine against the reference's: the ladder, the ticks'
    ``last_tick`` (but its measured ``wall_s``), ``stats()["sharding"]``
    and ``dispatches``, and every result at rtol 1e-4 / atol 1e-5."""
    g, params, jg, jparams = tiny
    clock, jclock = FakeClock(), FakeClock()
    eng = CNNServingEngine(g, params, None, batch_size=4, clock=clock,
                           mesh=make_data_mesh(1, **CPU), **CPU)
    jeng = JaxEngine(jg, jparams, None, batch_size=4, clock=jclock,
                     mesh=jax_make_data_mesh(1))
    assert eng.buckets == jeng.buckets == [1, 2, 4]
    assert eng.data_shards == jeng.data_shards == 1
    reqs, ticks = _dispatch_trail(eng, CNNRequest, clock)
    _, jticks = _dispatch_trail(jeng, JaxRequest, jclock)
    drop = lambda t: {k: v for k, v in t.items() if k != "wall_s"}
    assert [drop(t) for t in ticks] == [drop(t) for t in jticks]
    assert ticks[0]["per_chip_batch"] == 4 and ticks[1]["per_chip_batch"] == 1
    s, js = eng.stats(), jeng.stats()
    assert s["sharding"] == js["sharding"] == {
        "data_shards": 1, "mesh_devices": 1,
        "per_chip_batch": {1: 1, 2: 2, 4: 4}}
    assert s["dispatches"] == js["dispatches"]
    for r in reqs:
        np.testing.assert_allclose(eng.done[r.rid], jeng.done[r.rid], **TOL)
        np.testing.assert_allclose(eng.done[r.rid],
                                   jax_logits(tiny, r.image), **TOL)


def test_unsharded_engine_reports_its_bucket_per_chip(tiny):
    """An engine without a mesh reports the bucket as the per-chip batch
    and no sharding, as the reference's does."""
    g, params, jg, jparams = tiny
    clock, jclock = FakeClock(), FakeClock()
    eng = CNNServingEngine(g, params, None, batch_size=4, clock=clock, **CPU)
    jeng = JaxEngine(jg, jparams, None, batch_size=4, clock=jclock)
    _, ticks = _dispatch_trail(eng, CNNRequest, clock)
    _, jticks = _dispatch_trail(jeng, JaxRequest, jclock)
    drop = lambda t: {k: v for k, v in t.items() if k != "wall_s"}
    assert [drop(t) for t in ticks] == [drop(t) for t in jticks]
    assert eng.stats()["sharding"] is jeng.stats()["sharding"] is None


# ------------------------------------------- 2, 4 and 8 shards on the CPU
@pytest.mark.parametrize("devices", [2, 4, 8])
def test_sharded_outputs_match_single_device_per_bucket(tiny, devices):
    """Every bucket of the sharded ladder: the output against the
    reference's unsharded program at rtol 1e-4 / atol 1e-5, and each
    shard's rows bit for bit the port's unsharded program on that shard's
    slice."""
    g, params, jg, jparams = tiny
    mesh = cpu_mesh(devices)
    run_m = compile_plan(g, None, mesh=mesh, **CPU)
    run_s = compile_plan(g, None, **CPU)
    jrun_s = jax_compile_plan(jg, None)
    assert len(run_m.shards) == devices
    for bucket in batch_buckets(8, devices):
        x = imgs(bucket, seed=bucket)
        got = run_m(params, x)
        np.testing.assert_allclose(got.numpy(), np.asarray(jrun_s(jparams, x)),
                                   **TOL)
        per = bucket // devices
        for i in range(devices):
            rows = slice(i * per, (i + 1) * per)
            assert torch.equal(got[rows], run_s(params, x[rows]))


def test_sharded_batch_divisibility_rejected(tiny):
    g, params, _, _ = tiny
    run_m = compile_plan(g, None, mesh=cpu_mesh(4), **CPU)
    assert run_m.data_shards == 4
    with pytest.raises(ValueError, match="data shards"):
        run_m(params, imgs(6))                     # 6 % 4 != 0
    calls = []
    hooked = compile_plan(g, None, mesh=cpu_mesh(4), **CPU,
                          fault_hook=lambda: calls.append(1))
    assert hooked.data_shards == 4 and hooked.mesh == cpu_mesh(4)
    assert hooked(params, imgs(4)).shape[0] == 4 and calls == [1]


def test_mesh_must_match_the_device(tiny):
    g, params, _, _ = tiny
    meta = DataMesh(("meta",))
    with pytest.raises(ValueError, match="not of device"):
        compile_plan(g, None, mesh=meta, **CPU)
    with pytest.raises(ValueError, match="not of device"):
        CNNServingEngine(g, params, None, mesh=meta, **CPU)


def test_sharded_engine_ladder_and_bucket_validation(tiny):
    g, params, _, _ = tiny
    mesh = cpu_mesh(4)
    eng = CNNServingEngine(g, params, None, batch_size=8, mesh=mesh, **CPU)
    assert eng.buckets == [4, 8]
    assert eng.data_shards == 4
    with pytest.raises(ValueError, match="data-shard"):
        CNNServingEngine(g, params, None, buckets=(2, 8), mesh=mesh, **CPU)
    with pytest.raises(ValueError, match="multiple"):
        CNNServingEngine(g, params, None, batch_size=6, mesh=mesh, **CPU)


def test_sharded_stale_slot_zeroing_across_bucket_switches(tiny):
    """A bucket-8 tick then a padded bucket-4 tick: the smaller sharded
    dispatch must zero the slots the larger one staged."""
    g, params, _, _ = tiny
    eng = CNNServingEngine(g, params, None, batch_size=8, mesh=cpu_mesh(4),
                           **CPU)
    buf0 = eng._batch_buf
    reqs = submit_n(eng, 8)
    assert eng.step() == 8
    assert eng.last_tick["bucket"] == 8
    reqs += submit_n(eng, 2, start_rid=8)          # pads into bucket 4
    assert eng.step(flush=True) == 2
    assert eng.last_tick["bucket"] == 4
    assert eng.last_tick["per_chip_batch"] == 1
    assert eng._batch_buf is buf0                  # one staging buffer, ever
    np.testing.assert_array_equal(eng._batch_buf[2:], 0)
    for r in reqs:
        np.testing.assert_allclose(eng.done[r.rid], jax_logits(tiny, r.image),
                                   **TOL)


def test_sharded_engine_stats_accounting(tiny):
    g, params, _, _ = tiny
    eng = CNNServingEngine(g, params, None, batch_size=8, mesh=cpu_mesh(2),
                           **CPU)
    submit_n(eng, 5)
    assert eng.step(flush=True) == 5               # bucket 8 (covers 5)
    s = eng.stats()
    assert s["sharding"] == {"data_shards": 2, "mesh_devices": 2,
                             "per_chip_batch": {2: 1, 4: 2, 8: 4}}
    assert s["dispatches"] == {2: 0, 4: 0, 8: 1}
    assert s["served"] == 5 and s["window"] == 5
    assert set(s["service_ema_s"]) == {8}          # sharded wall time EMA
    for tr in eng.request_log:
        assert tr.bucket == 8


def test_sharded_pipelined_engine_matches_synchronous(tiny):
    """Depth 2 on a 2-shard mesh: the depth-1 engine's dispatches and
    results bit for bit, and the per-chip batch on the pipelined path's
    ``last_tick`` too."""
    g, params, _, _ = tiny
    engines = [CNNServingEngine(g, params, None, batch_size=8,
                                mesh=cpu_mesh(2), pipeline_depth=d, **CPU)
               for d in (1, 2)]
    trails = []
    for eng in engines:
        trail = []
        for start, n in ((0, 8), (8, 3), (11, 2)):
            submit_n(eng, n, start_rid=start)
            eng.step(flush=True)
            eng.drain()
            trail.append((eng.last_tick["bucket"],
                          eng.last_tick["per_chip_batch"]))
        trails.append(trail)
    assert trails[0] == trails[1] == [(8, 4), (4, 2), (2, 1)]
    sync, piped = engines
    assert sync.dispatches == piped.dispatches
    assert set(sync.done) == set(piped.done) == set(range(13))
    for rid in sync.done:
        assert np.array_equal(sync.done[rid], piped.done[rid])


def test_sharded_tuning_lookup_keys_off_per_chip_batch(tiny, monkeypatch):
    """With 4 data shards, bucket 4 runs per-chip batch 1 and bucket 8
    per-chip batch 2 — so a record tuned at per-chip buckets {1, 2} binds
    backend-distinct lowerings. The reference traces each bucket once; the
    port walks each bucket's lowering once per shard on the CPU."""
    g, params, _, _ = tiny
    entries = {}
    for node in g.conv_nodes():
        entries[record_key(node.conv, 1)] = LayerTuning(
            binding=Binding("im2col", "NS", 128, 128, "reference"),
            measured_s=1.0, candidates=[], batch=1)
        entries[record_key(node.conv, 2)] = LayerTuning(
            binding=Binding("im2col", "NS", 128, 128, "lax"),
            measured_s=1.0, candidates=[], batch=2)
    rec = TuningRecord(entries)
    seen = []
    real = overlay.apply_conv

    def spy(x, w, *a, **kw):
        seen.append(kw.get("backend"))
        return real(x, w, *a, **kw)

    monkeypatch.setattr(overlay, "apply_conv", spy)
    eng = CNNServingEngine(g, params, None, batch_size=8, tuning=rec,
                           mesh=cpu_mesh(4), **CPU)
    assert eng.buckets == [4, 8]
    reqs = submit_n(eng, 8)
    assert eng.step() == 8                         # bucket 8 → per-chip 2
    reqs += submit_n(eng, 4, start_rid=8)
    assert eng.step() == 4                         # bucket 4 → per-chip 1
    n_conv = len(g.conv_nodes())
    assert seen == ["lax"] * (4 * n_conv) + ["reference"] * (4 * n_conv)
    for r in reqs:
        np.testing.assert_allclose(eng.done[r.rid], jax_logits(tiny, r.image),
                                   **PLAN_TOL)


# ------------------------------------------------ cache key and tenants
def test_cache_key_mesh1_differs_from_unsharded(tiny):
    g, _, _, _ = tiny
    key = lambda mesh: executable_cache_key(g, None, mesh=mesh, **CPU)
    assert key(make_data_mesh(1, **CPU)) != key(None)
    assert key(make_data_mesh(1, **CPU)) == key(DataMesh(("cpu",)))
    assert key(cpu_mesh(2)) != key(cpu_mesh(4)) != key(cpu_mesh(1))
    cache = ExecutableCache()
    a = compile_plan(g, None, mesh=cpu_mesh(2), cache=cache, **CPU)
    b = compile_plan(g, None, mesh=cpu_mesh(2), cache=cache, **CPU)
    c = compile_plan(g, None, cache=cache, **CPU)
    assert a is b and a is not c
    assert cache.stats() == {"entries": 2, "hits": 1, "misses": 2}


def test_tenants_of_one_mesh_share_programs(tiny):
    """Two tenants on one 2-shard mesh: the second compiles nothing, every
    bucket program is one ``ShardedProgram``, and each tenant is served
    under its own weights."""
    g, params, jg, _ = tiny
    other = {n: {k: t * 0.5 for k, t in d.items()} for n, d in params.items()}
    multi = MultiModelEngine(clock=FakeClock())
    mesh = cpu_mesh(2)
    for name, p in (("a", params), ("b", other)):
        multi.register_model(name, g, p, None, batch_size=8, mesh=mesh, **CPU)
    ea, eb = multi.engines["a"], multi.engines["b"]
    assert ea.buckets == [2, 4, 8]
    assert multi.cache.stats() == {"entries": 3, "hits": 3, "misses": 3}
    for b in ea.buckets:
        assert ea._runs[b] is eb._runs[b]
        assert isinstance(ea._runs[b], ShardedProgram)
    images = imgs(5, seed=50)
    for name in ("a", "b"):
        for i, img in enumerate(images):
            multi.submit(name, CNNRequest(rid=i, image=img))
    done = multi.run_until_done()
    for name, p in (("a", params), ("b", other)):
        for i, img in enumerate(images):
            want = forward(g, p, img, epilogue="bias_relu", **CPU)
            np.testing.assert_allclose(done[name][i], want.numpy(), **TOL)


# ----------------------------------------- per-shard captures, faked
class _CpuGraph:
    """Stands in for a captured ``torch.cuda.CUDAGraph``: a replay walks
    the lowering on the CPU from the static input into the static
    output."""

    def __init__(self, g, lowering, params, use_pallas, avg_pool_via="jnp"):
        self.args = (g, lowering, params, use_pallas, avg_pool_via)
        self.replays = 0
        self.entry = None

    def replay(self):
        g, lowering, params, use_pallas, avg_pool_via = self.args
        self.replays += 1
        self.entry.static_out.copy_(_eval_graph(
            g, lowering, params, self.entry.static_in, use_pallas,
            avg_pool_via))


def test_each_shard_captures_on_its_own(tiny, monkeypatch):
    """Shards on one device hold a capture each: the first call walks every
    shard, the second captures every shard once and replays, the third
    replays; every output equals the eager forward."""
    g, params, _, _ = tiny
    made = []

    def fake_capture(graph, lowering, p, x, use_pallas, avg_pool_via):
        cg = _CpuGraph(graph, lowering, p, use_pallas, avg_pool_via)
        entry = executor._Capture(cg, x.clone(), torch.empty(0))
        cg.entry = entry
        entry.static_out = _eval_graph(graph, lowering, p, entry.static_in,
                                       use_pallas, avg_pool_via).mul_(0)
        made.append(entry)
        return entry

    monkeypatch.setattr(executor, "capture_forward", fake_capture)
    monkeypatch.setattr(executor, "_as_input",
                        lambda x, dev: torch.as_tensor(x,
                                                       dtype=torch.float32))
    run = compile_plan(g, None, mesh=cpu_mesh(2), **CPU)
    for shard in run.shards:                   # the card's path, faked
        shard.device = torch.device("cuda")
    xs = [imgs(4, seed=60 + s) for s in range(3)]
    want = [forward(g, params, x, **CPU) for x in xs]
    reps = replicate(params, run.mesh)
    assert torch.equal(run(reps, xs[0]), want[0]) and made == []
    assert torch.equal(run(reps, xs[1]), want[1]) and len(made) == 2
    assert torch.equal(run(reps, xs[2]), want[2]) and len(made) == 2
    assert [e.graph.replays for e in made] == [2, 2]
    assert made[0] is not made[1]
    for shard, entry in zip(run.shards, made):
        assert list(shard.captures.values()) == [entry]


# ------------------------------------------------ the supervisor's refresh
def test_supervisor_refresh_under_mesh_rescales_the_sharded_bucket(tiny):
    """The reference's supervisor hands ``refresh_from_service`` the
    engine's service EMAs keyed by the *sharded* bucket, while the record
    is keyed by the per-chip batch, so under 2 shards it rescales the
    entries of the wrong bucket. The port does the same: its record after
    one check equals the reference's ``refresh_from_service`` on the same
    record and EMAs, and the scales land on sharded buckets 2 and 4."""
    g, params, _, _ = tiny
    hw = identify_parameters(g, max_dim=512)
    plan = map_network(g, hw=hw)
    jg = tiny[2]
    entries = {}
    for bucket in (1, 2, 4):
        for node in g.conv_nodes():
            entries[record_key(node.conv, bucket)] = LayerTuning(
                binding=Binding("im2col", "NS", 128, 128, "reference"),
                measured_s=1e-4 * bucket, candidates=[("x", 2e-4 * bucket)],
                batch=bucket)
    rec = TuningRecord(entries)
    jrec = JaxRecord.from_json(rec.to_json())
    eng = CNNServingEngine(g, params, plan, batch_size=8, tuning=rec,
                           mesh=cpu_mesh(2), **CPU)
    assert eng.buckets == [2, 4, 8]
    emas = {2: 0.03, 4: 0.05, 8: 0.09}
    eng._svc.update(emas)
    sup = PlanSupervisor(eng, g, map_kwargs={"hw": hw}, settle_checks=0)
    sup._check()
    applied = jax_refresh(jrec, jg, emas, precisions={},
                          min_improvement=sup.hysteresis)
    assert sorted(sup.refresh_scales) == sorted(applied) == [2, 4]
    assert eng.tuning.to_json() == jrec.to_json()


def test_check_mesh_tool_runs_on_cpu_meshes(capsys):
    """The real-card mesh check, on meshes naming the CPU once and twice
    at a reduced GoogleNet: every check it makes passes."""
    path = Path(__file__).resolve().parents[1] / "tools" / "check_mesh.py"
    spec = importlib.util.spec_from_file_location("check_mesh", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu", "--virtual", "--res", "32",
                     "--scale", "0.125", "--cards", "1", "2"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith('{"ok": true')
