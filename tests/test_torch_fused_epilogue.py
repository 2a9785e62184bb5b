"""The fused-epilogue options of the port against the JAX package's on
the CPU: ``default_algo=`` (on ``forward``, ``compile_plan``, the engine
and ``tune_elision``) and ``avg_pool_via="overlay"``, the §3.4 AvgPool
run as a K×K conv on the im2col path (``layers.avg_pool``).

Tolerances: a pool against a pool, 1e-4 (the reference's f32 kernel
tolerance); whole plans, rtol 2e-2 / atol 2e-3 (``tests/test_system.py``).
On the CPU the port's im2col runs its plain version; the kernel itself
is held against the plain path on the card (``chip_smoke.py`` phase 24).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn import layers as JL
from repro.cnn.executor import compile_plan as jax_compile_plan
from repro.cnn.models import googlenet as jax_googlenet
from repro.cnn.models import inception_v4 as jax_inception_v4
from repro.core.algorithms import IM2COL as JAX_IM2COL
from repro.core.algorithms import KN2ROW as JAX_KN2ROW
from repro.core.autotune import Binding as JaxBinding
from repro.core.autotune import LayerTuning as JaxLayerTuning
from repro.core.autotune import TuningRecord as JaxTuningRecord
from repro.core.autotune import record_key as jax_record_key
from repro_torch.cnn import executor
from repro_torch.cnn import layers as L
from repro_torch.cnn.executor import (ExecutableCache, compile_plan,
                                      executable_cache_key, forward,
                                      init_params)
from repro_torch.cnn.models import googlenet, inception_v4
from repro_torch.core import autotune
from repro_torch.core.algorithms import IM2COL, KN2ROW
from repro_torch.core.autotune import (Binding, LayerTuning, TuningRecord,
                                       record_key)
from repro_torch.core.graph import LayerKind
from repro_torch.core.mapper import lower_plan
from repro_torch.serving.cnn_engine import CNNRequest, CNNServingEngine


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


POOL_TOL = dict(rtol=1e-4, atol=1e-4)
PLAN_TOL = dict(rtol=2e-2, atol=2e-3)
CPU = dict(device="cpu")
IV4 = dict(res=75, scale=0.25)          # blocks 4/7/3, the full depth


def rnd(*shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(builder, jax_builder, **kw):
    """(graph, reference graph, params, the same params for the
    reference) — the port's seeded ``init_params``, handed to the
    reference as arrays (its own init is the slow half of a CPU run)."""
    g, jg = builder(**kw), jax_builder(**kw)
    params = init_params(g, seed=0, **CPU)
    jparams = {nid: {k: jnp.asarray(v.numpy()) for k, v in layer.items()}
               for nid, layer in params.items()}
    return g, jg, params, jparams


@pytest.fixture(scope="module")
def reduced_googlenet():
    return _pair(googlenet, jax_googlenet, res=56, scale=0.25)


@pytest.fixture(scope="module")
def reduced_inception_v4():
    return _pair(inception_v4, jax_inception_v4, **IV4)


# -------------------------------------------------------- avg_pool overlay
@pytest.mark.parametrize("pool", [(3, 2), (3, 1), (2, 2)],
                         ids=["k3s2", "k3s1", "k2s2"])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_avg_pool_via_overlay(padding, pool):
    """§3.4: AvgPool as a K×K conv with 1/(K·K) channel-diagonal weights
    on the im2col path equals the reduce-window path, the SAME padding's
    valid-count division at the edges included, single and batched, and
    equals the reference's overlay pool."""
    k, stride = pool
    for shape in ((9, 9, 5), (2, 9, 9, 5)):
        x = rnd(*shape)
        want = L.avg_pool(torch.from_numpy(x), k, stride, padding)
        got = L.avg_pool(torch.from_numpy(x), k, stride, padding,
                         via="overlay")
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), **POOL_TOL)
        ref = JL.avg_pool(jnp.asarray(x), k, stride, padding, via="overlay")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **POOL_TOL)


def test_avg_pool_overlay_builds_its_constants_once():
    """The weight and the K²/n map are made once per shape and device and
    reused (a captured program binds their pointers), and the kernel
    path is refused on CPU tensors rather than run some other way."""
    x = torch.from_numpy(rnd(2, 9, 9, 5))
    L.avg_pool(x, 3, 1, "SAME", via="overlay")
    w = L._pool_weight(3, 5, torch.float32, x.device)
    scale = L._pool_rescale(9, 9, 3, 1, torch.float32, x.device)
    L.avg_pool(x, 3, 1, "SAME", via="overlay")
    assert L._pool_weight(3, 5, torch.float32, x.device) is w
    assert L._pool_rescale(9, 9, 3, 1, torch.float32, x.device) is scale
    assert float(scale[0, 0, 0]) == 9 / 4 and float(scale[4, 4, 0]) == 1.0
    with pytest.raises(ValueError, match="CUDA tensors"):
        L.avg_pool(x, 3, 1, "SAME", via="overlay", use_pallas=True)


def test_avg_pool_rejects_unknown_via():
    with pytest.raises(ValueError, match="via"):
        L.avg_pool(torch.from_numpy(rnd(8, 8, 3)), 2, 2, via="fpga")


def test_executor_avg_pool_via_overlay(reduced_googlenet):
    """GoogleNet has no POOL_AVG node, so the overlay option changes
    nothing there (as in the reference); the program still equals the
    reference's."""
    g, jg, params, jparams = reduced_googlenet
    assert not any(n.kind is LayerKind.POOL_AVG for n in g.nodes.values())
    x = rnd(56, 56, 3)
    via_overlay = compile_plan(g, avg_pool_via="overlay", **CPU)(params, x)
    via_jnp = compile_plan(g, **CPU)(params, x)
    assert torch.equal(via_overlay, via_jnp)
    want = jax_compile_plan(jg, avg_pool_via="overlay")(jparams, x)
    np.testing.assert_allclose(via_overlay.numpy(), np.asarray(want),
                               **PLAN_TOL)


def test_executor_avg_pool_via_overlay_inception_v4(reduced_inception_v4):
    """Reduced Inception-v4 (14 POOL_AVG nodes, 3×3 s1 SAME): the overlay
    program against the port's pooling program and against the
    reference's ``compile_plan(avg_pool_via="overlay")``."""
    g, jg, params, jparams = reduced_inception_v4
    pools = [n for n in g.nodes.values() if n.kind is LayerKind.POOL_AVG]
    assert len(pools) == 14
    x = rnd(2, 75, 75, 3)
    via_overlay = compile_plan(g, avg_pool_via="overlay", **CPU)(params, x)
    via_jnp = compile_plan(g, **CPU)(params, x)
    np.testing.assert_allclose(via_overlay.numpy(), via_jnp.numpy(),
                               **PLAN_TOL)
    want = jax_compile_plan(jg, avg_pool_via="overlay")(jparams, x)
    np.testing.assert_allclose(via_overlay.numpy(), np.asarray(want),
                               **PLAN_TOL)


# ------------------------------------------------------------ default_algo
def test_mixed_backend_compiled_plan_matches_reference_oracle(
        reduced_googlenet):
    """``default_algo=IM2COL`` with a tuning record cycling the backends
    per conv: the lowering binds each layer's backend, and the program
    equals the reference's mixed-backend program and its all-reference
    oracle. On the CPU the port runs the plain backends (a "pallas" layer
    on CPU tensors raises), so its record cycles "reference" and "lax"."""
    g, jg, params, jparams = reduced_googlenet
    three = ("pallas", "reference", "lax")
    jentries, entries, cpu_entries = {}, {}, {}
    for i, (node, jnode) in enumerate(zip(g.conv_nodes(),
                                          jg.conv_nodes())):
        jentries[jax_record_key(jnode.conv)] = JaxLayerTuning(
            binding=JaxBinding("im2col", "NS", 128, 128, three[i % 3]),
            measured_s=0.0, candidates=[])
        for table, backends in ((entries, three),
                                (cpu_entries, three[1:])):
            table[record_key(node.conv)] = LayerTuning(
                binding=Binding("im2col", "NS", 128, 128,
                                backends[i % len(backends)]),
                measured_s=0.0, candidates=[])
    lowering = lower_plan(g, None, default_algo=IM2COL,
                          tuning=TuningRecord(entries))
    assert {low.backend for low in lowering.values()} == set(three)
    record = TuningRecord(cpu_entries)
    with pytest.raises(ValueError, match="CUDA tensors"):
        compile_plan(g, default_algo=IM2COL, tuning=TuningRecord(entries),
                     **CPU)(params, rnd(2, 56, 56, 3))
    xb = rnd(2, 56, 56, 3)
    mixed = compile_plan(g, default_algo=IM2COL, tuning=record,
                         **CPU)(params, xb)
    want_mixed = jax_compile_plan(jg, default_algo=JAX_IM2COL,
                                  tuning=JaxTuningRecord(jentries),
                                  interpret=True)(jparams, xb)
    oracle = jax_compile_plan(jg, default_algo=JAX_IM2COL)(jparams, xb)
    for want in (want_mixed, oracle):
        np.testing.assert_allclose(mixed.numpy(), np.asarray(want),
                                   **PLAN_TOL)


def test_default_algo_kn2row_matches_reference(reduced_googlenet):
    """``plan=None`` with ``default_algo=KN2ROW``: every conv lowers to
    kn2row; the eager forward and the compiled program equal the
    reference's compiled kn2row program and the all-im2col program."""
    g, jg, params, jparams = reduced_googlenet
    lowering = lower_plan(g, None, default_algo=KN2ROW)
    assert {low.algo for low in lowering.values()} == {KN2ROW}
    x = rnd(2, 56, 56, 3)
    want = np.asarray(jax_compile_plan(jg, default_algo=JAX_KN2ROW)(jparams,
                                                                    x))
    got = forward(g, params, x, default_algo=KN2ROW, **CPU)
    np.testing.assert_allclose(got.numpy(), want, **PLAN_TOL)
    run = compile_plan(g, default_algo=KN2ROW, **CPU)
    assert {low.algo for low in run.lowering.values()} == {KN2ROW}
    np.testing.assert_allclose(run(params, x).numpy(), want, **PLAN_TOL)
    im2col = compile_plan(g, **CPU)(params, x)
    np.testing.assert_allclose(run(params, x).numpy(), im2col.numpy(),
                               **PLAN_TOL)


def test_options_key_the_cache(reduced_googlenet):
    """``default_algo`` (by its key) and ``avg_pool_via`` are part of a
    program's identity; equal options share one program."""
    g = reduced_googlenet[0]
    cache = ExecutableCache()
    a = compile_plan(g, cache=cache, **CPU)
    assert compile_plan(g, default_algo=IM2COL, avg_pool_via="jnp",
                        cache=cache, **CPU) is a
    assert compile_plan(g, default_algo=KN2ROW, cache=cache, **CPU) is not a
    assert compile_plan(g, avg_pool_via="overlay", cache=cache,
                        **CPU) is not a
    assert cache.stats()["entries"] == 3
    key = executable_cache_key(g, None, default_algo=KN2ROW,
                               avg_pool_via="overlay", **CPU)
    assert "kn2row" in key and "overlay" in key


def test_engine_default_algo_reaches_every_bucket(reduced_googlenet):
    """``CNNServingEngine(default_algo=KN2ROW)``: every bucket program and
    a swapped-in ladder lower every conv to kn2row, and served results
    equal the kn2row program's."""
    g, _, params, _ = reduced_googlenet
    eng = CNNServingEngine(g, params, None, batch_size=4,
                           default_algo=KN2ROW, **CPU)
    for run in eng._runs.values():
        assert {low.algo for low in run.lowering.values()} == {KN2ROW}
    eng.swap_plan(None)
    for run in eng._runs.values():
        assert {low.algo for low in run.lowering.values()} == {KN2ROW}
    imgs = [rnd(56, 56, 3, seed=s) for s in range(3)]
    for rid, img in enumerate(imgs):
        eng.submit(CNNRequest(rid=rid, image=img))
    done = eng.run_until_done()
    one = compile_plan(g, default_algo=KN2ROW, **CPU)
    for rid, img in enumerate(imgs):
        np.testing.assert_allclose(np.asarray(done[rid]),
                                   one(params, img[None])[0].numpy(),
                                   **PLAN_TOL)


def test_tune_elision_passes_default_algo(reduced_googlenet, monkeypatch):
    """``tune_elision(default_algo=...)`` compiles every measured program
    with it (None: IM2COL, as the reference)."""
    g, _, params, _ = reduced_googlenet
    seen = []
    real = executor.compile_plan

    def spy(*args, **kw):
        seen.append(kw["default_algo"])
        return real(*args, **kw)

    monkeypatch.setattr(executor, "compile_plan", spy)
    monkeypatch.setattr(autotune, "_program_s", lambda run, p, x, reps: 1.0)
    for algo, want in ((None, IM2COL), (KN2ROW, KN2ROW)):
        seen.clear()
        assert autotune.tune_elision(g, None, params=params, batch=2,
                                     default_algo=algo, **CPU) == {}
        assert seen and set(seen) == {want}
