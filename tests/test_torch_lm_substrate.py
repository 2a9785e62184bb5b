"""The port's LM training substrate against the JAX package's on the CPU:
the optimizer (``optim/adamw.py``), the data pipeline
(``data/pipeline.py``), the checkpoint manager
(``checkpoint/manager.py``) and the fault-tolerance control plane
(``distributed/fault.py``). Twins of ``tests/test_substrate.py``'s
twelve substrate tests, each run on both packages with the same numpy
inputs and held to equal outputs.

Tolerances: AdamW's params, moments and metrics within 1e-6 in f32 (the
same arithmetic in the same order; XLA and torch may reduce the global
norm in another order); the schedule within 1e-7 relative; the int8
compression, the data, the checkpoints and the fault logic exactly."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_pipeline
from repro.distributed import fault as jax_fault
from repro.optim import adamw as jax_adamw
from repro_torch.bridge import opt_state_from_jax
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.distributed import fault
from repro_torch.distributed.sharding import (NamedSharding, PartitionSpec,
                                              replicated)
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.scan_util import tree_leaves
from repro_torch.optim import adamw


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


def _np(t) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _tree_np(tree):
    return [_np(t) for t in tree_leaves(tree)]


def _jax_np(tree):
    return [np.asarray(x).astype(np.float32)
            if np.asarray(x).dtype == ml_dtypes.bfloat16 else np.asarray(x)
            for x in jax.tree_util.tree_leaves(tree)]


# ---------------------------------------------------------------- optim
def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200, clip_norm=100.0)
    jcfg = jax_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    jparams = {"w": jnp.array([5.0, -3.0, 2.0])}
    state = adamw.init_opt_state(params, cfg)
    jstate = jax_adamw.init_opt_state(jparams, jcfg)
    for _ in range(200):
        params, state, _ = adamw.apply_updates(
            params, {"w": 2 * params["w"]}, state, cfg)
        jparams, jstate, _ = jax_adamw.apply_updates(
            jparams, {"w": 2 * jparams["w"]}, jstate, jcfg)
    assert float(torch.max(torch.abs(params["w"]))) < 0.15
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]),
                               rtol=1e-5, atol=1e-6)
    assert int(state.step) == int(jstate.step) == 200


def test_apply_updates_equals_the_references_over_five_steps():
    """Five AdamW steps on one mixed tree (a clipped step included): the
    params, ``m``, ``v`` and the metrics within 1e-6 of the reference's."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}, "e": ()}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                            clip_norm=2.0)
    jcfg = jax_adamw.AdamWConfig(**dataclasses.asdict(cfg))

    def draw(scale):
        return jax.tree.map(
            lambda s: np.asarray(rng.standard_normal(s) * scale,
                                 np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))

    p0 = draw(1.0)
    params = jax.tree.map(torch.from_numpy, p0)
    jparams = jax.tree.map(jnp.asarray, p0)
    state = adamw.init_opt_state(params, cfg)
    jstate = jax_adamw.init_opt_state(jparams, jcfg)
    for scale in (0.1, 3.0, 0.5, 1.0, 0.2):
        g = draw(scale)
        params, state, met = adamw.apply_updates(
            params, jax.tree.map(torch.from_numpy, g), state, cfg)
        jparams, jstate, jmet = jax_adamw.apply_updates(
            jparams, jax.tree.map(jnp.asarray, g), jstate, jcfg)
        for got, want in zip(_tree_np((params, state.m, state.v)),
                             _jax_np((jparams, jstate.m, jstate.v))):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-6, atol=1e-7)
        assert int(state.step) == int(jstate.step)
    assert float(met["grad_norm"]) != pytest.approx(float(met["lr"]))


def test_apply_updates_keeps_dtypes_and_the_inputs():
    """bf16 params come back bf16, ``m`` / ``v`` in ``state_dtype``, and the
    input trees are left as they were (the update is functional)."""
    cfg = adamw.AdamWConfig(state_dtype="bfloat16", warmup_steps=0)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = adamw.init_opt_state(params, cfg)
    new, new_state, _ = adamw.apply_updates(
        params, {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}, state,
        cfg)
    assert new["w"].dtype == torch.bfloat16
    assert new_state.m["w"].dtype == new_state.v["w"].dtype == torch.bfloat16
    assert new_state.step.dtype == torch.int32 and int(new_state.step) == 1
    assert torch.equal(params["w"], torch.ones(4, dtype=torch.bfloat16))
    assert int(state.step) == 0 and not state.m["w"].any()


def test_schedule_warmup_and_cosine():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_frac=0.1)
    jcfg = jax_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    assert float(adamw.schedule(torch.tensor(0, dtype=torch.int32), cfg)) \
        == pytest.approx(0.0)
    assert float(adamw.schedule(torch.tensor(10, dtype=torch.int32), cfg)) \
        == pytest.approx(1.0)
    assert float(adamw.schedule(torch.tensor(100, dtype=torch.int32), cfg)) \
        == pytest.approx(0.1, abs=1e-6)
    for step in (0, 3, 10, 11, 55, 99, 100, 130):
        got = float(adamw.schedule(torch.tensor(step, dtype=torch.int32),
                                   cfg))
        want = float(jax_adamw.schedule(jnp.int32(step), jcfg))
        assert got == pytest.approx(want, rel=1e-7, abs=1e-9), step


def test_grad_compression_error_feedback():
    """The reference's error-feedback bound, and every step's sent
    gradient and carried error equal to the reference's bit for bit."""
    rng = np.random.default_rng(0)
    g_np = rng.standard_normal(1000).astype(np.float32)
    g, jg = torch.from_numpy(g_np), jnp.asarray(g_np)
    err, jerr = torch.zeros_like(g), jnp.zeros_like(jg)
    total_true, total_sent = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(20):
        sent, err = adamw.compressed_grad(g, err)
        jsent, jerr = jax_adamw.compressed_grad(jg, jerr)
        np.testing.assert_array_equal(sent.numpy(), np.asarray(jsent))
        np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
        total_true += g
        total_sent += sent
    denom = float(torch.max(torch.abs(total_true)))
    assert float(torch.max(torch.abs(total_true - total_sent))) / denom \
        < 0.05
    q, scale = adamw.compress_int8(g)
    jq, jscale = jax_adamw.compress_int8(jg)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(
        adamw.decompress_int8(q, scale).numpy(),
        np.asarray(jax_adamw.decompress_int8(jq, jscale)))


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "internvl2-2b"])
def test_data_determinism_equals_the_references(arch):
    """Tokens (and a VLM's frontend embeddings) bit-equal to the
    reference's at several steps; deterministic per step, different
    across steps, in the vocabulary."""
    cfg = pipeline.DataConfig(seed=1, global_batch=8, seq_len=64)
    jcfg = jax_pipeline.DataConfig(**dataclasses.asdict(cfg))
    model = get_config(arch, reduced=True)
    jmodel = jax_get_config(arch, reduced=True)
    for step in (0, 3, 4, 17):
        b = pipeline.make_batch(cfg, model, step, device="cpu")
        jb = jax_pipeline.make_batch(jcfg, jmodel, step)
        assert set(b) == set(jb)
        assert b["tokens"].dtype == torch.long
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))
        if "frontend_embeds" in b:
            np.testing.assert_array_equal(b["frontend_embeds"].numpy(),
                                          np.asarray(jb["frontend_embeds"]))
    assert (arch == "internvl2-2b") == ("frontend_embeds" in b)
    b1 = pipeline.make_batch(cfg, model, step=3, device="cpu")
    b2 = pipeline.make_batch(cfg, model, step=3, device="cpu")
    b3 = pipeline.make_batch(cfg, model, step=4, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert int(b1["tokens"].max()) < model.vocab


def test_prefetch_iterator_orders_steps():
    cfg = pipeline.DataConfig(seed=0, global_batch=4, seq_len=32)
    model = get_config("mamba2-370m", reduced=True)
    it = pipeline.PrefetchIterator(cfg, model, start_step=5, depth=2,
                                   device="cpu")
    s1, b1 = next(it)
    s2, b2 = next(it)
    it.close()
    assert (s1, s2) == (5, 6)
    assert not it._thread.is_alive()
    for s, b in ((s1, b1), (s2, b2)):
        assert torch.equal(b["tokens"], pipeline.make_batch(
            cfg, model, s, device="cpu")["tokens"])


def test_sharded_batch_waits_for_the_lm_mesh():
    """The host-sharded batch on the LM smoke mesh (one rank: every row)
    against the reference's ``make_batch(mesh=)`` on its one-device mesh:
    the same tokens and frontend embeddings."""
    cfg = pipeline.DataConfig(seed=2, global_batch=2, seq_len=32)
    model = get_config("internvl2-2b", reduced=True)
    jax_batch = jax_pipeline.make_batch(
        cfg, jax_get_config("internvl2-2b", reduced=True), 4,
        jax.make_mesh((1, 1), ("data", "model")))
    make_smoke_mesh("cpu")
    try:
        mesh = make_smoke_mesh("cpu")
        got = pipeline.make_batch(cfg, model, 4, mesh=mesh)
        assert sorted(got) == sorted(jax_batch)
        for k, v in got.items():
            assert type(v).__name__ == "DTensor"
            np.testing.assert_array_equal(v.full_tensor().numpy(),
                                          np.asarray(jax_batch[k]))
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------------------ checkpoint
def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=2, async_write=False)
    tree = _tree()
    for step in (10, 20, 30):
        mgr.save(step, tree, extra={"step": step})
    assert mgr.all_steps() == [20, 30]           # keep_n=2 GC'd step 10
    assert not (tmp_path / "step_000000010").exists()
    like = {"a": torch.empty((2, 3), device="meta"),
            "b": {"c": torch.empty((4,), dtype=torch.bfloat16,
                                   device="meta")}}
    restored, extra = mgr.restore(like, device="cpu")
    assert extra["step"] == 30
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    restored, _ = mgr.restore(tree, step=20)
    assert torch.equal(restored["a"], tree["a"])
    mesh = make_smoke_mesh("cpu")        # restore onto the LM smoke mesh
    try:
        sh = {"a": NamedSharding(mesh, PartitionSpec("data", None)),
              "b": {"c": replicated(mesh)}}
        restored, _ = mgr.restore(like, shardings=sh)
        for got, want, s in ((restored["a"], tree["a"], sh["a"]),
                             (restored["b"]["c"], tree["b"]["c"],
                              sh["b"]["c"])):
            assert got.placements == s.placements
            assert torch.equal(got.full_tensor(), want)
    finally:
        torch.distributed.destroy_process_group()


def test_checkpoint_atomicity(tmp_path):
    """A half-written (uncommitted) checkpoint must be invisible."""
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(5, {"a": torch.zeros((2,))})
    (tmp_path / "step_000000007").mkdir()
    assert mgr.latest_step() == 5
    with pytest.raises(FileNotFoundError, match="no committed"):
        CheckpointManager(tmp_path / "empty").restore({"a": torch.zeros(2)})


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=True)
    tree = {"a": torch.arange(1000, dtype=torch.float32)}
    mgr.save(1, tree)
    tree["a"].add_(1.0)               # the host copy was taken in save
    mgr.wait()
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(tree)
    assert torch.equal(restored["a"], torch.arange(1000,
                                                   dtype=torch.float32))


def _jax_train_state():
    """The reference's (params, OptState) with bf16 and f32 leaves, after
    one update, so that every leaf is nonzero."""
    params = {"w": jnp.asarray(np.linspace(-1, 1, 12).reshape(3, 4),
                               jnp.bfloat16),
              "ln": {"scale": jnp.arange(1.0, 5.0, dtype=jnp.float32)},
              "emb": {"table": jnp.asarray(
                  np.random.default_rng(3).standard_normal((5, 2)),
                  jnp.bfloat16)}}
    cfg = jax_adamw.AdamWConfig(warmup_steps=0)
    state = jax_adamw.init_opt_state(params, cfg)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.25, params)
    return jax_adamw.apply_updates(params, grads, state, cfg)[:2]


def test_checkpoints_restore_across_the_packages(tmp_path):
    """A ``(params, OptState)`` checkpoint with bf16 leaves written by the
    reference restores in the port bit for bit, and one written by the
    port restores in the reference bit for bit; the two packages write
    the same manifest."""
    jparams, jstate = _jax_train_state()
    np_state = jax.tree.map(np.asarray, (jparams, jstate))
    from repro_torch.bridge import lm_params_from_jax
    params = lm_params_from_jax(np_state[0], "cpu")
    state = opt_state_from_jax(np_state[1], "cpu")
    assert isinstance(state, adamw.OptState)

    JaxCheckpointManager(tmp_path / "jax", async_write=False).save(
        7, (jparams, jstate), extra={"step": 7})
    (got_p, got_s), extra = CheckpointManager(tmp_path / "jax").restore(
        (params, state))
    assert extra == {"step": 7}
    assert isinstance(got_s, adamw.OptState)
    assert got_p["w"].dtype == torch.bfloat16
    assert got_s.step.dtype == torch.int32 and int(got_s.step) == 1
    for got, want in zip(tree_leaves((got_p, got_s)),
                         jax.tree_util.tree_leaves((jparams, jstate))):
        want = np.asarray(want)
        if want.dtype == ml_dtypes.bfloat16:
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)

    CheckpointManager(tmp_path / "torch", async_write=False).save(
        7, (params, state), extra={"step": 7})
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        (jparams, jstate))
    (jp, js), jextra = JaxCheckpointManager(tmp_path / "torch").restore(like)
    assert jextra == {"step": 7}
    for got, want in zip(jax.tree_util.tree_leaves((jp, js)),
                         jax.tree_util.tree_leaves((jparams, jstate))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(
            np.asarray(got).reshape(-1).view(np.uint8),
            np.asarray(want).reshape(-1).view(np.uint8))
    manifests = [json.loads((tmp_path / d / "step_000000007" /
                             "manifest.json").read_text())
                 for d in ("jax", "torch")]
    assert manifests[0] == manifests[1]
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())


# ----------------------------------------------------------------- fault
def test_health_tracker_failure_detection():
    ht = fault.HealthTracker(n_hosts=4, beat_interval_s=1.0, max_missed=3)
    jht = jax_fault.HealthTracker(n_hosts=4, beat_interval_s=1.0,
                                  max_missed=3)
    for t in range(1, 10):
        for h in (0, 1, 2):
            ht.beat(h, float(t))
            jht.beat(h, float(t))
        dead = ht.sweep(float(t))
        assert dead == jht.sweep(float(t))
        if t >= 3:
            assert 3 in dead or 3 not in ht.alive_hosts()
        assert [dataclasses.asdict(h) for h in ht.hosts.values()] == \
            [dataclasses.asdict(h) for h in jht.hosts.values()]
    assert ht.alive_hosts() == jht.alive_hosts() == [0, 1, 2]


def test_elastic_planner_preserves_model_axis():
    pl = fault.ElasticPlanner(devices_per_host=4, model_axis=16)
    jpl = jax_fault.ElasticPlanner(devices_per_host=4, model_axis=16)
    plan, _ = pl.plan(n_alive_hosts=64, global_batch=256)
    assert plan.model == 16 and plan.data == 16
    plan2, info2 = pl.plan(n_alive_hosts=60, global_batch=256)
    assert plan2.model == 16 and plan2.data == 8
    assert info2["dropped_devices"] == 240 - plan2.devices
    for hosts in (4, 5, 17, 60, 64, 100):
        for batch in (1, 8, 256):
            got, ginfo = pl.plan(n_alive_hosts=hosts, global_batch=batch)
            want, winfo = jpl.plan(n_alive_hosts=hosts, global_batch=batch)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.devices == want.devices and ginfo == winfo
    with pytest.raises(RuntimeError):
        pl.plan(n_alive_hosts=2, global_batch=256)


def test_straggler_monitor_flags_persistent_offender():
    sm = fault.StragglerMonitor(n_hosts=8, k=3.0, patience=2)
    jsm = jax_fault.StragglerMonitor(n_hosts=8, k=3.0, patience=2)
    base = {h: 1.0 for h in range(8)}
    rng = np.random.default_rng(2)
    rounds = [{**base, 5: 10.0}, {**base, 5: 12.0}, base,
              *({h: float(t) for h, t in enumerate(1 + rng.random(8))}
                for _ in range(6))]
    evicts = [sm.observe(r) for r in rounds]
    assert evicts == [jsm.observe(r) for r in rounds]
    assert evicts[:2] == [[], [5]]
    assert sm.offense == jsm.offense
    assert sm.offense[5] == 0


@pytest.mark.parametrize("crash_at, n_steps, every", [
    ((7,), 12, 5), ((3, 3, 9), 14, 4), ((0,), 3, 50)])
def test_run_with_retries_restores_and_completes(crash_at, n_steps, every):
    """Both supervisors on one failure schedule: the same steps run, in
    the same order, the same saves, the same stats; a schedule with more
    failures than ``max_restarts`` raises from both."""
    def drive(module):
        log, saves = [], []
        saved = {"step": 0}
        pending = list(crash_at)

        def save_fn(step):
            saved["step"] = step
            saves.append(step)

        def injector(step):
            if pending and step == pending[0]:
                pending.pop(0)
                raise RuntimeError("simulated node failure")

        stats = module.run_with_retries(
            log.append, save_fn, lambda: saved["step"], n_steps=n_steps,
            checkpoint_every=every, failure_injector=injector)
        return stats, log, saves

    got, want = drive(fault), drive(jax_fault)
    assert got == want
    assert got[0] == {"completed": n_steps, "restarts": len(crash_at)}
    if crash_at == (7,):
        log = got[1]
        assert log.count(5) == 2 and log.count(6) == 2 and log.count(7) == 1

    def always(step):
        raise RuntimeError("node lost for good")

    for module in (fault, jax_fault):
        with pytest.raises(RuntimeError, match="for good"):
            module.run_with_retries(lambda s: None, lambda s: None,
                                    lambda: 0, n_steps=3,
                                    failure_injector=always)
