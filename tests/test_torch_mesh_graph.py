"""The train step compiled on an LM mesh (``launch.steps.compile_train_step``
on ``DTensor`` params, optimizer state and batch: the counterpart of the
reference's ``jax.jit(train_step, in_shardings=..., out_shardings=...,
donate_argnums=(0, 1))``) on the CPU's smoke mesh, a world-1 gloo group
each test starts and destroys, at the reduced configs in f32.

The CPU cannot capture, so every call runs the body a card's graph
records eagerly; the tests hold that body:

* three calls equal three eager sharded ``train_step`` calls bit for bit
  (params, ``m``, ``v``, ``step`` and every metric) for GQA
  (h2o-danube-1.8b), SSD (mamba2-370m, ``batch_local``) and MLA + MoE
  (deepseek-v2-236b) at one and two microbatches, and h2o under
  ``REPRO_ATTN_SHARD=heads``;
* the owned leaves keep their placements and their local shards'
  addresses, the batch buffers and accumulators are ``DTensor``s placed
  as the batch and the params, the metrics come back whole;
* ``load_state`` from a sharded ``CheckpointManager.restore`` gives the
  same next step;
* a batch of other placements or shapes, a plain batch, a tree that mixes
  ``DTensor`` and plain leaves and a plain tree of another shape into
  ``load_state`` raise (a plain tree of the right shapes is a host tree,
  of which each rank loads its shards: the driver's restore);
* one case per architecture family against the JAX package's own
  unsharded jitted ``train_step`` on the same weights
  (``bridge.lm_params_from_jax``) and batch, at
  ``tests/test_torch_lm_train.py``'s tolerances;
* ``mesh_check.compiled_check`` passes, and catches a compiled step whose
  update is wrong.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro_torch.bridge import lm_params_from_jax, opt_state_from_jax
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.distributed import api, sharding
from repro_torch.launch import mesh_check, steps
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import attention
from repro_torch.models import model as M
from repro_torch.models.scan_util import (tree_leaves,
                                          tree_leaves_with_path,
                                          tree_unflatten)
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


ROUTING_MARGIN = 2e-3


@pytest.fixture
def smoke():
    """The smoke mesh on a world-1 gloo group, torn down afterwards."""
    assert not dist.is_initialized()
    mesh = make_smoke_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def setup(name: str):
    """(f32 reduced config, optimizer config, params, OptState), as
    ``tests/test_torch_train_graph.py`` sets them: warm-up after two
    steps at lr 1e-3."""
    cfg = dataclasses.replace(get_config(name, reduced=True),
                              dtype="float32")
    opt = dataclasses.replace(steps.make_opt_config(cfg, total_steps=20),
                              warmup_steps=2, lr=1e-3)
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, opt, params, adamw.init_opt_state(params, opt)


def placed(mesh, params, state):
    """Copies of (params, state) on ``mesh`` (the rules' placements): a
    one-rank DTensor may share storage with the tensor it came from."""
    tree = (params, state)
    return sharding.distribute(
        tree_unflatten(tree, [t.clone() for t in tree_leaves(tree)]),
        (sharding.params_shardings(params, mesh),
         sharding.params_shardings(state, mesh)))


def batch_at(cfg, mesh, step: int, b: int = 4, s: int = 32):
    return make_batch(DataConfig(seed=1, global_batch=b, seq_len=s), cfg,
                      step, mesh=mesh)


def compiled(mesh, cfg, opt, params, state, microbatches=2, b=4):
    with api.activation_policy(api.policy_from_mesh(mesh)):
        return steps.compile_train_step(
            *placed(mesh, params, state), batch_at(cfg, mesh, 0, b=b),
            cfg=cfg, opt_cfg=opt, microbatches=microbatches)


def eager(mesh, p, s, batch, cfg, opt, microbatches=2):
    with api.activation_policy(api.policy_from_mesh(mesh)):
        return steps.train_step(p, s, batch, cfg=cfg, opt_cfg=opt,
                                microbatches=microbatches)


def assert_same(got, want):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.placements == b.placements
        a, b = a.full_tensor(), b.full_tensor()
        assert a.dtype == b.dtype and torch.equal(a, b)


def assert_same_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        assert not api.is_sharded(got[k]) and torch.equal(got[k], want[k]), k


def layout(step):
    """(placements, local shard address) of every owned leaf."""
    return [(t.placements, t.to_local().data_ptr())
            for t in tree_leaves((step.params, step.opt_state))]


@pytest.mark.parametrize("name, microbatches, strategy", [
    ("h2o-danube-1.8b", 1, "seq"), ("h2o-danube-1.8b", 2, "seq"),
    ("mamba2-370m", 1, "seq"), ("mamba2-370m", 2, "seq"),
    ("deepseek-v2-236b", 1, "seq"), ("deepseek-v2-236b", 2, "seq"),
    ("h2o-danube-1.8b", 2, "heads")])
def test_compiled_mesh_step_equals_the_eager_sharded_step(
        smoke, monkeypatch, name, microbatches, strategy):
    """Three calls of the step compiled on the smoke mesh against three
    eager sharded ``train_step`` calls from the same state on the same
    batches: bit for bit after every call, the owned leaves where they
    were. Under ``heads`` the attention core runs per head shard."""
    heads = []
    if strategy == "heads":
        monkeypatch.setenv("REPRO_ATTN_SHARD", "heads")
        real = attention.heads_parallel
        monkeypatch.setattr(attention, "heads_parallel",
                            lambda *a: heads.append(1) or real(*a))
    cfg, opt, params, state = setup(name)
    step = compiled(smoke, cfg, opt, params, state, microbatches)
    where = layout(step)
    p, s = placed(smoke, params, state)
    for i in range(3):
        b = batch_at(cfg, smoke, i)
        p, s, want = eager(smoke, p, s, b, cfg, opt, microbatches)
        got = step(b)
        assert ("aux" in got) == (microbatches == 1)
        assert_same_metrics(got, want)
        assert_same((step.params, step.opt_state), (p, s))
        assert layout(step) == where
    assert int(step.opt_state.step.full_tensor()) == 3
    assert bool(heads) == (strategy == "heads")


def test_owned_mesh_buffers_keep_their_placements_and_addresses(smoke):
    """The batch buffers are ``DTensor``s placed as ``make_batch(mesh=)``
    places the batch, the accumulators as the params; a call copies this
    rank's shard of the batch; nothing owned moves across calls and
    ``load_state``; the metrics are plain tensors, the same ones every
    call."""
    cfg, opt, params, state = setup("h2o-danube-1.8b")
    step = compiled(smoke, cfg, opt, params, state)
    b0 = batch_at(cfg, smoke, 0)
    for k, buf in step._batch.items():
        assert buf.placements == b0[k].placements
        assert buf.shape == b0[k].shape
    for a, q in zip(step._acc, tree_leaves(step.params)):
        assert a.placements == q.placements and a.dtype == torch.float32

    def owned():
        return layout(step) + [
            (t.placements, t.to_local().data_ptr())
            for t in list(step._batch.values()) + step._acc]

    where = owned()
    start = placed(smoke, params, state)
    metrics = step(b0)
    tokens = b0["tokens"].to_local().clone()
    b0["tokens"].to_local().zero_()            # the caller reuses its batch
    assert torch.equal(step._batch["tokens"].to_local(), tokens)
    loss = metrics["loss"]
    assert step(batch_at(cfg, smoke, 1)) is metrics
    assert metrics["loss"] is loss and not api.is_sharded(loss)
    assert owned() == where
    step.load_state(*start)
    assert owned() == where
    assert_same((step.params, step.opt_state), start)


def test_load_state_from_a_sharded_restore_gives_the_same_next_step(
        smoke, tmp_path):
    """A checkpoint of the compiled step's ``DTensor`` state after two
    calls, restored with ``shardings=`` into another compiled step
    (``load_state``), gives the third call of the first bit for bit."""
    cfg, opt, params, state = setup("mamba2-370m")
    first = compiled(smoke, cfg, opt, params, state)
    for i in range(2):
        first(batch_at(cfg, smoke, i))
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(2, (first.params, first.opt_state), extra={"step": 2})
    want = {k: v.clone() for k, v in first(batch_at(cfg, smoke, 2)).items()}

    other = compiled(smoke, cfg, opt, params, state)
    where = layout(other)
    shardings = (sharding.params_shardings(params, smoke),
                 sharding.params_shardings(state, smoke))
    tree, extra = mgr.restore((other.params, other.opt_state),
                              shardings=shardings)
    assert extra == {"step": 2}
    other.load_state(*tree)
    assert layout(other) == where
    assert_same_metrics(other(batch_at(cfg, smoke, 2)), want)
    assert_same((other.params, other.opt_state),
                (first.params, first.opt_state))


def test_other_placements_and_mixed_trees_raise(smoke):
    """The compiled mesh step reads batches placed as the one it was made
    with, and owns trees whose every leaf is a ``DTensor``."""
    from torch.distributed.tensor import Replicate
    cfg, opt, params, state = setup("h2o-danube-1.8b")
    step = compiled(smoke, cfg, opt, params, state)
    b = batch_at(cfg, smoke, 0)
    whole = {k: v.redistribute(smoke, [Replicate(), Replicate()])
             for k, v in b.items()}
    with pytest.raises(ValueError, match="tokens.*Replicate.*Shard"):
        step(whole)
    with pytest.raises(ValueError, match="a tensor"):
        step({k: v.full_tensor() for k, v in b.items()})
    with pytest.raises(ValueError, match=r"\(2, 32\)"):
        step(batch_at(cfg, smoke, 0, b=2))
    wrong = tree_unflatten(params, [torch.zeros(3)] + tree_leaves(params)[1:])
    with pytest.raises(ValueError, match="leaf 0 is a tensor"):
        step.load_state(wrong, state)
    d_p, _ = placed(smoke, params, state)
    with pytest.raises(ValueError, match="mix DTensor and plain"):
        steps.compile_train_step(d_p, state, b, cfg=cfg, opt_cfg=opt)
    d_p, d_s = placed(smoke, params, state)
    with pytest.raises(ValueError, match="tokens.*a tensor.*on a mesh"):
        steps.compile_train_step(d_p, d_s, {"tokens": torch.zeros(
            (4, 32), dtype=torch.long)}, cfg=cfg, opt_cfg=opt)
    assert step.calls == 0


# --------------------------------------------- against the JAX package
def pair(name: str):
    """(reference cfg, port cfg, reference params, port params), f32."""
    jcfg = dataclasses.replace(jax_get_config(name, reduced=True),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config(name, reduced=True),
                               dtype="float32")
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                              "cpu")


def batches(cfg, seed: int, b: int = 2, s: int = 16):
    """The same token batch for both packages: (reference, port)."""
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(tokens)},
            {"tokens": torch.as_tensor(tokens, dtype=torch.long)})


def routing_margin(monkeypatch, params, batch, cfg) -> float:
    """The least top-k routing margin of any token at any MoE layer of
    the port's loss on ``batch`` (inf without MoE)."""
    import repro_torch.models.moe as tmoe
    margins = [float("inf")]
    router = tmoe._router

    def spy(p, xt, mo):
        out = router(p, xt, mo)
        top = torch.sort(out[2], dim=-1, descending=True).values
        margins.append(float((top[..., mo.top_k - 1]
                              - top[..., mo.top_k]).min()))
        return out

    with monkeypatch.context() as mp:
        mp.setattr(tmoe, "_router", spy)
        M.loss_fn(params, batch, cfg)
    return min(margins)


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "mamba2-370m",
                                  "deepseek-v2-236b"])
def test_compiled_mesh_step_matches_the_reference(smoke, monkeypatch, name):
    """Two calls of the step compiled on the smoke mesh (two
    microbatches) against the reference's jitted unsharded
    ``train_step``; before each, both packages hold the reference's state
    (``load_state`` of the bridged tree, redistributed onto the step's
    placements). Metrics within 1e-5, ``m`` within 1e-4 of its largest
    magnitude, params within 1e-5 + 2·lr (``tests/test_torch_lm_train.py``'s
    tolerances). An MoE configuration takes batches whose routing margins
    all exceed 2e-3."""
    jcfg, tcfg, jp, tp = pair(name)
    opt = dataclasses.replace(steps.make_opt_config(tcfg, total_steps=20),
                              warmup_steps=2, lr=1e-3)
    jopt = jax_adamw.AdamWConfig(**dataclasses.asdict(opt))
    jstep = jax.jit(functools.partial(jax_steps.train_step, cfg=jcfg,
                                      opt_cfg=jopt, microbatches=2))
    js = jax_adamw.init_opt_state(jp, jopt)
    ts = adamw.init_opt_state(tp, opt)
    seeds = iter(range(1, 41))

    def next_batch():
        """The next batch whose tokens all route with a margin (any batch
        without MoE), on the params the step starts from."""
        for seed in seeds:
            jb, tb = batches(tcfg, seed)
            if tcfg.moe is None or routing_margin(
                    monkeypatch, tp, tb, tcfg) >= ROUTING_MARGIN:
                return jb, tb
        pytest.fail(f"no batch of seeds 1-40 routes {name} by "
                    f"{ROUTING_MARGIN}")

    step = None
    for n in (1, 2):
        jb, tb = next_batch()
        mesh_b = sharding.batch_shardings(tb, smoke)
        if step is None:
            with api.activation_policy(api.policy_from_mesh(smoke)):
                step = steps.compile_train_step(
                    *placed(smoke, tp, ts), sharding.distribute(tb, mesh_b),
                    cfg=tcfg, opt_cfg=opt, microbatches=2)
        jp2, js2, jm = jstep(jp, js, jb)
        step.load_state(*placed(smoke, tp, ts))
        tm = step(sharding.distribute(tb, mesh_b))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        lr = float(jm["lr"])
        for leaf, got, want in zip(
                [n for n, _ in tree_leaves_with_path(step.params)],
                tree_leaves(step.params), jax.tree_util.tree_leaves(jp2)):
            np.testing.assert_allclose(got.full_tensor().numpy(),
                                       np.asarray(want), rtol=0,
                                       atol=1e-5 + 2 * lr, err_msg=leaf)
        for got, want in zip(tree_leaves(step.opt_state.m),
                             jax.tree_util.tree_leaves(js2.m)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.full_tensor().numpy(), want, rtol=1e-4,
                atol=1e-4 * max(float(np.abs(want).max()), 1e-30))
        assert int(step.opt_state.step.full_tensor()) == int(js2.step) == n
        jp, js = jp2, js2
        tp = lm_params_from_jax(jax.tree.map(np.asarray, jp2), "cpu")
        ts = opt_state_from_jax(jax.tree.map(np.asarray, js2), "cpu")


# ------------------------------------------------------ the mesh check
def test_compiled_check_passes_and_catches_a_wrong_step(smoke, monkeypatch):
    """``mesh_check.compiled_check`` on the smoke mesh: bit-equal, the
    layout kept. With the compiled step's in-place update at half the
    learning rate (the eager step's left as it is) its params leave the
    1e-5 rule by far."""
    cfg = mesh_check.check_config("h2o-danube-1.8b", layers=2, reduced=True)
    r = mesh_check.compiled_check(smoke, cfg, "cpu", batch=4, seq=32)
    assert r["bit_equal"] and r["layout_kept"] and not r["captured"]
    assert r["max_rel"] == r["metrics_rel"] == 0.0 and r["calls"] == 3
    real = steps.apply_updates_
    monkeypatch.setattr(steps, "apply_updates_", lambda p, g, s, c: real(
        p, g, s, dataclasses.replace(c, lr=c.lr / 2)))
    r = mesh_check.compiled_check(smoke, cfg, "cpu", batch=4, seq=32)
    assert not r["bit_equal"] and r["max_rel"] > 3 * mesh_check.BASE_TOL
