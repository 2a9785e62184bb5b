"""The compiled LM train step (``launch.steps.compile_train_step``, the
counterpart of the reference's ``jax.jit(train_step,
donate_argnums=(0, 1))``) and the in-place AdamW update
(``optim.adamw.apply_updates_``) on the CPU, at the reduced configs in
f32.

Nothing here can capture: the CPU has no CUDA graphs. On the CPU the
compiled step runs the body its graph records eagerly on every call, so
the tests hold that body:

* three calls of the compiled step equal three calls of ``train_step``
  bit for bit (params, ``m``, ``v``, ``step`` and every metric), for all
  ten architectures at two microbatches and h2o-danube-1.8b and
  mamba2-370m at one; ``tests/test_torch_lm_train.py`` holds the compiled
  step to the reference's jitted ``train_step`` at its tolerances;
* ``apply_updates_`` equals ``apply_updates`` bit for bit (bf16 params,
  f32 moments), in place;
* the owned buffers keep their addresses across calls and restores, and
  a call copies its batch;
* the card's stages (two eager passes, a capture that records without
  running, then replays) with the capture faked by a graph whose replay
  runs the body, so the stage order shows in the state it leaves;
* ``launch.train`` recovers from an injected failure by restoring into
  the compiled step's buffers, with plain tensors and on the smoke mesh
  (a world-1 gloo group), a checkpoint holds the state of the step it
  was taken at, whatever steps follow, and a restore waits for a pending
  save of the same step;
* a tree that mixes ``DTensor`` and plain leaves is refused
  (``tests/test_torch_mesh_graph.py`` holds the step on the mesh);
* ``tools/check_train_graph.py`` runs its sweep on the CPU.
"""
import contextlib
import dataclasses
import functools
import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.distributed import api, fault, sharding
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import model as M
from repro_torch.models.scan_util import tree_leaves, tree_unflatten
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


def clone(tree):
    return tree_unflatten(tree, [t.clone() for t in tree_leaves(tree)])


def setup(name: str, seed: int = 0):
    """(f32 reduced config, optimizer config, params, OptState): the
    optimizer leaves warm-up after two steps at lr 1e-3, so three steps
    run both halves of the schedule."""
    cfg = dataclasses.replace(get_config(name, reduced=True),
                              dtype="float32")
    opt = dataclasses.replace(steps.make_opt_config(cfg, total_steps=20),
                              warmup_steps=2, lr=1e-3)
    params = M.init_model(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, opt, params, adamw.init_opt_state(params, opt)


def batch_at(cfg, step: int, b: int = 4, s: int = 32):
    return make_batch(DataConfig(seed=1, global_batch=b, seq_len=s), cfg,
                      step, device="cpu")


def assert_same(got, want):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def assert_same_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name, microbatches",
                         [(n, 2) for n in ARCH_NAMES]
                         + [("h2o-danube-1.8b", 1), ("mamba2-370m", 1)])
def test_compiled_step_equals_train_step(name, microbatches):
    cfg, opt, params, state = setup(name)
    step = steps.compile_train_step(clone(params), clone(state),
                                    batch_at(cfg, 0), cfg=cfg, opt_cfg=opt,
                                    microbatches=microbatches)
    for i in range(3):
        b = batch_at(cfg, i)
        params, state, want = steps.train_step(
            params, state, b, cfg=cfg, opt_cfg=opt,
            microbatches=microbatches)
        got = step(b)
        assert ("aux" in got) == (microbatches == 1)
        assert_same_metrics(got, want)
        assert_same((step.params, step.opt_state), (params, state))
    assert int(step.opt_state.step) == 3


def test_apply_updates_in_place_equals_apply_updates():
    """Three AdamW steps with bf16 params and f32 moments: the in-place
    update writes into the same storage the functional one's values, bit
    for bit, and increments the step on its tensor."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((33, 17), generator=gen).bfloat16(),
              "b": {"x": torch.randn((17,), generator=gen).bfloat16(),
                    "y": torch.zeros((5, 2, 3), dtype=torch.bfloat16)}}
    cfg = adamw.AdamWConfig(warmup_steps=2, total_steps=10, lr=1e-2,
                            clip_norm=0.5)
    state = adamw.init_opt_state(params, cfg)
    own_p, own_s = clone(params), clone(state)
    ptrs = [t.data_ptr() for t in tree_leaves((own_p, own_s))]
    step_tensor = own_s.step
    for _ in range(3):
        grads = {"w": torch.randn((33, 17), generator=gen).bfloat16() * 3,
                 "b": {"x": torch.randn((17,), generator=gen).bfloat16(),
                       "y": torch.randn((5, 2, 3), generator=gen).bfloat16()}}
        params, state, want = adamw.apply_updates(params, grads, state, cfg)
        got = adamw.apply_updates_(own_p, grads, own_s, cfg)
        assert_same_metrics(got, want)
        assert_same((own_p, own_s), (params, state))
        assert [t.data_ptr() for t in tree_leaves((own_p, own_s))] == ptrs
    assert own_s.step is step_tensor and int(step_tensor) == 3
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(own_p))
    assert all(m.dtype == torch.float32 for m in tree_leaves(own_s.m))


def test_owned_buffers_keep_their_addresses():
    """The params, moments, step, batch buffers and accumulators stay put
    across calls and ``load_state`` (a graph binds them by address); a
    call copies the caller's batch, so changing it afterwards changes
    nothing; ``load_state`` refuses a tree of other shapes."""
    cfg, opt, params, state = setup("h2o-danube-1.8b")
    step = steps.compile_train_step(clone(params), clone(state),
                                    batch_at(cfg, 0), cfg=cfg, opt_cfg=opt,
                                    microbatches=2)

    def owned():
        return [t.data_ptr() for t in
                tree_leaves((step.params, step.opt_state))
                + list(step._batch.values()) + step._acc]

    ptrs = owned()
    start = (clone(params), clone(state))
    for i in range(2):
        b = batch_at(cfg, i)
        params, state, _ = steps.train_step(params, state, clone(b), cfg=cfg,
                                            opt_cfg=opt, microbatches=2)
        metrics = step(b)
        tokens = b["tokens"].clone()
        b["tokens"].zero_()                 # the caller reuses its batch
        assert torch.equal(step._batch["tokens"], tokens)
        assert_same((step.params, step.opt_state), (params, state))
        assert owned() == ptrs
    loss = metrics["loss"]
    assert step(batch_at(cfg, 2)) is metrics and metrics["loss"] is loss
    step.load_state(*start)
    assert owned() == ptrs
    assert_same((step.params, step.opt_state), start)
    wrong = clone(start[0])
    wrong["embed"]["table"] = wrong["embed"]["table"][:-1]
    with pytest.raises(ValueError, match="leaf"):
        step.load_state(wrong, start[1])
    with pytest.raises(ValueError, match="tokens"):
        step(batch_at(cfg, 0, b=2))


class FakeGraph:
    """A CPU stand-in for ``torch.cuda.CUDAGraph``: ``fake_capture``
    gives it the body it recorded, and a replay runs that body."""

    made = []

    def __init__(self, keep_graph=False):
        self.body, self.replays = None, 0
        FakeGraph.made.append(self)

    def instantiate(self):
        pass

    def replay(self):
        self.replays += 1
        self.body()


class FakeStream:
    def wait_stream(self, other):
        pass


def test_card_stages_warm_capture_replay(monkeypatch):
    """The card's path with the capture faked: a capture that records
    without running is a body whose effects are undone on exit. Calls 1-2
    are eager passes, call 3 captures and replays once, later calls
    replay; after each the state equals ``train_step``'s bit for bit (a
    capture not followed by its replay would leave the state a step
    behind)."""
    cfg, opt, params, state = setup("mamba2-370m")
    step = steps.compile_train_step(clone(params), clone(state),
                                    batch_at(cfg, 0), cfg=cfg, opt_cfg=opt,
                                    microbatches=2)
    step.device = torch.device("cuda")
    warm = []

    @contextlib.contextmanager
    def fake_capture(graph, stream=None, capture_error_mode=None):
        assert capture_error_mode == "thread_local"
        assert stream is step._stream
        held = (tree_leaves((step.params, step.opt_state)) + step._acc
                + list(step._batch.values()) + list(step._metrics.values()))
        before = [t.clone() for t in held]
        yield
        for t, b in zip(held, before):
            t.copy_(b)
        graph.body = step._body

    FakeGraph.made = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None:
                        FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    real_warm = step._warm_pass
    monkeypatch.setattr(step, "_warm_pass",
                        lambda: warm.append(1) or real_warm())
    for i in range(5):
        b = batch_at(cfg, i)
        params, state, want = steps.train_step(params, state, b, cfg=cfg,
                                               opt_cfg=opt, microbatches=2)
        got = step(b)
        assert len(warm) == min(i + 1, steps.WARM_PASSES)
        if i < steps.WARM_PASSES:
            assert step.graph is None
        else:
            assert FakeGraph.made == [step.graph]
            assert step.graph.replays == i + 1 - steps.WARM_PASSES
        assert_same_metrics(got, want)
        assert_same((step.params, step.opt_state), (params, state))


def test_launch_train_recovers_into_the_compiled_step(tmp_path, monkeypatch):
    """``launch.train`` with a failure injected (``run_with_retries``'s
    ``failure_injector``) at step 4, after the checkpoint at step 3: the
    supervisor restores into the compiled step's buffers (the same
    tensors, ``load_state``) and replays steps 3-5, and the checkpoint at
    step 6 equals an uninterrupted run's bit for bit."""
    recover_into_the_compiled_step(tmp_path, monkeypatch, "none")


def test_launch_train_recovers_into_the_compiled_step_on_the_smoke_mesh(
        tmp_path, monkeypatch):
    """The same with ``--mesh smoke`` (a world-1 gloo group): the step the
    driver compiles owns ``DTensor`` state, and the recovery restores
    onto its placements (``restore(shardings=)``) and into its local
    shards."""
    assert not dist.is_initialized()
    try:
        recover_into_the_compiled_step(tmp_path, monkeypatch, "smoke")
    finally:
        dist.destroy_process_group()


def local(t):
    """A ``DTensor``'s local shard; any other tensor as it is."""
    return t.to_local() if api.is_sharded(t) else t


def recover_into_the_compiled_step(tmp_path, monkeypatch, mesh: str):
    runs, compiled = [], []

    class Spy(ckpt_manager.CheckpointManager):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append({})

        def save(self, step, tree, extra=None):
            runs[-1][step] = [local(t).clone() for t in tree_leaves(tree)]
            super().save(step, tree, extra)

    def spy_compile(*a, **kw):
        step = steps.compile_train_step(*a, **kw)
        step.loads = []
        step.ptrs = [local(t).data_ptr() for t in
                     tree_leaves((step.params, step.opt_state))]
        real = step.load_state
        step.load_state = lambda *t: (step.loads.append(1), real(*t))[1]
        compiled.append(step)
        return step

    monkeypatch.setattr(train, "CheckpointManager", Spy)
    monkeypatch.setattr(train, "compile_train_step", spy_compile)
    base = ["--arch", "h2o-danube-1.8b", "--reduced", "--batch", "4",
            "--seq", "32", "--microbatches", "2", "--steps", "6",
            "--ckpt-every", "3", "--log-every", "10", "--device", "cpu",
            "--mesh", mesh]
    assert train.main(base + ["--ckpt-dir", str(tmp_path / "a")]) == 0
    failed = []

    def inject(step):
        if step == 4 and not failed:
            failed.append(step)
            raise RuntimeError("injected node loss")

    monkeypatch.setattr(train, "run_with_retries", functools.partial(
        fault.run_with_retries, failure_injector=inject))
    assert train.main(base + ["--ckpt-dir", str(tmp_path / "b")]) == 0
    assert failed == [4]
    clean, hit = runs
    assert sorted(clean) == sorted(hit) == [3, 6]
    assert_same(hit[6], clean[6])
    assert int(hit[6][-1]) == 6                      # OptState.step
    assert compiled[0].loads == [] and compiled[1].loads == [1]
    for step in compiled:
        assert step.sharded == (mesh != "none")
        assert step.ptrs == [local(t).data_ptr() for t in
                             tree_leaves((step.params, step.opt_state))]


def test_checkpoint_holds_the_state_of_its_step(tmp_path):
    """``CheckpointManager.save`` takes its device→host copy before it
    returns: a step of the compiled step right after an async save
    changes the buffers, not what is written."""
    cfg, opt, params, state = setup("mamba2-370m")
    step = steps.compile_train_step(params, state, batch_at(cfg, 0),
                                    cfg=cfg, opt_cfg=opt)
    step(batch_at(cfg, 0))
    mgr = CheckpointManager(tmp_path, async_write=True)
    at_save = clone((step.params, step.opt_state))
    mgr.save(1, (step.params, step.opt_state), extra={"step": 1})
    step(batch_at(cfg, 1))
    mgr.wait()
    restored, extra = mgr.restore((step.params, step.opt_state),
                                  device="cpu")
    assert extra == {"step": 1}
    assert_same(restored, at_save)
    assert not torch.equal(tree_leaves(step.params)[0],
                           tree_leaves(at_save[0])[0])


def test_restore_waits_for_a_step_saved_again(tmp_path, monkeypatch):
    """A resumed run saves its first steps over the earlier run's (data
    steps count from 0 again), and a failure right after such an async
    save restores at once: ``restore`` joins the pending write and reads
    the new commit whole, never the old step's directory while it is
    being replaced."""
    mgr = CheckpointManager(tmp_path, async_write=True)
    old = {f"w{i:02d}": torch.zeros(4) for i in range(24)}
    mgr.save(5, old, extra={"step": 5})
    mgr.wait()
    real_save = ckpt_manager.np.save

    def slow_save(*args, **kw):
        time.sleep(0.005)
        return real_save(*args, **kw)

    monkeypatch.setattr(ckpt_manager.np, "save", slow_save)
    new = {k: torch.full((4,), float(i)) for i, k in enumerate(sorted(old))}
    mgr.save(5, new, extra={"step": 5})
    got, extra = mgr.restore(old, device="cpu")
    assert extra == {"step": 5} and mgr.all_steps() == [5]
    assert_same(got, new)


def test_dtensor_tree_is_refused():
    """A mixed tree is refused: the compiled step owns plain tensors on
    one device or ``DTensor``s on a mesh, never both. Params placed on
    the smoke mesh (a world-1 gloo group) beside a plain optimizer state,
    or the other way round, raise."""
    assert not dist.is_initialized()
    mesh = make_smoke_mesh("cpu")
    try:
        cfg, opt, params, state = setup("h2o-danube-1.8b")
        d_p, d_s = sharding.distribute(
            (clone(params), clone(state)),
            (sharding.params_shardings(params, mesh),
             sharding.params_shardings(state, mesh)))
        for p, s in ((d_p, state), (params, d_s)):
            with pytest.raises(ValueError, match="mix DTensor and plain"):
                steps.compile_train_step(p, s, batch_at(cfg, 0), cfg=cfg,
                                         opt_cfg=opt)
    finally:
        dist.destroy_process_group()


def test_check_train_graph_tool_on_the_cpu(capsys):
    """``tools/check_train_graph.py --device cpu``: every architecture's
    compiled steps bit-equal to ``train_step``'s, no capture."""
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "check_train_graph.py"
    spec = importlib.util.spec_from_file_location("check_train_graph", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--device", "cpu", "--steps", "2"]) == 0
    result = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert result["ok"] and result["capture_modes"] == []
    assert len(result["steps"]) == len(ARCH_NAMES) + 2
    assert all(r["bit_equal"] and r["kernel_nodes"] is None
               for r in result["steps"])
