"""The port's LM training path (``models.model`` under autograd,
``launch.steps.train_step``, ``launch.train``) against the JAX package's
on the CPU, at the reduced configs, the reference's weights carried over
by ``bridge.lm_params_from_jax``.

Tolerances, f32 throughout:
* gradients of ``loss_fn``: every leaf within rtol 1e-4 of the largest
  magnitude of the reference's gradient of that leaf. Top-k routing is
  discontinuous, so an MoE architecture takes the first batch (seeds
  1-10) whose routing margins, in the port, all exceed 2e-3, as the bf16
  model test does;
* ``remat=True`` against ``remat=False``: bit for bit (the recomputation
  runs the same ops on the same values);
* ``train_step``: loss, ce, grad_norm and lr within 1e-5; the optimizer's
  first moment (``m``, the clipped gradient's running mean: the
  gradients themselves) within 1e-4 of its largest magnitude; the
  updated params within an absolute 1e-5 + 2·lr. At step 1 AdamW's
  ``mhat / sqrt(vhat)`` is ±1 per element, so a gradient near 0, equal
  in both packages within the gradient tolerance, may take the other
  sign and move its parameter by 2·lr the other way.

The reference's own train driver is not compared: on one device its
first step raises ``DuplicateSpecError`` in the LM sharding rules
(``tests/test_system.py::test_train_driver_with_resume`` fails), so the
port's driver is held to the reference step by step instead."""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro_torch.bridge import lm_params_from_jax, opt_state_from_jax
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import steps, train
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


KEY = jax.random.PRNGKey(0)
ROUTING_MARGIN = 2e-3


def pair(name: str, **overrides):
    """(reference cfg, port cfg, reference params, port params), f32."""
    jcfg = dataclasses.replace(jax_get_config(name, reduced=True),
                               dtype="float32", **overrides)
    tcfg = dataclasses.replace(get_config(name, reduced=True),
                               dtype="float32", **overrides)
    jp = JM.init_model(jcfg, KEY)
    return jcfg, tcfg, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                              "cpu")


def batches(cfg, seed: int, b: int = 2, s: int = 16):
    """The same batch for both packages: (reference, port)."""
    rng = np.random.default_rng(seed)
    n_front = cfg.frontend_tokens if cfg.frontend != "none" else 0
    tokens = rng.integers(0, cfg.vocab, (b, s - n_front)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.as_tensor(tokens, dtype=torch.long)}
    if n_front:
        fe = rng.standard_normal((b, n_front, cfg.frontend_dim)).astype(
            np.float32)
        jb["frontend_embeds"] = jnp.asarray(fe)
        tb["frontend_embeds"] = torch.as_tensor(fe)
    return jb, tb


def routing_margin(monkeypatch, run) -> float:
    """The least top-k routing margin of any token at any MoE layer while
    ``run()`` runs the port (inf without MoE)."""
    import repro_torch.models.moe as tmoe
    margins = [float("inf")]
    router = tmoe._router

    def spy(p, xt, mo):
        out = router(p, xt, mo)
        top = torch.sort(out[2], dim=-1, descending=True).values
        margins.append(float((top[..., mo.top_k - 1]
                              - top[..., mo.top_k]).min()))
        return out

    monkeypatch.setattr(tmoe, "_router", spy)
    try:
        run()
    finally:
        monkeypatch.undo()
    return min(margins)


def port_grads(params, batch, cfg, remat=True):
    """(loss, grads as a list in JAX's leaf order) of the port's loss."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with pytest.MonkeyPatch.context() as mp:
        # loss_fn has the reference's signature: remat= reaches forward
        mp.setattr(M, "forward", functools.partial(M.forward, remat=remat))
        loss, _ = M.loss_fn(tree_unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), list(grads)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_gradients_equal_the_references(name, monkeypatch):
    jcfg, tcfg, jp, tp = pair(name)
    for seed in range(1, 11):
        jb, tb = batches(tcfg, seed)
        if tcfg.moe is None or routing_margin(
                monkeypatch, lambda: M.loss_fn(tp, tb, tcfg)) \
                >= ROUTING_MARGIN:
            break
    else:
        pytest.fail(f"no batch of seeds 1-10 routes every token of {name} "
                    f"with a margin of {ROUTING_MARGIN}")
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jcfg), has_aux=True))(jp, jb)
    loss, grads = port_grads(tp, tb, tcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = jax.tree_util.tree_leaves(jg)
    names = [n for n, _ in tree_leaves_with_path(tp)]
    assert len(grads) == len(want) == len(names)
    for leaf, got, w in zip(names, grads, want):
        w = np.asarray(w)
        assert got.shape == w.shape, leaf
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=leaf)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_remat_gives_bit_equal_gradients(name):
    _, tcfg, _, tp = pair(name)
    _, tb = batches(tcfg, 1)
    loss_r, g_r = port_grads(tp, tb, tcfg, remat=True)
    loss_n, g_n = port_grads(tp, tb, tcfg, remat=False)
    assert torch.equal(loss_r, loss_n)
    for a, b in zip(g_r, g_n):
        assert torch.equal(a, b)


@pytest.mark.parametrize("how", ["eager", "compiled"])
@pytest.mark.parametrize("name, microbatches", [
    ("h2o-danube-1.8b", 1), ("h2o-danube-1.8b", 2), ("mamba2-370m", 1),
    ("mamba2-370m", 2)])
def test_train_step_equals_the_references(name, microbatches, how):
    """Two steps of ``train_step`` (``eager``) or of the compiled step
    (``compiled``: ``compile_train_step``, each step's state copied in by
    ``load_state``) against the reference's jitted one on the same
    batches; the second starts both from the reference's state after the
    first (``bridge.opt_state_from_jax``), so each step is compared from
    one state."""
    jcfg, tcfg, jp, tp = pair(name)
    opt = dataclasses.replace(steps.make_opt_config(tcfg, total_steps=20),
                              warmup_steps=2, lr=1e-3)
    jopt = jax_adamw.AdamWConfig(**dataclasses.asdict(opt))
    jstep = jax.jit(functools.partial(jax_steps.train_step, cfg=jcfg,
                                      opt_cfg=jopt,
                                      microbatches=microbatches))
    js = jax_adamw.init_opt_state(jp, jopt)
    ts = adamw.init_opt_state(tp, opt)
    compiled = None
    for seed in (1, 2):
        jb, tb = batches(tcfg, seed, b=4)
        jp2, js2, jm = jstep(jp, js, jb)
        if how == "eager":
            tp2, ts2, tm = steps.train_step(tp, ts, tb, cfg=tcfg,
                                            opt_cfg=opt,
                                            microbatches=microbatches)
        else:
            if compiled is None:
                compiled = steps.compile_train_step(
                    tp, ts, tb, cfg=tcfg, opt_cfg=opt,
                    microbatches=microbatches)
            compiled.load_state(tp, ts)
            tm = compiled(tb)
            tp2, ts2 = compiled.params, compiled.opt_state
        assert set(tm) == set(jm)
        assert ("aux" in tm) == (microbatches == 1)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        lr = float(jm["lr"])
        for leaf, got, want in zip(
                [n for n, _ in tree_leaves_with_path(tp2)],
                tree_leaves(tp2), jax.tree_util.tree_leaves(jp2)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5 + 2 * lr,
                                       err_msg=leaf)
        for got, want in zip(tree_leaves(ts2.m),
                             jax.tree_util.tree_leaves(js2.m)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=1e-4,
                atol=1e-4 * max(float(np.abs(want).max()), 1e-30))
        assert int(ts2.step) == int(js2.step) == seed
        # the next step starts both packages from the reference's state
        jp, js = jp2, js2
        tp = lm_params_from_jax(jax.tree.map(np.asarray, jp2), "cpu")
        ts = opt_state_from_jax(jax.tree.map(np.asarray, js2), "cpu")


def test_lm_train_loss_decreases():
    """The overfit check of ``tests/test_system.py`` on the port: twelve
    steps on one repeated batch, no warm-up, lr 3e-3, two microbatches."""
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    opt_cfg = dataclasses.replace(steps.make_opt_config(cfg, total_steps=30),
                                  warmup_steps=0, lr=3e-3)
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    opt_state = adamw.init_opt_state(params, opt_cfg)
    dcfg = DataConfig(seed=0, global_batch=4, seq_len=64)
    batch = make_batch(dcfg, cfg, step=0, device="cpu")
    losses = []
    for _ in range(12):
        params, opt_state, m = steps.train_step(
            params, opt_state, batch, cfg=cfg, opt_cfg=opt_cfg,
            microbatches=2)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(params))


STEP_LINE = re.compile(r"step\s+(\d+)\s+loss\s+(\S+)\s+gnorm\s+(\S+)\s+"
                       r"lr\s+(\S+)\s+dt\s+\S+\s+on device cpu")


def test_train_driver_with_resume(tmp_path, capsys, monkeypatch):
    """The launcher end to end on the CPU: train 6 steps with a
    checkpoint at step 5, then resume for 8. The state restored equals the
    state saved bit for bit, and the reference's step-0 quirk shows: the
    resumed run logs data step 0 again, at the learning rate of optimizer
    step 6."""
    saved, restored = {}, []

    class Spy(ckpt_manager.CheckpointManager):
        def save(self, step, tree, extra=None):
            saved[step] = [t.clone() for t in tree_leaves(tree)]
            super().save(step, tree, extra)

        def restore(self, tree_like, step=None, shardings=None,
                    device="cuda"):
            out = super().restore(tree_like, step, shardings, device)
            restored.append(tree_leaves(out[0]))
            return out

    monkeypatch.setattr(train, "CheckpointManager", Spy)
    base = ["--arch", "mamba2-370m", "--reduced", "--batch", "4", "--seq",
            "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
            "--log-every", "5", "--device", "cpu"]
    assert train.main(base + ["--steps", "6"]) == 0
    first = capsys.readouterr().out
    assert list(saved) == [5]
    state5 = saved[5]
    assert train.main(base + ["--steps", "8", "--resume"]) == 0
    second = capsys.readouterr().out
    assert "resumed from step 5" in second
    assert len(restored) == 1
    assert len(restored[0]) == len(state5)
    for got, want in zip(restored[0], state5):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert "done: {'completed': 6, 'restarts': 0}" in first
    assert "done: {'completed': 8, 'restarts': 0}" in second
    logged = [STEP_LINE.search(line) for line in second.splitlines()
              if line.startswith("step ")]
    assert [int(m[1]) for m in logged] == [0, 5]
    cfg = get_config("mamba2-370m", reduced=True)
    opt_cfg = steps.make_opt_config(cfg, total_steps=8)
    want_lr = float(adamw.schedule(torch.tensor(6, dtype=torch.int32),
                                   opt_cfg))
    assert float(logged[0][4]) == pytest.approx(want_lr, rel=1e-2)
    first_lr = float(STEP_LINE.search(first)[4])
    assert first_lr == pytest.approx(float(adamw.schedule(
        torch.tensor(1, dtype=torch.int32), opt_cfg)), rel=1e-2)
    assert all(np.isfinite(float(m[2])) for m in logged)


def test_train_driver_meshes_wait_for_the_lm_mesh(tmp_path):
    """The production meshes need their process group (torchrun's 256 or
    512 ranks); without it the driver raises naming the size, and never
    trains on a smaller mesh."""
    for mesh, ranks in (("pod", 256), ("multipod", 512)):
        with pytest.raises(ValueError, match=f"world size {ranks}"):
            train.main(["--arch", "mamba2-370m", "--reduced", "--mesh", mesh,
                        "--device", "cpu", "--ckpt-dir", str(tmp_path)])
