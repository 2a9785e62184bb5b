"""The port's LM mesh (``distributed/{sharding,api}.py``,
``launch/{mesh,steps}.py``, the mesh arguments of the data pipeline, the
checkpoint manager and the train driver) against the JAX package on the
CPU.

* The sharding rules entry for entry: ``param_spec`` / ``params_shardings``
  over every leaf of ``model_shapes`` for all ten architectures at full
  width, ``batch_shardings`` / ``cache_shardings`` over every cell's
  ``input_specs``, and ``policy_from_mesh``'s fields, on shape-only
  16×16, 2×16×16 and 1×1 meshes (the reference's ``AbstractMesh`` in the
  installed JAX's signature; the port's ``AbstractMesh``).
* ``input_specs`` / ``model_shapes`` / ``opt_shapes`` (``meta`` tensors)
  against the reference's ``eval_shape``: shapes and dtypes; the port's
  token ids and decode position are int64 where the reference's are
  int32 (the same values).
* The reference's sharded steps do not run under the installed JAX
  (``tests/test_distributed.py``: ``ShardingTypeError`` on the embedding
  gather), so the port's sharded steps are held to its own unsharded
  steps, which ``tests/test_torch_lm_train.py`` holds to the reference:
  the smoke mesh (a world-1 gloo group) in this process, and a real 2×2
  mesh of four gloo processes (``tools/check_mesh.py --lm``), loss and
  every updated leaf within 1e-5 of the leaf's max (a param leaf's max
  taken as at least 1, the step at the full learning rate so that every
  leaf moves by 10x that or more: ``mesh_check.PARAM_FLOOR`` says why;
  the moments, the gradients' statistics, against their own max). A
  planted fault in the sharded update fails the same check. On the 2×2
  mesh the train step compiled on the mesh equals the eager sharded step
  bit for bit (``tests/test_torch_mesh_graph.py`` holds it on the smoke
  mesh), and ``launch.train --mesh smoke`` runs every step through it.
"""
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.distributed import api as jax_api
from repro.distributed import sharding as jax_sharding
from repro.launch import steps as jax_steps
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config, shapes_for
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, make_batch
from repro_torch.distributed import api, sharding
from repro_torch.distributed.sharding import AbstractMesh, PartitionSpec
from repro_torch.launch import mesh_check, steps, train
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.models import attention
from repro_torch.models.model import init_cache, init_model
from repro_torch.models.scan_util import (tree_leaves,
                                          tree_leaves_with_path, tree_map)
from repro_torch.optim.adamw import init_opt_state


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


REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


def meshes(name):
    sizes, names = MESHES[name]
    return JaxAbstractMesh(sizes, names), AbstractMesh(sizes, names)


@functools.lru_cache(maxsize=None)
def jax_model_shapes(arch):
    return jax_steps.model_shapes(jax_get_config(arch))


@functools.lru_cache(maxsize=None)
def port_model_shapes(arch):
    return steps.model_shapes(get_config(arch))


def jax_leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def specs_equal(jax_shardings, port_shardings):
    """Every leaf's spec, entry for entry (the port's ``PartitionSpec`` as
    a tuple against the reference's ``P``)."""
    j = [s.spec for s in jax.tree.leaves(jax_shardings)]
    p = [s.spec for s in tree_leaves(port_shardings)]
    assert len(j) == len(p)
    for a, b in zip(j, p):
        assert isinstance(b, PartitionSpec)
        assert tuple(a) == tuple(b) and b == a
    return len(p)


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_shardings_match_the_reference(arch, mesh_name, fsdp):
    jm, pm = meshes(mesh_name)
    jsds, psds = jax_model_shapes(arch), port_model_shapes(arch)
    jl, pl = jax_leaves(jsds), tree_leaves_with_path(psds)
    assert [tuple(x.shape) for _, x in jl] == \
        [tuple(x.shape) for _, x in pl]
    for (jp, leaf), (pp, _) in zip(jl, pl):
        path = sharding._path_str(pp)
        assert path == jax_sharding._path_str(jp)
        assert sharding.param_spec(path, tuple(leaf.shape), pm, fsdp) == \
            jax_sharding.param_spec(path, tuple(leaf.shape), jm, fsdp)
    n = specs_equal(jax_sharding.params_shardings(jsds, jm, fsdp),
                    sharding.params_shardings(psds, pm, fsdp))
    assert n == len(jl)
    # The optimizer state inherits them (NamedTuple fields dropped).
    jopt = jax_steps.opt_shapes(jax_get_config(arch), jsds) if fsdp \
        else None
    if jopt is not None:
        specs_equal(jax_sharding.params_shardings(jopt, jm),
                    sharding.params_shardings(
                        steps.opt_shapes(get_config(arch), psds), pm))


def test_param_spec_cases_of_the_reference_tests():
    """``tests/test_distributed.py``'s rule cases, which fail there only on
    the helper's old ``AbstractMesh`` signature."""
    m = AbstractMesh((16, 16), ("data", "model"))
    assert sharding.param_spec("embed/table", (32000, 2560), m) == \
        PartitionSpec("model", "data")
    assert sharding.param_spec("embed/table", (50280, 1024), m) == \
        PartitionSpec(None, "model")
    assert sharding.param_spec("layers/attn/wq/w", (48, 5120, 5120), m) == \
        PartitionSpec(None, "data", "model")
    assert sharding.param_spec("layers/moe/w_gate", (8, 160, 64, 128), m) \
        == PartitionSpec(None, "model", "data", None)
    assert sharding.param_spec("ln_f/scale", (64,), m) == \
        PartitionSpec(None)
    assert sharding.param_spec("x/w", (64, 33), m)[-1] is None


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_shardings_match_the_reference(arch, mesh_name):
    jm, pm = meshes(mesh_name)
    for shp in shapes_for(get_config(arch)):
        jspecs = jax_steps.input_specs(jax_get_config(arch),
                                       JAX_SHAPES[shp.name])
        pspecs = steps.input_specs(get_config(arch), shp)
        if shp.kind == "decode":
            specs_equal(jax_sharding.cache_shardings(jspecs["cache"], jm),
                        sharding.cache_shardings(pspecs["cache"], pm))
            jt, pt = ({"tokens": s["tokens"]} for s in (jspecs, pspecs))
        else:
            jt, pt = jspecs, pspecs
        specs_equal(jax_sharding.batch_shardings(jt, jm),
                    sharding.batch_shardings(pt, pm))


@pytest.mark.parametrize("seq_parallel", [True, False])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_policy_from_mesh_matches_the_reference(mesh_name, seq_parallel):
    jm, pm = meshes(mesh_name)
    assert dataclasses.asdict(api.policy_from_mesh(pm, seq_parallel)) == \
        dataclasses.asdict(jax_api.policy_from_mesh(jm, seq_parallel))


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert sharding.NamedSharding(
        m, PartitionSpec(("pod", "data"), None, "model")).placements == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.replicated(m).placements == (Replicate(),) * 3
    with pytest.raises(ValueError, match="shards tensor dims"):
        sharding.placements(PartitionSpec("data", "data"), m)
    with pytest.raises(ValueError, match="not axes"):
        sharding.placements(PartitionSpec("pod"),
                            AbstractMesh((1, 1), ("data", "model")))


# ----------------------------------------------------------------- shapes
def same_struct(jtree, ptree, ints_widen=False):
    j = jax_leaves(jtree)
    p = tree_leaves_with_path(ptree)
    assert len(j) == len(p)
    for (_, a), (_, b) in zip(j, p):
        assert b.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        want = str(a.dtype)
        if ints_widen and want == "int32":
            want = "int64"
        assert str(b.dtype).replace("torch.", "") == want


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_and_shapes_match_the_reference(arch):
    jcfg, pcfg = jax_get_config(arch), get_config(arch)
    same_struct(jax_model_shapes(arch), port_model_shapes(arch))
    jopt = jax_steps.opt_shapes(jcfg, jax_model_shapes(arch))
    popt = steps.opt_shapes(pcfg, port_model_shapes(arch))
    same_struct(jopt, popt)
    for shp in shapes_for(pcfg):
        jspecs = jax_steps.input_specs(jcfg, JAX_SHAPES[shp.name])
        pspecs = steps.input_specs(pcfg, shp)
        assert sorted(jspecs) == sorted(pspecs)
        # Token ids and the position: int64 in the port.
        same_struct(jspecs, pspecs, ints_widen=True)


# ------------------------------------------------------------- smoke mesh
@pytest.fixture
def smoke():
    """The smoke mesh on a world-1 gloo group, torn down afterwards."""
    assert not dist.is_initialized()
    mesh = make_smoke_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def test_smoke_mesh_train_and_serve_steps(smoke):
    """``tests/test_distributed.py::test_train_and_serve_steps_run_on_
    smoke_mesh``'s steps (zamba2-2.7b reduced, two microbatches, zero
    tokens), held to the port's unsharded steps (f32)."""
    assert smoke.mesh_dim_names == ("data", "model")
    assert tuple(smoke.shape) == (1, 1)
    cfg = dataclasses.replace(get_config("zamba2-2.7b", reduced=True),
                              dtype="float32")
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    opt_cfg = mesh_check.check_opt_config(cfg)
    opt_state = init_opt_state(params, opt_cfg)
    batch = {"tokens": torch.zeros((2, 32), dtype=torch.long)}
    want_p, want_s, want_m = steps.train_step(
        params, opt_state, batch, cfg=cfg, opt_cfg=opt_cfg, microbatches=2)
    p_sh = sharding.params_shardings(params, smoke)
    d_params = sharding.distribute(params, p_sh)
    d_opt = sharding.distribute(opt_state,
                                sharding.params_shardings(opt_state, smoke))
    d_batch = sharding.distribute(batch,
                                  sharding.batch_shardings(batch, smoke))
    with api.activation_policy(api.policy_from_mesh(smoke)):
        got_p, got_s, got_m = steps.train_step(
            d_params, d_opt, d_batch, cfg=cfg, opt_cfg=opt_cfg,
            microbatches=2)
    assert np.isfinite(float(got_m["loss"]))
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= \
        TOL * abs(float(want_m["loss"]))
    assert mesh_check.deviation(got_s, want_s)["max_rel"] <= TOL
    assert mesh_check.deviation(got_p, want_p,
                                mesh_check.PARAM_FLOOR)["max_rel"] <= TOL
    assert all(l.placements == s.placements for l, s in
               zip(tree_leaves(got_p), tree_leaves(p_sh)))

    cache = init_cache(cfg, 2, 16, device="cpu")
    d_cache = sharding.distribute(tree_map(torch.clone, cache),
                                  sharding.cache_shardings(cache, smoke))
    tok = torch.zeros((2, 1), dtype=torch.long)
    want_logits, _ = steps.serve_step(want_p, tok, cache, 0, cfg=cfg)
    got_logits, _ = steps.serve_step(got_p, tok, d_cache, 0, cfg=cfg)
    assert np.isfinite(got_logits.full_tensor().numpy()).all()
    assert mesh_check.deviation([got_logits], [want_logits])["max_rel"] \
        <= TOL
    assert mesh_check.deviation(d_cache, cache)["max_rel"] <= TOL


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v2-236b",
                                  "mamba2-370m"])
def test_smoke_mesh_check(smoke, arch):
    """``mesh_check``'s train and decode checks on the smoke mesh: the
    dense, MoE + MLA and SSD blocks' local paths (2 layers, reduced)."""
    cfg = mesh_check.check_config(arch, layers=2, reduced=True)
    train_r = mesh_check.train_check(smoke, cfg, "cpu", batch=4, seq=32)
    dec = mesh_check.decode_check(smoke, cfg, "cpu", batch=2, max_len=16)
    assert train_r["loss_rel"] <= TOL and train_r["max_rel"] <= TOL
    assert train_r["min_step"] > 5 * TOL        # the update shows
    assert dec["logits"]["max_rel"] <= TOL
    assert dec["cache"]["max_rel"] <= TOL


@pytest.mark.parametrize("fault", ["params_unchanged", "half_lr"])
def test_train_check_catches_a_wrong_update(smoke, monkeypatch, fault):
    """A sharded step with a planted fault in its update (the params
    returned as they came, or AdamW at half the learning rate) fails the
    check's 1e-5 rule by a wide margin, its loss and moments intact."""
    real = mesh_check.train_step

    def faulty(params, opt_state, batch, *, opt_cfg, **kw):
        if not api.is_sharded(*tree_leaves(params)):
            return real(params, opt_state, batch, opt_cfg=opt_cfg, **kw)
        if fault == "half_lr":
            return real(params, opt_state, batch, opt_cfg=dataclasses.replace(
                opt_cfg, lr=opt_cfg.lr / 2), **kw)
        _, new_s, met = real(params, opt_state, batch, opt_cfg=opt_cfg, **kw)
        return params, new_s, met

    monkeypatch.setattr(mesh_check, "train_step", faulty)
    cfg = mesh_check.check_config("h2o-danube-1.8b", layers=2, reduced=True)
    r = mesh_check.train_check(smoke, cfg, "cpu", batch=4, seq=32)
    assert r["loss_rel"] <= TOL
    assert r["max_rel"] > 3 * TOL and not r["worst_leaf"].startswith(".")


@pytest.mark.parametrize("noise, min_step, tol, guarded", [
    (7.3e-7, 7.3e-5, 1e-5, True),          # the CPU's noise: 1e-5 holds
    (2.25e-5, 7.3e-5, 4.5e-5, True),       # the card's cuBLASLt probe
    (4e-5, 7.3e-5, 8e-5, False),           # the rule would pass no update
    (0.0, 1e-5, 1e-5, False)])
def test_check_rule_is_the_measured_noise_under_min_step(noise, min_step,
                                                        tol, guarded):
    """``check_rule``: max(1e-5, twice the noise floor's largest probe),
    guarded only while it stays under the step's smallest param move."""
    rule = mesh_check.check_rule({"max_rel": noise}, min_step)
    assert rule["tol"] == pytest.approx(tol, rel=1e-12)
    assert rule["guarded"] is guarded
    assert rule["noise"] == noise and rule["min_step"] == min_step


@pytest.mark.parametrize("h,kvh,m", [(4, 2, 2), (32, 8, 16), (40, 8, 8),
                                     (16, 16, 16), (6, 2, 3)])
def test_kv_heads_are_those_the_query_heads_read(h, kvh, m):
    """``attention.kv_heads``: each model rank's share of the key heads,
    a slice of whole groups or one per query head, is the GQA repeat's
    rows for its query heads."""
    k = torch.randn((2, 3, kvh, 4), generator=torch.Generator().manual_seed(h))
    full = torch.repeat_interleave(k, h // kvh, dim=2)
    for r in range(m):
        h0, n = r * (h // m), h // m
        got = torch.repeat_interleave(
            attention.kv_heads(k, h0, n, h // kvh),
            n // attention.kv_heads(k, h0, n, h // kvh).shape[2], dim=2)
        assert torch.equal(got, full[:, :, h0:h0 + n])


def test_heads_strategy_on_the_smoke_mesh(smoke, monkeypatch):
    """``REPRO_ATTN_SHARD=heads``: q head-sharded on the model axis, the
    attention core run per head shard (``heads_parallel``), and the
    step held to the unsharded one."""
    calls = []
    real = attention.heads_parallel
    monkeypatch.setattr(attention, "heads_parallel",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("REPRO_ATTN_SHARD", "heads")
    cfg = mesh_check.check_config("h2o-danube-1.8b", layers=2, reduced=True)
    r = mesh_check.train_check(smoke, cfg, "cpu", batch=4, seq=32)
    assert calls and r["loss_rel"] <= TOL and r["max_rel"] <= TOL


def test_sharded_batch_prefetch_and_restore(smoke, tmp_path):
    """``make_batch(mesh=)`` and ``PrefetchIterator(mesh=)`` on the smoke
    mesh (one shard: the unsharded batch's rows), and a checkpoint of
    DTensor leaves restored with ``shardings=`` onto their placements."""
    from torch.distributed.tensor import DTensor
    model = get_config("internvl2-2b", reduced=True)
    dcfg = DataConfig(seed=1, global_batch=4, seq_len=32)
    got = make_batch(dcfg, model, 3, mesh=smoke)
    want = make_batch(dcfg, model, 3, device="cpu")
    assert sorted(got) == sorted(want) == ["frontend_embeds", "tokens"]
    for k in want:
        assert isinstance(got[k], DTensor)
        assert torch.equal(got[k].full_tensor(), want[k])
    it = PrefetchIterator(dcfg, model, mesh=smoke, start_step=3, depth=2,
                          device="cpu")
    s, b = next(it)
    it.close()
    assert s == 3 and torch.equal(b["tokens"].full_tensor(),
                                  want["tokens"])

    cfg = get_config("qwen2.5-14b", reduced=True)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    p_sh = sharding.params_shardings(params, smoke)
    d_params = sharding.distribute(params, p_sh)
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(7, d_params, extra={"step": 7})
    restored, extra = mgr.restore(params, shardings=p_sh)
    assert extra == {"step": 7}
    for r, p, sh in zip(tree_leaves(restored), tree_leaves(params),
                        tree_leaves(p_sh)):
        assert isinstance(r, DTensor) and r.placements == sh.placements
        assert torch.equal(r.full_tensor(), p)
    plain, _ = mgr.restore(params)          # the files are plain arrays
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(plain), tree_leaves(params)))


def test_train_driver_on_the_smoke_mesh_resumes(smoke, tmp_path, capsys,
                                                monkeypatch):
    """``launch.train --mesh smoke``: every step through the step it
    compiles on the mesh (``DTensor`` state), train then resume. The
    resumed run's first step (data step 0 again, as in the reference,
    from the checkpoint of step 2) has the loss of an eager sharded
    ``train_step`` from that state, bit for bit."""
    built, losses = [], []

    def spy_compile(*a, **kw):
        step = steps.compile_train_step(*a, **kw)
        built.append(step)
        real = step.__call__

        class Spy:
            def __getattr__(self, name):
                return getattr(step, name)

            def __call__(self, batch):
                metrics = real(batch)
                losses.append((len(built), metrics["loss"].clone()))
                return metrics

        return Spy()

    monkeypatch.setattr(train, "compile_train_step", spy_compile)
    base = ["--arch", "mamba2-370m", "--reduced", "--batch", "4", "--seq",
            "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1", "--device", "cpu", "--mesh", "smoke"]
    assert train.main(base + ["--steps", "3"]) == 0
    first = capsys.readouterr().out
    assert train.main(base + ["--steps", "4", "--resume"]) == 0
    second = capsys.readouterr().out
    assert "done: {'completed': 3, 'restarts': 0}" in first
    assert "resumed from step 2" in second
    assert "done: {'completed': 4, 'restarts': 0}" in second
    logged = [float(line.split()[3]) for line in (first + second).splitlines()
              if line.startswith("step ")]
    assert len(logged) == 7 and all(np.isfinite(logged))
    assert len(built) == 2 and all(
        isinstance(b, steps.CompiledTrainStep) and b.sharded
        and b.calls == n for b, n in zip(built, (3, 4)))
    assert [run for run, _ in losses] == [1] * 3 + [2] * 4

    cfg = get_config("mamba2-370m", reduced=True)
    dcfg = DataConfig(global_batch=4, seq_len=32)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    opt_cfg = steps.make_opt_config(cfg, total_steps=3)
    p, s = sharding.distribute(
        (params, init_opt_state(params, opt_cfg)),
        (sharding.params_shardings(params, smoke),
         sharding.params_shardings(init_opt_state(params, opt_cfg), smoke)))
    with api.activation_policy(api.policy_from_mesh(smoke)):
        for data_step in (0, 1, 0):
            p, s, want = steps.train_step(
                p, s, make_batch(dcfg, cfg, data_step, mesh=smoke), cfg=cfg,
                opt_cfg=opt_cfg)
    assert torch.equal(losses[3][1], want["loss"])


def test_production_meshes_need_their_world_size():
    """No group, or a group of another size: a ``ValueError`` naming the
    size needed, never a smaller mesh."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="world size 256"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="world size 512"):
        make_production_mesh(multi_pod=True, device="cpu")
    make_smoke_mesh("cpu")
    try:
        with pytest.raises(ValueError, match="world size 256; the default "
                                             "group has 1"):
            make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ 2×2, 4 ranks
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v2-236b"])
def test_two_by_two_mesh_matches_the_unsharded_step(arch):
    """Four gloo processes (torchrun, spawned by ``tools/check_mesh.py
    --lm``) on a (data 2, model 2) mesh: one train step of the reduced
    config at 2 layers, f32, two microbatches, and three decode steps,
    against the unsharded steps on the same weights and batch; then three
    calls of the train step compiled on the mesh against three eager
    sharded steps."""
    check_two_by_two(arch, "seq")


def test_two_by_two_mesh_heads_strategy():
    """The same on the 2×2 mesh under ``REPRO_ATTN_SHARD=heads``: each
    model rank attends with its two of the four query heads, and the
    head-parallel core is the one that ran (``train["cores"]``)."""
    result = check_two_by_two("h2o-danube-1.8b", "heads")
    assert result["train"]["cores"]["heads_parallel"] > 0
    assert result["train"]["cores"]["context_parallel"] == 0


def test_two_by_two_mesh_heads_strategy_mla_moe():
    """deepseek-v2-236b (MLA, MoE) on the 2×2 mesh under
    ``REPRO_ATTN_SHARD=heads``, the compiled step included."""
    check_two_by_two("deepseek-v2-236b", "heads")


def check_two_by_two(arch: str, attn_shard: str) -> dict:
    import os
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "check_mesh.py"), "--lm",
         "--device", "cpu", "--reduced", "--lm-mesh", "2x2", "--lm-arch",
         arch, "--timeout", "240"], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "REPRO_ATTN_SHARD": attn_shard})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    result = json.loads([line for line in proc.stdout.splitlines()
                         if line.startswith("{")][-1])
    assert result["ok"] and result["mesh"] == [2, 2]
    rule = result["rule"]
    assert rule["tol"] == max(mesh_check.BASE_TOL,
                              2 * result["noise_floor"]["max_rel"])
    assert rule["guarded"] and rule["min_step"] == result["train"]["min_step"]
    assert result["train"]["loss_rel"] <= TOL
    assert result["train"]["max_rel"] <= TOL
    assert result["train"]["min_step"] > 5 * TOL
    assert result["decode"]["logits"]["max_rel"] <= TOL
    assert result["decode"]["cache"]["max_rel"] <= TOL
    # The step compiled on the mesh (eager on the CPU) against three eager
    # sharded steps, bit for bit, its owned leaves where they were.
    compiled = result["compiled"]
    assert compiled["bit_equal"] and compiled["calls"] == 3
    assert compiled["layout_kept"] and not compiled["captured"]
    assert result["times"] is None
    return result
