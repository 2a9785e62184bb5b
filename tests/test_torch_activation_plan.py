"""The LM mesh's activation plan (``distributed/api.py``: column- and
row-parallel products, sequence-parallel norms, the vocab-parallel cross
entropy, the SSD heads on the model axis) and the restore into a tree's
own shards, on the CPU.

* Traced blocks: one GQA (h2o-danube-1.8b), one MLA + MoE
  (deepseek-v2-236b) and one SSD (mamba2-370m) block at reduced width,
  and the whole loss, traced on a fake (data 2, model 2) group
  (``launch.dryrun.TraceCounter``'s ``coll_log``): the only activations
  gathered are the sequence-sharded residual's shards, one gather per
  column-parallel group; no column-parallel output (q/k/v, gate/up,
  ``in_proj``) and no CE chunk's logits is gathered; one reduce-scatter
  per row-parallel branch.
* Collective totals against the reference: the reference's train step
  compiled on four host devices on a (data 2, model 2) ``Mesh`` (a
  process of its own, for ``XLA_FLAGS``), its HLO read by its own
  ``repro.launch.dryrun.collective_bytes``, against the port's
  ``trace_step`` on a fake 2×2 group: reduced h2o-danube-1.8b,
  mamba2-370m and deepseek-v2-236b at 2 layers, batch 4 × 64, two
  microbatches. The port's total is at most 2x the reference's.
* The unsharded step: each mesh helper is the identity on a plain
  tensor, no sharded product runs, and the loss and gradients hold to
  the reference's at ``tests/test_torch_lm_train.py``'s tolerances.
* The dry run's peak grows with the sequence length (S 256 → 1024,
  reduced h2o-danube-1.8b at 2 layers, batch 4, two microbatches) by at
  least a quarter of the reference's compiled ``temp_size_in_bytes``
  growth over the same step.
* The restore on a 2×2 gloo mesh (``tools/check_mesh.py --lm``, the SSD
  block's heads on the model axis): each rank's restored shards equal
  the saved arrays' slices bit for bit, and no rank made a sharded leaf
  whole (``mesh_check.restore_check``).

As a script, ``--reference arch:layers:batch:seq:microbatches ...``
prints the reference's counts, one JSON line per cell (the subprocess
the tests start):

  XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
      PYTHONPATH=src python tests/test_torch_activation_plan.py \\
      --reference h2o-danube-1.8b:2:4:64:2
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.bridge import lm_params_from_jax
from repro_torch.configs import get_config
from repro_torch.configs.base import BlockType, ShapeSpec
from repro_torch.distributed import api, sharding
from repro_torch.launch import dryrun, mesh_check, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.models.scan_util import (tree_at, tree_leaves,
                                          tree_leaves_with_path,
                                          tree_unflatten)


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
REF_CELLS = (("h2o-danube-1.8b", 2, 4, 64, 2), ("mamba2-370m", 2, 4, 64, 2),
             ("deepseek-v2-236b", 2, 4, 64, 2),
             ("h2o-danube-1.8b", 2, 4, 256, 2),
             ("h2o-danube-1.8b", 2, 4, 1024, 2))
# block: (arch, column-parallel groups, row-parallel branches)
BLOCKS = {"gqa": ("h2o-danube-1.8b", 2, 2),
          "mla_moe": ("deepseek-v2-236b", 2, 2),
          "ssd": ("mamba2-370m", 1, 1)}


# ------------------------------------------------------------ reference
def reference_counts(arch: str, layers: int, batch: int, seq: int,
                     micro: int) -> dict:
    """The reference's ``train_step`` compiled on the process's four host
    devices as a (data 2, model 2) mesh, under its policy and shardings:
    its HLO's collective bytes by its own counter, and its temp bytes."""
    from jax.sharding import Mesh

    from repro.configs.base import ShapeSpec as JaxShapeSpec
    from repro.distributed.api import activation_policy, policy_from_mesh
    from repro.distributed.sharding import batch_shardings, params_shardings
    from repro.launch.steps import (input_specs, make_opt_config,
                                    model_shapes, opt_shapes, train_step)
    devices = jax.devices()
    assert len(devices) == 4, devices
    # Imported once the backend holds its four devices: the module adds
    # 512 host devices to XLA_FLAGS when it is imported.
    from repro.launch.dryrun import collective_bytes
    cfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                              n_layers=layers)
    mesh = Mesh(np.array(devices).reshape(2, 2), ("data", "model"))
    params = model_shapes(cfg)
    opt = opt_shapes(cfg, params)
    specs = input_specs(cfg, JaxShapeSpec("probe", seq, batch, "train"))
    with mesh, activation_policy(policy_from_mesh(mesh)):
        p_sh, o_sh = params_shardings(params, mesh), \
            params_shardings(opt, mesh)
        compiled = jax.jit(
            functools.partial(train_step, cfg=cfg,
                              opt_cfg=make_opt_config(cfg),
                              microbatches=micro),
            in_shardings=(p_sh, o_sh, batch_shardings(specs, mesh)),
            out_shardings=(p_sh, o_sh, None)).lower(
                params, opt, specs).compile()
    total, by_op, counts = collective_bytes(compiled.as_text())
    return {"cell": [arch, layers, batch, seq, micro], "total": total,
            "by_op": by_op, "counts": counts,
            "temp": compiled.memory_analysis().temp_size_in_bytes}


@functools.lru_cache(maxsize=None)
def reference() -> dict:
    """``reference_counts`` of every ``REF_CELLS`` cell, from one process
    started with four host devices."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, __file__, "--reference",
         *(":".join(map(str, c)) for c in REF_CELLS)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    return {tuple(r["cell"]): r for r in rows}


def port_counts(arch: str, layers: int, batch: int, seq: int,
                micro: int) -> dryrun.Counts:
    """The port's dry-run counts of the same step on a fake 2×2 group."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              n_layers=layers)
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        return dryrun.trace_step(cfg, ShapeSpec("probe", seq, batch, "train"),
                                 mesh, microbatches=micro)["counts"]


# ------------------------------------------------------- traced blocks
def fake_tree(cfg, mesh):
    sds = steps.model_shapes(cfg)
    return dryrun.place_fake(sds, sharding.params_shardings(sds, mesh), mesh)


def residual(mesh, b: int, s: int, d: int, dtype):
    """A (b, s, d) residual placed as ``constrain_residual`` keeps it."""
    from torch.distributed.tensor import DTensor, Shard
    return DTensor.from_local(torch.empty((b // 2, s // 2, d), dtype=dtype,
                                          device="meta"), mesh,
                              (Shard(0), Shard(1)), run_check=False)


def traced(fn, *track):
    """``fn()`` under a ``TraceCounter`` (tracking ``track``), the 2×2
    mesh's policy and DTensor's implicit replication: (its output, the
    counter)."""
    from torch.distributed.tensor.experimental import implicit_replication
    counter = dryrun.TraceCounter()
    counter.track(track)
    with counter, implicit_replication():
        out = fn()
    return out, counter


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_collectives_follow_the_plan(block):
    from torch.distributed.tensor import Shard
    arch, groups, rows = BLOCKS[block]
    cfg = get_config(arch, reduced=True)
    b, s = 4, 64
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        layer = tree_at(fake_tree(cfg, mesh)["layers"], 0)
        x = residual(mesh, b, s, cfg.d_model, getattr(torch, cfg.dtype))
        apply = M._apply_mamba_block if cfg.block_type is BlockType.MAMBA \
            else (lambda *a: M._apply_attn_block(*a)[0])
        with api.activation_policy(api.policy_from_mesh(mesh)):
            out, c = traced(lambda: apply(layer, x, cfg), layer, x)
        assert out.placements == (Shard(0), Shard(1))
    shard = (b // 2, s // 2, cfg.d_model)
    gathers = [sh[0] for op, sh in c.coll_log if op == "all-gather"]
    # The residual's shards, once per column-parallel group; nothing whole
    # over the sequence (a column-parallel output is (b/2, s, ·)).
    assert gathers.count(shard) == groups, c.coll_log
    assert not [g for g in gathers if g[:2] == (b // 2, s)], c.coll_log
    scatters = [sh[0] for op, sh in c.coll_log if op == "reduce-scatter"]
    assert len(scatters) == rows and all(
        np.prod(sh) == b // 2 * s * cfg.d_model for sh in scatters), \
        c.coll_log


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-370m"])
def test_loss_gathers_no_logits(arch):
    """The whole loss's forward (2 layers): every activation gather is the
    residual's (two per attention layer, one per SSD layer, one for the
    final norm's output the CE reads); the CE chunks' vocab-sharded
    logits (b/2, c, V/2) are reduced, never gathered."""
    cfg = get_config(arch, reduced=True)
    b, s = 4, 64
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        params = fake_tree(cfg, mesh)
        specs = steps.input_specs(cfg, ShapeSpec("probe", s, b, "train"))
        batch = dryrun.place_fake(specs, sharding.batch_shardings(specs, mesh),
                                  mesh)
        with api.activation_policy(api.policy_from_mesh(mesh)), \
                torch.no_grad():
            (loss, _), c = traced(lambda: M.loss_fn(params, batch, cfg),
                                  params, batch)
        assert loss.shape == ()
    per_layer = 1 if cfg.block_type is BlockType.MAMBA else 2
    acts = [sh[0] for op, sh in c.coll_log
            if op == "all-gather" and len(sh[0]) >= 3]
    assert acts == [(b // 2, s // 2, cfg.d_model)] \
        * (per_layer * cfg.n_layers + 1), c.coll_log
    chunk = min(512, s - 1)
    assert not [sh for op, sh in c.coll_log
                if op == "all-gather" and sh[0][:2] == (b // 2, chunk)]
    assert c.coll_counts["all-reduce"] > 0     # the CE's (b/2, c) sums


@pytest.mark.parametrize("cell", REF_CELLS[:3], ids=lambda c: c[0])
def test_collective_bytes_within_twice_the_references(cell):
    ref = reference()[cell]
    got = port_counts(*cell)
    total = sum(got.coll.values())
    assert 0 < total <= 2 * ref["total"], (total, got.coll, ref)


def test_dryrun_peak_grows_with_the_sequence():
    ref = reference()
    short, long_ = REF_CELLS[3], REF_CELLS[4]
    grow = port_counts(*long_).peak - port_counts(*short).peak
    ref_grow = ref[long_]["temp"] - ref[short]["temp"]
    assert ref_grow > 0
    assert grow >= ref_grow / 4, (grow, ref_grow)


# ----------------------------------------------------- the unsharded step
def test_mesh_helpers_are_the_identity_off_the_mesh():
    t = torch.randn(2, 3, 4)
    for fn in (api.model_whole, api.residual_out, api.vocab_table,
               api.batch_sharded, api.gathered):
        assert fn(t) is t
    assert api.norm_scale(t, t) is t
    assert not api.last_dim_on_model(t)
    assert torch.equal(api.row_mean(t), torch.mean(t, dim=-1, keepdim=True))
    assert torch.equal(api.split_heads(t, 2), t.reshape(2, 3, 2, 2))


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "mamba2-370m",
                                  "deepseek-v2-236b"])
def test_unsharded_step_runs_no_sharded_product(name, monkeypatch):
    """No policy, plain tensors: none of the mesh's products or local
    blocks runs, and the loss and every gradient hold to the reference's
    (rtol 1e-5 on the loss, 1e-4 of each leaf's max on its gradient)."""
    def refuse(what):
        def run(*a, **k):
            raise AssertionError(f"{what} ran on the unsharded step")
        return run

    for mod, fn in ((api, "sharded_linear"), (api, "vocab_ce_sums"),
                    (api, "local_map"), (M, "vocab_ce_sums")):
        monkeypatch.setattr(mod, fn, refuse(fn))
    jcfg = dataclasses.replace(jax_get_config(name, reduced=True),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config(name, reduced=True),
                               dtype="float32")
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab, (2, 16)).astype(np.int32)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jcfg), has_aux=True))(
            jp, {"tokens": jnp.asarray(tokens)})
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    loss, _ = M.loss_fn(tree_unflatten(tp, leaves),
                        {"tokens": torch.as_tensor(tokens, dtype=torch.long)},
                        tcfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    names = [n for n, _ in tree_leaves_with_path(tp)]
    for leaf, got, want in zip(names, grads, jax.tree_util.tree_leaves(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=1e-4,
            atol=1e-4 * max(float(np.abs(want).max()), 1e-30), err_msg=leaf)


# ----------------------------------------------------------- the restore
def test_two_by_two_ssd_heads_and_restore():
    """mamba2-370m on a 2×2 gloo mesh (``tools/check_mesh.py --lm``): the
    SSD block's heads on the model axis within ``check_rule`` of the
    unsharded step, and the sharded state restored into a zeroed tree of
    its placements as the driver restores (mapped on the host, each
    rank's shards copied: ``mesh_check.restore_check``): every rank's
    shards equal the saved arrays' slices bit for bit, and no op made a
    new tensor the size of a sharded leaf."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "check_mesh.py"), "--lm",
         "--device", "cpu", "--reduced", "--lm-mesh", "2x2", "--lm-arch",
         "mamba2-370m", "--timeout", "240"], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    result = json.loads([line for line in proc.stdout.splitlines()
                         if line.startswith("{")][-1])
    assert result["ok"] and result["mesh"] == [2, 2]
    train = result["train"]
    assert train["loss_rel"] <= mesh_check.BASE_TOL
    assert train["max_rel"] <= result["rule"]["tol"] < train["min_step"]
    assert train["cores"] == {"heads_parallel": 0, "context_parallel": 0}
    restore = result["restore"]
    assert restore["bit_equal"] and restore["whole_made"] == 0
    assert restore["sharded_leaves"] > 0
    assert restore["leaves"] == train["leaves"]
    assert restore["extra"] == {"step": 1}
    assert "dry run of this step" in proc.stdout


def test_context_parallel_where_the_heads_do_not_split():
    """One query and key/value head (``--lm-heads 1 1``) on the 2×2 gloo
    mesh: q's columns split over the model axis mid-head, so the heads
    are gathered and the context-parallel core runs (the production
    meshes' path for 40 heads over 16 ranks), within ``check_rule``."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "check_mesh.py"), "--lm",
         "--device", "cpu", "--reduced", "--lm-mesh", "2x2", "--lm-heads",
         "1", "1", "--timeout", "240"], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    result = json.loads([line for line in proc.stdout.splitlines()
                         if line.startswith("{")][-1])
    train = result["train"]
    assert result["ok"] and train["cores"]["heads_parallel"] == 0
    assert train["cores"]["context_parallel"] > 0
    assert train["max_rel"] <= result["rule"]["tol"] < train["min_step"]
    assert result["decode"]["logits"]["max_rel"] <= result["rule"]["tol"]
    assert result["compiled"]["bit_equal"]


if __name__ == "__main__":
    assert sys.argv[1] == "--reference", sys.argv
    for spec in sys.argv[2:]:
        a, *nums = spec.split(":")
        print(json.dumps(reference_counts(a, *map(int, nums))), flush=True)
