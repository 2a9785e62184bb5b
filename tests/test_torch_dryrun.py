"""The port's dry run and roofline (``launch/dryrun.py``,
``launch/roofline.py``) on the CPU, on fake process groups.

* Per-chip parameter bytes: the dry run's ``sharded_bytes`` over the
  port's specs equals the reference's arithmetic (each sharded dim
  rounded up over its axes, times the item size) over the reference's
  specs, for every architecture × shape on both production meshes, with
  each cell's resident-weight choice; ``params_total`` / ``params_active``
  and the roofline's ``model_flops_per_chip`` equal the reference's
  formulas. The decode cells whose weights become resident under the
  H100 budget (80 GB · 7/8 at TP 16, where the reference had 14 GB of a
  16 GB chip) are named.
* The collective counter: a known FSDP gather and a known TP reduction
  on a fake 2×2 group count their analytic operand bytes per chip.
* The roofline's ``total`` (two probes, extrapolated per unit) equals a
  direct count of the full-depth config within 1e-6, on a fake 16×16
  group, for a dense, a hybrid and an interleaved-MoE reduced config.
* One full-width cell of each CLI (``python -m repro_torch.launch.dryrun``
  / ``.roofline``) in a process of its own, its JSON carrying the
  reference's keys.
"""
import dataclasses
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
from repro.distributed import sharding as jax_sharding
from repro.launch import steps as jax_steps
from repro_torch.configs import ARCH_NAMES, get_config, shapes_for
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh


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
PROD = {"pod": ((16, 16), ("data", "model")),
        "multipod": ((2, 16, 16), ("pod", "data", "model"))}
REFERENCE_KEYS = {"arch", "shape", "mesh", "kind", "n_devices", "seq_len",
                  "global_batch", "lower_s", "compile_s", "flops_total",
                  "bytes_accessed_total", "cost_analysis_keys",
                  "memory_analysis", "collective_bytes_total",
                  "collective_bytes_by_op", "collective_op_counts",
                  "param_bytes_per_device", "params_total", "params_active",
                  "ok"}


def reference_sharded_bytes(sds_tree, sh_tree, sizes) -> int:
    """``repro/launch/dryrun.py::run_cell``'s ``sharded_bytes``."""
    total = 0
    for sds, sh in zip(jax.tree.leaves(sds_tree), jax.tree.leaves(sh_tree)):
        elems = 1
        spec = sh.spec
        for i, dim in enumerate(sds.shape):
            ax = spec[i] if i < len(spec) else None
            if ax is None:
                elems *= dim
            else:
                n = 1
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    n *= sizes[a]
                elems *= -(-dim // n)
        total += elems * sds.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh", sorted(PROD))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_bytes_per_device_match_the_reference(arch, mesh):
    sizes, names = PROD[mesh]
    jm, pm = JaxAbstractMesh(sizes, names), AbstractMesh(sizes, names)
    jcfg, pcfg = jax_get_config(arch), get_config(arch)
    assert pcfg.param_count() == jcfg.param_count()
    assert pcfg.active_param_count() == jcfg.active_param_count()
    jsds = jax_steps.model_shapes(jcfg)
    psds = steps.model_shapes(pcfg)
    for shp in shapes_for(pcfg):
        resident = dryrun.is_resident(pcfg, shp)
        want = reference_sharded_bytes(
            jsds, jax_sharding.params_shardings(jsds, jm, fsdp=not resident),
            dict(zip(names, sizes)))
        got = dryrun.sharded_bytes(
            psds, sharding.params_shardings(psds, pm, fsdp=not resident), pm)
        assert got == want
        if resident:            # resident weights fit the card
            assert got < dryrun.HBM_BYTES
        jshape = JAX_SHAPES[shp.name]
        assert roofline.model_flops(pcfg, shp) / 256 == pytest.approx(
            (6 if shp.kind == "train" else 2) * jcfg.active_param_count()
            * jshape.global_batch
            * (jshape.seq_len if shp.kind != "decode" else 1) / 256,
            rel=1e-12)


def test_resident_decode_cells_under_the_h100_budget():
    """The reference keeps bf16 decode weights resident below 14e9 bytes
    at TP 16; the port below 7/8 of 80 GB. Two architectures move from
    FSDP to resident: deepseek-v2-236b and llama4-maverick-400b-a17b."""
    moved = set()
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shp in shapes_for(cfg):
            ref = shp.kind == "decode" and cfg.param_count() * 2 / 16 <= 14e9
            assert not ref or dryrun.is_resident(cfg, shp)
            if dryrun.is_resident(cfg, shp) and not ref:
                moved.add((arch, shp.name))
    assert moved == {("deepseek-v2-236b", "decode_32k"),
                     ("llama4-maverick-400b-a17b", "decode_32k")}


@pytest.fixture
def fake_2x2():
    assert not dist.is_initialized()
    with dryrun.fake_world(4):
        yield make_mesh_2x2()


def make_mesh_2x2():
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((2, 2), ("data", "model"), "cpu")


def test_collective_counter_counts_known_gathers_and_reductions(fake_2x2):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake_2x2
    w_sds = {"proj": {"w": torch.empty((64, 32), dtype=torch.bfloat16,
                                       device="meta")}}
    w = dryrun.place_fake(w_sds, sharding.params_shardings(w_sds, mesh),
                          mesh)["proj"]["w"]
    assert w.placements == (Shard(0), Shard(1))
    c = dryrun.TraceCounter()
    c.track(w)
    with c:       # the FSDP gather: data replicated, the model shard kept
        g = w.redistribute(mesh, (Replicate(), Shard(1)))
    assert g.to_local().shape == (64, 16)
    assert c.coll_counts["all-gather"] == 1
    assert c.coll["all-gather"] == 32 * 16 * 2        # the local shard
    assert sum(c.coll.values()) == c.coll["all-gather"]

    x = DTensor.from_local(torch.empty((4, 32), device="meta"), mesh,
                           (Shard(0), Shard(1)), run_check=False)
    v = DTensor.from_local(torch.empty((32, 16), device="meta"), mesh,
                           (Replicate(), Shard(0)), run_check=False)
    c = dryrun.TraceCounter()
    c.track((x, v))
    with c:       # TP: the contraction dim on the model axis, then reduce
        y = (x @ v).redistribute(mesh, (Shard(0), Replicate()))
    assert y.shape == (8, 16) and y.to_local().shape == (4, 16)
    assert c.flops == 2 * 4 * 32 * 16                  # the local product
    assert c.coll_counts["all-reduce"] == 1
    assert c.coll["all-reduce"] == 4 * 16 * 4          # f32 partial sums
    assert c.coll["all-gather"] == 0


def test_fake_world_refuses_a_real_group():
    make_smoke_mesh("cpu")
    try:
        with pytest.raises(RuntimeError, match="exists already"):
            with dryrun.fake_world(4):
                pass
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,layers", [("qwen2.5-14b", 4),
                                         ("zamba2-2.7b", 6),
                                         ("llama4-maverick-400b-a17b", 6)])
def test_roofline_total_matches_a_direct_full_depth_count(arch, layers):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              n_layers=layers)
    shape = ShapeSpec("probe", 64, 32, "train")
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        r = roofline.analyze(cfg, shape, mesh)
        p_sh = sharding.params_shardings(steps.model_shapes(cfg), mesh)
        direct = dryrun._trace(cfg, shape, mesh, p_sh, 1)
    assert r["n_units"] == layers // roofline.scan_unit(cfg) > 2
    for key, want in (("flops", direct.flops), ("bytes", direct.bytes),
                      ("coll", sum(direct.coll.values()))):
        assert want > 0
        assert r["total"][key] == pytest.approx(want, rel=1e-6)
    assert r["model_flops_per_chip"] == roofline.model_flops(cfg, shape) \
        / 256


def run_module(module, *args, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", module, *args, "--out-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_dryrun_cli_cell(tmp_path):
    """``qwen2.5-14b × decode_32k × pod`` at full width: the reference's
    keys, its parameter-byte arithmetic, and per-chip figures that fit."""
    out = run_module("repro_torch.launch.dryrun", "--arch", "qwen2.5-14b",
                     "--shape", "decode_32k", "--mesh", "pod",
                     tmp_path=tmp_path)
    assert "[OK] qwen2.5-14b × decode_32k × pod_16x16" in out
    r = json.loads((tmp_path / "qwen2.5-14b__decode_32k__pod_16x16.json")
                   .read_text())
    assert REFERENCE_KEYS <= set(r) and r["ok"]
    assert r["n_devices"] == 256 and r["resident_weights"]
    jcfg = jax_get_config("qwen2.5-14b")
    jsds = jax_steps.model_shapes(jcfg)
    sizes, names = PROD["pod"]
    assert r["param_bytes_per_device"] == reference_sharded_bytes(
        jsds, jax_sharding.params_shardings(
            jsds, JaxAbstractMesh(sizes, names), fsdp=False),
        dict(zip(names, sizes)))
    assert r["params_total"] == jcfg.param_count()
    assert r["flops_total"] > 0 and r["bytes_accessed_total"] > 0
    assert r["collective_bytes_total"] == sum(
        r["collective_bytes_by_op"].values()) > 0
    mem = r["memory_analysis"]
    assert 0 < mem["argument_size_in_bytes"] < 80e9
    assert 0 < mem["temp_size_in_bytes"] < 80e9


def test_roofline_cli_cell(tmp_path):
    out = run_module("repro_torch.launch.roofline", "--arch", "mamba2-370m",
                     "--shape", "long_500k", tmp_path=tmp_path)
    assert "[OK] mamba2-370m × long_500k" in out
    r = json.loads((tmp_path / "mamba2-370m__long_500k.json").read_text())
    assert r["ok"] and r["n_units"] == 48 and r["bound"] in (
        "compute", "memory", "collective")
    assert r["roofline_total_s"] == max(r["compute_s"], r["memory_s"],
                                        r["collective_s"]) > 0
    assert r["compute_s"] == r["total"]["flops"] / 989e12
    assert r["memory_s"] == r["total"]["bytes"] / 3.35e12
    assert r["collective_s"] == r["total"]["coll"] / 50e9
    assert np.isclose(r["model_flops_per_chip"],
                      2 * get_config("mamba2-370m").active_param_count()
                      / 256)
