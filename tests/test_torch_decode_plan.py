"""The LM decode step's activation plan on the mesh
(``distributed/api.py``'s ``decode_attend`` and ``CacheShard``,
``resident_linear`` under ``decode_plan``, ``models.ssm``'s sharded
step), on the CPU.

* Collectives against the reference: the reference's ``serve_step``
  compiled on four host devices as a (data 2, model 2) ``Mesh`` (a
  process of its own, for ``XLA_FLAGS``) with the setup of its
  ``launch/dryrun.py``: ``params_shardings(fsdp=False)``,
  ``cache_shardings``, ``policy_from_mesh(seq_parallel=False)``; its HLO
  read by its own ``repro.launch.dryrun.collective_bytes``. Against it,
  the port's ``serve_step`` traced on a fake 2×2 group
  (``launch.dryrun.TraceCounter``): reduced deepseek-v2-236b (MLA + MoE),
  qwen2.5-14b (GQA), mamba2-370m (SSD) and h2o-danube-1.8b (GQA under its
  reduced window of 64) at 2 layers, batch 4, caches 256 and 1024 (h2o
  32 and 64). (a) The port's total is at most 2x the reference's; (b)
  flat in the cache length for MLA and SSD, and for GQA growing by at
  most 2x the reference's growth (the port counts both layers, the
  reference's scanned body once); (c) no collective's operand is a param
  leaf's shard or a cache leaf's shard (the weights stay where they lie;
  no cache is made whole over the model axis); (d) the traced peak grows
  from the shorter cache to the longer by at most 2.5x the growth of the
  rank's own cache shards.
* Numbers on a gloo 2×2 mesh (``tools/check_mesh.py --lm
  --lm-decode-only``, four processes): three decode steps of each family
  through ``mesh_check.compiled_decode_check`` (eager on the CPU) bit for
  bit against the eager sharded steps, and within ``check_rule`` of the
  unsharded steps, logits and caches; h2o's ring wrapping, the new
  token's slot on each model rank, and the two caches shorter than a
  feature dim (the cache split on its features, not its slots).
* ``CacheShard.write``: the new token lands in the shard that holds its
  slot and nowhere else.

As a script, ``--reference-decode arch:layers:batch:seq ...`` prints the
reference's counts, one JSON line per cell (the subprocess the tests
start), and with ``--ops`` each collective of its HLO (op and result
type):

  XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
      PYTHONPATH=src python tests/test_torch_decode_plan.py \\
      --reference-decode deepseek-v2-236b:2:4:256 --ops
"""
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import api, sharding
from repro_torch.launch import dryrun, mesh_check, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.scan_util import (tree_leaves,
                                          tree_leaves_with_path)


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
BATCH = 4
# family: (arch, (shorter cache, longer cache))
FAMILIES = {"mla": ("deepseek-v2-236b", (256, 1024)),
            "gqa": ("qwen2.5-14b", (256, 1024)),
            "ssd": ("mamba2-370m", (256, 1024)),
            "gqa_window": ("h2o-danube-1.8b", (32, 64))}
REF_CELLS = tuple((arch, 2, BATCH, s) for arch, caches in FAMILIES.values()
                  for s in caches)
# Decode checks on the gloo 2×2 mesh, arch:cache:start. h2o's ring of 64
# wraps at position 64 (slots 62, 63 on model rank 1, then 0 on rank 0);
# qwen's and deepseek's slots 200.. lie on rank 1; deepseek at cache 32
# and h2o at cache 8 lay a cache on its features (kv_lora; head_dim).
DECODE_CASES = ("deepseek-v2-236b:256:0", "deepseek-v2-236b:256:200",
                "deepseek-v2-236b:32:0", "qwen2.5-14b:256:0",
                "qwen2.5-14b:256:200", "mamba2-370m:16:0",
                "h2o-danube-1.8b:64:62", "h2o-danube-1.8b:8:0")


# ------------------------------------------------------------ reference
def reference_decode_counts(arch: str, layers: int, batch: int,
                            seq: int) -> dict:
    """The reference's ``serve_step`` compiled on the process's four host
    devices as a (data 2, model 2) mesh, as its dry run compiles a decode
    cell: its HLO's collective bytes by its own counter, its temp bytes,
    and each collective's op and result type (``ops``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_config as jax_get_config
    from repro.configs.base import ShapeSpec as JaxShapeSpec
    from repro.distributed.api import activation_policy, policy_from_mesh
    from repro.distributed.sharding import (batch_shardings, cache_shardings,
                                            params_shardings, replicated)
    from repro.launch.steps import input_specs, model_shapes, serve_step
    devices = jax.devices()
    assert len(devices) == 4, devices
    # Imported once the backend holds its four devices: the module adds
    # 512 host devices to XLA_FLAGS when it is imported.
    from repro.launch.dryrun import collective_bytes
    cfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                              n_layers=layers)
    mesh = Mesh(np.array(devices).reshape(2, 2), ("data", "model"))
    params = model_shapes(cfg)
    specs = input_specs(cfg, JaxShapeSpec("probe", seq, batch, "decode"))
    with mesh, activation_policy(policy_from_mesh(mesh, seq_parallel=False)):
        c_sh = cache_shardings(specs["cache"], mesh)
        tok_sh = batch_shardings({"tokens": specs["tokens"]},
                                 mesh)["tokens"]
        compiled = jax.jit(
            functools.partial(serve_step, cfg=cfg),
            in_shardings=(params_shardings(params, mesh, fsdp=False), tok_sh,
                          c_sh, replicated(mesh)),
            out_shardings=(replicated(mesh), c_sh)).lower(
                params, specs["tokens"], specs["cache"],
                jax.ShapeDtypeStruct((), jnp.int32)).compile()
    hlo = compiled.as_text()
    total, by_op, counts = collective_bytes(hlo)
    ops = []
    for line in hlo.splitlines():
        m = re.search(r"= (.*?) (all-gather|all-reduce|reduce-scatter|"
                      r"all-to-all|collective-permute)(-start)?\(", line)
        if m:
            ops.append([m.group(2), m.group(1)])
    return {"cell": [arch, layers, batch, seq], "total": total,
            "by_op": by_op, "counts": counts,
            "temp": compiled.memory_analysis().temp_size_in_bytes,
            "ops": ops}


@functools.lru_cache(maxsize=None)
def reference() -> dict:
    """``reference_decode_counts`` of every ``REF_CELLS`` cell, from one
    process started with four host devices."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, __file__, "--reference-decode",
         *(":".join(map(str, c)) for c in REF_CELLS)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    return {tuple(r["cell"]): r for r in rows}


# ----------------------------------------------------------------- port
@dataclasses.dataclass
class Traced:
    total: int
    peak: int
    coll_log: list
    param_shards: set      # every param leaf's local shard shape (one
    cache_shards: set      # layer's of a stacked leaf); the caches' too
    cache_bytes: int       # the rank's own cache shards


@functools.lru_cache(maxsize=None)
def port(arch: str, seq: int, **overrides) -> Traced:
    """The port's ``serve_step`` traced as rank 0 of a fake (data 2,
    model 2) group, as ``launch.dryrun`` traces a decode cell."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), n_layers=2,
                              **overrides)
    shape = ShapeSpec("probe", seq, BATCH, "decode")
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        params_sds = steps.model_shapes(cfg)
        specs = steps.input_specs(cfg, shape)
        params = dryrun.place_fake(params_sds, sharding.params_shardings(
            params_sds, mesh, fsdp=False), mesh)
        cache = dryrun.place_fake(specs["cache"], sharding.cache_shardings(
            specs["cache"], mesh), mesh)
        tokens = dryrun.place_fake(specs["tokens"], sharding.batch_shardings(
            {"tokens": specs["tokens"]}, mesh)["tokens"], mesh)
        args = (params, tokens, cache,
                torch.zeros((), dtype=torch.long, device="meta"))
        counter = dryrun.TraceCounter()
        counter.track(args)
        with counter, api.activation_policy(api.policy_from_mesh(
                mesh, seq_parallel=False)):
            logits, _ = steps.serve_step(*args, cfg=cfg)
        assert tuple(logits.shape) == (BATCH, cfg.vocab)

        def shard_shapes(tree):
            """Each leaf's local shard shape, per layer for a stacked
            leaf (what one layer's step reads of it)."""
            return {tuple(t.to_local().shape)[
                int(path.startswith(("layers", "attn", "mamba"))):]
                for path, t in tree_leaves_with_path(tree)}
        c_bytes = sum(t.to_local().numel() * t.element_size()
                      for t in tree_leaves(cache))
        return Traced(sum(counter.coll.values()), counter.peak,
                      list(counter.coll_log), shard_shapes(params),
                      shard_shapes(cache), c_bytes)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_collectives_within_twice_the_references(family):
    arch, caches = FAMILIES[family]
    ref = reference()
    for s in caches:
        want = ref[(arch, 2, BATCH, s)]["total"]
        got = port(arch, s).total
        assert 0 < got <= 2 * want, (s, got, want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_collectives_flat_in_the_cache(family):
    """MLA and SSD move the same bytes whatever the cache length; GQA's
    bytes grow by at most twice the reference's growth (its all-to-all
    re-lays the cache onto head shards)."""
    arch, (short, long_) = FAMILIES[family]
    grow = port(arch, long_).total - port(arch, short).total
    if family in ("mla", "ssd"):
        assert grow == 0, grow
    else:
        ref = reference()
        ref_grow = ref[(arch, 2, BATCH, long_)]["total"] \
            - ref[(arch, 2, BATCH, short)]["total"]
        assert grow <= 2 * ref_grow, (grow, ref_grow)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_no_weight_and_no_cache_is_moved(family):
    """No collective's operand is a param leaf's local shard (a resident
    weight gathered or redistributed) or a cache leaf's (a cache made
    whole over the model axis, or re-laid), at either cache length."""
    arch, caches = FAMILIES[family]
    for s in caches:
        t = port(arch, s)
        assert t.coll_log, s
        moved = [(op, sh) for op, shapes in t.coll_log for sh in shapes
                 if sh in t.param_shards or sh in t.cache_shards]
        assert not moved, (s, moved, t.coll_log)


def test_a_vocab_that_does_not_divide_is_read_on_its_columns():
    """A vocab of 255 does not split over the model axis, so the rules
    put the tables' d there: the lookup reads each rank's columns and the
    logits are the columns' partial sums, all-reduced; neither table is
    gathered."""
    t = port("h2o-danube-1.8b", 32, vocab=255)
    moved = [(op, sh) for op, shapes in t.coll_log for sh in shapes
             if sh in t.param_shards]
    assert not moved, t.coll_log
    assert ("all-reduce", ((BATCH // 2, 1, 255),)) in t.coll_log


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_peak_follows_the_cache_shards(family):
    """The traced peak grows from the shorter cache to the longer by at
    most 2.5x the growth of the rank's own cache shards (the scores and
    the key and value heads a layer reads of its shards), and not at all
    where the caches do not grow (SSD)."""
    arch, (short, long_) = FAMILIES[family]
    a, b = port(arch, short), port(arch, long_)
    grow, shards = b.peak - a.peak, b.cache_bytes - a.cache_bytes
    assert grow <= 2.5 * shards, (grow, shards)
    if family == "ssd":
        assert shards == 0 and grow == 0


# ------------------------------------------------- the gloo 2×2 numbers
@functools.lru_cache(maxsize=None)
def two_by_two() -> dict:
    """``tools/check_mesh.py --lm --lm-decode-only`` on a 2×2 gloo mesh
    for every ``DECODE_CASES`` case: {case: its JSON line}."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "check_mesh.py"), "--lm",
         "--device", "cpu", "--reduced", "--lm-mesh", "2x2",
         "--lm-decode-only", "--lm-decode", *DECODE_CASES, "--timeout",
         "240"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    assert len(rows) == len(DECODE_CASES), proc.stdout[-3000:]
    return {case: r for case, r in zip(DECODE_CASES, rows)}


@pytest.mark.parametrize("case", DECODE_CASES)
def test_two_by_two_decode_matches_the_unsharded_step(case):
    """Three decode steps from the case's position, compiled on the mesh
    (eagerly on the CPU): bit-equal to the eager sharded steps, logits
    and caches within ``check_rule`` of the unsharded steps'."""
    arch, cache, start = case.split(":")
    r = two_by_two()[case]
    d = r["decode"]
    assert r["ok"] and r["mesh"] == [2, 2]
    assert (d["arch"], d["cache"], d["start"]) == (arch, int(cache),
                                                   int(start))
    comp, rule = d["compiled"], d["rule"]
    assert comp["bit_equal"] and comp["layout_kept"] and comp["calls"] == 3
    assert not comp["captured"]
    assert rule["tol"] == max(mesh_check.BASE_TOL,
                              2 * d["noise"]["max_rel"])
    for what in ("logits", "cache"):
        assert comp["deviation"][what]["max_rel"] <= rule["tol"]


@pytest.mark.parametrize("slot", [0, 3, 4, 7])
def test_write_lands_on_the_slot_owner_only(slot):
    """Two model ranks' shards of a ring of 8 slots (4 each): the new
    token is written at ``slot`` on the rank that holds it; the other
    rank's shard is left as it was (the slot it rewrites holds what it
    held)."""
    whole = torch.randn(2, 8, 3)
    new = torch.randn(2, 1, 3)
    want = whole.clone()
    want[:, slot] = new[:, 0]
    pos = torch.tensor([slot])
    for r in (0, 1):
        shard = whole[:, 4 * r:4 * r + 4].clone()
        part = api.CacheShard("seq", lo=4 * r, slots=8)
        out = part.write(shard, pos, new)
        assert out is shard
        assert torch.equal(shard, want[:, 4 * r:4 * r + 4])


def test_whole_cache_shard_is_the_plain_op():
    """Off the mesh (``WHOLE``) the decode core's cache ops are the plain
    ones: the slot written with ``index_copy_``, every slot scored, the
    softmax whole."""
    w = api.WHOLE
    cache, new = torch.randn(2, 5, 3), torch.randn(2, 1, 3)
    want = cache.clone().index_copy_(1, torch.tensor([2]), new)
    assert torch.equal(w.write(cache, torch.tensor([2]), new), want)
    assert torch.equal(w.slot_index(5, "cpu"), torch.arange(5))
    s = torch.randn(2, 4, 1, 5)
    assert w.scores(s) is s and w.local(s) is s
    v = torch.randn(2, 5, 4, 3)
    assert torch.equal(w.attend(s, v, "bhqk,bkhd->bqhd"), torch.einsum(
        "bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v))


# --------------------------------------------------- the compiled step
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v2-236b",
                                  "mamba2-370m"])
def test_compiled_serve_step_is_serve_step(arch):
    """``compile_serve_step`` on plain tensors (eager on the CPU): each
    call is one ``serve_step`` on the cache it owns, logits and cache bit
    for bit, h2o's ring wrapping on the third call."""
    from repro_torch.models.model import init_cache, init_model
    from repro_torch.models.scan_util import tree_map
    cfg = mesh_check.check_config(arch, 2, reduced=True)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = init_cache(cfg, BATCH, 64, device="cpu")
    step = steps.compile_serve_step(params, tree_map(torch.clone, cache),
                                    torch.zeros((BATCH, 1), dtype=torch.long),
                                    cfg=cfg)
    for pos in (62, 63, 64) if cfg.sliding_window else (0, 1, 2):
        tok = mesh_check.decode_tokens(cfg, BATCH, pos, "cpu")
        got = step(tok, pos).clone()
        want, _ = steps.serve_step(params, tok, cache, pos, cfg=cfg)
        assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(step.cache),
                                                 tree_leaves(cache)))
    assert step.graph is None and step.calls == 3
    with pytest.raises(ValueError, match="tokens"):
        step(torch.zeros((BATCH + 1, 1), dtype=torch.long), 0)


if __name__ == "__main__":
    assert sys.argv[1] == "--reference-decode", sys.argv
    for spec in sys.argv[2:]:
        if spec == "--ops":
            continue
        a, *nums = spec.split(":")
        r = reference_decode_counts(a, *map(int, nums))
        print(json.dumps(r), flush=True)
        if "--ops" in sys.argv:
            for op, result in r["ops"]:
                print(f"  {op} -> {result}", flush=True)
