"""The LM prefill step's activation plan on the mesh
(``distributed/api.py``'s ``prefill_plan``, ``last_row`` and
``SeqRows``; ``models.ssm._mamba_rows``), on the CPU.

* Collectives against the reference: the reference's ``prefill_step``
  compiled on four host devices as a (data 2, model 2) ``Mesh`` (a
  process of its own, for ``XLA_FLAGS``) with the setup of its
  ``launch/dryrun.py``: ``params_shardings(fsdp=True)``,
  ``batch_shardings``, ``policy_from_mesh(seq_parallel=True)``,
  ``out_shardings=replicated(mesh)``; its HLO read by its own
  ``repro.launch.dryrun.collective_bytes``. Against it, the port's
  ``prefill_step`` traced as rank 0 of a fake 2×2 group
  (``launch.dryrun.TraceCounter``): reduced deepseek-v2-236b (MLA + MoE),
  qwen2.5-14b (GQA), mamba2-370m (SSD) and internvl2-2b (a front end, its
  vocab cut to 255 so that it does not split over the model axis) at 2
  layers, batch 4, sequences 256 and 1024. (a) The port's total is at
  most 2x the reference's; (b) no collective's operand is the rank's
  whole (B_local, S, d) hidden, but the MoE's combined output (the
  reference all-reduces the whole (B, S, d) there), the last row moves
  one row a sequence, and the total grows from the shorter sequence to
  the longer by at most 2x the reference's growth; (c) the logits come
  back replicated, as the reference's ``out_shardings``.
* (d) Numbers on a gloo 2×2 mesh (``tools/check_mesh.py --lm
  --lm-prefill-only``, four processes): ``compile_prefill_step`` on the
  mesh (eager on the CPU) over five batches, each call's logits
  bit-equal to the eager sharded prefill's and replicated, and within
  ``check_rule`` of the unsharded prefill; internvl2-2b's and
  musicgen-medium's front ends, the hybrid and interleaved stacks, and
  SSD rows that do not align with its chunks included.
* (e) The unsharded prefill: bit-equal to ``forward`` and
  ``logits_from_hidden`` of the last position on the same weights, and
  within 1e-4 of the reference's prefill on its weights (f32); the SSD
  scan started from a carried state equal to the reference's scan of the
  whole sequence.

As a script, ``--reference-prefill arch:layers:batch:seq[:vocab] ...``
prints the reference's counts, one JSON line per cell (the subprocess
the tests start), and with ``--ops`` each collective of its HLO (op and
result type):

  XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
      PYTHONPATH=src python tests/test_torch_prefill_plan.py \\
      --reference-prefill qwen2.5-14b:2:4:256 --ops
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
from repro_torch.models import model as M


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
SEQS = (256, 1024)
# family: (arch, vocab override or 0)
FAMILIES = {"mla_moe": ("deepseek-v2-236b", 0), "gqa": ("qwen2.5-14b", 0),
            "ssd": ("mamba2-370m", 0), "frontend": ("internvl2-2b", 255)}
REF_CELLS = tuple((arch, 2, BATCH, s, v) for arch, v in FAMILIES.values()
                  for s in SEQS)
# Prefill checks on the gloo 2×2 mesh, arch:batch:seq[:vocab]. mamba2's
# chunk is 32: 40 tokens give each model rank 20 rows (one short chunk),
# 88 give 44 (a chunk and a padded one).
PREFILL_CASES = ("h2o-danube-1.8b:4:64", "deepseek-v2-236b:4:64",
                 "mamba2-370m:4:64", "mamba2-370m:4:40", "mamba2-370m:4:88",
                 "internvl2-2b:4:64:255", "musicgen-medium:4:64",
                 "zamba2-2.7b:4:64", "llama4-maverick-400b-a17b:4:64")


# ------------------------------------------------------------ reference
def reference_prefill_counts(arch: str, layers: int, batch: int, seq: int,
                             vocab: int = 0) -> dict:
    """The reference's ``prefill_step`` compiled on the process's four
    host devices as a (data 2, model 2) mesh, as its dry run compiles a
    prefill cell: its HLO's collective bytes by its own counter, its temp
    bytes, and each collective's op and result type (``ops``)."""
    import jax
    from jax.sharding import Mesh

    from repro.configs import get_config as jax_get_config
    from repro.configs.base import ShapeSpec as JaxShapeSpec
    from repro.distributed.api import activation_policy, policy_from_mesh
    from repro.distributed.sharding import (batch_shardings,
                                            params_shardings, replicated)
    from repro.launch.steps import input_specs, model_shapes, prefill_step
    devices = jax.devices()
    assert len(devices) == 4, devices
    # Imported once the backend holds its four devices: the module adds
    # 512 host devices to XLA_FLAGS when it is imported.
    from repro.launch.dryrun import collective_bytes
    cfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                              n_layers=layers,
                              **({"vocab": vocab} if vocab else {}))
    mesh = Mesh(np.array(devices).reshape(2, 2), ("data", "model"))
    params = model_shapes(cfg)
    specs = input_specs(cfg, JaxShapeSpec("probe", seq, batch, "prefill"))
    with mesh, activation_policy(policy_from_mesh(mesh, seq_parallel=True)):
        compiled = jax.jit(
            functools.partial(prefill_step, cfg=cfg),
            in_shardings=(params_shardings(params, mesh, fsdp=True),
                          batch_shardings(specs, mesh)),
            out_shardings=replicated(mesh)).lower(params, specs).compile()
    hlo = compiled.as_text()
    total, by_op, counts = collective_bytes(hlo)
    ops = []
    for line in hlo.splitlines():
        m = re.search(r"= (.*?) (all-gather|all-reduce|reduce-scatter|"
                      r"all-to-all|collective-permute)(-start)?\(", line)
        if m:
            ops.append([m.group(2), m.group(1)])
    return {"cell": [arch, layers, batch, seq, vocab], "total": total,
            "by_op": by_op, "counts": counts,
            "temp": compiled.memory_analysis().temp_size_in_bytes,
            "ops": ops}


@functools.lru_cache(maxsize=None)
def reference() -> dict:
    """``reference_prefill_counts`` of every ``REF_CELLS`` cell, from one
    process started with four host devices."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, __file__, "--reference-prefill",
         *(":".join(map(str, c)) for c in REF_CELLS)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    return {tuple(r["cell"]): r for r in rows}


def ref_cell(family: str, seq: int) -> dict:
    arch, vocab = FAMILIES[family]
    return reference()[(arch, 2, BATCH, seq, vocab)]


# ----------------------------------------------------------------- port
@dataclasses.dataclass
class Traced:
    total: int
    coll_log: list
    logits: tuple          # (shape, placements)
    d_model: int


@functools.lru_cache(maxsize=None)
def port(family: str, seq: int) -> Traced:
    """The port's ``prefill_step`` traced as rank 0 of a fake (data 2,
    model 2) group, as ``launch.dryrun`` traces a prefill cell."""
    arch, vocab = FAMILIES[family]
    cfg = dataclasses.replace(get_config(arch, reduced=True), n_layers=2,
                              **({"vocab": vocab} if vocab else {}))
    shape = ShapeSpec("probe", seq, BATCH, "prefill")
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        params_sds = steps.model_shapes(cfg)
        specs = steps.input_specs(cfg, shape)
        params = dryrun.place_fake(params_sds, sharding.params_shardings(
            params_sds, mesh, fsdp=True), mesh)
        batch = dryrun.place_fake(specs, sharding.batch_shardings(
            specs, mesh), mesh)
        counter = dryrun.TraceCounter()
        counter.track((params, batch))
        with counter, api.activation_policy(api.policy_from_mesh(
                mesh, seq_parallel=True)):
            logits = steps.prefill_step(params, batch, cfg=cfg)
        return Traced(sum(counter.coll.values()), list(counter.coll_log),
                      (tuple(logits.shape), tuple(logits.placements)),
                      cfg.d_model)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_collectives_within_twice_the_references(family):
    for s in SEQS:
        want = ref_cell(family, s)["total"]
        got = port(family, s).total
        assert 0 < got <= 2 * want, (s, got, want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_hidden_never_moves_whole(family):
    """(b) No collective's operand holds the rank's whole (B_local, S, d)
    hidden, save the MoE's combined output (a partial sum over the model
    axis' experts, reduce-scattered back onto the rows), which the
    reference's own HLO all-reduces whole over (B, S, d); the last row
    moves as one gather of (B_local, 1, d); and the bytes grow from the
    shorter sequence to the longer by at most twice the reference's
    growth."""
    b_local = BATCH // 2
    for s in SEQS:
        t = port(family, s)
        hidden = b_local * s * t.d_model
        whole = [(op, sh) for op, shapes in t.coll_log for sh in shapes
                 if int(np.prod(sh)) >= hidden]
        if family == "mla_moe":
            assert whole and all(op == "reduce-scatter" for op, _ in whole)
            ref_whole = [r for _, r in ref_cell(family, s)["ops"]
                         if f"[{BATCH},{s},{t.d_model}]" in r]
            assert ref_whole, ref_cell(family, s)["ops"]
        else:
            assert not whole, (s, whole)
        assert ("all-gather", ((b_local, 1, t.d_model),)) in t.coll_log
    grow = port(family, SEQS[1]).total - port(family, SEQS[0]).total
    ref_grow = ref_cell(family, SEQS[1])["total"] \
        - ref_cell(family, SEQS[0])["total"]
    assert grow <= 2 * ref_grow, (grow, ref_grow)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_logits_come_back_replicated(family):
    from torch.distributed.tensor import Replicate
    arch, vocab = FAMILIES[family]
    shape, placements = port(family, SEQS[0]).logits
    assert shape == (BATCH, vocab or get_config(arch, reduced=True).vocab)
    assert placements == (Replicate(), Replicate())


# ------------------------------------------------- the gloo 2×2 numbers
@functools.lru_cache(maxsize=None)
def two_by_two() -> dict:
    """``tools/check_mesh.py --lm --lm-prefill-only`` on a 2×2 gloo mesh
    for every ``PREFILL_CASES`` case: {case: its JSON line}."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "check_mesh.py"), "--lm",
         "--device", "cpu", "--reduced", "--lm-mesh", "2x2",
         "--lm-prefill-only", "--lm-prefill", *PREFILL_CASES, "--timeout",
         "240"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    assert len(rows) == len(PREFILL_CASES), proc.stdout[-3000:]
    return {case: r for case, r in zip(PREFILL_CASES, rows)}


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_two_by_two_prefill_matches_the_unsharded_step(case):
    """Five prefills on fresh tokens, compiled on the mesh (eagerly on
    the CPU): each bit-equal to the eager sharded prefill and
    replicated, all within ``check_rule`` of the unsharded prefill; the
    attention families ran the context-parallel core."""
    arch, batch, seq, *vocab = case.split(":")
    r = two_by_two()[case]
    p = r["prefill"]
    assert r["ok"] and r["mesh"] == [2, 2]
    assert (p["arch"], p["batch"], p["seq"]) == (arch, int(batch), int(seq))
    if vocab:
        assert p["vocab"] == int(vocab[0])
    comp, rule = p["compiled"], p["rule"]
    assert comp["bit_equal"] and comp["replicated"] and comp["layout_kept"]
    assert comp["calls"] == steps.WARM_PASSES + 3 and not comp["captured"]
    assert rule["tol"] == max(mesh_check.BASE_TOL,
                              2 * p["noise"]["max_rel"])
    assert comp["deviation"]["max_rel"] <= rule["tol"]
    attends = get_config(arch).block_type.name != "MAMBA" \
        or get_config(arch).attn_every
    assert bool(comp["cores"]["context_parallel"]) == bool(attends)
    assert not comp["cores"]["heads_parallel"]


def test_prefill_check_on_the_smoke_mesh():
    """``mesh_check.prefill_check`` on a one-rank gloo mesh with the
    production axis names (``make_smoke_mesh``, its group started and
    destroyed here): the sharded prefill's logits come back replicated
    and within 1e-5 of the unsharded ones, the SSD block on its rows and
    the GQA core context-parallel."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh
    assert not dist.is_initialized()
    mesh = make_smoke_mesh("cpu")
    try:
        for arch, cores in (("mamba2-370m", 0), ("qwen2.5-14b", 2)):
            r = mesh_check.prefill_check(
                mesh, mesh_check.check_config(arch, 2, reduced=True), "cpu",
                batch=2, seq=32)
            assert r["replicated"], r
            assert r["logits"]["max_rel"] <= mesh_check.BASE_TOL, r
            assert r["cores"] == {"heads_parallel": 0,
                                  "context_parallel": cores}, r
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------- unsharded
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen2.5-14b",
                                  "mamba2-370m", "internvl2-2b"])
def test_unsharded_prefill_is_forward_and_the_last_row(arch):
    """(e) Off the mesh ``prefill`` is ``forward``, then
    ``logits_from_hidden`` of the last position, bit for bit (the plan's
    helpers are the plain ops on plain tensors)."""
    cfg = mesh_check.check_config(arch, 2, reduced=True)
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(11)
    n_front = cfg.frontend_tokens if cfg.frontend != "none" else 0
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 40 - n_front)))
    fe = torch.as_tensor(rng.standard_normal(
        (3, n_front, cfg.frontend_dim)).astype(np.float32)) \
        if n_front else None
    got = M.prefill(params, tokens, cfg, fe)
    hidden, _ = M.forward(params, tokens, cfg, fe)
    want = M.logits_from_hidden(params, cfg, hidden[:, -1:, :])[:, 0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen2.5-14b",
                                  "mamba2-370m", "internvl2-2b"])
def test_unsharded_prefill_matches_the_reference(arch):
    """The port's ``prefill`` against the reference's on its weights
    (``bridge.lm_params_from_jax``) and the same numpy tokens, f32:
    within 1e-4 of the logits' largest magnitude."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import model as JM
    from repro_torch.bridge import lm_params_from_jax
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               dtype="float32", n_layers=2)
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               dtype="float32", n_layers=2)
    jp = JM.init_model(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(12)
    n_front = tcfg.frontend_tokens if tcfg.frontend != "none" else 0
    tokens = rng.integers(0, tcfg.vocab, (2, 24 - n_front)).astype(np.int32)
    fe = rng.standard_normal((2, n_front, tcfg.frontend_dim)).astype(
        np.float32) if n_front else None
    want = np.asarray(JM.prefill(jp, jnp.asarray(tokens), jcfg,
                                 None if fe is None else jnp.asarray(fe)))
    got = M.prefill(tp, torch.as_tensor(tokens, dtype=torch.long), tcfg,
                    None if fe is None else torch.as_tensor(fe)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_ssd_scan_from_a_carried_state_is_the_whole_scan():
    """``ssd_chunked`` on the second half of a sequence, started from the
    first half's final state (what ``SeqRows.carry`` hands a rank), equals
    the reference's scan of the whole sequence there; chunks that do not
    align with the halves included."""
    import jax.numpy as jnp

    from repro.models.ssm import ssd_chunked as jax_ssd_chunked
    from repro_torch.models.ssm import ssd_chunked
    rng = np.random.default_rng(13)
    b, l, h, p, n, half = 2, 44, 3, 4, 5, 20
    xbar = rng.standard_normal((b, l, h, p)).astype(np.float32)
    da = -np.abs(rng.standard_normal((b, l, h))).astype(np.float32) * 0.3
    b_in = rng.standard_normal((b, l, n)).astype(np.float32)
    c_in = rng.standard_normal((b, l, n)).astype(np.float32)
    want = np.asarray(jax_ssd_chunked(*(jnp.asarray(a) for a in (
        xbar, da, b_in, c_in)), 8))
    state = np.zeros((b, h, n, p), np.float32)    # the first half, in order
    for t in range(half):
        state = state * np.exp(da[:, t])[:, :, None, None] \
            + np.einsum("bn,bhp->bhnp", b_in[:, t], xbar[:, t])
    seen = []

    def carry(states, decay):
        seen.append((tuple(states.shape), tuple(decay.shape)))
        return torch.as_tensor(state)

    got = ssd_chunked(*(torch.as_tensor(a[:, half:]) for a in (
        xbar, da, b_in, c_in)), 8, carry=carry)
    assert seen == [((b, 3, h, n, p), (b, h, 3))]
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want[:, half:]).max() <= 1e-5 * scale
    plain = ssd_chunked(*(torch.as_tensor(a) for a in (
        xbar, da, b_in, c_in)), 8)
    assert np.abs(plain.numpy() - want).max() <= 1e-5 * scale


# --------------------------------------------------- the compiled step
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "internvl2-2b"])
def test_compiled_prefill_step_is_prefill_step(arch):
    """``compile_prefill_step`` on plain tensors (eager on the CPU): each
    call is one ``prefill_step`` on the params it owns, bit for bit, the
    front end's embeddings read from their own buffer; a batch of
    another shape or keys is refused."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    cfg = mesh_check.check_config(arch, 2, reduced=True)
    params = M.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    feeds = [make_batch(DataConfig(seed=5, global_batch=BATCH, seq_len=32),
                        cfg, i, device="cpu") for i in range(3)]
    step = steps.compile_prefill_step(params, feeds[0], cfg=cfg)
    for f in feeds:
        got = step(f).clone()
        assert torch.equal(got, steps.prefill_step(params, f, cfg=cfg))
    assert step.graph is None and step.calls == 3 and step.params is params
    bad = dict(feeds[0], tokens=feeds[0]["tokens"][:, :-1])
    with pytest.raises(ValueError, match="tokens"):
        step(bad)
    with pytest.raises(ValueError, match="batch has"):
        step({**feeds[0], "extra": feeds[0]["tokens"]})


if __name__ == "__main__":
    assert sys.argv[1] == "--reference-prefill", sys.argv
    for spec in sys.argv[2:]:
        if spec == "--ops":
            continue
        a, *nums = spec.split(":")
        r = reference_prefill_counts(a, *map(int, nums))
        print(json.dumps(r), flush=True)
        if "--ops" in sys.argv:
            for op, result in r["ops"]:
                print(f"  {op} -> {result}", flush=True)
