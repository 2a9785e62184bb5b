#!/usr/bin/env python3
"""Check the port's mesh paths on real cards: the CNN data-parallel mesh,
and with ``--lm`` the LM (data, model) mesh.

    python3 tools/check_mesh.py --cards 2 4        # needs 4 visible cards
    python3 tools/check_mesh.py --cards 2 4 --dtype bf16   # in bf16
    python3 tools/check_mesh.py --virtual --cards 2  # one card, cuda:0 twice
    PYTHONPATH=src python tools/check_mesh.py --device cpu --virtual \\
        --res 32 --scale 0.125                     # the control flow, CPU
    python3 tools/check_mesh.py --lm --lm-mesh 1x2 2x1 2x2   # 4 cards
    PYTHONPATH=src python tools/check_mesh.py --lm --device cpu --reduced \\
        --lm-mesh 2x2                              # 4 gloo processes
    python3 tools/check_mesh.py --lm --lm-decode-only --lm-mesh 1x2 2x2 \\
        --lm-decode h2o-danube-1.8b:4096:4094 deepseek-v2-236b:32768
    python3 tools/check_mesh.py --lm --lm-prefill-only \\
        --lm-prefill h2o-danube-1.8b:2:32768 mamba2-370m:2:32768

``--lm``: for each (data, model) mesh asked for, the script launches
itself under ``torchrun --nproc-per-node data*model`` (NCCL on the cards,
gloo on the CPU) and runs one train step (two microbatches) of
h2o-danube-1.8b cut to 2 layers at full width in f32 on that mesh,
holding the loss and every updated param and optimizer leaf to the
unsharded step on the same weights and batch, then three decode steps'
logits and caches likewise, each within ``mesh_check.check_rule``'s
tolerance of the leaf's max: 1e-5, or twice the unsharded step's own
float noise (``mesh_check.noise_floor``, measured in the same run)
where that is larger. The mesh fails where that tolerance reaches the
step's smallest param move (``min_step``), since a missing update
could then pass. Then the train step compiled on the mesh
(``mesh_check.compiled_check``: on the cards two eager passes, one CUDA
graph with the step's collectives, a replay) against three eager sharded
steps: bit-equal, or within the same rule (the line says which). On the
cards it times the eager sharded step and the replayed one (CUDA events,
median of 5) and reads each one's compute and NCCL kernel time (the
profiler's; an NCCL kernel's holds its wait for the other ranks) and
host share (1 - compute / step). ``--lm-decode arch:cache[:start]``
adds, per mesh, the decode step of each ``arch`` (f32, ``--lm-layers``,
batch ``--lm-batch``, a cache of ``cache`` slots; ``decode_report``):
``serve_step`` compiled on the mesh (``mesh_check.
compiled_decode_check``: on the cards one CUDA graph with the step's
collectives) bit-equal to the eager sharded decode over three steps
from ``start``, and within ``check_rule`` of the unsharded decode's own
float noise; on the cards the eager and the replayed step's ms (events,
median of 5), compute and NCCL kernel ms and every rank's
``max_memory_reserved``. ``--lm-prefill arch:batch:seq[:vocab]``
adds, per mesh, the prefill step of each ``arch`` (f32, ``--lm-layers``,
``batch`` rows of ``seq`` tokens; ``prefill_report``): ``prefill_step``
compiled on the mesh (``mesh_check.compiled_prefill_check``: on the
cards two eager passes, then one CUDA graph with the step's collectives
replayed three times) bit-equal to the eager sharded prefill on every
call, its logits replicated, and within ``check_rule`` of the unsharded
prefill's own float noise (``mesh_check.prefill_noise``); on the cards
the replayed step's ms (events, median of 5; beside it the second eager
pass's), its compute and NCCL kernel ms and host share, and every rank's
``max_memory_reserved``.
``--lm-decode-only`` and ``--lm-prefill-only`` skip the train step;
``--src`` imports another source tree (a parent's: only timed, as is
every tree under ``--times-only``). With fewer cards
than the mesh needs it says so and exits 2; it never runs a smaller mesh
in place of the one asked for.

For each mesh of ``--cards`` devices (``make_data_mesh(n)``, or with
``--virtual`` a ``DataMesh`` naming the first device n times), on
GoogleNet (224², scale 1.0 by default) under the serving plan
(``map_network(..., use_on_chip=False)``) with random weights from a seed:

- the plan's program at every bucket of ``batch_buckets(8, n)``, called
  three times (the eager pass, the capture, a replay): the launch counters
  read n times the lowering's launches on the first two and 0 on the
  replay; each shard holds one capture, on its own device; each shard's
  rows equal the unsharded program's at the per-chip batch bit for bit,
  and the bucket the unsharded program's at rtol 2e-2 / atol 2e-3;
- ``CNNServingEngine(mesh=)`` at pipeline depths 1 and 2 serving waves of
  8, 8 and 2 requests: ``stats()["sharding"]``,
  ``last_tick["per_chip_batch"]``, the zeroed stale staging rows, no
  counter moving over the replayed ticks, and every result within the
  whole-plan tolerance of the unsharded program;
- two ``MultiModelEngine`` tenants on the mesh sharing each bucket
  program, every shard holding one capture per tenant;

and prints each device's ``max_memory_reserved`` (every card of a real
mesh must have held work). ``--dtype bf16`` runs the same checks on bf16
params (``init_params(dtype=torch.bfloat16)``), bf16 programs fed bf16
images and bf16 engines; on the cards every pass must launch the bf16
GEMMs on their wgmma loop and never on the mma.sync loop, so each card
of the mesh runs the Hopper kernels (their shared-memory opt-in is a
setting of each device), and a whole bucket is held to the unsharded
program within the reference's bf16 tolerance, 5e-2 of its largest
logit, in place of rtol 2e-2 / atol 2e-3. Any failed check raises. The
last line is one JSON object:
``{"ok": true, "meshes": [...], "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-2, atol=2e-3)
# A bf16 bucket against the unsharded bf16 program (other tiles and K
# slices: other f32 sums, each rounded once): the reference's bf16
# tolerance (tests/test_kernels.py:41) of the largest logit.
BF16_REL = 5e-2
WAVES = (8, 8, 2)


def lm_main(args) -> int:
    """``--lm``: launch each mesh under torchrun, or (inside torchrun) run
    this rank's part of one."""
    import os
    if "RANK" in os.environ:
        return lm_rank(args)
    import torch
    if args.device == "cuda" and torch.cuda.is_available():
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    failed = 0
    for shape in args.lm_mesh:
        d, m = (int(n) for n in shape.split("x"))
        cards = torch.cuda.device_count() if args.device == "cuda" else None
        if cards is not None and cards < d * m:
            print(f"the {shape} LM mesh needs {d * m} cards; "
                  f"{cards} visible", flush=True)
            return 2
        argv = [a for a in sys.argv[1:]]
        i = argv.index("--lm-mesh") if "--lm-mesh" in argv else len(argv)
        j = i + 1
        while j < len(argv) and not argv[j].startswith("--"):
            j += 1
        argv[i:j] = ["--lm-mesh", shape]
        if not (args.lm_decode_only or args.lm_prefill_only):
            print(f"[{shape}] " + dryrun_line(args, d, m), flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc-per-node", str(d * m), __file__,
                   *argv, "--restore-dir", tmp]
            print(f"[{shape}] {' '.join(cmd[1:])}", flush=True)
            rc = subprocess.run(cmd, timeout=args.timeout,
                                cwd=REPO).returncode
        if rc != 0:
            print(f"[{shape}] failed: rc {rc}", flush=True)
            failed = failed or rc
    return failed


def lm_config(args):
    """The checked config: ``--lm-arch`` at ``--lm-layers`` (reduced with
    ``--reduced``), f32, with ``--lm-heads``' head counts."""
    from repro_torch.launch import mesh_check
    heads = dict(zip(("n_heads", "n_kv_heads"), args.lm_heads or ()))
    return mesh_check.check_config(args.lm_arch, args.lm_layers,
                                   reduced=args.reduced, **heads)


def dryrun_line(args, d: int, m: int) -> str:
    """The dry run's counts of the checked step on a fake (d, m) group
    (``launch.dryrun.trace_step``: no card), this process being rank 0:
    collective bytes per rank by op, their counts, and the peak."""
    sys.path.insert(0, str(args.src))
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    cfg = lm_config(args)
    with dryrun.fake_world(d * m):
        c = dryrun.trace_step(
            cfg, ShapeSpec("check", args.lm_seq, args.lm_batch, "train"),
            make_mesh((d, m), ("data", "model"), "cpu"),
            microbatches=2)["counts"]
    return (f"dry run of this step ({cfg.name}, {cfg.n_layers} layers, "
            f"batch {args.lm_batch} x {args.lm_seq}, counts, per rank): "
            f"collective bytes {sum(c.coll.values()):.6g} by op "
            f"{ {k: v for k, v in c.coll.items() if v} }, op counts "
            f"{ {k: v for k, v in c.coll_counts.items() if v} }, peak "
            f"{c.peak:.6g} B")


def device_busy_ms(fn):
    """(compute, NCCL) kernel time in ms of one call of ``fn`` under
    ``torch.profiler``, memcpys and memsets aside. NCCL's kernels are
    counted apart: each runs from its launch until every rank has joined,
    so its time holds the wait for the slowest rank's host, on a stream
    beside the compute kernels. The window opens with sixteen spin
    kernels that are not counted: the profiler has dropped the first
    kernels of a window on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(16):
            torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    busy = {False: 0.0, True: 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not any(
                w in e.key for w in ("Memcpy", "Memset", "spin_kernel")):
            busy["nccl" in e.key.lower()] += getattr(
                e, "self_device_time_total", 0) / 1e3
    return busy[False], busy[True]


def step_times(mesh, cfg, dev, batch: int, seq: int, reps: int = 5):
    """The eager sharded ``train_step`` against the step compiled on
    ``mesh`` (two eager passes, the capture, then replays), both at two
    microbatches from the same weights: each one's ms (CUDA events,
    median of ``reps`` calls after the first ones), compute kernels' and
    NCCL kernels' time (``device_busy_ms``), the host share (1 - compute
    / ms), and the compiled step's capture seconds."""
    import statistics

    import torch

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed.api import (activation_policy,
                                             policy_from_mesh)
    from repro_torch.distributed.sharding import distribute, params_shardings
    from repro_torch.launch import steps
    from repro_torch.models.model import init_model
    from repro_torch.optim.adamw import init_opt_state
    opt_cfg = steps.make_opt_config(cfg, total_steps=30)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    policy = policy_from_mesh(mesh)
    feed = make_batch(DataConfig(seed=0, global_batch=batch, seq_len=seq),
                      cfg, 0, mesh=mesh)

    def state():
        params = init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
        opt_state = init_opt_state(params, opt_cfg)
        return distribute((params, opt_state),
                          (params_shardings(params, mesh),
                           params_shardings(opt_state, mesh)))

    def ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    held = list(state())

    def eager():
        with activation_policy(policy):
            held[0], held[1], _ = steps.train_step(
                held[0], held[1], feed, cfg=cfg, opt_cfg=opt_cfg,
                microbatches=2)

    eager_ms = [ms(eager) for _ in range(reps + 1)][1:]
    eager_busy, eager_nccl = device_busy_ms(eager)
    del held[:]
    with activation_policy(policy):
        step = steps.compile_train_step(*state(), feed, cfg=cfg,
                                        opt_cfg=opt_cfg, microbatches=2)
    for _ in range(steps.WARM_PASSES):
        ms(lambda: step(feed))
    capture_s = ms(lambda: step(feed)) / 1e3
    if step.graph is None:
        raise RuntimeError("the compiled mesh step holds no graph after "
                           f"{step.calls} calls")
    replay_ms = [ms(lambda: step(feed)) for _ in range(reps)]
    replay_busy, replay_nccl = device_busy_ms(lambda: step(feed))
    out = {"eager_ms": statistics.median(eager_ms),
           "replay_ms": statistics.median(replay_ms),
           "eager_busy_ms": eager_busy, "replay_busy_ms": replay_busy,
           "eager_nccl_ms": eager_nccl, "replay_nccl_ms": replay_nccl,
           "capture_s": capture_s}
    out["eager_host_share"] = 1 - eager_busy / out["eager_ms"]
    out["replay_host_share"] = 1 - replay_busy / out["replay_ms"]
    out["max_reserved_gib"] = torch.cuda.max_memory_reserved() / 2 ** 30
    return out


def lm_rank(args) -> int:
    import os

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(args.src))
    from repro_torch.launch.mesh import make_mesh
    d, m = (int(n) for n in args.lm_mesh[0].split("x"))
    card = args.device == "cuda"
    if card:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl" if card else "gloo")
    try:
        dev = torch.device("cuda", torch.cuda.current_device()) if card \
            else torch.device("cpu")
        mesh = make_mesh((d, m), ("data", "model"), dev)
        ok = True
        if not (args.lm_decode_only or args.lm_prefill_only):
            ok = train_report(args, mesh, dev, d, m, card)
        for spec in args.lm_decode:
            ok = decode_report(args, mesh, dev, d, m, card, spec) and ok
        for spec in args.lm_prefill:
            ok = prefill_report(args, mesh, dev, d, m, card, spec) and ok
        return 0 if ok else 1
    finally:
        dist.destroy_process_group()


def train_report(args, mesh, dev, d: int, m: int, card: bool) -> bool:
    """The train step's checks and times on this mesh (rank 0 prints)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh_check
    cfg = lm_config(args)
    t0 = time.perf_counter()
    train = mesh_check.train_check(mesh, cfg, dev, batch=args.lm_batch,
                                   seq=args.lm_seq)
    dec = mesh_check.decode_check(mesh, cfg, dev)
    comp = mesh_check.compiled_check(mesh, cfg, dev, batch=args.lm_batch,
                                     seq=args.lm_seq)
    secs = time.perf_counter() - t0
    restore = mesh_check.restore_check(mesh, cfg, dev, args.restore_dir) \
        if args.restore_dir else None
    noise = mesh_check.noise_floor(cfg, dev, batch=args.lm_batch,
                                   seq=args.lm_seq)
    worst = max(train["max_rel"], train["loss_rel"],
                dec["logits"]["max_rel"], dec["cache"]["max_rel"],
                comp["max_rel"], comp["metrics_rel"])
    rule = mesh_check.check_rule(noise, train["min_step"])
    ok = worst <= rule["tol"] and rule["guarded"] \
        and comp["layout_kept"] and comp["captured"] == card \
        and (restore is None or (restore["bit_equal"]
                                 and not restore["whole_made"]))
    times = step_times(mesh, cfg, dev, args.lm_batch, args.lm_seq) \
        if card else None
    mem = None
    if times:       # every rank's peak, gathered on every rank
        mem = [None] * dist.get_world_size()
        dist.all_gather_object(mem, round(times["max_reserved_gib"], 2))
    if dist.get_rank() == 0:
        print(f"[{d}x{m}] {cfg.name} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, f32) train step: loss {train['loss']:.6f}"
              f" vs unsharded {train['ref_loss']:.6f}, {train['leaves']}"
              f" leaves within {train['max_rel']:.2e} of their max "
              f"(bit-equal: {train['bit_equal']}; the smallest leaf's "
              f"step {train['min_step']:.2e}); decode logits within "
              f"{dec['logits']['max_rel']:.2e}, caches "
              f"{dec['cache']['max_rel']:.2e}; {secs:.1f} s; the "
              f"unsharded step's own float noise "
              f"{ {k: f'{v:.2e}' for k, v in noise['probes'].items()} }"
              f", worst at {noise['worst_leaf']}; the rule "
              f"{rule['tol']:.2e} (max of 1e-5 and twice the noise), "
              f"{'under' if rule['guarded'] else 'NOT under'} the "
              f"smallest step: {'pass' if ok else 'FAIL'}", flush=True)
        how = ("two eager passes, one CUDA graph, a replay" if card
               else "eagerly: no capture on the CPU")
        print(f"[{d}x{m}] the train step compiled on the mesh ({how}) "
              f"against {comp['calls']} eager sharded steps: "
              + ("bit-equal" if comp["bit_equal"] else
                 f"within {comp['max_rel']:.2e} (metrics "
                 f"{comp['metrics_rel']:.2e}) of the leaves' max, the "
                 f"rule {rule['tol']:.2e}")
              + f"; placements and local addresses kept: "
              f"{comp['layout_kept']}", flush=True)
        print(f"[{d}x{m}] attention cores the sharded step ran: "
              f"{train['cores']}", flush=True)
        if restore:
            print(f"[{d}x{m}] a checkpoint read leaf by leaf into a "
                  f"zeroed sharded tree: {restore['leaves']} leaves "
                  f"({restore['sharded_leaves']} sharded), each rank's "
                  f"shards equal to the saved arrays' slices bit for "
                  f"bit: {restore['bit_equal']}; new tensors the size "
                  f"of a sharded leaf on rank 0: "
                  f"{restore['whole_made']}", flush=True)
        if times:
            print(f"[{d}x{m}] step ms (events, median of 5; batch "
                  f"{args.lm_batch} x {args.lm_seq}, 2 microbatches): "
                  f"eager sharded {times['eager_ms']:.2f}, compute "
                  f"kernels {times['eager_busy_ms']:.2f}, NCCL kernels "
                  f"{times['eager_nccl_ms']:.2f}, host share "
                  f"{100 * times['eager_host_share']:.1f}%; replayed "
                  f"{times['replay_ms']:.2f}, compute kernels "
                  f"{times['replay_busy_ms']:.2f}, NCCL kernels "
                  f"{times['replay_nccl_ms']:.2f}, host share "
                  f"{100 * times['replay_host_share']:.1f}%; replay / "
                  f"eager {times['replay_ms'] / times['eager_ms']:.3f}; "
                  f"capture {times['capture_s']:.2f} s", flush=True)
        if times:
            print(f"[{d}x{m}] max_memory_reserved per rank over the "
                  f"timed eager and replayed steps (GiB): {mem}",
                  flush=True)
        print(json.dumps({"ok": ok, "mesh": [d, m], "rule": rule,
                          "train": train, "decode": dec,
                          "compiled": comp, "times": times,
                          "restore": restore,
                          "noise_floor": noise, "device": str(dev)}),
              flush=True)
    return ok


def decode_report(args, mesh, dev, d: int, m: int, card: bool,
                  spec: str) -> bool:
    """``--lm-decode arch:cache[:start]`` on this mesh: ``arch`` at
    ``--lm-layers`` (f32, full width or ``--reduced``), batch
    ``--lm-batch``, a cache of ``cache`` slots. Where the source tree has
    it, ``mesh_check.compiled_decode_check`` (three calls from position
    ``start``: on the cards two eager passes, one CUDA graph with the
    step's collectives, a replay) against the eager sharded decode, bit
    for bit, and against the unsharded decode within ``check_rule`` of
    its own float noise (``mesh_check.decode_noise``), unless
    ``--times-only``. On the cards the step's times (``decode_times``)
    and every rank's ``max_memory_reserved``. Rank 0 prints; returns
    whether it passed."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh_check
    arch, cache, *rest = spec.split(":")
    cache, start = int(cache), int(rest[0]) if rest else 0
    cfg = mesh_check.check_config(arch, args.lm_layers, reduced=args.reduced)
    tag = f"[{d}x{m}] {cfg.name} decode ({cfg.n_layers} layers, d_model " \
          f"{cfg.d_model}, f32, batch {args.lm_batch}, cache {cache})"
    ok, result = True, {"arch": arch, "cache": cache, "start": start}
    if hasattr(mesh_check, "compiled_decode_check") and not args.times_only:
        comp = mesh_check.compiled_decode_check(
            mesh, cfg, dev, batch=args.lm_batch, max_len=cache, start=start)
        noise = mesh_check.decode_noise(cfg, dev, batch=args.lm_batch,
                                        max_len=cache)
        rule = mesh_check.check_rule(noise, float("inf"))
        dev_u = comp["deviation"]
        worst = max(dev_u["logits"]["max_rel"], dev_u["cache"]["max_rel"])
        ok = comp["bit_equal"] and comp["layout_kept"] \
            and comp["captured"] == card and worst <= rule["tol"]
        result.update(compiled=comp, noise=noise, rule=rule)
        if dist.get_rank() == 0:
            how = ("two eager passes, one CUDA graph, a replay" if card
                   else "eagerly: no capture on the CPU")
            print(f"{tag}: serve_step compiled on the mesh ({how}), "
                  f"{comp['calls']} calls from position {start}, against "
                  f"the eager sharded decode: "
                  f"{'bit-equal' if comp['bit_equal'] else 'NOT bit-equal'}"
                  f"; against the unsharded decode: logits within "
                  f"{dev_u['logits']['max_rel']:.2e}, caches "
                  f"{dev_u['cache']['max_rel']:.2e} of their max, the rule "
                  f"{rule['tol']:.2e} (the unsharded decode's own noise "
                  f"{ {k: f'{v:.2e}' for k, v in noise['probes'].items()} })"
                  f"; placements and local addresses kept: "
                  f"{comp['layout_kept']}: {'pass' if ok else 'FAIL'}",
                  flush=True)
    if card:
        times = decode_times(mesh, cfg, dev, args.lm_batch, cache)
        mem = [None] * dist.get_world_size()
        dist.all_gather_object(mem, round(times["max_reserved_gib"], 2))
        times["max_reserved_gib_per_rank"] = mem
        result["times"] = times
        if dist.get_rank() == 0:
            print(f"{tag} ms (events, median of 5, position {cache - 1}): "
                  f"eager sharded {times['eager_ms']:.3f}, compute kernels "
                  f"{times['eager_busy_ms']:.3f}, NCCL kernels "
                  f"{times['eager_nccl_ms']:.3f}; replayed "
                  f"{times['replay_ms']:.3f}, compute kernels "
                  f"{times['replay_busy_ms']:.3f}, NCCL kernels "
                  f"{times['replay_nccl_ms']:.3f}; max_memory_reserved per "
                  f"rank (GiB) {mem}", flush=True)
    if dist.get_rank() == 0:
        print(json.dumps({"ok": ok, "mesh": [d, m], "decode": result,
                          "src": str(args.src), "device": str(dev)}),
              flush=True)
    return ok


def decode_times(mesh, cfg, dev, batch: int, cache: int, reps: int = 5):
    """The eager sharded ``serve_step`` at position ``cache - 1`` (every
    slot filled) against the same step captured as one CUDA graph (two
    eager passes on a side stream, the capture, then replays; the token
    and position in static buffers), from the same resident params and
    caches: each one's ms (CUDA events, median of ``reps`` calls after
    the first), compute and NCCL kernel time (``device_busy_ms``), and
    ``max_memory_reserved``. Uses only what every source tree with
    ``serve_step`` on a mesh has, so parent and change are timed
    alike."""
    import statistics

    import torch

    from repro_torch.distributed.api import (activation_policy,
                                             policy_from_mesh)
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  cache_shardings,
                                                  distribute,
                                                  params_shardings)
    from repro_torch.launch import steps
    from repro_torch.models.model import init_cache, init_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    d_params = distribute(params, params_shardings(params, mesh, fsdp=False))
    del params
    whole_cache = init_cache(cfg, batch, cache, device=dev)
    d_cache = distribute(whole_cache, cache_shardings(whole_cache, mesh))
    del whole_cache
    tokens = torch.arange(batch, device=dev)[:, None] % cfg.vocab + 1
    tok = distribute({"t": tokens}, batch_shardings({"t": tokens},
                                                    mesh))["t"]
    pos = torch.full((1,), cache - 1, dtype=torch.long, device=dev)
    policy = policy_from_mesh(mesh, seq_parallel=False)

    def step():
        with activation_policy(policy):
            return steps.serve_step(d_params, tok, d_cache, pos, cfg=cfg)[0]

    def ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    eager_ms = [ms(step) for _ in range(reps + 1)][1:]
    eager_busy, eager_nccl = device_busy_ms(step)
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        for _ in range(2):
            step()
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        step()
    replay_ms = [ms(graph.replay) for _ in range(reps + 1)][1:]
    replay_busy, replay_nccl = device_busy_ms(graph.replay)
    out = {"eager_ms": statistics.median(eager_ms),
           "replay_ms": statistics.median(replay_ms),
           "eager_busy_ms": eager_busy, "eager_nccl_ms": eager_nccl,
           "replay_busy_ms": replay_busy, "replay_nccl_ms": replay_nccl,
           "max_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}
    del graph
    return out


def prefill_report(args, mesh, dev, d: int, m: int, card: bool,
                   spec: str) -> bool:
    """``--lm-prefill arch:batch:seq[:vocab]`` on this mesh: ``arch`` at
    ``--lm-layers`` (f32, full width or ``--reduced``; its vocab
    ``vocab`` where given) on ``batch`` rows of ``seq`` tokens. Where
    the source tree has it, ``mesh_check.compiled_prefill_check`` (on
    the cards two eager passes, then one CUDA graph with the step's
    collectives, replayed three times) against the eager sharded
    prefill, bit for bit, its logits replicated, and against the
    unsharded prefill within ``check_rule`` of its own float noise
    (``mesh_check.prefill_noise``), unless ``--times-only``. On the
    cards the step's times (``prefill_times``) and every rank's
    ``max_memory_reserved``. Rank 0 prints; returns whether it
    passed."""
    import torch.distributed as dist

    from repro_torch.launch import mesh_check
    arch, batch, seq, *vocab = spec.split(":")
    batch, seq = int(batch), int(seq)
    cfg = mesh_check.check_config(arch, args.lm_layers, reduced=args.reduced,
                                  **({"vocab": int(vocab[0])} if vocab
                                     else {}))
    tag = f"[{d}x{m}] {cfg.name} prefill ({cfg.n_layers} layers, d_model " \
          f"{cfg.d_model}, f32, batch {batch} x {seq})"
    ok, result = True, {"arch": arch, "batch": batch, "seq": seq,
                        "vocab": cfg.vocab}
    if hasattr(mesh_check, "compiled_prefill_check") and not args.times_only:
        t0 = time.perf_counter()
        comp = mesh_check.compiled_prefill_check(mesh, cfg, dev, batch=batch,
                                                 seq=seq)
        noise = mesh_check.prefill_noise(cfg, dev, batch=batch, seq=seq)
        rule = mesh_check.check_rule(noise, float("inf"))
        dev_u = comp["deviation"]["max_rel"]
        ok = comp["bit_equal"] and comp["replicated"] \
            and comp["layout_kept"] and comp["captured"] == card \
            and dev_u <= rule["tol"]
        result.update(compiled=comp, noise=noise, rule=rule,
                      check_s=time.perf_counter() - t0)
        if dist.get_rank() == 0:
            how = ("two eager passes, then one CUDA graph replayed "
                   f"{comp['calls'] - 2} times" if card
                   else "eagerly: no capture on the CPU")
            print(f"{tag}: prefill_step compiled on the mesh ({how}), "
                  f"{comp['calls']} calls on fresh tokens, against the "
                  f"eager sharded prefill: "
                  f"{'bit-equal' if comp['bit_equal'] else 'NOT bit-equal'}"
                  f", replicated: {comp['replicated']}; against the "
                  f"unsharded prefill: logits within {dev_u:.2e} of their "
                  f"max, the rule {rule['tol']:.2e} (the unsharded "
                  f"prefill's own noise "
                  f"{ {k: f'{v:.2e}' for k, v in noise['probes'].items()} })"
                  f"; attention cores {comp['cores']}; placements and "
                  f"local addresses kept: {comp['layout_kept']}: "
                  f"{'pass' if ok else 'FAIL'} "
                  f"({result['check_s']:.1f} s)", flush=True)
    if card:
        times = prefill_times(mesh, cfg, dev, batch, seq)
        mem = [None] * dist.get_world_size()
        dist.all_gather_object(mem, round(times["max_reserved_gib"], 2))
        times["max_reserved_gib_per_rank"] = mem
        result["times"] = times
        if dist.get_rank() == 0:
            print(f"{tag} ms (events): the second eager sharded pass "
                  f"{times['eager_ms']:.3f}; replayed (median of 5) "
                  f"{times['replay_ms']:.3f}, compute kernels "
                  f"{times['replay_busy_ms']:.3f}, NCCL kernels "
                  f"{times['replay_nccl_ms']:.3f}, host share "
                  f"{100 * times['replay_host_share']:.1f}%; "
                  f"max_memory_reserved per rank (GiB) {mem}", flush=True)
    if dist.get_rank() == 0:
        print(json.dumps({"ok": ok, "mesh": [d, m], "prefill": result,
                          "src": str(args.src), "device": str(dev)}),
              flush=True)
    return ok


def prefill_times(mesh, cfg, dev, batch: int, seq: int, reps: int = 5):
    """The eager sharded ``prefill_step`` captured as one CUDA graph (two
    eager passes on a side stream, the capture, then replays) on one
    batch, from FSDP-sharded params: the second eager pass's ms and the
    replay's (CUDA events, median of ``reps`` replays after the first),
    the replay's compute and NCCL kernel time (``device_busy_ms``) and
    host share, and ``max_memory_reserved`` from the set-up's end (the
    whole tree is drawn and sliced before it, C.12). Uses only what every
    source tree with ``prefill_step`` on a mesh has, so parent and change
    are timed alike."""
    import statistics

    import torch

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed.api import (activation_policy,
                                             policy_from_mesh)
    from repro_torch.distributed.sharding import distribute, params_shardings
    from repro_torch.launch import steps
    from repro_torch.models.model import init_model
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    d_params = distribute(params, params_shardings(params, mesh))
    del params
    feed = make_batch(DataConfig(seed=0, global_batch=batch, seq_len=seq),
                      cfg, 0, mesh=mesh)
    policy = policy_from_mesh(mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def step():
        with activation_policy(policy):
            return steps.prefill_step(d_params, feed, cfg=cfg)

    def ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        warm_ms = [ms(step) for _ in range(2)]
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        step()
    replay_ms = [ms(graph.replay) for _ in range(reps + 1)][1:]
    busy, nccl = device_busy_ms(graph.replay)
    out = {"eager_ms": warm_ms[1], "replay_ms": statistics.median(replay_ms),
           "replay_busy_ms": busy, "replay_nccl_ms": nccl,
           "max_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}
    out["replay_host_share"] = 1 - busy / out["replay_ms"]
    del graph
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lm", action="store_true",
                    help="check the LM (data, model) mesh instead")
    ap.add_argument("--lm-mesh", nargs="+", default=["1x2", "2x1", "2x2"])
    ap.add_argument("--lm-arch", default="h2o-danube-1.8b")
    ap.add_argument("--lm-layers", type=int, default=2)
    ap.add_argument("--lm-batch", type=int, default=4)
    ap.add_argument("--lm-seq", "--seq", type=int, default=64,
                    help="tokens per row of the LM check's batch")
    ap.add_argument("--lm-heads", type=int, nargs=2, default=None,
                    metavar=("Q", "KV"),
                    help="query and key/value heads of the checked config "
                         "(heads that do not split over the model axis run "
                         "the context-parallel core)")
    ap.add_argument("--lm-decode", nargs="+", default=[],
                    metavar="ARCH:CACHE[:START]",
                    help="--lm: also check (and on cards time) the decode "
                         "step of ARCH with a cache of CACHE slots on each "
                         "mesh, from position START")
    ap.add_argument("--lm-decode-only", action="store_true",
                    help="--lm: the --lm-decode checks alone")
    ap.add_argument("--lm-prefill", nargs="+", default=[],
                    metavar="ARCH:BATCH:SEQ[:VOCAB]",
                    help="--lm: also check (and on cards time) the prefill "
                         "step of ARCH on BATCH rows of SEQ tokens on each "
                         "mesh")
    ap.add_argument("--lm-prefill-only", action="store_true",
                    help="--lm: the --lm-prefill (and --lm-decode) checks, "
                         "no train step")
    ap.add_argument("--src", type=Path, default=REPO / "src",
                    help="the source tree to import (a parent's, to time "
                         "it beside this one)")
    ap.add_argument("--times-only", action="store_true",
                    help="--lm-decode / --lm-prefill: time the step, "
                         "check nothing (a tree without "
                         "compiled_decode_check or compiled_prefill_check "
                         "is only timed)")
    ap.add_argument("--restore-dir", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--reduced", action="store_true",
                    help="--lm at the config's reduced width")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--cards", type=int, nargs="+", default=[2])
    ap.add_argument("--virtual", action="store_true",
                    help="name the first device n times instead of n cards")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="the CNN mesh's params, programs and engines")
    args = ap.parse_args(argv)
    if args.lm:
        return lm_main(args)
    sys.path.insert(0, str(REPO / "src"))

    import numpy as np
    import torch

    from repro_torch.cnn.executor import compile_plan, init_params
    from repro_torch.cnn.models import googlenet
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.mapper import map_network
    from repro_torch.distributed.sharding import replicate
    from repro_torch.kernels import build
    from repro_torch.kernels.common import resolve_device
    from repro_torch.launch.mesh import DataMesh, make_data_mesh
    from repro_torch.serving.cnn_engine import (CNNRequest, CNNServingEngine,
                                                batch_buckets)
    from repro_torch.serving.multi_engine import MultiModelEngine

    dev = resolve_device(args.device)
    card = dev.type == "cuda"
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        print(f"built {', '.join(build.SOURCES)} in "
              f"{build.build_all():.1f} s", flush=True)
    from repro_torch.kernels.conv_im2col.conv_im2col import (CONV, CONV_BF16,
                                                             CONV_I8)
    from repro_torch.kernels.gemm import gemm as gm
    from repro_torch.kernels.kn2row import kn2row as kn2
    from repro_torch.kernels.winograd import winograd as wino
    kernels = (CONV, gm.GEMM, wino.INPUT_TRANSFORM, wino.INPUT_TRANSFORM_TILES,
               gm.BATCHED_GEMM, wino.OUTPUT_TRANSFORM, kn2.UNIT_CONV_GEMMS,
               kn2.PAD_ACCUMULATE, gm.GEMM_I8, CONV_I8, kn2.UNIT_CONV_GEMMS_I8,
               kn2.PAD_ACCUMULATE_I32, CONV_BF16, gm.GEMM_BF16,
               gm.GEMM_BF16_MMA, gm.BATCHED_GEMM_BF16,
               gm.BATCHED_GEMM_BF16_MMA, wino.INPUT_TRANSFORM_BF16,
               wino.INPUT_TRANSFORM_TILES_BF16, wino.OUTPUT_TRANSFORM_BF16,
               kn2.UNIT_CONV_GEMMS_BF16, kn2.PAD_ACCUMULATE_BF16)
    # Where the bf16 GEMMs' launches sit in a counts() tuple: the wgmma
    # loop's entry points, then the mma.sync loop's.
    wgmma_at = [kernels.index(k) for k in (gm.GEMM_BF16,
                                           gm.BATCHED_GEMM_BF16)]
    mma_at = [kernels.index(k) for k in (gm.GEMM_BF16_MMA,
                                         gm.BATCHED_GEMM_BF16_MMA)]

    def counts():
        return tuple(k.launches for k in kernels)

    def launched(fn):
        before = counts()
        out = fn()
        if card:
            torch.cuda.synchronize()
        return out, tuple(a - b for a, b in zip(counts(), before))

    def sync_all():
        if card:
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    def check(cond, msg):
        if not cond:
            raise AssertionError(msg)

    g = googlenet(res=args.res, scale=args.scale)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512),
                       use_on_chip=False)
    shape = tuple(int(d) for d in g.nodes[g.source()].attrs["out_shape"])

    def seeded(seed):
        p = init_params(g, seed=seed, device=dev, dtype=dt)
        gen = torch.Generator().manual_seed(1000 + seed)
        for nid in sorted(p):
            p[nid]["b"].copy_(torch.randn(p[nid]["b"].shape,
                                          generator=gen) * 0.05)
        return p

    params = seeded(2)
    rng = np.random.default_rng(7)

    def images(n):
        return rng.standard_normal((n,) + shape).astype(np.float32)

    def batch(imgs):
        """Images as a program's input: a tensor in the params' dtype."""
        return torch.as_tensor(imgs, device=dev).to(dt)

    def unsharded(bsz):
        return compile_plan(g, plan, epilogue="bias_relu", tuning_batch=bsz,
                            device=dev, dtype=dt)

    def close(got, want, what):
        got = torch.as_tensor(got).cpu().float()
        want = torch.as_tensor(want).cpu().float()
        err = float((got - want).abs().max())
        if dt == torch.float32:
            check(torch.allclose(got, want, **TOL),
                  f"{what}: max|diff| {err:.3e} outside rtol 2e-2 atol 2e-3")
        else:
            bound = BF16_REL * float(want.abs().max())
            check(err <= bound, f"{what}: max|diff| {err:.3e} above "
                  f"{BF16_REL} of the largest logit ({bound:.3e})")
        return err

    def on_wgmma(k, what):
        """A bf16 pass's counts: the bf16 GEMMs launched on the wgmma loop
        and never on the mma.sync loop."""
        if dt == torch.bfloat16:
            check(all(k[i] for i in wgmma_at) and not any(k[i] for i in
                                                           mma_at),
                  f"{what}: bf16 GEMM launches {[k[i] for i in wgmma_at]} "
                  f"on the wgmma loop, {[k[i] for i in mma_at]} on the "
                  f"mma.sync loop")

    tol_text = ("rtol 2e-2 atol 2e-3" if dt == torch.float32 else
                f"{BF16_REL} of the unsharded program's largest logit")
    report = []
    for n in args.cards:
        t0 = time.perf_counter()
        if card:
            for i in range(torch.cuda.device_count()):
                torch.cuda.reset_peak_memory_stats(i)
        mesh = (DataMesh((torch.device(dev.type, 0),) * n) if args.virtual
                else make_data_mesh(n, device=dev))
        tag = f"{'virtual ' if args.virtual else ''}{n}-device {args.dtype} " \
              f"mesh {[str(d) for d in mesh.devices]}"
        reps = replicate(params, mesh)
        per_fwd = None
        errs = []
        for bsz in batch_buckets(8, n):
            per = bsz // n
            run = compile_plan(g, plan, epilogue="bias_relu",
                               tuning_batch=per, mesh=mesh, device=dev,
                               dtype=dt)
            x = batch(images(bsz))
            outs, ns = [], []
            for _ in range(3):
                out, k = launched(lambda: run(reps, x))
                outs.append(out)
                ns.append(k)
            if card:
                per_fwd = ns[0]
                check(ns[0] == ns[1] and not any(ns[2]) and any(ns[0]),
                      f"{tag} b{bsz}: launches per pass {ns}")
                on_wgmma(ns[0], f"{tag} b{bsz}")
                for s, d in zip(run.shards, mesh.devices):
                    caps = list(s.captures.values())
                    check(s.device == d and len(caps) == 1
                          and caps[0] is not None
                          and caps[0].static_out.device == d,
                          f"{tag} b{bsz}: shard on {s.device} holds "
                          f"{len(caps)} capture(s)")
            first = mesh.devices[0]
            check(all((o.device.type, o.device.index or 0)
                      == (first.type, first.index) for o in outs),
                  f"{tag} b{bsz}: output not gathered on the first device")
            run_c = unsharded(per)
            for i in range(n):
                rows = slice(i * per, (i + 1) * per)
                want = run_c(params, x[rows])
                for stage, o in zip(("eager", "capture", "replay"), outs):
                    check(torch.equal(o[rows], want),
                          f"{tag} b{bsz} {stage}: shard {i} differs from the "
                          f"unsharded program at batch {per}")
            errs.append(close(outs[2], unsharded(bsz)(params, x),
                              f"{tag} b{bsz}"))
            print(f"{tag} b{bsz}: per-chip batch {per}; launches "
                  f"{ns[0] if card else 'not counted on the CPU'} on the "
                  f"eager pass and the capture, none on a replay; each shard "
                  f"bit-equal to the unsharded program at batch {per}; "
                  f"max|diff| vs the unsharded b{bsz} {errs[-1]:.3e}",
                  flush=True)
            del run, run_c

        for depth in (1, 2):
            eng = CNNServingEngine(g, params, plan, batch_size=8, mesh=mesh,
                                   warmup=True, pipeline_depth=depth,
                                   device=dev, dtype=dt)
            imgs = images(sum(WAVES))
            slots = []

            def serve():
                rid = 0
                for w in WAVES:
                    for _ in range(w):
                        eng.submit(CNNRequest(rid=rid, image=imgs[rid]))
                        rid += 1
                    eng.step(flush=True)
                    slots.append(eng._last_buf_index)
                eng.drain()

            _, k = launched(serve)
            check(not any(k), f"{tag} depth {depth}: ticks launched {k}")
            want_sh = {"data_shards": n, "mesh_devices": n,
                       "per_chip_batch": {b: b // n for b in eng.buckets}}
            check(eng.stats()["sharding"] == want_sh,
                  f"{tag} depth {depth}: {eng.stats()['sharding']}")
            last = eng.covering_bucket(WAVES[-1])
            check(eng.last_tick["bucket"] == last
                  and eng.last_tick["per_chip_batch"] == last // n,
                  f"{tag} depth {depth}: last_tick {eng.last_tick}")
            check(slots[0] == slots[-1]
                  and not eng._batch_bufs[slots[-1]][2:].any(),
                  f"{tag} depth {depth}: stale staging rows in slot "
                  f"{slots[-1]}")
            run8 = unsharded(8)
            for lo in range(0, len(imgs), 8):
                chunk = imgs[lo:lo + 8]
                want = run8(params, batch(chunk))
                for i in range(len(chunk)):
                    errs.append(close(eng.done[lo + i], want[i],
                                      f"{tag} depth {depth} request "
                                      f"{lo + i}"))
            rb = eng.stats()["robustness"]
            check(sum(rb["outcomes"].values()) + rb["pending"]
                  == eng.submitted_total, f"{tag}: outcomes do not conserve")
            print(f"{tag} engine depth {depth}: buckets {eng.buckets}, "
                  f"sharding {want_sh}, last_tick per_chip_batch "
                  f"{eng.last_tick['per_chip_batch']}, stale rows zeroed, "
                  f"no launch over the ticks, {len(imgs)} results within "
                  f"{tol_text}", flush=True)
            del eng

        multi = MultiModelEngine()
        tenants = {"a": params, "b": seeded(3)}
        for name, p in tenants.items():
            multi.register_model(name, g, p, plan, batch_size=8, mesh=mesh,
                                 warmup=True, device=dev, dtype=dt)
        ea, eb = multi.engines["a"], multi.engines["b"]
        nb = len(ea.buckets)
        check(multi.cache.stats() == {"entries": nb, "hits": nb,
                                      "misses": nb},
              f"{tag} tenants: cache {multi.cache.stats()}")
        for bsz in ea.buckets:
            run = ea._runs[bsz]
            check(run is eb._runs[bsz], f"{tag} b{bsz}: not shared")
            if card:
                check(all(len(s.captures) == 2 for s in run.shards),
                      f"{tag} b{bsz}: not two captures a shard")
        imgs = images(11)
        for name in tenants:
            for i, img in enumerate(imgs):
                multi.submit(name, CNNRequest(rid=i, image=img))
        done = multi.run_until_done()
        run8 = unsharded(8)
        for name, p in tenants.items():
            for lo in (0, 8):
                chunk = imgs[lo:lo + 8]
                want = run8(p, batch(chunk))
                for i in range(len(chunk)):
                    errs.append(close(done[name][lo + i], want[i],
                                      f"{tag} tenant {name}"))
        print(f"{tag} tenants: cache {multi.cache.stats()}, each bucket "
              f"program shared, one capture per tenant on every shard",
              flush=True)
        del multi, ea, eb
        sync_all()
        reserved = ({str(d): round(torch.cuda.max_memory_reserved(d)
                                   / 2 ** 30, 2)
                     for d in dict.fromkeys(mesh.devices)} if card else {})
        if card and not args.virtual:
            check(all(v > 0 for v in reserved.values()),
                  f"{tag}: a card held nothing: {reserved}")
        secs = time.perf_counter() - t0
        print(f"{tag}: max_memory_reserved GiB per device {reserved}; "
              f"max|diff| {max(errs):.3e}; {secs:.1f} s", flush=True)
        report.append({"devices": [str(d) for d in mesh.devices],
                       "virtual": args.virtual, "dtype": args.dtype,
                       "max_abs_diff": max(errs),
                       "launches_per_forward_all_shards": per_fwd,
                       "max_memory_reserved_gib": reserved,
                       "seconds": secs})
    print(json.dumps({"ok": True, "meshes": report, "device": {
        "kind": torch.cuda.get_device_name(0) if card else "cpu",
        "count": torch.cuda.device_count() if card else 0}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
