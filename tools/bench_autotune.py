#!/usr/bin/env python3
"""The measured autotuner on the card: full-width GoogleNet tuned per
batch bucket, and its tuned programs against the untuned one.

    python3 tools/bench_autotune.py [--save DIR] [--load DIR]

The card's twin of the reference's ``benchmarks/bench_fused_autotune.py``.
With random weights from fixed seeds, GoogleNet (224², scale 1.0) is
planned by ``identify_parameters(g, max_dim=512)`` → ``map_network`` and
tuned by ``core.autotune.autotune_buckets`` over the four kernel tiles
(``FOUR_PAIRS``) at buckets 1 and 8, every candidate timed as the
fastest of three CUDA-graph replays:

- record "kernels": ``backends=("pallas",)``, the plan's own binding on
  the kernels as the hysteresis baseline — every conv on a hand-written
  kernel;
- record "all": the three backends (kernels, the plain torch oracles,
  cuDNN), the reference's default baseline (the plan's binding on the
  plain oracles).

Then three programs per bucket — untuned, tuned "kernels", tuned "all" —
compiled with ``epilogue="bias_relu"``: each forward's ms by CUDA events
around 20 back-to-back replays per program and turn, the programs
interleaved in turns (forward order, then backward) over five turns, the
median per program; and per
bucket the ten heaviest signatures (the plan binding's measured time
times the layers that share it): the plan's binding against each
record's measured winner.

``--save DIR`` writes the two records as ``DIR/googlenet_kernels.json``
and ``DIR/googlenet_all.json`` (the reference's record format: either
package loads them); ``--load DIR`` reads them instead of tuning, so a
second run skips the tuning. Prints the card's name and power limit, one
line per row and one JSON object of all the numbers last, on stdout.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# The four tile instantiations of the kernels (``kernel_tile``): the
# plan's (128, 128) gives every dataflow the same tile.
FOUR_PAIRS = ((64, 64), (64, 128), (128, 64), (128, 128))
RECORDS = ("kernels", "all")
BUCKETS = (1, 8)
REPS = 3            # timed replays per candidate
ROUNDS = 5          # interleaved turns of the three forwards
CALLS = 20          # back-to-back replays per program and turn


def forward_ms(fn) -> float:
    """ms of one call of ``fn``: three warm-up calls (a compiled program's
    eager pass, capture and first replay), then CUDA events around
    ``CALLS`` back-to-back calls."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def plan_binding(plan, node, backend: str):
    """The plan's own binding of one conv node under ``backend``."""
    from repro_torch.core.autotune import Binding
    return Binding(plan.assignment[node.id].key,
                   plan.dataflows[node.id].name, plan.p1, plan.p2, backend)


def binding_tile(conv, binding, batch: int):
    """The kernel tile (rows, cols) the binding's GEMM runs on: the
    dataflow's block binding clamped to the GEMM's M and N
    (``kernel_tile``): im2col multiplies B·O1·O2 rows, kn2row B·H·W (its
    unit convs run at input resolution), Winograd B·tiles per transform
    point; N is Cout."""
    from repro_torch.core.algorithms import AlgoFamily
    from repro_torch.kernels.gemm.gemm import kernel_tile
    from repro_torch.kernels.gemm.ops import dataflow_blocks
    from repro_torch.core.cost_model import Dataflow
    algo = binding.algo
    if algo.family is AlgoFamily.KN2ROW:
        m = batch * conv.h1 * conv.h2
    elif algo.family is AlgoFamily.WINOGRAD:
        m = batch * -(-conv.o1 // algo.m) * -(-conv.o2 // algo.m)
    else:
        m = batch * conv.o1 * conv.o2
    bm, bn, _ = dataflow_blocks(Dataflow[binding.dataflow], binding.p1,
                                binding.p2)
    return kernel_tile(bm, bn, m, conv.c_out)


def _signatures(graph):
    """{signature: (first conv node, number of convs sharing it)}."""
    from repro_torch.core.autotune import conv_key
    out = {}
    for node in graph.conv_nodes():
        key = conv_key(node.conv)
        first, n = out.get(key, (node, 0))
        out[key] = (first, n + 1)
    return out


def tuning_summary(record, graph, plan, bucket: int,
                   baseline_backend: str) -> dict:
    """One bucket of a record against the plan (its hysteresis baseline
    the plan's binding on ``baseline_backend``): the signatures whose
    winner left the baseline, the winners by algorithm and by kernel tile
    (a winner off the kernels by its backend), and the sums of the
    winners' and the baselines' measured times over the signatures and
    over the layers (each signature times the convs that share it)."""
    from repro_torch.core.autotune import record_key
    moved, by_algo, by_tile = 0, Counter(), Counter()
    win_s = base_s = win_layers_s = base_layers_s = 0.0
    sigs = _signatures(graph)
    for key, (node, n) in sigs.items():
        ent = record.entries[record_key(node.conv, bucket)]
        base_label = plan_binding(plan, node, baseline_backend).label()
        base = dict(ent.candidates).get(base_label)
        moved += ent.binding.label() != base_label
        by_algo[ent.binding.algo_key] += 1
        if ent.binding.backend == "pallas":
            tile = binding_tile(node.conv, ent.binding, bucket)
            by_tile[f"{tile[0]}x{tile[1]}"] += 1
        else:
            by_tile[ent.binding.backend] += 1
        win_s += ent.measured_s
        win_layers_s += n * ent.measured_s
        if base is not None:
            base_s += base
            base_layers_s += n * base
    return {"bucket": bucket, "signatures": len(sigs), "moved": moved,
            "by_algo": dict(by_algo), "by_tile": dict(by_tile),
            "winners_ms": win_s * 1e3, "baselines_ms": base_s * 1e3,
            "winners_layers_ms": win_layers_s * 1e3,
            "baselines_layers_ms": base_layers_s * 1e3}


def backend_report(record, graph, bucket: int, top: int = 5) -> dict:
    """Which backend wins each signature at ``bucket``, and the ``top``
    signatures where the best plain-oracle or cuDNN candidate beats the
    best kernel candidate by the largest factor, with both times."""
    from repro_torch.core.autotune import record_key
    wins, rows = Counter(), []
    for key, (node, _) in _signatures(graph).items():
        ent = record.entries[record_key(node.conv, bucket)]
        wins[ent.binding.backend] += 1
        best = {}
        for label, s in ent.candidates:
            backend = label.rsplit("|", 1)[1]
            side = "kernels" if backend == "pallas" else "other"
            if side not in best or s < best[side][1]:
                best[side] = (label, s)
        if "kernels" in best and "other" in best:
            rows.append({"signature": key,
                         "other": best["other"][0],
                         "other_ms": best["other"][1] * 1e3,
                         "kernels": best["kernels"][0],
                         "kernels_ms": best["kernels"][1] * 1e3,
                         "factor": best["kernels"][1] / best["other"][1]})
    rows.sort(key=lambda r: -r["factor"])
    return {"bucket": bucket, "wins": dict(wins), "top": rows[:top]}


def heavy_rows(records: dict, graph, plan, bucket: int, n: int = 10):
    """The ``n`` heaviest signatures at ``bucket`` (the plan binding's
    measured time in the "kernels" record times its layer count), each
    record's winner beside the plan's binding."""
    from repro_torch.core.autotune import record_key
    rows = []
    for key, (node, count) in _signatures(graph).items():
        ent = records["kernels"].entries[record_key(node.conv, bucket)]
        plan_label = plan_binding(plan, node, "pallas").label()
        plan_s = dict(ent.candidates)[plan_label]
        row = {"signature": key, "layers": count, "plan": plan_label,
               "plan_ms": plan_s * 1e3, "weight_ms": count * plan_s * 1e3}
        for name, rec in records.items():
            win = rec.entries[record_key(node.conv, bucket)]
            row[name] = win.binding.label()
            row[f"{name}_ms"] = win.measured_s * 1e3
        rows.append(row)
    rows.sort(key=lambda r: -r["weight_ms"])
    return rows[:n]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save", type=Path, default=None)
    ap.add_argument("--load", type=Path, default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_autotune: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.cnn.executor import compile_plan, init_params
    from repro_torch.cnn.models import googlenet
    from repro_torch.core.autotune import (BACKENDS, TuningRecord,
                                           autotune_buckets)
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.mapper import map_network
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; built in {build.build_all():.1f} s", flush=True)
    g = googlenet(res=224, scale=1.0)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    params = init_params(g, seed=0, device=dev)
    gen = torch.Generator().manual_seed(0)
    for nid in sorted(params):
        b = params[nid]["b"]
        b.copy_((torch.randn(b.shape, generator=gen) * 0.05).to(dev))

    records, tune_s = {}, {}
    options = {"kernels": dict(backends=("pallas",),
                               baseline_backend="pallas"),
               "all": dict(backends=BACKENDS,
                           baseline_backend="reference")}
    for name in RECORDS:
        path = None if args.load is None else \
            args.load / f"googlenet_{name}.json"
        t0 = time.perf_counter()
        if path is not None:
            records[name] = TuningRecord.load(path)
        else:
            records[name] = autotune_buckets(
                g, plan, buckets=BUCKETS, p1p2=FOUR_PAIRS, reps=REPS,
                device=dev, **options[name])
        tune_s[name] = time.perf_counter() - t0
        how = "tuned" if path is None else f"loaded from {path}"
        print(f"record {name}: {how} in {tune_s[name]:.1f} s", flush=True)
        if args.save is not None:
            args.save.mkdir(parents=True, exist_ok=True)
            records[name].save(args.save / f"googlenet_{name}.json")

    summaries, reports, heavy, forwards = [], [], {}, {}
    for bucket in BUCKETS:
        for name in RECORDS:
            s = tuning_summary(records[name], g, plan, bucket,
                               options[name]["baseline_backend"])
            summaries.append({"record": name, **s})
            print(f"b{bucket} {name}: {s['moved']} of {s['signatures']} "
                  f"signatures left the plan's binding; by algorithm "
                  f"{s['by_algo']}; by tile {s['by_tile']}; winners "
                  f"{s['winners_ms']:.4f} ms against baselines "
                  f"{s['baselines_ms']:.4f} (per layer "
                  f"{s['winners_layers_ms']:.4f} against "
                  f"{s['baselines_layers_ms']:.4f})", flush=True)
        rep = backend_report(records["all"], g, bucket)
        reports.append(rep)
        print(f"b{bucket} backends: wins {rep['wins']}; top "
              f"{json.dumps(rep['top'])}", flush=True)
        heavy[bucket] = heavy_rows(records, g, plan, bucket)
        for row in heavy[bucket]:
            print(f"b{bucket} heavy {json.dumps(row)}", flush=True)

        x = torch.randn((bucket, 224, 224, 3),
                        generator=torch.Generator().manual_seed(bucket)
                        ).to(dev)
        runs = {"untuned": compile_plan(g, plan, epilogue="bias_relu",
                                        tuning_batch=bucket, device=dev)}
        for name in RECORDS:
            runs[name] = compile_plan(g, plan, epilogue="bias_relu",
                                      tuning=records[name],
                                      tuning_batch=bucket, device=dev)
        outs = {name: run(params, x) for name, run in runs.items()}
        ms = {name: [] for name in runs}
        order = list(runs)
        for turn in range(ROUNDS):
            for name in (order if turn % 2 == 0 else order[::-1]):
                ms[name].append(forward_ms(lambda: runs[name](params, x)))
        max_diff = {name: float((outs[name] - outs["untuned"]).abs().max())
                    for name in RECORDS}
        forwards[bucket] = {name: {"median_ms": statistics.median(v),
                                   "ms": v} for name, v in ms.items()}
        forwards[bucket]["max_abs_diff_vs_untuned"] = max_diff
        print(f"b{bucket} forwards (median ms of {ROUNDS} turns): "
              + ", ".join(f"{n} {statistics.median(v):.4f}"
                          for n, v in ms.items())
              + f"; max|diff| vs untuned {max_diff}", flush=True)
        del runs, outs
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "kind": torch.cuda.get_device_name(0),
                      "buckets": list(BUCKETS), "reps": REPS,
                      "tune_s": tune_s, "summaries": summaries,
                      "backends": reports,
                      "heavy": {str(b): r for b, r in heavy.items()},
                      "forwards": {str(b): f for b, f in forwards.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
