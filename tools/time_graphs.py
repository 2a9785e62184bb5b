#!/usr/bin/env python3
"""Time the port's compiled programs of one source tree on the card, or of
a parent tree and this one in turns, for the four configurations that
``chip_smoke.py`` serves.

    python3 tools/time_graphs.py [--src DIR] [--label NAME]
    python3 tools/time_graphs.py --parent DIR

With ``--src`` (default: this checkout's ``src``) one tree is timed in
this process; its kernels are built from its own ``csrc`` (``build/kernels``
of that checkout). With ``--parent`` (the ``src`` directory of another
checkout, e.g. a ``git archive`` of the parent commit unpacked under the
gitignored ``build/``) the script runs itself four times, each in a
process of its own, in the order parent, change, change, parent, and
prints the four trees' numbers side by side.

Per tree, with random weights from fixed seeds (the same in every tree):
full-width GoogleNet (224²), VGG16 (224²), Inception-v4 (299², 4/7/3
blocks) in f32 and Inception-v4 gated to int8 (``plan_mixed_precision`` at
tol 0.02 on two calibration images), each elided at buckets 1, 2, 4 and 8
and the gated one also unelided at 8:

- the forward in ms by CUDA events over back-to-back calls, after three
  warm calls (a program of a tree that captures CUDA graphs is replaying
  by then);
- device busy, the kernels' rows under ``torch.profiler`` (mean of 5
  forwards), and its share of the forward, and the kernels one forward
  runs (copies and fills aside);
- the sum of the logits in float64, which equals across trees when their
  programs compute the same bits;
- per configuration, ``CNNServingEngine``'s wall time per tick for a
  burst of 13 requests (two ticks of bucket 8), three bursts, after its
  warm-up.

Prints the card's name and power limit, one line per row and one JSON
object of all the numbers last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BUCKETS = (1, 2, 4, 8)
N_BURST = 13
BURSTS = 3


def time_tree(src: Path, label: str) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_graphs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src.resolve()))
    sys.path.insert(0, str(REPO))

    from chip_smoke import (device_time, profiled_launches, time_ms,
                            use_source_tree)
    use_source_tree(src)
    from repro_torch.cnn.executor import compile_plan, init_params
    from repro_torch.cnn.models import googlenet, inception_v4, vgg16
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.mapper import map_network
    from repro_torch.core.quant import plan_mixed_precision
    from repro_torch.kernels import build
    from repro_torch.serving.cnn_engine import CNNRequest, CNNServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{label}: {smi}; sources {src.resolve()}; built in "
          f"{build.build_all():.1f} s", flush=True)

    def randn(shape, seed, scale=1.0):
        gen = torch.Generator().manual_seed(seed)
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def model(graph, seed):
        params = init_params(graph, seed=seed, device=dev)
        for i, nid in enumerate(sorted(params)):
            params[nid]["b"].copy_(randn(params[nid]["b"].shape,
                                         1000 * seed + i, 0.05))
        return graph, params

    configs = []
    g, p = model(googlenet(res=224, scale=1.0), 0)
    configs.append(("googlenet", g, p, map_network(
        g, hw=identify_parameters(g, max_dim=512)), None, 224))
    g, p = model(vgg16(res=224, scale=1.0), 1)
    configs.append(("vgg16", g, p, map_network(
        g, hw=identify_parameters(g, max_dim=512)), None, 224))
    g, p = model(inception_v4(res=299, scale=1.0), 2)
    hw = identify_parameters(g, max_dim=512)
    configs.append(("inception_v4 f32", g, p, map_network(g, hw=hw), None,
                    299))
    report = plan_mixed_precision(g, p, randn((2, 299, 299, 3), 7),
                                  tol=0.02, hw=hw)
    configs.append(("inception_v4 int8", g, p, report.plan,
                    report.act_scales, 299))

    rows, serving = [], {}
    for ci, (name, graph, params, plan, scales, res) in enumerate(configs):
        cases = [(True, b) for b in BUCKETS]
        if scales is not None:
            cases.append((False, 8))
        for elide, bsz in cases:
            run = compile_plan(graph, plan, epilogue="bias_relu",
                               tuning_batch=bsz, elide=elide,
                               act_scales=scales, device=dev)
            x = randn((bsz, res, res, 3), 100 * ci + bsz)
            f_ms = time_ms(lambda: run(params, x), reps=5, rounds=5)
            busy = device_time(lambda: run(params, x), reps=5)[0]
            out, _, kernels = profiled_launches(lambda: run(params, x))
            row = dict(config=name, elide=elide, bucket=bsz, forward_ms=f_ms,
                       device_busy_ms=busy, busy_share=busy / f_ms,
                       kernels=kernels,
                       logits_sum=float(out.double().sum()),
                       finite=bool(torch.isfinite(out).all()))
            rows.append(row)
            print(f"{label}: {name} b{bsz} elide={elide}: forward "
                  f"{f_ms:.3f} ms, device busy {busy:.3f} ms "
                  f"({100 * busy / f_ms:.1f}%), {kernels} kernels; logits sum "
                  f"{row['logits_sum']!r}", flush=True)
            del run, out
        engine = CNNServingEngine(graph, params, plan, batch_size=8,
                                  warmup=True, act_scales=scales, device=dev)
        rng = np.random.default_rng(ci)
        images = [rng.standard_normal((res, res, 3)).astype(np.float32)
                  for _ in range(N_BURST)]
        ticks = []
        for burst in range(BURSTS):
            for i, img in enumerate(images):
                engine.submit(CNNRequest(rid=burst * N_BURST + i, image=img))
            first = len(engine.request_log)
            engine.run_until_done()
            log = list(engine.request_log)[first:]
            ticks += [(t.bucket, t.service_s * 1e3)
                      for t in {t.t_dispatch: t for t in log}.values()]
        serving[name] = ticks
        print(f"{label}: {name} engine, {BURSTS} bursts of {N_BURST}: wall "
              f"time per tick (bucket, ms) "
              + ", ".join(f"({b}, {ms:.3f})" for b, ms in ticks), flush=True)
        del engine
        torch.cuda.empty_cache()
    print(json.dumps({"label": label, "card": smi, "rows": rows,
                      "serving_tick_ms": serving}))
    return 0


def compare(parent: Path) -> int:
    """Parent, change, change, parent, each in a process of its own; then
    every row of the four side by side."""
    order = [(parent, "parent a"), (REPO / "src", "change a"),
             (REPO / "src", "change b"), (parent, "parent b")]
    results = {}
    for src, label in order:
        proc = subprocess.run([sys.executable, __file__, "--src", str(src),
                               "--label", label], capture_output=True,
                              text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"time_graphs: {label} exited {proc.returncode}",
                  file=sys.stderr)
            return proc.returncode
        results[label] = json.loads(proc.stdout.strip().splitlines()[-1])
    labels = [label for _, label in order]
    print("forward ms / device busy ms / busy share / kernels, "
          + " | ".join(labels))
    for i, row in enumerate(results[labels[0]]["rows"]):
        cells = [results[lab]["rows"][i] for lab in labels]
        same = len({c["logits_sum"] for c in cells}) == 1
        print(f"{row['config']} b{row['bucket']} elide={row['elide']}: "
              + " | ".join(f"{c['forward_ms']:.3f} / "
                           f"{c['device_busy_ms']:.3f} / "
                           f"{100 * c['busy_share']:.1f}% / "
                           f"{c['kernels']}" for c in cells)
              + f"; logits equal across trees: {same}")
    for name in results[labels[0]]["serving_tick_ms"]:
        print(f"{name} engine tick ms: " + " | ".join(
            ", ".join(f"{ms:.3f}" for _, ms in
                      results[lab]["serving_tick_ms"][name])
            for lab in labels))
    print(json.dumps({"trees": results}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=REPO / "src")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--parent", type=Path, default=None,
                    help="src directory of the parent tree: time parent, "
                         "change, change, parent")
    args = ap.parse_args()
    if args.parent is not None:
        return compare(args.parent)
    return time_tree(args.src, args.label)


if __name__ == "__main__":
    sys.exit(main())
