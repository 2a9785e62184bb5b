#!/usr/bin/env python3
"""Per-request latency of the port's ``CNNServingEngine`` under Poisson
load on the card: full-width GoogleNet served at pipeline depths 1 and 2.

    python3 tools/bench_serving.py [--src DIR] [--label NAME]
                                   [--n-requests N]
    python3 tools/bench_serving.py --parent DIR

The card's twin of the reference's ``benchmarks/bench_dynamic_batching.py``
(rates and SLO) and ``bench_pipelined_serving.py`` (wall-clock replay per
depth). With random weights from fixed seeds, GoogleNet (224², scale 1.0)
is planned by ``identify_parameters(g, max_dim=512)`` → ``map_network``
and served through one engine per depth (buckets 1, 2, 4, 8, warmed):

- saturation = 8 / the warm-up's bucket-8 service estimate, and the
  arrival rates 0.15×, 0.6× and 1.2× of it; the SLO 2.5 × the bucket-1
  estimate; each rate a Poisson trace of ``--n-requests`` (400) requests
  from seed 42, as the reference bench sets them;
- per rate and depth, the trace replayed on the wall clock
  (``serving.replay.replay_wallclock``): p50, p99 and max latency, each
  request's from its trace arrival time,
  throughput, the engine's ``overlap_ratio``, SLO violations and
  dispatches per bucket;
- at 1.2×, engines with ``max_queue`` = 4 × 8 and ``shed_deadline=True``
  at each depth: the outcome counts, and latency and throughput of the
  completed requests.

With ``--src`` (default: this checkout's ``src``) one tree is measured in
this process, its kernels built from its own ``csrc``; the tree must
hold ``serving/replay.py``. With ``--parent`` (the ``src`` of another
checkout, e.g. a ``git archive`` unpacked under the gitignored
``build/``) the script runs itself four times, each in a process of its
own, in the order parent, change, change, parent. Prints the card's name
and power limit, one line per row and one JSON object of all the numbers
last, on stdout; it writes no file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
RATE_FACTORS = {"low": 0.15, "mid": 0.6, "high": 1.2}
SLO_FACTOR = 2.5
TRACE_SEED = 42
N_REQUESTS = 400
DEPTHS = (1, 2)
TOP_BUCKET = 8


def _latency_row(lat_s, makespan_s: float, n_served: int) -> dict:
    import numpy as np
    lat = np.asarray(lat_s) * 1e3
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "max_ms": float(lat.max()),
            "throughput_rps": n_served / makespan_s,
            "makespan_s": makespan_s}


def load_rows(graph, params, plan, device, rates=tuple(RATE_FACTORS),
              n_requests: int = N_REQUESTS, depths=DEPTHS,
              log=print) -> dict:
    """Serve Poisson traces through warmed engines at each depth, as the
    module docstring says; ``rates`` names the factors of
    ``RATE_FACTORS`` to replay. Returns {"config": ..., "rows": [...],
    "overload": [...]} and logs one line per row."""
    from repro_torch.serving.cnn_engine import (OUTCOME_COMPLETED,
                                                CNNServingEngine)
    from repro_torch.serving.replay import poisson_trace, replay_wallclock

    shape = tuple(int(d) for d in graph.nodes[graph.source()]
                  .attrs["out_shape"])

    def engine(depth, slo_s=None, **kw):
        return CNNServingEngine(graph, params, plan, batch_size=TOP_BUCKET,
                                slo_s=slo_s, pipeline_depth=depth,
                                warmup=True, device=device, **kw)

    engines = {d: engine(d) for d in depths}
    first = engines[depths[0]]
    svc1 = first.service_estimate(1)
    svc8 = first.service_estimate(TOP_BUCKET)
    slo_s = SLO_FACTOR * svc1
    saturation = TOP_BUCKET / svc8
    for eng in engines.values():
        eng.slo_s = slo_s
    config = {"svc_ms_b1": svc1 * 1e3, "svc_ms_b8": svc8 * 1e3,
              "slo_ms": slo_s * 1e3, "saturation_rps": saturation,
              "n_requests": n_requests, "trace_seed": TRACE_SEED}
    log(f"config: warm-up service estimates b1 {svc1 * 1e3:.4f} ms, b8 "
        f"{svc8 * 1e3:.4f} ms; SLO {slo_s * 1e3:.4f} ms; saturation "
        f"{saturation:.1f} requests/s; {n_requests} requests per rate")
    traces = {name: poisson_trace(RATE_FACTORS[name] * saturation,
                                  n_requests, shape, seed=TRACE_SEED)
              for name in rates}
    rows = []
    for name in rates:
        for depth in depths:
            eng = engines[depth]
            eng.reset()
            lat, makespan = replay_wallclock(eng, traces[name])
            st = eng.stats()
            row = {"rate": name, "factor": RATE_FACTORS[name],
                   "arrival_rps": RATE_FACTORS[name] * saturation,
                   "depth": depth, "served": st["served"],
                   **_latency_row(lat, makespan, st["served"]),
                   "overlap_ratio": st["pipeline"]["overlap_ratio"],
                   "slo_violations": st["slo_violations"],
                   "dispatches": st["dispatches"]}
            rows.append(row)
            log(f"{name} ({row['factor']}x, {row['arrival_rps']:.1f}/s) "
                f"depth {depth}: p50 {row['p50_ms']:.4f} ms, p99 "
                f"{row['p99_ms']:.4f}, max {row['max_ms']:.4f}; "
                f"{row['throughput_rps']:.1f} requests/s; overlap_ratio "
                f"{row['overlap_ratio']:.4f}; SLO violations "
                f"{row['slo_violations']} of {row['served']}; dispatches "
                f"{row['dispatches']}")
    overload = []
    if "high" in rates:
        for depth in depths:
            eng = engine(depth, slo_s=slo_s, max_queue=4 * TOP_BUCKET,
                         shed_deadline=True)
            _, makespan = replay_wallclock(eng, traces["high"])
            st = eng.stats()
            rb = st["robustness"]
            done = [t.latency_s for t in eng.request_log
                    if t.outcome == OUTCOME_COMPLETED]
            row = {"rate": "high", "depth": depth,
                   "max_queue": rb["max_queue"],
                   "outcomes": rb["outcomes"], "pending": rb["pending"],
                   "queue_high_water": rb["queue_high_water"],
                   **_latency_row(done or [0.0], makespan, st["served"]),
                   "overlap_ratio": st["pipeline"]["overlap_ratio"],
                   "slo_violations": st["slo_violations"]}
            if sum(rb["outcomes"].values()) + rb["pending"] != n_requests:
                raise AssertionError(f"overload depth {depth}: outcomes "
                                     f"{rb['outcomes']} do not conserve")
            overload.append(row)
            log(f"high overload depth {depth} (max_queue {rb['max_queue']}"
                f", shed_deadline): outcomes {rb['outcomes']}; completed "
                f"p50 {row['p50_ms']:.4f} ms, p99 {row['p99_ms']:.4f}, max "
                f"{row['max_ms']:.4f}; {row['throughput_rps']:.1f} "
                f"completed/s; queue high water {rb['queue_high_water']}")
            del eng
    del engines
    return {"config": config, "rows": rows, "overload": overload}


def bench_tree(src: Path, label: str, n_requests: int) -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.cnn.executor import init_params
    from repro_torch.cnn.models import googlenet
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.mapper import map_network
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{label}: {smi}; sources {src.resolve()}; built in "
          f"{build.build_all():.1f} s", flush=True)
    g = googlenet(res=224, scale=1.0)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    params = init_params(g, seed=0, device=dev)
    gen = torch.Generator().manual_seed(0)
    for nid in sorted(params):
        b = params[nid]["b"]
        b.copy_((torch.randn(b.shape, generator=gen) * 0.05).to(dev))
    result = load_rows(g, params, plan, dev, n_requests=n_requests,
                       log=lambda s: print(f"{label}: {s}", flush=True))
    print(json.dumps({"label": label, "card": smi,
                      "kind": torch.cuda.get_device_name(0), **result}))
    return 0


def compare(parent: Path, n_requests: int) -> int:
    """Parent, change, change, parent, each in a process of its own."""
    order = [(parent, "parent a"), (REPO / "src", "change a"),
             (REPO / "src", "change b"), (parent, "parent b")]
    results = {}
    for src, label in order:
        proc = subprocess.run([sys.executable, __file__, "--src", str(src),
                               "--label", label, "--n-requests",
                               str(n_requests)], capture_output=True,
                              text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"bench_serving: {label} exited {proc.returncode}",
                  file=sys.stderr)
            return proc.returncode
        results[label] = json.loads(proc.stdout.strip().splitlines()[-1])
    labels = [label for _, label in order]
    print("p50 / p99 / max ms / requests/s, " + " | ".join(labels))
    for i, row in enumerate(results[labels[0]]["rows"]):
        cells = [results[lab]["rows"][i] for lab in labels]
        print(f"{row['rate']} depth {row['depth']}: " + " | ".join(
            f"{c['p50_ms']:.4f} / {c['p99_ms']:.4f} / {c['max_ms']:.4f} / "
            f"{c['throughput_rps']:.1f}" for c in cells))
    print(json.dumps({"trees": results}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=REPO / "src")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--n-requests", type=int, default=N_REQUESTS)
    ap.add_argument("--parent", type=Path, default=None,
                    help="src directory of the parent tree: measure "
                         "parent, change, change, parent")
    args = ap.parse_args()
    if args.parent is not None:
        return compare(args.parent, args.n_requests)
    return bench_tree(args.src, args.label, args.n_requests)


if __name__ == "__main__":
    sys.exit(main())
