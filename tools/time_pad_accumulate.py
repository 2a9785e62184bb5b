#!/usr/bin/env python3
"""Time the port's pad-and-accumulate kernels of one source tree on the
card: every distinct main-path launch, and their share of the Inception-v4
forwards.

    python3 tools/time_pad_accumulate.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of a checkout (default: this one's), so
two trees can be timed in one call on one card, in the order parent,
change, change, parent, each in a process of its own. The tree's kernels
are built from its own ``csrc`` (``build/kernels`` of that checkout).

- ``pad_accumulate_f32`` at each distinct launch of the full-width f32
  Inception-v4 forward (``chip_smoke.PAD_ACCUMULATE_LAUNCHES``), buckets 1
  and 8, through ``chip_smoke.time_pad_accumulate``: held to the plain
  version, then timed by CUDA events, by queued launches and by profiler
  device time beside its bound and the grouped ``F.conv2d``;
- ``pad_accumulate_i32`` at stem/c4 and stem/c5, bucket 8, with f32 and
  requantized int8 outputs;
- the f32 forward and the gated int8 one (``plan_mixed_precision`` at tol
  0.02 on two calibration images), elided, at buckets 1 and 8: device
  busy and its ``pad_accumulate_*`` group under ``torch.profiler``.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=REPO / "src")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_pad_accumulate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(0, str(REPO))

    from chip_smoke import (PAD_ACCUMULATE_LAUNCHES, device_time,
                            pad_accumulate_text, time_pad_accumulate,
                            use_source_tree)
    use_source_tree(args.src)
    from repro_torch.cnn.executor import compile_plan, init_params
    from repro_torch.cnn.models import inception_v4
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.mapper import map_network
    from repro_torch.core.quant import plan_mixed_precision
    from repro_torch.kernels import build
    from repro_torch.kernels.kn2row import kn2row as kn2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{args.label}: {smi}; sources {args.src.resolve()}; built in "
          f"{build.build_all():.1f} s")
    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for bsz in (1, 8):
        for label in PAD_ACCUMULATE_LAUNCHES:
            rows[f"pad_accumulate_f32 {label} b{bsz}"] = (
                label, bsz, time_pad_accumulate(kn2, label, bsz, rng))
    for label in ("stem/c4", "stem/c5"):
        for quant in ("f32", "int8"):
            rows[f"pad_accumulate_i32 {quant} out {label} b8"] = (
                label, 8, time_pad_accumulate(kn2, label, 8, rng,
                                              quant=quant))
    for key, (label, bsz, row) in rows.items():
        print(f"{args.label} {key.rsplit(' ', 2)[0]} "
              + pad_accumulate_text(label, bsz, row))

    g = inception_v4(res=299, scale=1.0)
    hw = identify_parameters(g, max_dim=512)
    params = init_params(g, seed=2, device=dev)
    gen = torch.Generator().manual_seed(1)
    samples = torch.randn((2, 299, 299, 3), generator=gen).to(dev)
    report = plan_mixed_precision(g, params, samples, tol=0.02, hw=hw)
    forwards = {}
    for tag, plan, scales, group in (
            ("f32", map_network(g, hw=hw), None, "pad_accumulate_f32"),
            ("int8", report.plan, report.act_scales, "pad_accumulate_i32")):
        for bsz in (1, 8):
            run = compile_plan(g, plan, epilogue="bias_relu",
                               tuning_batch=bsz, elide=True,
                               act_scales=scales, device=dev)
            x = torch.randn((bsz, 299, 299, 3), generator=gen).to(dev)
            busy, _, groups = device_time(lambda: run(params, x), reps=5)
            forwards[f"{tag} b{bsz}"] = dict(device_ms=busy,
                                             group=group,
                                             group_ms=groups.get(group, 0.0))
            print(f"{args.label} inception_v4 299 {tag} forward b{bsz} "
                  f"(elide): device busy {busy:.3f} ms, {group} "
                  f"{forwards[f'{tag} b{bsz}']['group_ms']:.4f} ms "
                  f"(profiler, mean of 5 forwards)")
    print(json.dumps({"label": args.label, "device": smi,
                      "rows": {k: v[2] for k, v in rows.items()},
                      "forwards": forwards}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
