#!/usr/bin/env python3
"""Time the port's bf16 GEMMs of one source tree on the card, at their
main-path shapes, and the bf16 forwards of GoogleNet, VGG16 and
Inception-v4 beside the f32 ones.

    python3 tools/time_bf16_gemm.py [--src DIR] [--label NAME] [--json PATH]

``--src`` is the ``src`` directory of a checkout (default: this one's), so
several trees can be timed in one call on one card, each in a process of
its own, in the order parent, change, change, parent. The tree's kernels
are built from its own ``csrc`` (``build/kernels`` of that checkout).
Rows, each kernel checked against its plain version (one bf16 ulp) and
timed beside its bound and the library call (cuBLAS through
``torch.matmul`` / ``torch.bmm`` on the same bf16 operands):

- ``gemm_bf16`` on GoogleNet's conv2 at bucket 8 (M 25088, K 576, N 192),
  by CUDA events and by queued launches (device time without host gaps,
  ``chip_smoke.queued_ms``);
- ``gemm_bf16`` on GoogleNet's 5b/1x1 at bucket 1 (M 49, K 832, N 384),
  queued, beside ``gemm_f32`` on the same values widened;
- ``batched_gemm_bf16`` on VGG16's conv0_1 and conv2_1 at bucket 8;
- Inception-v4's Toeplitz GEMMs at buckets 1 and 8, each distinct shape
  queued under its plan's tile and weighted by its launches a forward;
- the replayed forwards (CUDA graphs, events) of the three full-width
  models in bf16 and in f32 at buckets 1, 2, 4 and 8, elided, with the
  bf16 forward's device busy time (``torch.profiler``).

Prints the card's name and power limit first, one line per row, and one
JSON object of all the numbers last (also written to ``--json``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

GEMMS = [("gemm_bf16 googlenet conv2 b8", 25088, 576, 192),
         ("gemm_bf16 googlenet 5b/1x1 b1", 49, 832, 384)]
BATCHED = [("batched_gemm_bf16 vgg16 conv0_1 b8", 36, 25088, 64, 64),
           ("batched_gemm_bf16 vgg16 conv2_1 b8", 36, 1568, 256, 256)]
BUCKETS = (1, 2, 4, 8)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=REPO / "src")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_bf16_gemm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import (PEAK_BF16_FLOPS, CheckFailed, bf16_close, bound,
                            device_time, queued_ms, time_ms, use_source_tree)
    use_source_tree(args.src)
    import repro_torch
    from repro_torch.cnn.executor import compile_plan, init_params
    from repro_torch.cnn.models import googlenet, inception_v4, vgg16
    from repro_torch.core.algorithms import AlgoFamily
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.mapper import map_network
    from repro_torch.kernels import build
    from repro_torch.kernels.gemm import gemm as gemm_mod
    from repro_torch.kernels.gemm.ops import dataflow_blocks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{args.label}: {smi}; sources {Path(repro_torch.__file__).parent}"
          f"; built in {build.build_all():.1f} s", flush=True)
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    def gemm_bound(g, m, k, n):
        return bound(2.0 * g * m * n * k,
                     2.0 * g * (m * k + k * n + m * n) + 2.0 * n,
                     PEAK_BF16_FLOPS)

    rows = {}
    for label, m, k, n in GEMMS:
        a, b = randn(m, k), randn(k, n, scale=k ** -0.5)
        bias = randn(n, scale=0.1)

        def kern():
            return gemm_mod.gemm_call(a, b, epilogue="bias_relu", bias=bias)

        err = bf16_close(label, kern(), gemm_mod.gemm_plain(
            a, b, "bias_relu", bias))
        b_ms, b_by = gemm_bound(1, m, k, n)
        row = dict(ms=time_ms(kern), queued_ms=queued_ms(kern),
                   library_ms=time_ms(lambda: torch.matmul(a, b)),
                   library_queued_ms=queued_ms(lambda: torch.matmul(a, b)),
                   bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        if m < 64:                      # beside the split f32 GEMM
            a32, b32, bias32 = a.float(), b.float(), bias.float()
            row["f32_queued_ms"] = queued_ms(lambda: gemm_mod.gemm_call(
                a32, b32, epilogue="bias_relu", bias=bias32))
        rows[label] = row
    for label, g, m, k, n in BATCHED:
        a, b = randn(g, m, k), randn(g, k, n, scale=k ** -0.5)

        def kern():
            return gemm_mod.batched_gemm_call(a, b)

        err = bf16_close(label, kern(), gemm_mod.batched_gemm_plain(a, b))
        b_ms, b_by = gemm_bound(g, m, k, n)
        rows[label] = dict(ms=time_ms(kern), queued_ms=queued_ms(kern),
                           library_ms=time_ms(lambda: torch.bmm(a, b)),
                           library_queued_ms=queued_ms(
                               lambda: torch.bmm(a, b)),
                           bound_ms=b_ms, bound_by=b_by, max_abs_err=err)

    models = {"googlenet": (googlenet(res=224, scale=1.0), 224),
              "vgg16": (vgg16(res=224, scale=1.0), 224),
              "inception_v4": (inception_v4(), 299)}
    forwards = {}
    for name, (g, res) in models.items():
        plan = map_network(g, hw=identify_parameters(g, max_dim=512))
        if name == "inception_v4":      # its Toeplitz GEMMs, summed
            low = compile_plan(g, plan, epilogue="bias_relu",
                               device=dev).lowering
            for bsz in (1, 8):
                shapes = Counter()
                for nid, lw in low.items():
                    if (lw.algo.family is AlgoFamily.IM2COL
                            and lw.in_layout is not None
                            and lw.in_layout.kind == "toeplitz"):
                        c = g.nodes[nid].conv
                        m, k = bsz * c.o1 * c.o2, c.k1 * c.k2 * c.c_in
                        bm, bn, _ = dataflow_blocks(lw.dataflow, lw.p1,
                                                    lw.p2)
                        shapes[(m, k, c.c_out, gemm_mod.kernel_tile(
                            bm, bn, m, c.c_out))] += 1
                sums = [0.0, 0.0, 0.0]
                for (m, k, n, tile), count in shapes.items():
                    a, b = randn(m, k), randn(k, n, scale=k ** -0.5)
                    bias = randn(n, scale=0.1)
                    sums[0] += count * queued_ms(lambda: gemm_mod.gemm_call(
                        a, b, bm=tile[0], bn=tile[1], epilogue="bias_relu",
                        bias=bias), reps=5)
                    sums[1] += count * queued_ms(lambda: torch.matmul(a, b),
                                                 reps=5)
                    sums[2] += count * gemm_bound(1, m, k, n)[0]
                rows[f"inception_v4 toeplitz gemms b{bsz}"] = dict(
                    launches=sum(shapes.values()), shapes=len(shapes),
                    queued_ms=sums[0], library_queued_ms=sums[1],
                    bound_ms=sums[2])
        p16 = init_params(g, seed=0, device=dev, dtype=bf)
        p32 = {nid: {k: t.float() for k, t in layer.items()}
               for nid, layer in p16.items()}
        for bsz in BUCKETS:
            x16 = randn(bsz, res, res, 3)
            x32 = x16.float()
            run16 = compile_plan(g, plan, epilogue="bias_relu",
                                 tuning_batch=bsz, dtype=bf, device=dev)
            run32 = compile_plan(g, plan, epilogue="bias_relu",
                                 tuning_batch=bsz, device=dev)
            loops = {}
            if hasattr(gemm_mod, "bf16_loop_launches"):
                for kern in (gemm_mod.GEMM_BF16, gemm_mod.GEMM_BF16_MMA,
                             gemm_mod.BATCHED_GEMM_BF16,
                             gemm_mod.BATCHED_GEMM_BF16_MMA):
                    kern.launches = 0
            for _ in range(2):          # the eager pass, the capture
                run16(p16, x16)
                if not loops and hasattr(gemm_mod, "bf16_loop_launches"):
                    loops = gemm_mod.bf16_loop_launches()
                run32(p32, x32)
            ms16 = time_ms(lambda: run16(p16, x16), reps=10, rounds=5)
            ms32 = time_ms(lambda: run32(p32, x32), reps=10, rounds=5)
            try:
                busy16, split16, _ = device_time(lambda: run16(p16, x16))
            except CheckFailed as e:        # a profiler window came back empty
                busy16, split16 = float("nan"), f"not measured ({e})"
            forwards[f"{name} b{bsz}"] = dict(
                bf16_ms=ms16, f32_ms=ms32, bf16_busy_ms=busy16,
                bf16_busy=split16, bf16_loops=loops)
            del run16, run32
        del p16, p32
        torch.cuda.empty_cache()

    for label, r in rows.items():
        print(f"{args.label} {label}: "
              + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                          else f"{k} {v}" for k, v in r.items()), flush=True)
    for label, r in forwards.items():
        print(f"{args.label} forward {label}: bf16 {r['bf16_ms']:.3f} ms, "
              f"f32 {r['f32_ms']:.3f} ms ({r['f32_ms'] / r['bf16_ms']:.2f}x);"
              f" bf16 device busy {r['bf16_busy_ms']:.3f} ms = "
              f"{r['bf16_busy']} (ms); bf16 GEMM launches per loop "
              f"{r['bf16_loops']}")
    out = {"label": args.label, "device": smi, "rows": rows,
           "forwards": forwards}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
