#!/usr/bin/env python3
"""Time the port's int8 implicit-GEMM conv of one source tree on the card,
at every int8 im2col conv shape of the gated Inception-v4 lowering, beside
the two int8 GEMMs that share its mainloop.

    python3 tools/time_i8_conv.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of a checkout (default: this one's), so
two trees can be timed in one call on one card, in the order parent,
change, change, parent, each in a process of its own. The tree's kernels
are built from its own ``csrc`` (``build/kernels`` of that checkout).

- the gate (``plan_mixed_precision`` at tol 0.02 on two calibration
  images) plans full-width Inception-v4 (299², 4/7/3 blocks);
- ``conv_im2col_i8`` at each distinct shape of its launches in the gated
  lowering, elided (stem/c1 only) and not, with the layer's own output
  (f32, or int8 where the layer requantizes for its consumer) and bias +
  ReLU, at buckets 1 and 8: held to ``conv_i8_plain`` (f32 within 1e-4,
  int8 exactly), then timed by CUDA events and by queued launches beside
  its bound;
- ``gemm_i8`` at redA/b3b's Toeplitz shape (M 9800, K 1728, N 224, bucket
  8) and ``unit_conv_gemms_i8`` at stem/c4 (G 9, M 172872, K 64, N 96),
  held to their plain versions exactly and timed the same way;
- the gated forward elided at buckets 1 and 8 and unelided at bucket 8:
  device busy and the ``conv_im2col_i8`` group under ``torch.profiler``
  (mean of 5 forwards), and the conv's launches per forward.

Prints the card's name and power limit, the int8 kernels' ptxas counts
when this process built them, one line per row and one JSON object of
all the numbers last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=REPO / "src")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_i8_conv: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(0, str(REPO))

    from chip_smoke import (EXACT, KERNEL_TOL, PEAK_INT8_OPS, bound,
                            check_close, device_time, ptxas_report,
                            queued_ms, time_ms, use_source_tree)
    use_source_tree(args.src)
    from repro_torch.cnn.executor import compile_plan, init_params
    from repro_torch.cnn.models import inception_v4
    from repro_torch.core.algorithms import AlgoFamily
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.quant import plan_mixed_precision
    from repro_torch.kernels import build
    from repro_torch.kernels.conv_im2col.conv_im2col import (
        CONV_I8, conv_i8_plain, conv_im2col_call)
    from repro_torch.kernels.conv_im2col.ref import conv_geometry
    from repro_torch.kernels.gemm.gemm import gemm_call, gemm_i8_plain
    from repro_torch.kernels.kn2row import kn2row as kn2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{args.label}: {smi}; sources {args.src.resolve()}; built in "
          f"{build.build_all():.1f} s")
    for name, log in build.BUILD_LOG.items():
        for kernel, info in ptxas_report(log):
            if "_i8" in kernel:
                print(f"{args.label} ptxas {name}: {kernel}: {info}")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randi8(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8).to(dev)

    def scales(n, depth):
        return ((torch.rand(n, generator=gen) * 1.5 + 0.5)
                / (127.0 ** 2 * depth ** 0.5 / 3)).to(dev)

    g = inception_v4(res=299, scale=1.0)
    hw = identify_parameters(g, max_dim=512)
    params = init_params(g, seed=2, device=dev)
    samples = torch.randn((2, 299, 299, 3), generator=gen).to(dev)
    report = plan_mixed_precision(g, params, samples, tol=0.02, hw=hw)
    runs = {(elide, bsz): compile_plan(g, report.plan, epilogue="bias_relu",
                                       tuning_batch=bsz, elide=elide,
                                       act_scales=report.act_scales,
                                       device=dev)
            for elide, bsz in ((True, 1), (True, 8), (False, 8))}

    # (H, W, Cin, K1, K2, stride, padding, Cout, int8 out) of every NHWC
    # int8 im2col layer: launches per forward, elided and not.
    shapes = {True: Counter(), False: Counter()}
    for elide in (True, False):
        for nid, low in runs[(elide, 8)].lowering.items():
            nhwc = low.in_layout is None or low.in_layout.kind == "nhwc"
            if (low.algo.family is AlgoFamily.IM2COL and nhwc
                    and low.precision == "int8"):
                m = g.nodes[nid].conv
                shapes[elide][(m.h1, m.h2, m.c_in, m.k1, m.k2, m.stride,
                               m.pad.upper(), m.c_out,
                               low.out_scale is not None)] += 1

    rows = {}

    def timed(label, kern, plain, tol, flops, nbytes):
        err = check_close(label, kern(), plain(), **tol)
        b_ms, b_by = bound(flops, nbytes, PEAK_INT8_OPS)
        rows[label] = dict(ms=time_ms(kern), queued_ms=queued_ms(kern),
                           bound_ms=b_ms, bound_by=b_by, max_abs_err=err)

    for key in sorted(set(shapes[True]) | set(shapes[False]),
                      key=lambda s: (-s[0] * s[1] * s[2], s)):
        h, w_in, c_in, k1, k2, stride, pad, c_out, q = key
        o1, o2 = conv_geometry(h, w_in, k1, k2, stride, pad)[:2]
        k = k1 * k2 * c_in
        for bsz in (1, 8):
            x, w = randi8(bsz, h, w_in, c_in), randi8(k1, k2, c_in, c_out)
            kw = dict(stride=stride, padding=pad, epilogue="bias_relu",
                      bias=(torch.randn(c_out, generator=gen) * 0.1).to(dev),
                      scale=scales(c_out, k), out_scale=0.05 if q else None)
            m = bsz * o1 * o2
            timed(f"conv_im2col_i8 {bsz}x{h}x{w_in}x{c_in} {k1}x{k2} "
                  f"s{stride} {pad} -> {c_out} {'int8' if q else 'f32'} out "
                  f"(launches elided {shapes[True][key]}, not "
                  f"{shapes[False][key]})",
                  lambda: conv_im2col_call(x, w, **kw),
                  lambda: conv_i8_plain(x, w, **kw),
                  EXACT if q else KERNEL_TOL, 2.0 * m * c_out * k,
                  x.numel() + w.numel() + 8.0 * c_out
                  + (1.0 if q else 4.0) * m * c_out)
    m, k, n = 8 * 35 * 35, 9 * 192, 224
    a, b = randi8(m, k), randi8(k, n)
    s, c = scales(n, k), (torch.randn(n, generator=gen) * 0.1).to(dev)
    timed(f"gemm_i8 redA/b3b M={m} K={k} N={n} f32 out",
          lambda: gemm_call(a, b, epilogue="bias_relu", bias=c, scale=s),
          lambda: gemm_i8_plain(a, b, "bias_relu", c, scale=s), EXACT,
          2.0 * m * n * k, m * k + k * n + 8.0 * n + 4.0 * m * n)
    x2d, wg = randi8(8 * 147 * 147, 64), randi8(9, 64, 96)
    g_, m, k, n = 9, x2d.shape[0], 64, 96
    timed(f"unit_conv_gemms_i8 stem/c4 G={g_} M={m} K={k} N={n}",
          lambda: kn2.unit_conv_gemms_call(x2d, wg),
          lambda: kn2.unit_conv_gemms_plain(x2d, wg), EXACT,
          2.0 * g_ * m * k * n, m * k + g_ * k * n + 4.0 * g_ * m * n)
    del a, b, x2d, wg
    for label, r in rows.items():
        print(f"{args.label} {label}: events {r['ms']:.4f} ms, queued "
              f"{r['queued_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); max|diff| {r['max_abs_err']:.3e}")

    forwards = {}
    for (elide, bsz), run in runs.items():
        x = torch.randn((bsz, 299, 299, 3), generator=gen).to(dev)
        run(params, x)
        torch.cuda.synchronize()
        before = CONV_I8.launches
        run(params, x)
        launches = CONV_I8.launches - before
        busy, _, groups = device_time(lambda: run(params, x), reps=5)
        conv_ms = sum(v for key, v in groups.items()
                      if key.startswith("conv_im2col_i8"))
        gemm_ms = sum(v for key, v in groups.items()
                      if key.startswith("gemm_i8"))
        tag = f"{'elided' if elide else 'unelided'} b{bsz}"
        forwards[tag] = dict(device_ms=busy, conv_im2col_i8_ms=conv_ms,
                             gemm_i8_ms=gemm_ms, conv_launches=launches)
        print(f"{args.label} inception_v4 299 int8 forward {tag}: device "
              f"busy {busy:.3f} ms, conv_im2col_i8 group {conv_ms:.4f} ms "
              f"({launches} launches a forward), gemm_i8 group "
              f"{gemm_ms:.4f} ms (profiler, mean of 5 forwards)")
    print(json.dumps({"label": args.label, "device": smi, "rows": rows,
                      "forwards": forwards}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
