#!/usr/bin/env python3
"""Time the port's f32 conv and batched GEMM kernels of one source tree on
the card, at the shapes of their main-path launches.

    python3 tools/time_f32_loops.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of a checkout (default: this one's), so
two trees can be timed in one call on one card, in the order parent,
change, change, parent, each in a process of its own. The tree's kernels
are built from its own ``csrc`` (``build/kernels`` of that checkout). Each
shape is checked against the kernel's plain version (rtol/atol 1e-4), then
timed by CUDA events and by queued launches (device time without host
gaps, ``chip_smoke.queued_ms``) beside the library call (cuDNN for the
conv, ``torch.bmm`` for the batched GEMM; TF32 off for both). Prints the
card's name and power limit, one line per shape and one JSON object of
all the numbers last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# (label, x (B, H, W, Cin), w (K1, K2, Cin, Cout), stride, padding)
CONVS = [("googlenet stem b8", (8, 224, 224, 3), (7, 7, 3, 64), 2, "SAME"),
         ("vgg16 conv0_0 b8", (8, 224, 224, 3), (3, 3, 3, 64), 1, "SAME"),
         ("iv4 stem/c1 b8", (8, 299, 299, 3), (3, 3, 3, 32), 2, "VALID")]
# (label, G, M, K, N): Winograd F(4,3) transform-space products.
BATCHED = [("vgg16 conv0_1 b8", 36, 25088, 64, 64),
           ("vgg16 conv2_1 b8", 36, 1568, 256, 256),
           ("iv4 incA0/b4c b1", 36, 81, 96, 96),
           ("iv4 incA0/b4c b8", 36, 648, 96, 96)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=REPO / "src")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_f32_loops: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(0, str(REPO))
    import torch.nn.functional as F

    from chip_smoke import (KERNEL_TOL, bound, check_close, queued_ms,
                            time_ms, use_source_tree)
    use_source_tree(args.src)
    from repro_torch.kernels import build
    from repro_torch.kernels.common import pad_nhwc
    from repro_torch.kernels.conv_im2col.conv_im2col import (conv_im2col_call,
                                                             conv_plain)
    from repro_torch.kernels.conv_im2col.ref import conv_geometry
    from repro_torch.kernels.gemm.gemm import (batched_gemm_call,
                                              batched_gemm_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{args.label}: {smi}; sources {args.src.resolve()}; built in "
          f"{build.build_all():.1f} s")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    rows = {}
    for label, xs, ws, stride, pad in CONVS:
        x = randn(*xs)
        w = randn(*ws, scale=(ws[0] * ws[1] * ws[2]) ** -0.5)
        bias = randn(ws[3], scale=0.1)
        o1, o2, pt, pb, pl, pr = conv_geometry(xs[1], xs[2], ws[0], ws[1],
                                               stride, pad)
        xp = pad_nhwc(x, pt, pb, pl, pr).permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()

        def kern():
            return conv_im2col_call(x, w, stride=stride, padding=pad,
                                    epilogue="bias_relu", bias=bias)

        def lib():
            return F.conv2d(xp, w_oihw, stride=stride)

        err = check_close(label, kern(), conv_plain(
            x, w, stride=stride, padding=pad, epilogue="bias_relu",
            bias=bias), **KERNEL_TOL)
        m = xs[0] * o1 * o2
        b_ms, b_by = bound(2.0 * m * ws[3] * ws[0] * ws[1] * ws[2],
                           4.0 * (x.numel() + w.numel() + ws[3]
                                  + m * ws[3]))
        rows[label] = dict(ms=time_ms(kern), queued_ms=queued_ms(kern),
                           library_ms=time_ms(lib),
                           library_queued_ms=queued_ms(lib), bound_ms=b_ms,
                           bound_by=b_by, max_abs_err=err)
    for label, g, m, k, n in BATCHED:
        a, b = randn(g, m, k), randn(g, k, n, scale=k ** -0.5)

        def kern():
            return batched_gemm_call(a, b)

        def lib():
            return torch.bmm(a, b)

        err = check_close(label, kern(), batched_gemm_plain(a, b),
                          **KERNEL_TOL)
        b_ms, b_by = bound(2.0 * g * m * k * n,
                           4.0 * g * (m * k + k * n + m * n))
        rows[label] = dict(ms=time_ms(kern), queued_ms=queued_ms(kern),
                           library_ms=time_ms(lib),
                           library_queued_ms=queued_ms(lib), bound_ms=b_ms,
                           bound_by=b_by, max_abs_err=err)
    for label, r in rows.items():
        print(f"{args.label} {label}: kernel {r['ms']:.4f} ms (queued "
              f"{r['queued_ms']:.4f}), library {r['library_ms']:.4f} ms "
              f"(queued {r['library_queued_ms']:.4f}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); max|diff| "
              f"{r['max_abs_err']:.3e}")
    print(json.dumps({"label": args.label, "device": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
