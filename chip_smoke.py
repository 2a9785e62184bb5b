#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from anywhere inside a checkout: ``python3 chip_smoke.py``. It puts
``src`` on ``sys.path`` itself, builds the hand-written CUDA kernels from
``src/repro_torch/csrc`` (``build/kernels/``), and then, with TF32 off for
both matrix products and cuDNN:

1. prints the card, its power limit, the toolchain and the build time;
2. holds the GEMM kernel against its plain version at main-path shapes;
3. holds the implicit-GEMM conv kernel against its plain version (the
   GoogleNet stem, a 3x3 SAME and a VALID case);
4. runs full-width GoogleNet (224x224, scale 1.0; random weights from a
   seed) planned by the port's planner, kernels vs the plain path on the
   card, at every bucket with layout elision and once without, and checks
   the kernel launches per forward;
5. serves distinct requests through the port's ``CNNServingEngine`` (the
   main path: the launch counts of that run are the ones reported) and
   checks every result against a per-image plain forward;
6. times each kernel, its plain version and the library call at the
   main-path shapes beside the card's bound, and the full forward per
   bucket.

Every check raises on failure, so the script exits nonzero without its
final line. The line before the last is one JSON object of per-kernel
numbers; the last is ``{"ok": true, "device": {...}}``. With no CUDA
device, or outside a checkout, it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

BUCKETS = (1, 2, 4, 8)
FORWARD_TOL = dict(rtol=2e-2, atol=2e-3)    # the reference's whole-plan tol
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)     # the reference's f32 kernel tol
N_REQUESTS = 13


class CheckFailed(AssertionError):
    pass


def check_close(name: str, got, want, rtol: float, atol: float) -> float:
    """Raise unless ``got`` matches ``want`` elementwise; returns max|Δ|."""
    import torch
    if tuple(got.shape) != tuple(want.shape):
        raise CheckFailed(f"{name}: shape {tuple(got.shape)} != "
                          f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise CheckFailed(f"{name}: non-finite output")
    diff = (got - want).abs()
    err = float(diff.max())
    bad = int((diff > atol + rtol * want.abs()).sum())
    if bad:
        raise CheckFailed(f"{name}: {bad} elements outside rtol={rtol} "
                          f"atol={atol} (max |diff| {err:.3e})")
    return err


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Time of one call in ms: CUDA events around ``reps`` back-to-back
    calls, divided by ``reps``; the median of ``rounds`` such runs, after
    three warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def device_time(fn):
    """(device ms summed over every kernel one call runs, that time split
    into this port's kernels by tile, torch's index gathers — the Toeplitz
    layout conversions — and all other torch kernels) from
    ``torch.profiler``."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {}
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total", 0) / 1e3
        if ms <= 0:
            continue
        ours = re.search(r"(gemm_f32|conv_im2col_f32)_kernel<(\d+), (\d+)>",
                         e.key)
        key = (f"{ours[1]}<{ours[2]}x{ours[3]}>" if ours
               else "torch index/gather" if "index" in e.key
               else "torch other")
        groups[key] = groups.get(key, 0.0) + ms
    split = ", ".join(f"{k} {v:.3f}" for k, v in
                      sorted(groups.items(), key=lambda kv: -kv[1]))
    return sum(groups.values()), split


def bound(flops: float, nbytes: float):
    """(least ms the card could take, what bounds it) for f32 work."""
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.cnn.executor import compile_plan, init_params
    from repro_torch.cnn.models import googlenet
    from repro_torch.core.algorithms import AlgoFamily
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.mapper import map_network
    from repro_torch.kernels import build
    from repro_torch.kernels.common import pad_nhwc
    from repro_torch.kernels.conv_im2col.conv_im2col import (
        CONV, conv_im2col_call, conv_plain)
    from repro_torch.kernels.conv_im2col.ref import conv_geometry
    from repro_torch.kernels.gemm.gemm import GEMM, gemm_call, gemm_plain
    from repro_torch.serving.cnn_engine import CNNRequest, CNNServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale: float = 1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    # ---- 1. card and toolchain -----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    build_s = build.build_all()
    print(f"[1] built {', '.join(build.SOURCES)} in {build_s:.2f} s "
          f"({build.BUILD_DIR})")
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1] ptxas {name}: {line.strip()}")

    # ---- 2. gemm kernel vs plain --------------------------------------
    gemm_cases = [("conv2", 8 * 3136, 576, 192, ((128, 128),)),
                  ("ragged", 49 * 8, 832, 32,
                   ((64, 64), (64, 128), (128, 64), (128, 128)))]
    gemm_err = {}
    gemm_inputs = {}
    for label, m, k, n, tiles in gemm_cases:
        a = randn(m, k)
        b = randn(k, n, scale=k ** -0.5)
        bias = randn(n, scale=0.1)
        want = gemm_plain(a, b, "bias_relu", bias)
        for bm, bn in tiles:
            got = gemm_call(a, b, bm=bm, bn=bn, epilogue="bias_relu",
                            bias=bias)
            torch.cuda.synchronize()
            err = check_close(f"gemm {label} M={m} K={k} N={n} tile "
                              f"({bm},{bn})", got, want, **KERNEL_TOL)
            gemm_err[label] = max(gemm_err.get(label, 0.0), err)
        got = gemm_call(a, b, epilogue="none")
        check_close(f"gemm {label} no epilogue", got, a @ b, **KERNEL_TOL)
        gemm_inputs[label] = (a, b, bias)
        print(f"[2] gemm {label} M={m} K={k} N={n} bias_relu tiles "
              f"{list(tiles)}: max|diff| {gemm_err[label]:.3e} "
              f"(rtol/atol 1e-4)")

    # ---- 3. conv kernel vs plain --------------------------------------
    conv_cases = [("stem", (8, 224, 224, 3), (7, 7, 3, 64), 2, "SAME"),
                  ("3x3", (8, 56, 56, 64), (3, 3, 64, 192), 1, "SAME"),
                  ("valid", (4, 17, 17, 32), (3, 3, 32, 48), 2, "VALID"),
                  ("5x5", (2, 28, 28, 16), (5, 5, 16, 32), 1, "SAME")]
    conv_err = {}
    conv_inputs = {}
    for label, xs, ws, stride, pad in conv_cases:
        x = randn(*xs)
        w = randn(*ws, scale=(ws[0] * ws[1] * ws[2]) ** -0.5)
        bias = randn(ws[3], scale=0.1)
        want = conv_plain(x, w, stride=stride, padding=pad,
                          epilogue="bias_relu", bias=bias)
        got = conv_im2col_call(x, w, stride=stride, padding=pad,
                               epilogue="bias_relu", bias=bias)
        torch.cuda.synchronize()
        conv_err[label] = check_close(f"conv {label}", got, want,
                                      **KERNEL_TOL)
        conv_inputs[label] = (x, w, bias, stride, pad)
        print(f"[3] conv {label} x{xs} w{ws} s{stride} {pad} bias_relu: "
              f"max|diff| {conv_err[label]:.3e} (rtol/atol 1e-4)")

    # ---- 4. full-width GoogleNet: kernels vs plain path ---------------
    g = googlenet(res=224, scale=1.0)
    plan = map_network(g, hw=identify_parameters(g, max_dim=512))
    convs = g.conv_nodes()
    if not plan.solver.exact or any(
            a.family is not AlgoFamily.IM2COL
            for a in plan.assignment.values()):
        raise CheckFailed("the GoogleNet plan is not the all-im2col exact "
                          "plan this slice serves")
    params = init_params(g, seed=0, device=dev)
    for nid in sorted(params):
        params[nid]["b"].copy_(randn(*params[nid]["b"].shape, scale=0.05))
    runs = {}
    for elide, buckets in ((True, BUCKETS), (False, (8,))):
        for bsz in buckets:
            run_k = compile_plan(g, plan, epilogue="bias_relu",
                                 tuning_batch=bsz, elide=elide, device=dev)
            run_p = compile_plan(g, plan, epilogue="bias_relu",
                                 tuning_batch=bsz, elide=elide,
                                 use_pallas=False, device=dev)
            x = randn(bsz, 224, 224, 3)
            GEMM.launches = CONV.launches = 0
            got = run_k(params, x)
            torch.cuda.synchronize()
            n_gemm, n_conv = GEMM.launches, CONV.launches
            # Elided: 56 convs read their Toeplitz matrix (gemm), the stem
            # reads the NHWC image (conv). Not elided: every conv is NHWC.
            expect = (56, 1) if elide else (0, len(convs))
            if (n_gemm, n_conv) != expect:
                raise CheckFailed(
                    f"forward b{bsz} elide={elide}: launches gemm={n_gemm} "
                    f"conv={n_conv}, expected {expect}")
            want = run_p(params, x)
            err = check_close(f"googlenet b{bsz} elide={elide}", got, want,
                              **FORWARD_TOL)
            runs[(elide, bsz)] = (run_k, run_p, x)
            print(f"[4] googlenet 224 b{bsz} elide={elide}: logits "
                  f"{tuple(got.shape)} max|diff| vs plain {err:.3e} "
                  f"(rtol 2e-2 atol 2e-3); launches per forward "
                  f"gemm={n_gemm} conv={n_conv}")

    # ---- 5. serving: the main path ------------------------------------
    engine = CNNServingEngine(g, params, plan, batch_size=8, slo_s=0.25,
                              warmup=True, device=dev)
    rng = np.random.default_rng(1)
    images = [rng.standard_normal((224, 224, 3)).astype(np.float32)
              for _ in range(N_REQUESTS)]
    for rid, img in enumerate(images):
        engine.submit(CNNRequest(rid=rid, image=img))
    GEMM.launches = CONV.launches = 0
    done = engine.run_until_done()
    torch.cuda.synchronize()
    launches = {"gemm": GEMM.launches, "conv": CONV.launches}
    stats = engine.stats()
    ticks = sum(stats["dispatches"].values())
    if stats["served"] != N_REQUESTS or sorted(done) != list(
            range(N_REQUESTS)):
        raise CheckFailed(f"served {stats['served']} of {N_REQUESTS}")
    if launches != {"gemm": 56 * ticks, "conv": ticks}:
        raise CheckFailed(f"serving launches {launches} over {ticks} ticks")
    run_p1 = runs[(True, 1)][1]
    serve_err = 0.0
    for rid, img in enumerate(images):
        want = run_p1(params, img[None])[0]
        got = torch.as_tensor(done[rid], device=dev)
        serve_err = max(serve_err, check_close(f"served request {rid}", got,
                                               want, **FORWARD_TOL))
    # A correctness check, not a latency measurement: a handful of
    # requests flushed at once, so only each tick's wall time is shown.
    tick_ms = {(t.t_dispatch, t.bucket): round(t.service_s * 1e3, 3)
               for t in engine.request_log}
    print(f"[5] served {stats['served']}/{N_REQUESTS} requests in {ticks} "
          f"ticks, dispatches per bucket {stats['dispatches']}; wall time "
          f"per tick (bucket: ms) "
          f"{[(b, ms) for (_, b), ms in tick_ms.items()]}; "
          f"max|diff| vs per-image plain forward {serve_err:.3e}; "
          f"launches gemm={launches['gemm']} conv={launches['conv']}")

    # ---- 6. timings ---------------------------------------------------
    a, b, bias = gemm_inputs["conv2"]
    m, k = a.shape
    n = b.shape[1]
    g_ms = time_ms(lambda: gemm_call(a, b, epilogue="bias_relu", bias=bias))
    g_plain = time_ms(lambda: gemm_plain(a, b, "bias_relu", bias))
    g_lib = time_ms(lambda: torch.matmul(a, b))
    g_bound, g_by = bound(2.0 * m * n * k, 4.0 * (m * k + k * n + n + m * n))
    print(f"[6] gemm conv2 M={m} K={k} N={n}: kernel {g_ms:.4f} ms, plain "
          f"{g_plain:.4f} ms, torch.matmul {g_lib:.4f} ms, bound "
          f"{g_bound:.4f} ms ({g_by}; 67 TFLOP/s f32, 3.35 TB/s)")

    # The smallest-M main-path GEMM at bucket 1: inception 5b's 1x1 conv on
    # the 7x7 map (M = 49) runs on a grid of one tile row.
    a5, b5 = randn(49, 832), randn(832, 384, scale=832 ** -0.5)
    s_ms = time_ms(lambda: gemm_call(a5, b5, epilogue="relu"))
    s_bound, s_by = bound(2.0 * 49 * 832 * 384,
                          4.0 * (49 * 832 + 832 * 384 + 49 * 384))
    print(f"[6] gemm inception_5b/1x1 b1 M=49 K=832 N=384 (grid "
          f"{-(-384 // 128)}x1 blocks): kernel {s_ms:.4f} ms, bound "
          f"{s_bound:.4f} ms ({s_by})")

    x, w, cbias, stride, pad = conv_inputs["stem"]
    bsz, h, w_in, c_in = x.shape
    k1, k2, _, c_out = w.shape
    o1, o2, pt, pb, pl, pr = conv_geometry(h, w_in, k1, k2, stride, pad)
    xp_nchw = pad_nhwc(x, pt, pb, pl, pr).permute(0, 3, 1, 2).contiguous()
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    c_ms = time_ms(lambda: conv_im2col_call(
        x, w, stride=stride, padding=pad, epilogue="bias_relu", bias=cbias))
    c_plain = time_ms(lambda: conv_plain(
        x, w, stride=stride, padding=pad, epilogue="bias_relu", bias=cbias))
    c_lib = time_ms(lambda: F.conv2d(xp_nchw, w_oihw, stride=stride))
    c_flops = 2.0 * bsz * o1 * o2 * c_out * k1 * k2 * c_in
    c_bytes = 4.0 * (x.numel() + w.numel() + c_out + bsz * o1 * o2 * c_out)
    c_bound, c_by = bound(c_flops, c_bytes)
    print(f"[6] conv stem x{tuple(x.shape)} w{tuple(w.shape)} s{stride}: "
          f"kernel {c_ms:.4f} ms, plain {c_plain:.4f} ms, F.conv2d (cuDNN, "
          f"no TF32) {c_lib:.4f} ms, bound {c_bound:.4f} ms ({c_by})")

    for bsz in BUCKETS:
        run_k, run_p, x = runs[(True, bsz)]
        f_ms = time_ms(lambda: run_k(params, x), reps=10, rounds=5)
        p_ms = time_ms(lambda: run_p(params, x), reps=10, rounds=5)
        dev_ms, split = device_time(lambda: run_k(params, x))
        print(f"[6] googlenet 224 forward b{bsz} (elide): kernels "
              f"{f_ms:.3f} ms, plain path {p_ms:.3f} ms; device busy "
              f"{dev_ms:.3f} ms of the kernels' forward "
              f"({100 * dev_ms / f_ms:.1f}%) = {split} (ms)")

    kernels = [
        {"name": "gemm_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/gemm.cu",
         "replaces": "src/repro/kernels/gemm/gemm.py:117",
         "launches": launches["gemm"], "max_abs_err": gemm_err["conv2"],
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
         "bound_by": g_by, "library_ms": g_lib},
        {"name": "conv_im2col_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/conv_im2col.cu",
         "replaces": "src/repro/kernels/conv_im2col/conv_im2col.py:89",
         "launches": launches["conv"], "max_abs_err": conv_err["stem"],
         "ms": c_ms, "plain_ms": c_plain, "bound_ms": c_bound,
         "bound_by": c_by, "library_ms": c_lib},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
