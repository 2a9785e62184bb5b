"""Quickstart on the PyTorch/CUDA port: the full DYNAMAP flow on GoogleNet.

    python examples/quickstart_torch.py                      # on the card
    python examples/quickstart_torch.py --device cpu --res 56 --scale 0.25

The twin of ``examples/quickstart.py``, on ``repro_torch``:

1. Build the CNN graph (GoogleNet — the paper's first evaluation network).
2. Run Algorithm 1 (hardware DSE → virtual-array shape + per-(layer, algo)
   dataflow).
3. Build the cost graph and solve the PBQP optimally via series-parallel
   reduction (Theorem 4.1).
4. Compare against the paper's fixed-algorithm baselines (Table 4).
5. Execute the network under the chosen plan and check it against the
   im2col-only forward.
6. Lower the plan with ``compile_plan`` into one batched program (on the
   card: an eager warm pass, one CUDA-graph capture, then replays) and
   check a replayed batch against the eager per-image loop.

It runs on the card at full width (224², scale 1.0) by default;
``--device cpu --res 56 --scale 0.25`` is the reference's CPU size. It
exits nonzero when a check fails.
"""
import argparse
import sys
import time
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

# The whole-plan tolerance of the reference's tests.
TOL = dict(rtol=2e-2, atol=2e-3)


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    from repro_torch.cnn.executor import compile_plan, forward, init_params
    from repro_torch.cnn.models import googlenet
    from repro_torch.core.cost_model import FPGA_LIKE
    from repro_torch.core.dse import identify_parameters
    from repro_torch.core.graph import is_series_parallel
    from repro_torch.core.mapper import evaluate_fixed_mapping, map_network
    from repro_torch.kernels.common import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the network runs (cuda, or cpu at a "
                         "reduced --res/--scale)")
    ap.add_argument("--res", type=int, default=224)
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    failures = []

    g = googlenet(res=args.res, scale=args.scale)
    print(f"GoogleNet graph ({args.res}², scale {args.scale}): "
          f"{len(g.nodes)} nodes, {len(g.conv_nodes())} conv layers, "
          f"series-parallel={is_series_parallel(g)}")

    hw = identify_parameters(g, spec=FPGA_LIKE, max_dim=512, k_panel=256)
    print(f"Algorithm 1 → virtual array ({hw.p1}×{hw.p2}), "
          f"τ_emp={hw.tau_emp * 1e3:.3f} ms")

    plan = map_network(g, hw=hw, spec=FPGA_LIKE)
    print(f"PBQP optimal mapping (exact={plan.solver.exact}): "
          f"{dict(Counter(str(a) for a in plan.assignment.values()))}")
    print(f"end-to-end latency (cost model): {plan.total_cost_s * 1e3:.3f} ms")
    if not plan.solver.exact:
        failures.append("the PBQP solution is not exact")
    for pol in ("im2col", "kn2row", "winograd"):
        bl = evaluate_fixed_mapping(g, pol, hw=hw, spec=FPGA_LIKE)
        print(f"  vs {pol:8s}-only: {bl * 1e3:8.3f} ms "
              f"(OPT {100 * (1 - plan.total_cost_s / bl):5.1f}% lower)")

    params = init_params(g, seed=0, device=dev)
    shape = tuple(int(d) for d in g.nodes[g.source()].attrs["out_shape"])
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen).to(dev)
    ref = forward(g, params, x, device=dev)            # every conv im2col
    opt = forward(g, params, x, plan=plan, device=dev)
    err = _max_diff(opt, ref)
    print(f"plan-executed output vs im2col reference: max|Δ| = {err:.2e}")
    if not torch.allclose(opt, ref, **TOL):
        failures.append(f"plan vs im2col-only forward max|Δ| {err:.3e}")

    # 6. Plan compilation: every per-layer algorithm + dataflow/(p1, p2)
    # choice is resolved now; the result is one program over a static
    # lowering. GoogleNet lowers CONV+bias+ReLU fused ("bias_relu").
    run = compile_plan(g, plan, epilogue="bias_relu", device=dev)
    xb = torch.randn((8,) + shape, generator=gen).to(dev)
    run(params, xb)                          # eager warm pass
    run(params, xb)                          # capture (on the card)
    _sync(dev)
    t0 = time.perf_counter()
    yb = run(params, xb)                     # replay
    _sync(dev)
    t_comp = time.perf_counter() - t0
    t0 = time.perf_counter()
    eager = [forward(g, params, xb[i], plan=plan, epilogue="bias_relu",
                     device=dev) for i in range(xb.shape[0])]
    _sync(dev)
    t_eager = time.perf_counter() - t0
    eager = torch.stack(eager)
    err_b = _max_diff(yb, eager)
    print(f"compiled batched plan: {tuple(yb.shape)} in {t_comp * 1e3:.1f} "
          f"ms vs eager per-image loop {t_eager * 1e3:.1f} ms "
          f"({t_eager / t_comp:.1f}x); max|Δ| vs eager = {err_b:.2e}")
    if not bool(torch.isfinite(yb).all()) or \
            not torch.allclose(yb, eager, **TOL):
        failures.append(f"compiled batch vs eager loop max|Δ| {err_b:.3e}")

    for msg in failures:
        print(f"quickstart check failed: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
