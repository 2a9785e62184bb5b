"""A tour of the algorithm-mapping machinery on the PyTorch/CUDA port:
all five CNN families (Lemmas 4.3/4.4) — chain nets, residual nets, and
both Inception networks — each reduced to K2 by the series-parallel
solver, mapped optimally, and compared against the greedy baseline the
paper argues against (§6.1.2).

The twin of ``examples/algorithm_mapping_tour.py``, on ``repro_torch``'s
planner (``repro_torch.core``, ``repro_torch.cnn.models``) with the same
FPGA-like cost spec and sizes; it prints the same line per family. The
planner is host-side Python, so nothing runs on a device.

    PYTHONPATH=src python examples/algorithm_mapping_tour_torch.py
"""
import argparse
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.cnn.models import MODELS  # noqa: E402
from repro_torch.core.cost_model import FPGA_LIKE  # noqa: E402
from repro_torch.core.dse import identify_parameters  # noqa: E402
from repro_torch.core.graph import is_series_parallel  # noqa: E402
from repro_torch.core.mapper import map_network  # noqa: E402


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    for name, build in MODELS.items():
        res = 75 if name == "inception_v4" else 64
        g = build(res=res, scale=0.25)
        if not is_series_parallel(g):
            print(f"{name}: the graph is not series-parallel")
            return 1
        hw = identify_parameters(g, spec=FPGA_LIKE, max_dim=256,
                                 k_panel=256)
        opt = map_network(g, hw=hw, spec=FPGA_LIKE)
        greedy = map_network(g, hw=hw, spec=FPGA_LIKE,
                             solver="greedy_node")
        mix = dict(Counter(a.family.value for a in
                           opt.assignment.values()))
        gain = 100 * (1 - opt.total_cost_s / greedy.total_cost_s)
        print(f"{name:14s} convs={len(g.conv_nodes()):3d} "
              f"reductions={opt.solver.reductions:4d} exact={opt.solver.exact}  "
              f"OPT={opt.total_cost_s * 1e6:9.1f}µs  "
              f"greedy +{gain:4.1f}%  mix={mix}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
