#!/usr/bin/env python3
"""Hold the compiled LM train step to the eager one for every
architecture, and capture it under each CUDA-graph capture mode.

    python3 tools/check_train_graph.py                        # one card
    PYTHONPATH=src python tools/check_train_graph.py --device cpu

For each architecture's reduced config in f32 (batch 4 x 32, two
microbatches; h2o-danube-1.8b and mamba2-370m also at one): three calls
of ``compile_train_step``'s step (on a card: two eager passes, then the
capture and its replay) against three ``train_step`` calls from the same
weights and batches, the params, moments, step and every metric bit for
bit. On a card it also counts the graph's kernel nodes
(``chip_smoke.graph_kernel_symbols``), and captures reduced
h2o-danube-1.8b under each ``capture_error_mode`` (``global``,
``relaxed``, ``thread_local``): the nodes of each graph and its replays'
bits. On the CPU nothing is captured and the same body runs eagerly.
Prints the card's name and power limit first; the last line is one JSON
object with ``"ok"``. Exits 1 when a step differs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
MODES = ("global", "relaxed", "thread_local")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import torch

    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.common import resolve_device
    from repro_torch.launch import steps
    from repro_torch.models import model as lm
    from repro_torch.models.scan_util import tree_leaves, tree_unflatten
    from repro_torch.optim.adamw import init_opt_state

    dev = resolve_device(args.device)
    card = dev.type == "cuda"
    if card:
        from chip_smoke import graph_kernel_symbols
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)

    def clone(tree):
        return tree_unflatten(tree, [t.clone() for t in tree_leaves(tree)])

    def held(name, microbatches, mode="thread_local"):
        """(bit-equal, kernel nodes or None, seconds) of ``args.steps``
        compiled steps against as many eager ones."""
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(name, reduced=True),
                                  dtype="float32")
        opt = dataclasses.replace(steps.make_opt_config(cfg, total_steps=20),
                                  warmup_steps=2, lr=1e-3)
        params = lm.init_model(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        state = init_opt_state(params, opt)
        batches = [make_batch(DataConfig(seed=1, global_batch=4, seq_len=32),
                              cfg, i, device=dev)
                   for i in range(args.steps)]
        step = steps.compile_train_step(clone(params), clone(state),
                                        batches[0], cfg=cfg, opt_cfg=opt,
                                        microbatches=microbatches)
        if mode != "thread_local":
            step._capture = lambda: capture(step, mode)
        equal = True
        for b in batches:
            params, state, want = steps.train_step(
                params, state, b, cfg=cfg, opt_cfg=opt,
                microbatches=microbatches)
            got = step(b)
            equal = equal and set(got) == set(want) and all(
                torch.equal(got[k], want[k]) for k in want)
        equal = equal and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
                tree_leaves((step.params, step.opt_state)),
                tree_leaves((params, state))))
        nodes = None
        if card:
            if step.graph is None:
                raise RuntimeError(f"{name}: no graph after {args.steps} "
                                   f"calls on the card")
            nodes = len(graph_kernel_symbols(step.graph))
        return equal, nodes, time.perf_counter() - t0

    def capture(step, mode):
        """``CompiledTrainStep._capture`` under another mode."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=step._stream,
                              capture_error_mode=mode):
            step._body()
        graph.instantiate()
        step.graph = graph

    rows = []
    cases = [(n, 2) for n in ARCH_NAMES] + [("h2o-danube-1.8b", 1),
                                             ("mamba2-370m", 1)]
    for name, mb in cases:
        equal, nodes, secs = held(name, mb)
        rows.append({"arch": name, "microbatches": mb, "bit_equal": equal,
                     "kernel_nodes": nodes})
        print(f"{name} ({mb} microbatches): {args.steps} compiled steps "
              f"{'bit-equal to' if equal else 'DIFFER from'} train_step's"
              + (f"; {nodes} kernel nodes" if nodes is not None else "")
              + f"; {secs:.1f} s", flush=True)
    modes = []
    for mode in MODES if card else ():
        equal, nodes, _ = held("h2o-danube-1.8b", 2, mode)
        modes.append({"mode": mode, "bit_equal": equal,
                      "kernel_nodes": nodes})
        print(f"capture_error_mode={mode!r}: reduced h2o-danube-1.8b "
              f"(2 microbatches) {nodes} kernel nodes, "
              f"{'bit-equal' if equal else 'DIFFERENT'}", flush=True)
    ok = all(r["bit_equal"] for r in rows + modes)
    print(json.dumps({"ok": ok, "device": str(dev), "steps": rows,
                      "capture_modes": modes}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
