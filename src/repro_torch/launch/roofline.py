"""Roofline terms per chip for every (arch × shape) cell on the 16×16
production mesh: the reference's ``launch/roofline.py`` over the dry
run's trace (``launch.dryrun.trace_step`` on a fake 256-rank group).

The reference compiles two probe variants of every cell, ``u`` and
``2u`` scan units (``REPRO_FULL_UNROLL=1``, since XLA counts a loop body
once), and recovers

    per_unit = probe(2u) − probe(u)          (exact per-layer terms)
    base     = probe(u) − per_unit           (embed + CE + caches)
    total    = base + n_units_full · per_unit

for FLOPs, HBM bytes and collective bytes. An eager trace counts every
iteration already; the port keeps the two probes (microbatches=1, the
same per-step math) so ``per_unit``, ``base`` and ``total`` mean what
they mean there. Terms (per chip, NVIDIA H100 SXM, ``repro_torch.hw``):

    compute_s    = flops / 989e12      (dense bf16 tensor cores)
    memory_s     = hbm_bytes / 3.35e12 (HBM3)
    collective_s = collective_bytes / 50e9 (InfiniBand NDR per GPU: a
                   16-wide model axis spans two 8-GPU NVLink domains)

FLOPs are the matrix products' (``TraceCounter``); HBM bytes each
non-view op's inputs read and outputs written once.

  PYTHONPATH=src python -m repro_torch.launch.roofline --arch qwen2.5-14b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.roofline --all

Results go to ``experiments/roofline_torch/`` (gitignored).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, shapes_for
from repro_torch.configs.base import BlockType, ModelConfig, ShapeSpec
from repro_torch.hw import (COLLECTIVE_BYTES_PER_S, HBM_BYTES_PER_S,
                            PEAK_BF16_FLOPS)
from repro_torch.launch.dryrun import fake_world, trace_step
from repro_torch.launch.mesh import make_production_mesh

RESULT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "roofline_torch"

PEAK_FLOPS = PEAK_BF16_FLOPS
HBM_BW = HBM_BYTES_PER_S
COLLECTIVE_BW = COLLECTIVE_BYTES_PER_S


def scan_unit(cfg: ModelConfig) -> int:
    """Layers per scan step (group size)."""
    if cfg.block_type is BlockType.MAMBA and cfg.attn_every:
        return cfg.attn_every
    if cfg.moe is not None and cfg.moe_every > 1:
        return cfg.moe_every
    return 1


def probe_cfg(cfg: ModelConfig, units: int) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=units * scan_unit(cfg))


def compile_cell(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """One trace of the cell (microbatches=1): the dry run's counts."""
    return trace_step(cfg, shape, mesh, microbatches=1)["counts"]


def probe_terms(cfg: ModelConfig, shape: ShapeSpec, units: int, mesh):
    c = compile_cell(probe_cfg(cfg, units), shape, mesh)
    return {"flops": float(c.flops), "bytes": float(c.bytes),
            "coll": float(sum(c.coll.values())),
            "coll_by_op": dict(c.coll)}


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS: 6·N·D (dense) / 6·N_active·D (MoE) for training,
    2·N_active·D to serve; decode D = the new tokens."""
    if shape.kind == "train":
        return 6 * cfg.active_param_count() * shape.global_batch \
            * shape.seq_len
    if shape.kind == "prefill":
        return 2 * cfg.active_param_count() * shape.global_batch \
            * shape.seq_len
    return 2 * cfg.active_param_count() * shape.global_batch


def analyze(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """The roofline of ``cfg`` at ``shape`` on ``mesh`` (a fake group's):
    two probes, the per-unit extrapolation to ``cfg.n_layers`` and the
    per-chip terms."""
    n_units_full = cfg.n_layers // scan_unit(cfg)
    t0 = time.time()
    r1 = probe_terms(cfg, shape, 1, mesh)
    r2 = probe_terms(cfg, shape, 2, mesh)
    per_unit = {k: r2[k] - r1[k] for k in ("flops", "bytes", "coll")}
    base = {k: r1[k] - per_unit[k] for k in per_unit}
    total = {k: max(0.0, base[k]) + n_units_full * max(0.0, per_unit[k])
             for k in per_unit}

    compute_s = total["flops"] / PEAK_FLOPS
    memory_s = total["bytes"] / HBM_BW
    collective_s = total["coll"] / COLLECTIVE_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bound = max(terms, key=terms.get).replace("_s", "")

    model_flops_per_chip = model_flops(cfg, shape) / mesh.size()
    hlo_flops = total["flops"]
    ratio = model_flops_per_chip / hlo_flops if hlo_flops else float("nan")
    return {
        "arch": cfg.name, "kind": shape.kind,
        "n_units": n_units_full,
        "per_unit": per_unit, "base": base, "total": total,
        "coll_by_op_probe_1": r1["coll_by_op"],
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "bound": bound,
        "roofline_total_s": max(compute_s, memory_s, collective_s),
        "model_flops_per_chip": model_flops_per_chip,
        "hlo_flops_per_chip": hlo_flops,
        "useful_flops_ratio": ratio,
        "probe_wall_s": round(time.time() - t0, 1),
        "ok": True,
    }


def analyze_cell(arch: str, shape_name: str) -> dict:
    cfg = get_config(arch)
    with fake_world(256):
        out = analyze(cfg, SHAPES[shape_name],
                      make_production_mesh(device="cpu"))
    return dict(out, shape=shape_name)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out-dir", type=Path, default=RESULT_DIR)
    args = ap.parse_args(argv)
    args.out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = [(arch, shp.name) for arch in ARCH_NAMES
                 for shp in shapes_for(get_config(arch))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shp in cells:
        fname = args.out_dir / f"{arch}__{shp}.json"
        if args.skip_existing and fname.exists() and \
                json.loads(fname.read_text()).get("ok"):
            print(f"[skip] {arch} × {shp}", flush=True)
            continue
        try:
            r = analyze_cell(arch, shp)
            fname.write_text(json.dumps(r, indent=2))
            print(f"[OK] {arch} × {shp}: bound={r['bound']} "
                  f"compute={r['compute_s']*1e3:.2f}ms "
                  f"mem={r['memory_s']*1e3:.2f}ms "
                  f"coll={r['collective_s']*1e3:.2f}ms "
                  f"ratio={r['useful_flops_ratio']:.2f} "
                  f"[{r['probe_wall_s']}s]", flush=True)
        except Exception as e:      # recorded for triage; the run goes on
            failures += 1
            fname.write_text(json.dumps(
                {"arch": arch, "shape": shp, "ok": False, "error": repr(e),
                 "traceback": traceback.format_exc()[-3000:]}, indent=2))
            print(f"[FAIL] {arch} × {shp}: {e!r}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
