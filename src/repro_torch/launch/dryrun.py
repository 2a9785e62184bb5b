"""Multi-pod dry run: trace every (architecture × input-shape × mesh) cell
at full width on a fake process group of 256 or 512 ranks, and record per
chip what it holds, computes and communicates. The reference's
``launch/dryrun.py`` (512 placeholder host devices, ``lower().compile()``)
on torch: no card and no memory needed.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

A cell runs the port's own step (``launch.steps``: ``train_step_``, the
train step with its update in place as the driver's compiled step makes
it, with the reference's microbatch count, ``prefill_step`` or
``serve_step``) once
as rank 0 of a ``"fake"`` process group (``FakeStore``: every collective
returns at once), its params, optimizer state, batch and caches
``DTensor``s placed by ``distributed.sharding``'s rules over local shards
on the ``meta`` device (shapes and dtypes, no storage). ``TraceCounter``
sees each op rank 0 runs on its local shards: the FLOPs of the matrix
products (``torch.utils.flop_counter``'s formulas, per chip: counted
below DTensor, which would report the whole product), the bytes every
op that makes a new tensor reads and writes, the operand bytes of each
collective under the reference's five names, and the peak of the bytes
it holds live (the reference's ``temp_size_in_bytes``: what the step
makes, its arguments aside; with the functional update the peak was the
new tree's, set after every activation was freed, whatever the sequence
length). The fake group is started inside ``run_cell`` and torn
down after it; it refuses to start next to a real default group. Results
go to ``experiments/dryrun_torch/`` (gitignored), one JSON per cell with
the reference's keys: ``compile_s`` holds the trace's seconds (there is
no separate lowering: ``lower_s`` is 0), ``output_size_in_bytes`` is not
counted. A train cell of more than three microbatches is counted from
two probes of 2 and 3 of its microbatches (``trace_step``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.api import activation_policy, policy_from_mesh
from repro_torch.distributed.sharding import (batch_shardings,
                                              cache_shardings, data_axes,
                                              mesh_axes, params_shardings)
from repro_torch.hw import HBM_BYTES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (input_specs, make_opt_config,
                                      model_shapes, opt_shapes, prefill_step,
                                      serve_step, train_step_)
from repro_torch.models.scan_util import tree_leaves, tree_unflatten

RESULT_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

# A decode cell keeps its bf16 weights resident (model-axis TP only, no
# per-step FSDP gathers) when they fit 7/8 of the H100's 80 GB at TP 16:
# the reference's 14 GB of a 16 GB chip, scaled to this card.
RESIDENT_WEIGHT_BYTES = HBM_BYTES * 7 / 8

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# torch's functional collectives (what DTensor's redistributions run) by
# the reference's HLO names. The fake group has no all-to-all: DTensor
# runs a shard-to-shard move there as an all-gather and a chunk.
_FUNCOL = {"all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_coalesced": "all-gather",
           "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
           "reduce_scatter_tensor": "reduce-scatter",
           "reduce_scatter_tensor_coalesced": "reduce-scatter",
           "all_to_all_single": "all-to-all",
           "permute_tensor": "collective-permute"}
_NO_TRAFFIC = ("empty", "lift_fresh")


def _tensors(tree) -> list:
    """The tensors in an op's arguments or outputs (tensors, and lists,
    tuples and dicts of them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TraceCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts what one rank runs on its local tensors. An op on
    ``DTensor``s is passed on (``NotImplemented``) to DTensor, whose
    local ops and collectives then come back here one by one. The local
    shards are ``meta`` tensors, and so are the global-shape tensors
    DTensor's sharding propagation runs ops on: only ops that read a
    tensor of the program (``track``ed, or made by a counted op) are
    counted. So a tensor made from nothing (``zeros``, ``arange``) counts
    from the first op that combines it with the program's: positions and
    masks are left out, and a buffer's bytes count once it is written.
    A storage's bytes are live from the op that made it until the last
    tensor on it dies (autograd's saved tensors and views included);
    ``coll_log`` lists each collective with its operands' local
    shapes."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = {c: 0 for c in COLLECTIVES}
        self.coll_counts = {c: 0 for c in COLLECTIVES}
        self.coll_log: list = []     # (op, operand shapes), in order
        self.live = 0
        self.peak = 0
        self._ours: Dict[int, weakref.ref] = {}

    def track(self, tree) -> None:
        """Take the local shards of ``tree``'s ``DTensor``s (and its plain
        tensors) as the program's."""
        for t in tree_leaves(tree):
            self._own(getattr(t, "_local_tensor", t))

    def _own(self, t: torch.Tensor) -> None:
        key = id(t)
        self._ours[key] = weakref.ref(t, lambda _, k=key: self._ours.pop(k,
                                                                         None))

    def _is_ours(self, t: torch.Tensor) -> bool:
        ref = self._ours.get(id(t))
        return ref is not None and ref() is t

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(t, DTensor) for t in ins):
            return NotImplemented
        out = func(*args, **kwargs)
        if not any(self._is_ours(t) for t in ins):
            return out
        for t in _tensors(out):
            self._own(t)
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            op = _FUNCOL.get(name)
            if op is not None:
                self.coll[op] += sum(_nbytes(t) for t in ins)
                self.coll_counts[op] += 1
                self.coll_log.append((op, tuple(tuple(t.shape)
                                                for t in ins)))
            return out
        flop = flop_registry.get(func._overloadpacket)
        if flop is not None:
            self.flops += flop(*args, **kwargs, out_val=out)
        # New storages only: a view (chunk, split, detach, ...) aliases an
        # input's storage and moves and holds nothing.
        seen = {t.untyped_storage()._cdata for t in ins}
        outs = []
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                outs.append((t, st))
        if outs and not name.startswith(_NO_TRAFFIC):
            self.bytes += sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t, _ in outs)
        for t, st in outs:
            n = st.nbytes()
            weakref.finalize(st, self._free, n)
            self.live += n
        self.peak = max(self.peak, self.live)
        return out


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``"fake"`` default process group of ``world_size`` ranks (this
    process is rank 0) for the duration; refuses to start next to a
    default group that exists already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "a default process group exists already; the dry run starts "
            "its own fake group and runs in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(shape, pl, mesh) -> tuple:
    from torch.distributed.tensor import Shard
    out = list(shape)
    for p, n in zip(pl, mesh_axes(mesh).values()):
        if isinstance(p, Shard):
            out[p.dim] //= n
    return tuple(out)


def place_fake(tree, shardings, mesh):
    """``tree``'s leaves (``meta`` tensors) as ``DTensor``s of fake local
    shards on ``mesh``, with no collective."""
    from torch.distributed.tensor import DTensor
    leaves = []
    for t, sh in zip(tree_leaves(tree), tree_leaves(shardings)):
        pl = sh.placements
        local = torch.empty(_local_shape(t.shape, pl, mesh), dtype=t.dtype,
                            device="meta")
        leaves.append(DTensor.from_local(local, mesh, pl, run_check=False))
    return tree_unflatten(tree, leaves)


def sharded_bytes(sds_tree, sh_tree, mesh) -> int:
    """Per-device bytes of ``sds_tree`` under ``sh_tree``: the
    reference's arithmetic (each sharded dim rounded up over its axes)."""
    sizes = mesh_axes(mesh)
    total = 0
    for sds, sh in zip(tree_leaves(sds_tree), tree_leaves(sh_tree)):
        elems = 1
        spec = sh.spec
        for i, dim in enumerate(sds.shape):
            ax = spec[i] if i < len(spec) else None
            if ax is None:
                elems *= dim
            else:
                n = 1
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    n *= sizes[a]
                elems *= -(-dim // n)
        total += elems * sds.element_size()
    return total


def is_resident(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """Decode keeps bf16 weights resident when they fit the H100 budget
    at TP 16 (``RESIDENT_WEIGHT_BYTES``)."""
    return (shape.kind == "decode"
            and cfg.param_count() * 2 / 16 <= RESIDENT_WEIGHT_BYTES)


@dataclasses.dataclass
class Counts:
    """What one traced step counts on one rank (``TraceCounter``'s
    totals)."""
    flops: float
    bytes: float
    coll: Dict[str, float]
    coll_counts: Dict[str, float]
    peak: int

    @classmethod
    def of(cls, c: TraceCounter) -> "Counts":
        return cls(float(c.flops), float(c.bytes), dict(c.coll),
                   dict(c.coll_counts), c.peak)


def _trace(cfg: ModelConfig, shape: ShapeSpec, mesh, p_sh,
           microbatches: int) -> Counts:
    """One step of ``cfg`` at ``shape`` on fake local shards, counted."""
    params_sds = model_shapes(cfg)
    specs = input_specs(cfg, shape)
    params = place_fake(params_sds, p_sh, mesh)
    if shape.kind == "train":
        opt_sds = opt_shapes(cfg, params_sds)
        args = (params, place_fake(opt_sds, params_shardings(opt_sds, mesh),
                                   mesh),
                place_fake(specs, batch_shardings(specs, mesh), mesh))
    elif shape.kind == "prefill":
        args = (params, place_fake(specs, batch_shardings(specs, mesh),
                                   mesh))
    else:
        tok_sh = batch_shardings({"tokens": specs["tokens"]},
                                 mesh)["tokens"]
        args = (params, place_fake(specs["tokens"], tok_sh, mesh),
                place_fake(specs["cache"],
                           cache_shardings(specs["cache"], mesh), mesh),
                torch.zeros((), dtype=torch.long, device="meta"))
    counter = TraceCounter()
    counter.track(args)
    with counter, activation_policy(policy_from_mesh(
            mesh, seq_parallel=shape.kind != "decode")):
        if shape.kind == "train":
            train_step_(*args, cfg=cfg, opt_cfg=make_opt_config(cfg),
                        microbatches=microbatches)
        elif shape.kind == "prefill":
            prefill_step(*args, cfg=cfg)
        else:
            serve_step(*args, cfg=cfg)
    return Counts.of(counter)


def trace_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
               microbatches: Optional[int] = None) -> Dict[str, Any]:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` (a fake group's
    ``DeviceMesh``). ``microbatches`` (train only) defaults to the
    reference's ``max(1, min(16, B // n_data))``. More than three
    microbatches are counted from two probes, of 2 and 3 microbatches of
    the cell's size: the step repeats one microbatch's ops exactly, so
    every count is ``c(2) + (M - 2) (c(3) - c(2))``, and the peak (the
    accumulators and one microbatch live) is the probes'. Returns the
    counts, the per-chip argument and parameter bytes from the specs,
    and the trace's seconds."""
    t0 = time.time()
    params_sds = model_shapes(cfg)
    p_sh = params_shardings(params_sds, mesh,
                            fsdp=not is_resident(cfg, shape))
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        n_data = 1
        for a in data_axes(mesh):
            n_data *= mesh_axes(mesh)[a]
        micro = microbatches or max(1, min(16, shape.global_batch // n_data))
        opt_sds = opt_shapes(cfg, params_sds)
        arg_sh = (p_sh, params_shardings(opt_sds, mesh),
                  batch_shardings(specs, mesh))
        args = (params_sds, opt_sds, specs)
    elif shape.kind == "prefill":
        micro = None
        arg_sh, args = (p_sh, batch_shardings(specs, mesh)), \
            (params_sds, specs)
    else:
        micro = None
        arg_sh = (p_sh, batch_shardings({"tokens": specs["tokens"]},
                                        mesh)["tokens"],
                  cache_shardings(specs["cache"], mesh))
        args = (params_sds, specs["tokens"], specs["cache"])
    if micro is not None and micro > 3:
        rows = shape.global_batch // micro
        c2, c3 = (_trace(cfg, dataclasses.replace(shape,
                                                  global_batch=k * rows),
                         mesh, p_sh, k) for k in (2, 3))

        def ext(a, b):
            return a + (micro - 2) * (b - a)
        counts = Counts(ext(c2.flops, c3.flops), ext(c2.bytes, c3.bytes),
                        {k: ext(c2.coll[k], c3.coll[k]) for k in c2.coll},
                        {k: ext(c2.coll_counts[k], c3.coll_counts[k])
                         for k in c2.coll_counts}, max(c2.peak, c3.peak))
        traced = [2, 3]
    else:
        counts = _trace(cfg, shape, mesh, p_sh, micro or 1)
        traced = [micro] if micro else None
    return {"counts": counts, "trace_s": time.time() - t0,
            "argument_bytes": sharded_bytes(args, arg_sh, mesh),
            "param_bytes": sharded_bytes(params_sds, p_sh, mesh),
            "microbatches": micro, "microbatches_traced": traced}


def mesh_name(multi_pod: bool) -> str:
    return "multipod_2x16x16" if multi_pod else "pod_16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path = RESULT_DIR, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        tr = trace_step(cfg, shape, mesh)
        n_dev = mesh.size()
    c = tr["counts"]
    coll_total = sum(c.coll.values())
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
        "kind": shape.kind, "n_devices": n_dev,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "lower_s": 0.0, "compile_s": round(tr["trace_s"], 2),
        "flops_total": c.flops,
        "bytes_accessed_total": c.bytes,
        "cost_analysis_keys": ["bytes accessed", "flops"],
        "memory_analysis": {
            "argument_size_in_bytes": tr["argument_bytes"],
            "output_size_in_bytes": None,
            "temp_size_in_bytes": c.peak,
            "generated_code_size_in_bytes": None},
        "collective_bytes_total": coll_total,
        "collective_bytes_by_op": c.coll,
        "collective_op_counts": c.coll_counts,
        "param_bytes_per_device": tr["param_bytes"],
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "resident_weights": is_resident(cfg, shape),
        "microbatches": tr["microbatches"],
        "microbatches_traced": tr["microbatches_traced"],
        "ok": True,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = out_dir / f"{arch}__{shape_name}__{mesh_name(multi_pod)}.json"
    fname.write_text(json.dumps(result, indent=2))
    if verbose:
        print(f"[OK] {arch} × {shape_name} × {mesh_name(multi_pod)}: "
              f"trace {tr['trace_s']:.1f}s flops/chip={c.flops:.4g} "
              f"params/chip={tr['param_bytes'] / 1e9:.3f}GB of "
              f"{HBM_BYTES / 1e9:.0f}GB temp={c.peak / 1e9:.3f}GB "
              f"coll={coll_total / 1e9:.3f}GB "
              f"{ {k: v for k, v in c.coll.items() if v} }", flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out-dir", type=Path, default=RESULT_DIR)
    args = ap.parse_args(argv)

    meshes = ((False, True) if args.mesh == "both"
              else ((args.mesh == "multipod"),))
    if args.all:
        cells = [(arch, shp.name, mp) for arch in ARCH_NAMES
                 for shp in shapes_for(get_config(arch)) for mp in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, mp) for mp in meshes]

    failures = 0
    for arch, shp, mp in cells:
        fname = args.out_dir / f"{arch}__{shp}__{mesh_name(mp)}.json"
        if args.skip_existing and fname.exists() and \
                json.loads(fname.read_text()).get("ok"):
            print(f"[skip] {arch} × {shp} × {mesh_name(mp)}", flush=True)
            continue
        try:
            run_cell(arch, shp, mp, args.out_dir)
        except Exception as e:      # recorded for triage; the run goes on
            failures += 1
            args.out_dir.mkdir(parents=True, exist_ok=True)
            fname.write_text(json.dumps({
                "arch": arch, "shape": shp, "mesh": mesh_name(mp),
                "ok": False, "error": repr(e),
                "traceback": traceback.format_exc()[-4000:]}, indent=2))
            print(f"[FAIL] {arch} × {shp} × {mesh_name(mp)}: {e!r}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
