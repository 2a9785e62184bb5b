"""End-to-end training driver: the reference's ``launch/train.py``.

  python -m repro_torch.launch.train --arch h2o-danube-1.8b --steps 20 \
      --batch 8 --seq 128 --microbatches 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \
      --reduced --steps 50 --batch 8 --seq 128 --device cpu

Random weights from seed 0, the deterministic data pipeline, the train
step, checkpoints every ``--ckpt-every`` steps through
``CheckpointManager`` (``--resume`` restores the latest) and the
bounded-retry supervisor ``run_with_retries``, which restores and replays
after a failed step. Every step is ``compile_train_step``'s, as the
reference always jits it (on a mesh with the params' and optimizer
state's shardings): it owns the params and optimizer state, on a card
runs its first two steps eagerly, captures the third as one CUDA graph
(on a mesh with its collectives) and replays it from then on; a capture
that fails raises. Checkpoints read its buffers (the device→host copy is
taken before ``save`` returns, so the next replay cannot change what is
written) and restores, ``--resume`` included, are read into them
leaf by leaf from the host (``restore(..., device="cpu")`` maps the
files; ``load_state`` copies each leaf, on a mesh each rank's shard of
it), so the state never exists twice on the card. As in the reference,
the supervisor counts data steps from 0 on every run, resumed or not,
while the learning-rate schedule goes on from the restored optimizer
step. ``--mesh none`` (the
default) is one device with no process group and plain tensors; the
reference's meshes are ``smoke`` (one rank, a world-1 group started
here), ``pod`` (16×16) and ``multipod`` (2×16×16), the last two over
the process group torchrun starts (a group of another size raises
``ValueError``): params and optimizer state placed by
``params_shardings``, the batch drawn per rank (``make_batch(mesh=)``),
a resume restored into the step's own shards,
and the step made under ``activation_policy(policy_from_mesh(mesh))``.
Each logged line carries the card's name and power limit on a CUDA
device; on a mesh only rank 0 logs.
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.distributed.api import activation_policy, policy_from_mesh
from repro_torch.distributed.fault import run_with_retries
from repro_torch.distributed.sharding import distribute, params_shardings
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
from repro_torch.launch.serve import card_text
from repro_torch.launch.steps import compile_train_step, make_opt_config
from repro_torch.models.model import init_model
from repro_torch.models.scan_util import tree_leaves, tree_unflatten
from repro_torch.optim.adamw import init_opt_state


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", choices=["none", "smoke", "pod", "multipod"],
                    default="none")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = _mesh(args.mesh, dev)
    if dev.type == "cuda" and mesh is not None:
        dev = torch.device("cuda", torch.cuda.current_device())
    log = print if mesh is None or torch.distributed.get_rank() == 0 \
        else (lambda *a, **k: None)
    card = card_text(dev)
    cfg = get_config(args.arch, reduced=args.reduced)
    opt_cfg = make_opt_config(cfg, total_steps=args.steps)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq)

    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt_state = init_opt_state(params, opt_cfg)
    if mesh is not None:
        params, opt_state = distribute(
            (params, opt_state), (params_shardings(params, mesh),
                                  params_shardings(opt_state, mesh)))
    policy = policy_from_mesh(mesh) if mesh is not None else None
    with activation_policy(policy):
        compiled = compile_train_step(
            params, opt_state, make_batch(dcfg, cfg, 0, mesh=mesh,
                                          device=dev),
            cfg=cfg, opt_cfg=opt_cfg, microbatches=args.microbatches)
    del params, opt_state

    def current():
        """The (params, OptState) the next step starts from."""
        return compiled.params, compiled.opt_state

    mgr = CheckpointManager(Path(args.ckpt_dir) / cfg.name)

    def restore_latest() -> dict:
        # To the host, mapped from the files: each rank reads only its
        # shards, straight into the step's own buffers.
        tree, extra = mgr.restore(tree_unflatten(current(), [
            torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in tree_leaves(current())]), device="cpu")
        compiled.load_state(*tree)
        return extra

    start_step = 0
    if args.resume and mgr.latest_step() is not None:
        start_step = int(restore_latest().get("step", mgr.latest_step()))
        log(f"resumed from step {start_step}")

    def one_step(step: int) -> None:
        batch = make_batch(dcfg, cfg, step, mesh=mesh, device=dev)
        t0 = time.time()
        metrics = compiled(batch)
        if step % args.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            log(f"step {step:5d}  loss {loss:8.4f}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"dt {time.time() - t0:6.2f}s  on {card}", flush=True)

    def save(step: int) -> None:
        mgr.save(step, current(), extra={"step": step})

    def restore() -> int:
        return int(restore_latest()["step"])

    stats = run_with_retries(one_step, save, restore,
                             n_steps=args.steps,
                             checkpoint_every=args.ckpt_every)
    mgr.wait()
    log(f"done: {stats}")
    return 0


def _mesh(name: str, dev: torch.device):
    """The ``--mesh`` named: None, the smoke mesh, or a production mesh
    over the default process group (started from torchrun's environment
    when it is not up yet)."""
    if name == "none":
        return None
    if name == "smoke":
        return make_smoke_mesh(dev)
    import torch.distributed as dist
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return make_production_mesh(multi_pod=name == "multipod", device=dev)


if __name__ == "__main__":
    raise SystemExit(main())
