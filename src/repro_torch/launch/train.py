"""End-to-end training driver: the reference's ``launch/train.py`` on one
device.

  python -m repro_torch.launch.train --arch h2o-danube-1.8b --steps 20 \
      --batch 8 --seq 128 --microbatches 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \
      --reduced --steps 50 --batch 8 --seq 128 --device cpu

Random weights from seed 0, the deterministic data pipeline, eager
``train_step`` under autograd, checkpoints every ``--ckpt-every`` steps
through ``CheckpointManager`` (``--resume`` restores the latest) and the
bounded-retry supervisor ``run_with_retries``, which restores and replays
after a failed step. As in the reference, the supervisor counts data
steps from 0 on every run, resumed or not, while the learning-rate
schedule goes on from the restored optimizer step. ``--mesh smoke`` (the
default) is one device with no sharding; ``pod`` and ``multipod`` are the
LM mesh's (ROADMAP item C.7) and raise. Each logged line carries the
card's name and power limit on a CUDA device.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.distributed.fault import run_with_retries
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.serve import card_text
from repro_torch.launch.steps import make_opt_config, train_step
from repro_torch.models.model import init_model
from repro_torch.optim.adamw import init_opt_state


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", choices=["smoke", "pod", "multipod"],
                    default="smoke")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "smoke":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the production meshes come with the LM "
            "mesh (ROADMAP item C.7)")
    dev = resolve_device(args.device)
    card = card_text(dev)
    cfg = get_config(args.arch, reduced=args.reduced)
    opt_cfg = make_opt_config(cfg, total_steps=args.steps)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq)

    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt_state = init_opt_state(params, opt_cfg)

    mgr = CheckpointManager(Path(args.ckpt_dir) / cfg.name)
    start_step = 0
    if args.resume and mgr.latest_step() is not None:
        (params, opt_state), extra = mgr.restore((params, opt_state))
        start_step = int(extra.get("step", mgr.latest_step()))
        print(f"resumed from step {start_step}")

    state = {"params": params, "opt": opt_state}
    del params, opt_state

    def one_step(step: int) -> None:
        batch = make_batch(dcfg, cfg, step, device=dev)
        t0 = time.time()
        state["params"], state["opt"], metrics = train_step(
            state["params"], state["opt"], batch, cfg=cfg, opt_cfg=opt_cfg,
            microbatches=args.microbatches)
        if step % args.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            print(f"step {step:5d}  loss {loss:8.4f}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"dt {time.time() - t0:6.2f}s  on {card}", flush=True)

    def save(step: int) -> None:
        mgr.save(step, (state["params"], state["opt"]),
                 extra={"step": step})

    def restore() -> int:
        (state["params"], state["opt"]), extra = mgr.restore(
            (state["params"], state["opt"]))
        return int(extra["step"])

    stats = run_with_retries(one_step, save, restore,
                             n_steps=args.steps,
                             checkpoint_every=args.ckpt_every)
    mgr.wait()
    print(f"done: {stats}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
