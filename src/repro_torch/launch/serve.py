"""LM serving driver: batched requests through the continuous-batching
engine, with random weights from a seed.

  python -m repro_torch.launch.serve --arch h2o-danube-1.8b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \
      --reduced --device cpu

It prints each request's tokens, then the tokens per second, beside the
card's name and power limit on a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import init_model
from repro_torch.serving.engine import Request, ServingEngine


def card_text(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card (the reading
    every time is written beside), or the CPU."""
    if device.type != "cuda":
        return "device cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[torch.cuda.current_device()]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    engine = ServingEngine(cfg, params, batch_size=args.batch,
                           max_len=args.max_len, device=dev)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              size=args.prompt_len).astype(np.int32)
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=args.max_new))
    out = engine.run_until_done()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(v) for v in out.values())
    for rid in sorted(out):
        print(f"request {rid}: {out[rid]}")
    print(f"{args.requests} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s, batch={args.batch}) on "
          f"{card_text(dev)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
