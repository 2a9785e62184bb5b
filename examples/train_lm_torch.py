"""LM training example on the PyTorch/CUDA port: h2o-danube-1.8b through
the train driver, with checkpointing and restart through the
fault-tolerant supervisor.

The twin of ``examples/train_lm.py``, on ``repro_torch``: the same driver
settings (batch 8, sequence 128, two microbatches, a checkpoint every 50
steps under ``checkpoints/``, a log line every 10), run in-process through
``repro_torch.launch.train.main``.

    python examples/train_lm_torch.py --steps 20             # the card
    python examples/train_lm_torch.py --device cpu --reduced --steps 200

On the card the model is at full width and depth (24 layers, d_model
2560; bf16 params, f32 AdamW moments: ~29 GB before activations).
``--reduced`` takes the CPU-sized config of the same topology, as the
reference example does; ``--resume`` goes on from the latest checkpoint.
"""
import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.launch import train  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", default="200")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(REPO / "checkpoints"))
    args = ap.parse_args(argv)
    return train.main(
        ["--arch", "h2o-danube-1.8b", "--steps", args.steps, "--batch", "8",
         "--seq", "128", "--microbatches", "2", "--ckpt-every", "50",
         "--ckpt-dir", args.ckpt_dir, "--log-every", "10",
         "--device", args.device]
        + (["--reduced"] if args.reduced else [])
        + (["--resume"] if args.resume else []))


if __name__ == "__main__":
    raise SystemExit(main())
