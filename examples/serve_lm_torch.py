"""Batched LM serving example on the PyTorch/CUDA port: continuous
batching through the serving engine with greedy decoding.

The twin of ``examples/serve_lm.py``, on ``repro_torch``: qwen2.5-14b,
6 requests of a 12-token prompt and 8 new tokens on a decode batch of 4,
run in-process through ``repro_torch.launch.serve.main``. On the card
the engine replays its decode step as one CUDA graph.

    python examples/serve_lm_torch.py                        # the card
    python examples/serve_lm_torch.py --device cpu --reduced

On the card the model is at full width and depth (48 layers, d_model
5120, bf16: ~29 GB of weights); ``--reduced`` takes the CPU-sized config
of the same topology, as the reference example does.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import serve  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    return serve.main(
        ["--arch", "qwen2.5-14b", "--requests", "6", "--batch", "4",
         "--prompt-len", "12", "--max-new", "8", "--device", args.device]
        + (["--reduced"] if args.reduced else []))


if __name__ == "__main__":
    raise SystemExit(main())
