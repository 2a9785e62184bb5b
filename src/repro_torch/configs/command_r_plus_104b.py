"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias, parallel block
[hf:CohereForAI/c4ai-command-r-plus; unverified]."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000,
    parallel_block=True, tie_embeddings=True,
    opt_dtype="bfloat16",   # fits 16 GB/chip on one pod (EXPERIMENTS.md)
)

REDUCED = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    parallel_block=True, tie_embeddings=True,
)

register(FULL, REDUCED)
