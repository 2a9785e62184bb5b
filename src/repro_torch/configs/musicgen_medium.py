"""musicgen-medium [audio]: 48L d_model=1536 24H (GQA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

The EnCodec/conditioning frontend is a STUB per the assignment:
input_specs() provides precomputed frame embeddings for a conditioning
prefix; the decoder operates on EnCodec token codes (vocab 2048).
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048,
    frontend="audio", frontend_tokens=256, frontend_dim=1024,
)

REDUCED = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=128,
    frontend="audio", frontend_tokens=8, frontend_dim=32,
)

register(FULL, REDUCED)
