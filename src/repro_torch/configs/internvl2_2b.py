"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT frontend + InternLM2 decoder [arXiv:2404.16821; hf].
The ViT is a STUB: input_specs() provides precomputed patch embeddings
(1024 tokens × 1024 dims) projected into the decoder."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553,
    frontend="vision", frontend_tokens=1024, frontend_dim=1024,
)

REDUCED = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    frontend="vision", frontend_tokens=8, frontend_dim=32,
)

register(FULL, REDUCED)
