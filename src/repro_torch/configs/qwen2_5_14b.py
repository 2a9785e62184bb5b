"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA with QKV bias [hf:Qwen/Qwen2.5; hf]."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064,
    qkv_bias=True, rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    qkv_bias=True,
)

register(FULL, REDUCED)
