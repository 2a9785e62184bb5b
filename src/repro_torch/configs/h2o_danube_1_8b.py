"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf]. SWA ⇒ runs the long_500k cell."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000,
    sliding_window=4096,
)

REDUCED = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    sliding_window=64,
)

register(FULL, REDUCED)
