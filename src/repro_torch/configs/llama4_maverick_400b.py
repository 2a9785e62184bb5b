"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192(expert) vocab=202048, MoE 128 experts top-1 + 1 shared expert
[hf:meta-llama/Llama-4; unverified]. Optimizer states in bf16 so the
single-pod (256-chip) training cell fits 16 GB/chip (see EXPERIMENTS.md).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=16384, vocab=202048,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192,
                  n_shared=1, d_ff_shared=8192),
    moe_every=2,        # alternating dense / MoE layers (Llama-4)
    opt_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    moe=MoEConfig(n_experts=8, top_k=1, d_ff_expert=128,
                  n_shared=1, d_ff_shared=128),
    moe_every=2,
)

register(FULL, REDUCED)
