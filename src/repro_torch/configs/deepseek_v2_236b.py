"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536(expert)
vocab=102400 — MLA kv_lora=512, 2 shared + 160 routed experts top-6
[arXiv:2405.04434; hf]. bf16 optimizer states for single-pod fit."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, register

FULL = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400, d_head=192,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                  n_shared=2, d_ff_shared=3072),
    opt_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, d_head=48,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                  qk_nope_dim=32, qk_rope_dim=16, v_dim=32),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64,
                  n_shared=1, d_ff_shared=128),
)

register(FULL, REDUCED)
