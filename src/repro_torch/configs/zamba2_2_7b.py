"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 blocks + ONE shared attention block
applied every 6 mamba layers [arXiv:2411.15242; hf]. Sub-quadratic ⇒ runs
long_500k."""
from repro_torch.configs.base import BlockType, ModelConfig, SSMConfig, register

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    block_type=BlockType.MAMBA, attn_every=6, shared_attn=True,
    ssm=SSMConfig(state_dim=64, head_dim=64, conv_width=4, expand=2),
)

REDUCED = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    block_type=BlockType.MAMBA, attn_every=2, shared_attn=True,
    ssm=SSMConfig(state_dim=16, head_dim=16, conv_width=4, expand=2,
                  chunk=32),
)

register(FULL, REDUCED)
