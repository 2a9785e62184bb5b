"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060; unverified].
Attention-free ⇒ runs long_500k with O(1) decode state."""
from repro_torch.configs.base import BlockType, ModelConfig, SSMConfig, register

FULL = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab=50280, tie_embeddings=True,
    block_type=BlockType.MAMBA,
    ssm=SSMConfig(state_dim=128, head_dim=64, conv_width=4, expand=2),
)

REDUCED = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=256, tie_embeddings=True,
    block_type=BlockType.MAMBA,
    ssm=SSMConfig(state_dim=16, head_dim=16, conv_width=4, expand=2,
                  chunk=32),
)

register(FULL, REDUCED)
