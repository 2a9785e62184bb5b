"""Model / shape configuration schema and the architecture registry.

Every assigned architecture is a ``ModelConfig`` built from the exact table
in the assignment; ``reduced()`` derives the CPU-runnable smoke config with
identical topology.

The PyTorch port's copy of the reference's schema: the same tables, with
no JAX import (the reference imports ``jax`` here and uses none of it).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple


class BlockType(enum.Enum):
    ATTN = "attn"          # attention + MLP block
    MAMBA = "mamba"        # Mamba2 / SSD block
    MOE = "moe"            # attention + MoE block
    SHARED_ATTN = "shared_attn"  # Zamba-style shared attention block


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = full-rank Q projection
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD."""
    state_dim: int = 128
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 256
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0               # 0 → d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0       # 0 = full attention
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    moe_every: int = 1            # 2 = alternate dense/MoE (Llama-4 style)
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # Hybrid stacking: attn block every `attn_every` blocks (Zamba-like);
    # 0 = homogeneous stack of `block_type`.
    block_type: BlockType = BlockType.ATTN
    attn_every: int = 0
    shared_attn: bool = False     # Zamba: ONE attention param set, reused
    # Modality frontend stub: number of prefix embedding tokens & their dim.
    frontend: str = "none"        # none | vision | audio
    frontend_tokens: int = 0
    frontend_dim: int = 0
    # Parallel residual (attention and MLP from same input) — Command-R.
    parallel_block: bool = False
    dtype: str = "bfloat16"
    # Optimizer-state dtype (fp32 default; bf16 for the 400B-class configs
    # so single-pod training fits 16 GB/chip — see EXPERIMENTS.md).
    opt_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.block_type is BlockType.MAMBA and self.attn_every == 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token decode shape?"""
        return (self.block_type is BlockType.MAMBA or self.sliding_window > 0)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        n_attn, n_mamba = self._block_counts()
        hd = self.head_dim
        if self.mla is not None:
            m = self.mla
            q_in = m.q_lora_rank or d
            attn_p = (d * (m.kv_lora_rank + m.qk_rope_dim)
                      + (d * m.q_lora_rank if m.q_lora_rank else 0)
                      + q_in * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                      + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_dim)
                      + self.n_heads * m.v_dim * d)
        else:
            attn_p = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                      + self.n_heads * hd * d)
        if self.moe is not None:
            mo = self.moe
            moe_p = (mo.n_experts * 3 * d * mo.d_ff_expert
                     + mo.n_shared * 3 * d * (mo.d_ff_shared or mo.d_ff_expert)
                     + d * mo.n_experts)
            n_moe = n_attn // self.moe_every
            n_dense = n_attn - n_moe
            ffn_total = n_moe * moe_p + n_dense * 3 * d * self.d_ff
        else:
            ffn_total = n_attn * 3 * d * self.d_ff
        total += n_attn * attn_p + ffn_total
        if self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            mamba_p = (d * (2 * d_in + 2 * s.state_dim + nh)
                       + d_in * d + s.conv_width * (d_in + 2 * s.state_dim)
                       + 2 * nh)
            total += n_mamba * mamba_p
        return int(total)

    def active_param_count(self) -> int:
        """Active (per-token) params for MoE — 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        d = self.d_model
        n_attn, _ = self._block_counts()
        n_moe = n_attn // self.moe_every
        dead = (mo.n_experts - mo.top_k) * 3 * d * mo.d_ff_expert * n_moe
        return int(self.param_count() - dead)

    def _block_counts(self) -> Tuple[int, int]:
        """(#attention-bearing blocks, #mamba blocks)."""
        if self.block_type is BlockType.MAMBA:
            if self.attn_every:
                n_attn = self.n_layers // self.attn_every
                return n_attn, self.n_layers - n_attn
            return 0, self.n_layers
        return self.n_layers, 0


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str       # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")
ALL_SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]
SHAPES = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ModelConfig) -> List[ShapeSpec]:
    """The assigned 4 shapes, with long_500k only for sub-quadratic archs
    (skip recorded in DESIGN.md §Arch-applicability)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return out


# ---------------------------------------------------------------------------
# Registry (populated by repro.configs package import).
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, "ArchEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    full: ModelConfig
    reduced: ModelConfig


def register(full: ModelConfig, reduced: ModelConfig) -> ModelConfig:
    REGISTRY[full.name] = ArchEntry(full=full, reduced=reduced)
    return full


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401 — populate registry
    e = REGISTRY[name]
    return e.reduced if reduced else e.full
