"""Model configuration covering every architecture family in the pool
(a copy of :mod:`repro.models.config`; the port runs every block kind)."""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # ---- block layout: pattern repeated to fill num_layers. Entries:
    # "attn" (self-attention + MLP), "mamba" (SSM + MLP), "rwkv"
    # (time-mix + channel-mix). MoE replaces the MLP on layers where
    # (layer_index % moe_every == moe_offset) when n_experts > 0.
    block_pattern: tuple = ("attn",)

    # ---- attention variant
    attn_type: str = "gqa"  # gqa | mla
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_mode: str = "full"  # full | half (2d rope on half the dims)
    rope_theta: float = 10000.0

    # ---- MLA (multi-head latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # ---- MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1
    moe_offset: int = 0

    # ---- SSM / RWKV
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_dim: int = 64

    # ---- encoder-decoder (audio) / frontends
    encoder_layers: int = 0
    frontend: str = "none"  # none | vision_stub | audio_stub
    frontend_len: int = 0  # patch/frame embeddings prepended/cross-attended

    # ---- misc
    tie_embeddings: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp_act: str = "swiglu"  # swiglu | gelu

    # ---- numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # decode KV cache storage: "bfloat16" or "int8" (per-token-head
    # symmetric quantization; halves the decode bandwidth term)
    kv_cache_dtype: str = "bfloat16"

    # whether full attention is required (no sub-quadratic path) — decides
    # the long_500k skip (pure full-attention archs)
    @property
    def subquadratic(self) -> bool:
        return any(b in ("mamba", "rwkv") for b in self.block_pattern)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def group_size(self) -> int:
        return len(self.block_pattern)

    @property
    def num_groups(self) -> int:
        if self.num_layers % self.group_size:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"block pattern length {self.group_size}"
            )
        return self.num_layers // self.group_size

    @property
    def has_encoder(self) -> bool:
        return self.encoder_layers > 0

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced copy for smoke tests (same family, tiny dims)."""
        small = dict(
            num_layers=max(self.group_size, 2 * self.group_size),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) or 2,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_nope_dim=8 if self.qk_nope_dim else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_d_ff=32 if self.moe_d_ff else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_len=8 if self.frontend_len else 0,
            rwkv_head_dim=16,
            mamba_d_state=4,
            name=self.name + "-smoke",
        )
        small.update(overrides)
        # keep GQA ratio valid
        if small["num_kv_heads"] > small["num_heads"]:
            small["num_kv_heads"] = small["num_heads"]
        return replace(self, **small)
