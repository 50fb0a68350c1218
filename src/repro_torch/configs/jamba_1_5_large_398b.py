"""Jamba-1.5-Large (398B total) [hybrid]: 72 layers = 9 groups of
[attn, 7×mamba]; MoE 16 experts top-2 on every other layer.
[arXiv:2403.19887]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", num_layers=72,
    d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128, d_ff=24576,
    vocab_size=65536,
    block_pattern=("attn",) + ("mamba",) * 7,
    n_experts=16, n_shared_experts=0, top_k=2, moe_d_ff=24576, moe_every=2,
    moe_offset=1,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)
