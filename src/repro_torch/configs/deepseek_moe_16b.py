"""DeepSeekMoE-16B [moe]: 2 shared + 64 routed experts, top-6,
fine-grained d_ff=1408. [arXiv:2401.06066]

Deviation noted in DESIGN.md: the real model's layer 0 is dense; here all
28 layers are MoE so the block group stays homogeneous for scan.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", num_layers=28, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=1408,
    vocab_size=102400,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408, moe_every=1,
)
