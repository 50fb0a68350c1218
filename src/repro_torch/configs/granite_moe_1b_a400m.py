"""Granite-3.0-1B-A400M [moe]: 32 experts top-8, d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, head_dim=64, d_ff=512,
    vocab_size=49155,
    n_experts=32, n_shared_experts=0, top_k=8, moe_d_ff=512, moe_every=1,
    tie_embeddings=True,
)
