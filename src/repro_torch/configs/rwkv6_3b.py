"""RWKV6-3B (Finch) [ssm]: attention-free, data-dependent decay.
[arXiv:2404.05892]

KV-cache tiering does not apply to it (an O(d^2) constant decode state, no
cold tail); it is served without the technique.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", num_layers=32, d_model=2560,
    num_heads=40, num_kv_heads=40, head_dim=64, d_ff=8960,
    vocab_size=65536, block_pattern=("rwkv",), rwkv_head_dim=64,
    norm="layernorm",
)
