"""ChatGLM3-6B [dense]: GQA kv=2, 2d RoPE (half dims), QKV bias.
[arXiv:2406.12793]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense", num_layers=28, d_model=4096,
    num_heads=32, num_kv_heads=2, head_dim=128, d_ff=13696,
    vocab_size=65024, rope_mode="half", qkv_bias=True,
)
