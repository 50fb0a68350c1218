"""InternVL2-1B [vlm]: Qwen2-0.5B-class LM backbone; the InternViT
frontend is a stub -- the caller supplies 256 precomputed patch embeddings
prepended to the token sequence. [arXiv:2404.16821]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm", num_layers=24, d_model=896,
    num_heads=14, num_kv_heads=2, head_dim=64, d_ff=4864,
    vocab_size=151655, qkv_bias=True,
    frontend="vision_stub", frontend_len=256, tie_embeddings=True,
)
