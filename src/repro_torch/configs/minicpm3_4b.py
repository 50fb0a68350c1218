"""MiniCPM3-4B [dense]: MLA attention (q_lora 768, kv_lora 256).
[hf:openbmb/MiniCPM3-4B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense", num_layers=62, d_model=2560,
    num_heads=40, num_kv_heads=40, head_dim=96, d_ff=6400,
    vocab_size=73448, attn_type="mla",
    q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64, qk_rope_dim=32,
    v_head_dim=64,
)
