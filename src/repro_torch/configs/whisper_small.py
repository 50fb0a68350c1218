"""Whisper-small [audio]: enc-dec 12+12 layers; the conv/mel frontend is a
stub -- the caller supplies 1500 precomputed frame embeddings.
[arXiv:2212.04356]

Deviation from Whisper, as in the JAX package's config: positions use RoPE
(the encoder's on top of a learned ``pos_embed``) rather than Whisper's
absolute embeddings alone (same structure and FLOPs; the published
checkpoint is not loaded).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072,
    vocab_size=51865, norm="layernorm", mlp_act="gelu",
    encoder_layers=12, frontend="audio_stub", frontend_len=1500,
)
