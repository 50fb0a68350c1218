"""Model definitions of the port (counterpart of :mod:`repro.models`): the
dense-GQA (with qk-norm, QKV-bias and half-RoPE variants), MLA, MoE (with
shared experts), Mamba and RWKV6 blocks, the encoder and cross-attention of an
encoder-decoder arch and a VLM's prefix embeddings, as plain functions
over dicts of tensors, with prefill attention and the RWKV6 recurrence on
hand-written Hopper kernels; the decode KV cache in the compute dtype or
int8.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    active_param_count,
    active_param_count_shapes,
    cross_state,
    decode_step,
    encode,
    forward,
    init_decode_state,
    init_model,
    model_flops,
    param_count,
    prefill,
    prefill_stepwise,
)

__all__ = [
    "ModelConfig",
    "active_param_count",
    "active_param_count_shapes",
    "cross_state",
    "decode_step",
    "encode",
    "forward",
    "init_decode_state",
    "init_model",
    "model_flops",
    "param_count",
    "prefill",
    "prefill_stepwise",
]
