"""Model definitions of the port (counterpart of :mod:`repro.models`): the
dense-GQA (with qk-norm, QKV-bias and half-RoPE variants), MLA, MoE (with
shared experts) and RWKV6 blocks as plain functions over dicts of tensors,
with prefill attention and the RWKV6 recurrence on hand-written Hopper
kernels.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    active_param_count,
    active_param_count_shapes,
    decode_step,
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
    "decode_step",
    "forward",
    "init_decode_state",
    "init_model",
    "model_flops",
    "param_count",
    "prefill",
    "prefill_stepwise",
]
