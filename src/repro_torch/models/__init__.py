"""Model definitions of the port (counterpart of :mod:`repro.models`): the
dense-GQA and RWKV6 families as plain functions over dicts of tensors, with
prefill attention and the RWKV6 recurrence on hand-written Hopper kernels.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_decode_state,
    init_model,
    param_count,
    prefill,
    prefill_stepwise,
)

__all__ = [
    "ModelConfig",
    "decode_step",
    "forward",
    "init_decode_state",
    "init_model",
    "param_count",
    "prefill",
    "prefill_stepwise",
]
