"""Serving steps on one card: prefill and one-token decode (counterpart of
:mod:`repro.launch.serve`).

The JAX module builds them under ``pjit`` with a mesh, parameter and state
shardings and a context-parallel decode; the port runs on one card, so
there is no mesh, and the ``shape`` / ``sharding`` entries of the JAX
return value have no counterpart.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import decode_step, forward, init_decode_state
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_supported


def make_serve_fns(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """``{"prefill", "decode", "init_state"}`` for ``batch`` sequences of
    up to ``max_len`` tokens on ``device`` (``None`` means the card).

    * ``prefill(params, tokens, extra_embeds=None, frames=None)`` -- the
      full-sequence forward (the flash-attention / WKV6 kernels on the
      card), last position's logits (B, 1, V); a VLM's patch embeddings
      go in ``extra_embeds``, an encoder arch's frame embeddings in
      ``frames``;
    * ``decode(params, state, token, cur_len)`` -- one decode step,
      ``(logits (B, 1, V), state)``, the state updated in place;
    * ``init_state()`` -- a zeroed decode state on the device, with room
      for ``cfg.frontend_len`` encoder positions of cross keys and values
      for an encoder arch (the JAX function's ``enc_len``).
    """
    check_supported(cfg)
    dev = resolve_device(device)
    enc_len = cfg.frontend_len if cfg.has_encoder else 0

    def prefill_fn(params, tokens, extra_embeds=None, frames=None):
        with torch.inference_mode():
            logits, _ = forward(params, cfg, tokens, extra_embeds=extra_embeds,
                                frames=frames)
        return logits[:, -1:]

    def decode_fn(params, state, token, cur_len):
        return decode_step(params, cfg, state, token, cur_len)

    def init_state():
        return init_decode_state(cfg, batch, max_len, enc_len, device=dev)

    return {"prefill": prefill_fn, "decode": decode_fn, "init_state": init_state}
