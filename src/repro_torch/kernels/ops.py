"""The model's kernel entry points (counterpart of :mod:`repro.kernels.ops`).

Model code calls attention and the RWKV6 recurrence through this module's
attributes, looked up at call time. Dispatch is by device: each kernel
wrapper launches its CUDA kernel for a CUDA tensor and takes its plain
PyTorch version for a CPU tensor. The JAX module's ``try: ... except
Exception:`` fallback to the reference is not carried over: a CUDA tensor
launches the kernel or raises.

Training differentiates both: where autograd records, ``attention`` and
``wkv6`` on a CUDA tensor go through their ``torch.autograd.Function``
(``FlashAttention``, ``WKV6``), whose backward is a hand-written kernel
too; on a CPU tensor autograd differentiates the plain versions. Serving
(no gradient) launches the forward kernels alone.

Decode attention over the model's contiguous cache is the paged decode
kernel's contiguous mode on a CUDA tensor (:func:`decode_attention`), the
plain version on a CPU tensor.
"""

from __future__ import annotations

import math

import torch

from repro_torch import obs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import contiguous_decode_attention
from repro_torch.kernels.wkv6 import wkv6

__all__ = ["attention", "decode_attention", "decode_attention_plain", "wkv6"]

# prefill / training attention: q (B,S,H,hd), k/v (B,T,KV,hd), causal=True
attention = flash_attention


def decode_attention_plain(q, k_cache, v_cache, valid_len: int):
    """Plain PyTorch decode attention (``ref.decode_attention``; the JAX
    package has no TPU kernel for it): q (B,S,H,hd) against a cache
    (B,T,KV,hd) whose positions >= ``valid_len`` are masked, float32 scores
    and softmax. It reads only the valid prefix of the cache, and query
    head h reads KV head h // (H // KV) through a grouped view instead of
    a repeated cache."""
    B, S, H, hd = q.shape
    KV = k_cache.shape[2]
    k = k_cache[:, :valid_len].float()
    v = v_cache[:, :valid_len].float()
    qg = q.float().reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k) / math.sqrt(hd)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bgrst,btgd->bsgrd", w, v)
    return o.reshape(B, S, H, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid_len: int):
    """Decode attention: q (B,S,H,hd) against a cache (B,T,KV,hd) whose
    positions >= ``valid_len`` are masked, float32 scores and softmax.

    On a CPU tensor, :func:`decode_attention_plain`. On a CUDA tensor (one
    query position, S == 1) the hand-written kernel
    ``csrc/paged_attention.cu`` in its contiguous mode, which reads the
    cache in place (no sliced or float32 copy) and raises on what it does
    not take; ``decode_attention.launches`` counts its calls, and the
    counter ``attn.decode.splits`` each call's number of splits."""
    B, S, H, hd = q.shape
    with obs.span("rt.decode_attention"):
        if q.device.type == "cpu":
            return decode_attention_plain(q, k_cache, v_cache, valid_len)
        if q.device.type != "cuda":
            raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
        if S != 1:
            raise ValueError(f"the decode kernel takes one query position, got {S}")
        o, splits = contiguous_decode_attention(q.reshape(B, H, hd), k_cache, v_cache,
                                                valid_len)
        decode_attention.launches += 1
        obs.count("attn.decode.splits", splits)
        return o.reshape(B, 1, H, hd)


decode_attention.launches = 0
