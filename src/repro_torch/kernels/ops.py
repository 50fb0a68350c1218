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
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.wkv6 import wkv6

__all__ = ["attention", "decode_attention", "wkv6"]

# prefill / training attention: q (B,S,H,hd), k/v (B,T,KV,hd), causal=True
attention = flash_attention


def decode_attention(q, k_cache, v_cache, valid_len: int):
    """Decode attention: q (B,S,H,hd) against a cache (B,T,KV,hd) whose
    positions >= ``valid_len`` are masked, float32 scores and softmax
    (``ref.decode_attention``; the JAX package has no TPU kernel for it).
    Plain PyTorch: it reads only the valid prefix of the cache, and query
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
