"""Useful FLOPs and HBM bytes, counted from a configuration's shape
(``reference.arch.Arch``), never from the program.

* A token's matrix work is 2 FLOPs a weight it multiplies: attention's four
  projections; a dense FFN's three matrices; an MoE layer's router, its
  top-k routed experts (no capacity padding) and its shared experts; the
  head. The embedding lookup multiplies nothing.
* Training is 6 FLOPs a weight a token (forward and backward); remat's
  recompute is not counted. Decode counts the head at every sequence of
  the batch.
* Causal attention over the visible (query, key) pairs, S (S + 1) / 2 a
  sequence: 4 hd FLOPs a pair and head forward, 8 more backward.
* A kernel's bound (the rooflines): the larger of its FLOPs over the bf16
  tensor-core peak and its input and output bytes over HBM bandwidth, each
  byte counted once; flash backward at 10 hd FLOPs a pair and head (the five
  products of recomputed scores, dP, dV, dQ and dK), as ``chip_smoke.py``'s
  ``time_flash`` counts them.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense bf16 on the tensor cores and HBM3
PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def attn_params(a) -> int:
    Q, KV = a.heads * a.hd, a.kv_heads * a.hd
    return a.d * Q + 2 * a.d * KV + Q * a.d


def ffn_active_params(a, layer: int) -> int:
    if a.is_moe(layer):
        return a.d * a.experts + 3 * a.d * a.moe_ff * (a.top_k + a.shared)
    return 3 * a.d * a.d_ff


def layer_active_params(a) -> int:
    """Matrix weights a token multiplies in all layers."""
    return sum(attn_params(a) + ffn_active_params(a, i) for i in range(a.layers))


def head_params(a) -> int:
    return a.d * a.vocab


def train_step_flops(a, B: int, S: int) -> float:
    return (6.0 * (layer_active_params(a) + head_params(a)) * B * S
            + 12.0 * a.hd * a.heads * a.layers * B * causal_pairs(S))


def decode_step_flops(a, B: int, context: int) -> float:
    """One step of B sequences whose cache holds ``context`` positions: the
    new token attends over context + 1 keys."""
    return (2.0 * (layer_active_params(a) + head_params(a)) * B
            + 4.0 * a.hd * a.heads * a.layers * B * (context + 1))


def decode_step_bytes(a, B: int, context: int) -> float:
    """Weights read once (an MoE layer's experts as many as B tokens' picks
    are expected to touch), the B embedding rows, the valid cache read once,
    the new keys and values written, the logits written."""
    weights = 0.0
    for i in range(a.layers):
        weights += attn_params(a) + 2 * a.d
        if a.is_moe(i):
            touched = a.experts * (1.0 - (1.0 - a.top_k / a.experts) ** B)
            weights += a.d * a.experts + 3 * a.d * a.moe_ff * (touched + a.shared)
        else:
            weights += 3 * a.d * a.d_ff
    weights += head_params(a) + a.d + B * a.d
    kv = B * a.layers * 2 * a.kv_heads * a.hd * (context + 1)
    return BF16 * (weights + kv + B * a.vocab)


def flash_bwd_bound_s(B: int, S: int, H: int, KV: int, hd: int) -> float:
    flops = 10.0 * B * H * hd * causal_pairs(S)
    io = BF16 * (4 * B * S * H * hd + 4 * B * S * KV * hd) + 4 * B * S * H
    return max(flops / PEAK_FLOPS, io / HBM_BYTES_PER_S)


def roofline_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
