"""The layers of the dense-GQA, MLA, MoE, Mamba and RWKV6 families, as plain
functions over dicts of tensors (counterpart of :mod:`repro.models.layers`).

Conventions, as in the JAX package: activations ``x`` are (B, S, D) in the
compute dtype; norms and softmaxes run in float32; decode takes and returns
explicit state. GQA attention and the RWKV6 recurrence go through
:mod:`repro_torch.kernels.ops`, which launches the Hopper kernels on a CUDA
tensor and their plain versions on a CPU tensor. MLA attends over its
compressed cache in plain float32, the MoE experts are batched matrix
products and the Mamba selective scan runs in chunks over the sequence in
plain float32: the JAX package calls no Pallas kernel for any of them. GQA decode
keeps its cache in the compute dtype or, with ``kv_cache_dtype ==
"int8"``, as int8 values with a bfloat16 scale a (position, KV head)
(:func:`quantize_kv`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def dense_init(shape, dtype, in_axis: int, generator, device):
    """Normal weights scaled by 1/sqrt(fan_in), drawn in float32 from
    ``generator`` and cast (the JAX package's ``dense_init``)."""
    fan_in = shape[in_axis] if shape else 1
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (w * (1.0 / math.sqrt(max(fan_in, 1)))).to(dtype)


# --------------------------------------------------------------------- norms
def norm_init(cfg: ModelConfig, d: int, device):
    p = {"scale": torch.ones((d,), dtype=param_dtype(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=param_dtype(cfg), device=device)
    return p


def norm_apply(p, x, cfg: ModelConfig, eps: float = 1e-6):
    """RMSNorm or LayerNorm over the last axis, computed in float32."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------- rope
def rope_cos_sin(positions, dim: int, theta: float):
    """positions (...,) -> cos, sin (..., dim/2) in float32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def rope_tables(positions, cfg: ModelConfig):
    """The (cos, sin) that :func:`apply_rope` needs for ``positions``
    (B, S), shaped (B, S, 1, rot/2). Every attention layer of a forward or
    decode step rotates at the same positions, so the model computes them
    once a step (the JAX package's ``apply_rope`` recomputes them per call;
    XLA folds the copies). MLA rotates its ``qk_rope_dim`` dims in full
    mode whatever ``head_dim`` and ``rope_mode`` say."""
    if cfg.attn_type == "mla":
        rot = cfg.qk_rope_dim
    else:
        rot = cfg.head_dim if cfg.rope_mode == "full" else cfg.head_dim // 2
    cos, sin = rope_cos_sin(positions, rot, cfg.rope_theta)
    return cos[:, :, None, :], sin[:, :, None, :]


def apply_rope(x, tables, mode: str = "full"):
    """x (B, S, H, hd) rotated by the (cos, sin) ``tables`` of
    :func:`rope_tables`; mode 'half' rotates only the first hd/2 dims
    (ChatGLM's 2d RoPE layout). Interleaved pairs, in float32."""
    hd = x.shape[-1]
    rot = hd if mode == "full" else hd // 2
    cos, sin = tables
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    rotated = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    if rot == hd:
        return rotated
    return torch.cat([rotated, x[..., rot:]], dim=-1)


# ----------------------------------------------------------------- attention
def attn_init(cfg: ModelConfig, generator, device):
    D, Q, KV = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = param_dtype(cfg)
    p = {
        "w_q": dense_init((D, Q), dt, 0, generator, device),
        "w_k": dense_init((D, KV), dt, 0, generator, device),
        "w_v": dense_init((D, KV), dt, 0, generator, device),
        "w_o": dense_init((Q, D), dt, 0, generator, device),
    }
    if cfg.qkv_bias:
        for name, n in (("b_q", Q), ("b_k", KV), ("b_v", KV)):
            p[name] = torch.zeros((n,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.head_dim,), dtype=dt, device=device)
        p["k_norm"] = torch.ones((cfg.head_dim,), dtype=dt, device=device)
    return p


def _qk_norm(v, scale, eps: float = 1e-6):
    vf = v.float()
    ms = (vf * vf).mean(-1, keepdim=True)
    return (vf * torch.rsqrt(ms + eps) * scale.float()).to(v.dtype)


def attn_project_qkv(p, x, cfg: ModelConfig, rope):
    """q (B,S,H,hd), k, v (B,S,KVH,hd), q and k rotated by the ``rope``
    tables of the positions."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p["w_q"], x @ p["w_k"], x @ p["w_v"]
    if "b_q" in p:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KVH, hd)
    v = v.reshape(B, S, KVH, hd)
    if "q_norm" in p:
        q = _qk_norm(q, p["q_norm"])
        k = _qk_norm(k, p["k_norm"])
    q = apply_rope(q, rope, cfg.rope_mode)
    k = apply_rope(k, rope, cfg.rope_mode)
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, rope, causal: bool = True):
    """Full-sequence attention (prefill / training) at the positions of the
    ``rope`` tables. Returns (out, (k, v))."""
    with obs.span("rt.attn"):
        q, k, v = attn_project_qkv(p, x, cfg, rope)
        o = ops.attention(q, k, v, causal=causal)  # (B, S, H, hd)
        out = o.reshape(o.shape[0], o.shape[1], -1) @ p["w_o"]
        return out, (k, v)


def attn_apply_int8(p, x, cfg: ModelConfig, rope):
    """Causal full-sequence attention that reads its keys and values as an
    int8 cache holds them: each (position, KV head) quantized by
    :func:`quantize_kv` and dequantized (:func:`dequantize_kv`), as S
    decode steps over an int8 cache read them. Returns (out, (k values, k
    scales, v values, v scales)) for the cache."""
    q, k, v = attn_project_qkv(p, x, cfg, rope)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    o = ops.attention(q, dequantize_kv(kq, ks).to(q.dtype), dequantize_kv(vq, vs).to(q.dtype),
                      causal=True)
    out = o.reshape(o.shape[0], o.shape[1], -1) @ p["w_o"]
    return out, (kq, ks, vq, vs)


def quantize_kv(x, dim: int = -1):
    """Symmetric int8 quantization along ``dim`` (per token and KV head):
    (int8 values, bfloat16 scales), step for step as the JAX
    ``quantize_kv``: the absolute maximum in float32, ``scale = max(amax,
    1e-6) / 127`` in float32, ``clip(rint(x / scale), -127, 127)`` (a
    division, not a product with the reciprocal; ``torch.round`` rounds
    half to even as ``jnp.rint`` does), the scale stored in bfloat16."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q, scale):
    """An int8 cache's values in bfloat16: ``q.bf16 * scale.bf16``, the
    product rounded to bfloat16 (the JAX ``attn_decode``'s)."""
    return q.to(torch.bfloat16) * scale.to(torch.bfloat16)


def attn_decode(p, x, cfg: ModelConfig, cache_k, cache_v, cur_len: int, rope,
                k_scale=None, v_scale=None):
    """One-token decode against a KV cache, which is updated in place.

    x (B, 1, D); cache_k / cache_v (B, S_max, KVH, hd); ``cur_len`` tokens
    are already in the cache. The new K/V row is written at ``cur_len``:
    the JAX package rebuilds the whole cache with an iota mask instead
    (``_masked_insert``, for its sharded cache), with the same result.
    ``rope``: the :func:`rope_tables` of position ``cur_len``. With
    ``cfg.kv_cache_dtype == "int8"`` the caches hold int8 values and
    ``k_scale`` / ``v_scale`` (B, S_max, KVH, 1) their bfloat16 scales: the
    new row is quantized (:func:`quantize_kv`) and the first ``cur_len +
    1`` positions dequantized in bfloat16 (:func:`dequantize_kv`) before
    the float32 attention, as the JAX function's single-device branch
    writes it. Returns the block's output (B, 1, D).
    """
    B = x.shape[0]
    with obs.span("rt.attn.decode"):
        q, k, v = attn_project_qkv(p, x, cfg, rope)
        n = cur_len + 1
        if cfg.kv_cache_dtype == "int8":
            kq, ks = quantize_kv(k[:, 0])
            vq, vs = quantize_kv(v[:, 0])
            cache_k[:, cur_len], k_scale[:, cur_len] = kq, ks
            cache_v[:, cur_len], v_scale[:, cur_len] = vq, vs
            # the kernel takes one dtype; bfloat16 to float32 is exact
            keys = dequantize_kv(cache_k[:, :n], k_scale[:, :n]).to(q.dtype)
            values = dequantize_kv(cache_v[:, :n], v_scale[:, :n]).to(q.dtype)
        else:
            cache_k[:, cur_len] = k[:, 0].to(cache_k.dtype)
            cache_v[:, cur_len] = v[:, 0].to(cache_v.dtype)
            keys, values = cache_k, cache_v
        o = ops.decode_attention(q, keys, values, n)
        return o.reshape(B, 1, -1) @ p["w_o"]


def cross_attn_apply(p, x, cross_k, cross_v, cfg: ModelConfig):
    """Cross-attention of x (B, S, D) over an encoder's keys and values
    (B, T, KVH, hd), as the JAX ``_block_train`` and ``decode_step`` write
    it: ``w_q`` and ``w_o`` only (no bias, no qk-norm, no RoPE), every key
    visible (``ops.attention(..., causal=False)``: the flash-attention
    kernel on the card, also for S == 1 in decode). Returns (B, S, D)."""
    B, S, _ = x.shape
    q = (x @ p["w_q"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    o = ops.attention(q, cross_k, cross_v, causal=False)
    return o.reshape(B, S, -1) @ p["w_o"]


def cross_kv(p, enc_out, cfg: ModelConfig):
    """The keys and values (B, T, KVH, hd) that cross-attention reads from
    the encoder's output (the JAX ``_cross_kv``: ``w_k`` and ``w_v`` only)."""
    B, T, _ = enc_out.shape
    shape = (B, T, cfg.num_kv_heads, cfg.head_dim)
    return (enc_out @ p["w_k"]).reshape(shape), (enc_out @ p["w_v"]).reshape(shape)


# ----------------------------------------------------------------------- MLP
def mlp_init(cfg: ModelConfig, generator, device, d_ff: int | None = None):
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    dt = param_dtype(cfg)
    if cfg.mlp_act == "swiglu":
        return {
            "w1": dense_init((D, Fd), dt, 0, generator, device),
            "w3": dense_init((D, Fd), dt, 0, generator, device),
            "w2": dense_init((Fd, D), dt, 0, generator, device),
        }
    return {
        "w1": dense_init((D, Fd), dt, 0, generator, device),
        "w2": dense_init((Fd, D), dt, 0, generator, device),
    }


def mlp_apply(p, x, cfg: ModelConfig):
    with obs.span("rt.mlp"):
        if "w3" in p:
            h = F.silu(x @ p["w1"]) * (x @ p["w3"])
        else:
            h = F.gelu(x @ p["w1"], approximate="tanh")  # jax.nn.gelu's default
        return h @ p["w2"]


# ----------------------------------------------------------------------- MLA
def mla_init(cfg: ModelConfig, generator, device):
    D, H = cfg.d_model, cfg.num_heads
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    dt = param_dtype(cfg)
    return {
        "q_a": dense_init((D, cfg.q_lora_rank), dt, 0, generator, device),
        "q_norm": torch.ones((cfg.q_lora_rank,), dtype=dt, device=device),
        "q_b": dense_init((cfg.q_lora_rank, H * qk_dim), dt, 0, generator, device),
        "kv_a": dense_init((D, cfg.kv_lora_rank + cfg.qk_rope_dim), dt, 0, generator,
                           device),
        "kv_norm": torch.ones((cfg.kv_lora_rank,), dtype=dt, device=device),
        "kv_b": dense_init((cfg.kv_lora_rank, H * (cfg.qk_nope_dim + cfg.v_head_dim)),
                           dt, 0, generator, device),
        "w_o": dense_init((H * cfg.v_head_dim, D), dt, 0, generator, device),
    }


def _mla_qkv(p, x, cfg: ModelConfig, rope):
    """The MLA projections: q_nope (B,S,H,nope), q_rope (B,S,H,rope) and
    the compressed (c_kv (B,S,r), k_rope (B,S,1,rope)) that form the
    cache; the rope parts rotated by the ``rope`` tables."""
    B, S, _ = x.shape
    H = cfg.num_heads
    cq = _qk_norm(x @ p["q_a"], p["q_norm"])
    q = (cq @ p["q_b"]).reshape(B, S, H, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_rope = apply_rope(q_rope, rope)
    ckv_full = x @ p["kv_a"]
    c_kv = _qk_norm(ckv_full[..., :cfg.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(ckv_full[..., None, cfg.kv_lora_rank:], rope)
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(p, q_nope, q_rope, c_kv, k_rope, cfg: ModelConfig, causal: bool,
                kv_valid_len=None):
    """Attention over the compressed cache in float32, kv_b's key part
    absorbed into the query (the MLA decode identity), as the JAX
    ``_mla_attend`` writes it. Keys past ``kv_valid_len`` are masked."""
    B, S, H, _ = q_nope.shape
    T = c_kv.shape[1]
    kv_b = p["kv_b"].reshape(cfg.kv_lora_rank, H, cfg.qk_nope_dim + cfg.v_head_dim)
    k_b = kv_b[..., :cfg.qk_nope_dim].float()  # (r, H, nope)
    v_b = kv_b[..., cfg.qk_nope_dim:].float()  # (r, H, v)
    ckv = c_kv.float()
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(), k_b)
    scores = torch.einsum("bshr,btr->bhst", q_lat, ckv)
    scores = scores + torch.einsum("bshn,btxn->bhst", q_rope.float(), k_rope.float())
    scores = scores / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    if causal:
        qpos = torch.arange(S, device=scores.device)[:, None]
        kpos = torch.arange(T, device=scores.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, -math.inf)
    if kv_valid_len is not None:
        kpos = torch.arange(T, device=scores.device)
        scores = scores.masked_fill(kpos >= kv_valid_len, -math.inf)
    w = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", w, ckv)
    o = torch.einsum("bshr,rhv->bshv", o_lat, v_b)
    return o.reshape(B, S, H * cfg.v_head_dim).to(q_nope.dtype)


def mla_apply(p, x, cfg: ModelConfig, rope, causal: bool = True):
    """Full-sequence MLA. Returns (out, (c_kv (B,S,r), k_rope (B,S,rope)))."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, rope)
    o = _mla_attend(p, q_nope, q_rope, c_kv, k_rope, cfg, causal)
    return o @ p["w_o"], (c_kv, k_rope.squeeze(2))


def mla_decode(p, x, cfg: ModelConfig, cache_ckv, cache_krope, cur_len: int, rope):
    """One-token MLA decode; ``cache_ckv`` (B, S_max, r) and
    ``cache_krope`` (B, S_max, rope) are updated in place at ``cur_len``
    (the JAX package's ``_masked_insert``), and the query attends over the
    first ``cur_len + 1`` positions. Returns the block's output (B, 1, D)."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, rope)
    cache_ckv[:, cur_len] = c_kv[:, 0].to(cache_ckv.dtype)
    cache_krope[:, cur_len] = k_rope[:, 0, 0].to(cache_krope.dtype)
    o = _mla_attend(p, q_nope, q_rope, cache_ckv.to(c_kv.dtype), cache_krope[:, :, None, :],
                    cfg, causal=False, kv_valid_len=cur_len + 1)
    return o @ p["w_o"]


# ----------------------------------------------------------------------- MoE
def moe_init(cfg: ModelConfig, generator, device):
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    dt = param_dtype(cfg)
    p = {
        "router": dense_init((D, E), dt, 0, generator, device),
        "we1": dense_init((E, D, Fd), dt, 1, generator, device),
        "we3": dense_init((E, D, Fd), dt, 1, generator, device),
        "we2": dense_init((E, Fd, D), dt, 1, generator, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(cfg, generator, device, d_ff=Fd * cfg.n_shared_experts)
    return p


def moe_capacity(n_tokens: int, cfg: ModelConfig, capacity_factor: float = 1.25) -> int:
    """Slots an expert keeps of ``n_tokens`` tokens' picks."""
    return max(1, int(capacity_factor * n_tokens * cfg.top_k / cfg.n_experts))


def moe_route(logits, K: int, C: int):
    """Token-choice top-K routing of ``logits`` (G, N, E) float32, each of
    the G groups of N tokens filling its own expert buffers of C slots.
    Returns (probs (G,N,E), gates (G,N,K), picks (G,N,K), pos (G,N,K),
    keep (G,N,K)): the gates renormalised over the K picks before any is
    dropped, and pick (n, k)'s slot in its expert's buffer, counted in
    (token, k) order; picks at slot C or beyond are dropped.
    ``jax.lax.top_k`` puts the lower expert first among equal
    probabilities, as a stable descending sort does (``torch.topk`` does
    not)."""
    E = logits.shape[-1]
    G, N = logits.shape[:2]
    probs = torch.softmax(logits, dim=-1)
    gates, picks = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, picks = gates[..., :K], picks[..., :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = F.one_hot(picks, E).reshape(G, N * K, E)
    # each expert's running count in (token, k) order, scanned along a
    # contiguous last axis: a scan along axis 1 of (G, N K, E) runs as the
    # card's slow outer-axis scan (PERF.md §5)
    pos = torch.cumsum(flat.transpose(1, 2).contiguous(), dim=-1).transpose(1, 2) - flat
    pos = (pos * flat).sum(-1).reshape(G, N, K)
    return probs, gates, picks, pos, pos < C


def moe_apply(p, x, cfg: ModelConfig, capacity_factor: float = 1.25,
              per_position: bool = False):
    """Token-choice top-k MoE with capacity-based dispatch (the JAX
    ``moe_apply``): over x (B, S, D), returns (out, Switch aux loss).

    The capacity applies over all N = B * S tokens, as in the JAX package.
    With ``per_position``, each position's B tokens route as one group of
    their own, in batch order, with the capacity of B tokens: what S
    decode steps compute, one position at a time (the state fill of
    ``prefill``); the aux loss is then not computed (0).

    As written in the JAX function: a dropped pick adds zeros at slot 0 of
    expert 0, and the experts run over every slot of their buffers."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xg = x.transpose(0, 1) if per_position else x.reshape(1, B * S, D)  # (G, N, D)
    G, N = xg.shape[:2]
    C = moe_capacity(N, cfg, capacity_factor)
    with obs.span("rt.moe.route"):
        logits = (xg @ p["router"]).float()
        probs, gates, picks, pos, keep = moe_route(logits, K, C)
    if obs.counting():
        obs.count("moe.picks", G * N * K)
        obs.count("moe.kept", keep.sum())
        obs.count("moe.slots", E * G * C)
    # dispatch (G, N, K) -> the experts' buffers (E, G, C, D)
    with obs.span("rt.moe.dispatch"):
        e_idx = torch.where(keep, picks, 0)
        s_idx = torch.where(keep, pos, 0)
        g_idx = torch.arange(G, device=x.device)[:, None, None].expand(G, N, K)
        vals = torch.where(keep[..., None], xg[:, :, None, :], 0).to(x.dtype)
        disp = torch.zeros((E, G, C, D), dtype=x.dtype, device=x.device)
        disp.index_put_((e_idx, g_idx, s_idx), vals, accumulate=True)
    with obs.span("rt.moe.experts"):
        flat = disp.reshape(E, G * C, D)
        h = F.silu(torch.bmm(flat, p["we1"])) * torch.bmm(flat, p["we3"])
        eout = torch.bmm(h, p["we2"]).reshape(E, G, C, D)
    # combine, in float32 as the JAX function promotes it
    with obs.span("rt.moe.combine"):
        gathered = eout[e_idx, g_idx, s_idx]  # (G, N, K, D)
        combined = (gathered * torch.where(keep, gates, 0.0)[..., None]).sum(-2)
        out = combined.to(x.dtype)
        out = out.transpose(0, 1) if per_position else out.reshape(B, S, D)
    if "shared" in p:
        with obs.span("rt.moe.shared"):
            out = out + mlp_apply(p["shared"], x, cfg)
    if per_position:
        return out, torch.zeros((), dtype=torch.float32, device=x.device)
    me = probs[0].mean(0)
    ce = (F.one_hot(picks[0], E).sum(1) > 0).float().mean(0)
    return out, E * torch.sum(me * ce)


# --------------------------------------------------------------------- Mamba
# Positions of one chunk of the full-sequence scan. At Jamba-1.5-Large's
# serving shape (B 4, d_inner 16,384, d_state 16) one chunk's float32
# (B, L, d_inner, d_state) array is 4 * 128 * 16,384 * 16 * 4 = 537 MB,
# against 8.59 GB for the whole 2,048-token sequence.
MAMBA_CHUNK = 128


def dt_rank(cfg: ModelConfig) -> int:
    """The rank of the Mamba block's dt projection (the JAX ``_dt_rank``)."""
    return max(1, math.ceil(cfg.d_model / 16))


def mamba_init(cfg: ModelConfig, generator, device):
    """A Mamba-1 block's parameters (the JAX ``g_mamba_init`` of one layer):
    ``A_log`` = log(1 .. d_state) on every channel and ``Dskip`` = 1, both
    float32 whatever ``param_dtype`` is; the biases zero."""
    D, DI, DS = cfg.d_model, cfg.d_inner, cfg.mamba_d_state
    R = dt_rank(cfg)
    dt = param_dtype(cfg)
    A = torch.arange(1, DS + 1, dtype=torch.float32, device=device)[None, :].expand(DI, DS)
    return {
        "in_proj": dense_init((D, 2 * DI), dt, 0, generator, device),
        "conv_w": dense_init((cfg.mamba_d_conv, DI), dt, 0, generator, device),
        "conv_b": torch.zeros((DI,), dtype=dt, device=device),
        "x_proj": dense_init((DI, R + 2 * DS), dt, 0, generator, device),
        "dt_proj": dense_init((R, DI), dt, 0, generator, device),
        "dt_bias": torch.zeros((DI,), dtype=dt, device=device),
        "A_log": torch.log(A).contiguous(),
        "Dskip": torch.ones((DI,), dtype=torch.float32, device=device),
        "out_proj": dense_init((DI, D), dt, 0, generator, device),
    }


def _mamba_conv(p, xs, cfg: ModelConfig, conv_state=None):
    """The depthwise causal convolution over S of xs (B, S, DI), after the
    ``d_conv - 1`` inputs of ``conv_state`` (zeros when None), in the
    compute dtype with the JAX ``_mamba_conv_scan``'s order of terms.
    Returns (y, the last ``d_conv - 1`` inputs: the new conv state)."""
    K = cfg.mamba_d_conv
    B, S, DI = xs.shape
    pad = (xs.new_zeros((B, K - 1, DI)) if conv_state is None
           else conv_state.to(xs.dtype))
    xp = torch.cat([pad, xs], dim=1)  # (B, S + K - 1, DI)
    w = p["conv_w"]
    y = xp[:, :S] * w[0]
    for k in range(1, K):
        y = y + xp[:, k:k + S] * w[k]
    return y + p["conv_b"], xp[:, S:]


def _scan_chunk(dt, dtx, Bm, Cm, A, h):
    """One chunk of :func:`_mamba_scan` from the state ``h`` that enters
    it: (y (B, L, DI), the last h)."""
    decay = torch.exp(dt[..., None] * A).unbind(1)
    drive = (dtx[..., None] * Bm[:, :, None, :]).unbind(1)
    hs = []
    for t in range(dt.shape[1]):
        h = torch.addcmul(drive[t], decay[t], h)
        hs.append(h)
    return torch.einsum("bled,bld->ble", torch.stack(hs, dim=1), Cm), h


def _mamba_scan(dt, dtx, Bm, Cm, A, chunk: int, entries: list | None = None):
    """``h_t = exp(dt_t A) h_{t-1} + dtx_t B_t`` from h = 0 over S, and
    ``y_t = h_t . C_t``, in chunks of ``chunk`` positions: only one
    chunk's decays, drives and states (B, L, DI, DS) exist at a time, and
    h carries from chunk to chunk. dt, dtx (B, S, DI), Bm, Cm (B, S, DS)
    and A (DI, DS), all float32. Returns (y (B, S, DI), the last h (B,
    DI, DS)); ``entries`` receives the h that enters each chunk. No tensor
    is written in place, so autograd can run through it, but it then keeps
    every position's h and decay and each chunk's stacked states: three
    (B, S, DI, DS) float32 arrays, 8.6 GB each at Jamba-1.5-Large's
    training shape (B 4, S 2,048). :class:`MambaScan` is its gradient
    with one chunk's worth of them at a time."""
    B, S, DI = dt.shape
    h = dt.new_zeros((B, DI, A.shape[-1]))
    ys = []
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        if entries is not None:
            entries.append(h)
        y, h = _scan_chunk(dt[:, c0:c1], dtx[:, c0:c1], Bm[:, c0:c1], Cm[:, c0:c1], A, h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


class MambaScan(torch.autograd.Function):
    """:func:`_mamba_scan` with a gradient that keeps only the h entering
    each chunk (S / chunk states of (B, DI, DS) float32: 16 x 4.2 MB at
    B 4, S 2,048, DI 16,384, DS 16) and, in the backward, recomputes one
    chunk at a time under autograd from its entering h, the last chunk
    first, carrying the gradient of that h back to the chunk before: the
    role ``jax.grad`` of the JAX ``associative_scan`` plays, in plain
    PyTorch. ``apply(dt, dtx, Bm, Cm, A, chunk)`` -> (y, last h); the
    forward's values are the loop's, bit for bit."""

    @staticmethod
    def forward(ctx, dt, dtx, Bm, Cm, A, chunk):
        entries = []
        y, h = _mamba_scan(dt, dtx, Bm, Cm, A, chunk, entries)
        ctx.save_for_backward(dt, dtx, Bm, Cm, A, *entries)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        dt, dtx, Bm, Cm, A, *entries = ctx.saved_tensors
        S, chunk = dt.shape[1], ctx.chunk
        parts = [[], [], [], []]  # dt, dtx, Bm, Cm, the last chunk first
        gA, carry = None, gh
        for i in reversed(range(len(entries))):
            c0, c1 = i * chunk, min(S, (i + 1) * chunk)
            with torch.enable_grad():
                ins = [t[:, c0:c1].detach().requires_grad_(True) for t in (dt, dtx, Bm, Cm)]
                a = A.detach().requires_grad_(True)
                h0 = entries[i].detach().requires_grad_(True)
                y, h1 = _scan_chunk(*ins, a, h0)
                outs = [(o, g) for o, g in ((y, None if gy is None else gy[:, c0:c1]),
                                            (h1, carry)) if g is not None]
                grads = torch.autograd.grad([o for o, _ in outs], ins + [a, h0],
                                            [g for _, g in outs], allow_unused=True)
            for part, g, t in zip(parts, grads[:4], ins):
                part.append(torch.zeros_like(t) if g is None else g)
            if grads[4] is not None:
                gA = grads[4] if gA is None else gA + grads[4]
            carry = grads[5]
        cat = [torch.cat(part[::-1], dim=1) for part in parts]
        return (*cat, gA, None)


def mamba_apply(p, x, cfg: ModelConfig, state=None, chunk: int = MAMBA_CHUNK):
    """The selective SSM (Mamba-1) over x (B, S, D), as the JAX
    ``mamba_apply`` computes it: ``dt`` is the softplus in the compute
    dtype, then float32; B, C, the decays, drives and states are float32;
    y returns to x's dtype before ``out_proj``.

    ``state`` = (conv state (B, d_conv - 1, DI), SSM state (B, DI, DS)
    float32) for a decode step (S == 1): ``h = ssm[:, None] * decay +
    drive``, the JAX line. With ``state=None`` the whole sequence is
    scanned from zeros by :class:`MambaScan` in chunks of ``chunk``
    positions (default ``MAMBA_CHUNK`` = 128: one chunk's float32 (B, L,
    DI, DS) array is 537 MB at Jamba-1.5-Large's serving shape, B 4, DI
    16,384, DS 16); nothing
    of shape (B, S, DI, DS) is allocated. The JAX function runs
    ``jax.lax.associative_scan`` over the whole sequence instead: the same
    recurrence, summed in another order.

    Returns (out (B, S, D), (conv state, SSM state)): after S positions,
    the last ``d_conv - 1`` inputs of the convolution (zero-padded when S
    is shorter, as the decode steps' state is) and the last h; a decode
    step's new state, or, for a full sequence, the state S decode steps
    from zeros would leave (the one-forward fill)."""
    B, S, D = x.shape
    DI, DS = cfg.d_inner, cfg.mamba_d_state
    R = dt_rank(cfg)
    xz = x @ p["in_proj"]
    xs, z = xz[..., :DI], xz[..., DI:]
    xs, new_conv = _mamba_conv(p, xs, cfg, None if state is None else state[0])
    xs = F.silu(xs)
    proj = xs @ p["x_proj"]
    dt = F.softplus(proj[..., :R] @ p["dt_proj"] + p["dt_bias"]).float()  # (B, S, DI)
    Bm = proj[..., R:R + DS].float()  # (B, S, DS)
    Cm = proj[..., R + DS:].float()
    A = -torch.exp(p["A_log"])  # (DI, DS)
    xf = xs.float()
    dtx = dt * xf
    if state is None:
        y, h = MambaScan.apply(dt, dtx, Bm, Cm, A, chunk)
    else:
        decay = torch.exp(dt[..., None] * A)
        drive = dtx[..., None] * Bm[:, :, None, :]
        hs = state[1][:, None] * decay + drive  # S == 1
        y = torch.einsum("bsed,bsd->bse", hs, Cm)
        h = hs[:, -1]
    y = y + xf * p["Dskip"]
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p["out_proj"], (new_conv, h)


# --------------------------------------------------------------------- RWKV6
def rwkv_init(cfg: ModelConfig, generator, device):
    D, hd = cfg.d_model, cfg.rwkv_head_dim
    H = D // hd
    lora = max(32, D // 32)
    dt = param_dtype(cfg)

    def full(value, shape, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=device)

    p = {f"mu_{n}": full(0.5, (D,)) for n in ("r", "k", "v", "w", "g")}
    for n in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        p[n] = dense_init((D, D), dt, 0, generator, device)
    p["w_decay_a"] = dense_init((D, lora), dt, 0, generator, device)
    p["w_decay_b"] = dense_init((lora, D), dt, 0, generator, device)
    p["decay_base"] = full(-4.0, (D,), torch.float32)
    p["bonus"] = full(0.0, (H, hd), torch.float32)
    p["ln_x"] = full(1.0, (D,))
    p["cm_mu"] = full(0.5, (D,))
    p["cm_k"] = dense_init((D, cfg.d_ff), dt, 0, generator, device)
    p["cm_v"] = dense_init((cfg.d_ff, D), dt, 0, generator, device)
    p["cm_r"] = dense_init((D, D), dt, 0, generator, device)
    return p


def _shifted(x, prev=None):
    """(x_{t-1}, x_t - x_{t-1}); ``prev`` (B, 1, D) is the decode carry."""
    if prev is None:
        xprev = F.pad(x[:, :-1], (0, 0, 1, 0))
    else:
        xprev = torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)
    return xprev, x - xprev


def _token_shift(x, mu, prev=None, shifted=None):
    """lerp(x_{t-1}, x_t, mu); ``prev`` (B, 1, D) is the decode carry.
    ``shifted``: :func:`_shifted` of (x, prev), shared by the time mix's
    five lerps (the same values the JAX package computes five times)."""
    xprev, dx = _shifted(x, prev) if shifted is None else shifted
    return xprev + mu.to(x.dtype) * dx


def rwkv_time_mix(p, x, cfg: ModelConfig, state=None):
    """RWKV6 time mix. ``state`` = (x_prev (B,1,D), wkv (B,H,hd,hd)) for
    decode (S == 1), None for a full sequence (the ``wkv6`` kernel).
    Returns (out, (last x, wkv state))."""
    B, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    sh = _shifted(x, state[0] if state is not None else None)
    r = _token_shift(x, p["mu_r"], shifted=sh) @ p["w_r"]
    k = _token_shift(x, p["mu_k"], shifted=sh) @ p["w_k"]
    v = _token_shift(x, p["mu_v"], shifted=sh) @ p["w_v"]
    g = _token_shift(x, p["mu_g"], shifted=sh) @ p["w_g"]
    xw = _token_shift(x, p["mu_w"], shifted=sh)
    dd = torch.tanh(xw @ p["w_decay_a"]) @ p["w_decay_b"]
    w = torch.exp(-torch.exp(p["decay_base"].float() + dd.float()))
    rh, kh, vh, wh = (t.reshape(B, S, H, hd) for t in (r, k, v, w))
    u = p["bonus"]  # (H, hd)
    if state is None:
        o, new_wkv = ops.wkv6(rh, kh, vh, wh, u)  # (B, S, H, hd)
    else:
        wkv = state[1]  # (B, H, hd, hd): S_{t-1}
        kt, vt, rt = kh[:, 0].float(), vh[:, 0].float(), rh[:, 0].float()
        at = torch.einsum("bhk,bhv->bhkv", kt, vt)
        out = torch.einsum("bhk,bhkv->bhv", rt, wkv + u.float()[None, :, :, None] * at)
        new_wkv = wh[:, 0].float()[..., None] * wkv + at
        o = out.reshape(B, 1, H, hd).to(x.dtype)
    # group norm per head (ln_x), then the gate
    of = o.float().reshape(B, S, H, hd)
    ms = (of * of).mean(-1, keepdim=True)
    of = (of * torch.rsqrt(ms + 1e-6)).reshape(B, S, D) * p["ln_x"].float()
    o = (of * F.silu(g.float())).to(x.dtype)
    return o @ p["w_o"], (x[:, -1:, :], new_wkv)


def rwkv_channel_mix(p, x, cfg: ModelConfig, prev=None):
    xs = _token_shift(x, p["cm_mu"], prev)
    k = torch.square(F.relu(xs @ p["cm_k"]))
    v = k @ p["cm_v"]
    r = torch.sigmoid(xs @ p["cm_r"])
    return r * v, x[:, -1:, :]
