"""The layers of the dense-GQA and RWKV6 families, as plain functions over
dicts of tensors (counterpart of :mod:`repro.models.layers`).

Conventions, as in the JAX package: activations ``x`` are (B, S, D) in the
compute dtype; norms and softmaxes run in float32; decode takes and returns
explicit state. Attention and the RWKV6 recurrence go through
:mod:`repro_torch.kernels.ops`, which launches the Hopper kernels on a CUDA
tensor and their plain versions on a CPU tensor.

Not ported yet (later slices): MLA, MoE, Mamba and the int8 KV cache.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
    XLA folds the copies)."""
    hd = cfg.head_dim
    rot = hd if cfg.rope_mode == "full" else hd // 2
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
    if cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.attn_type} attention comes with a later slice "
            "of the port (MLA)"
        )
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
    q, k, v = attn_project_qkv(p, x, cfg, rope)
    o = ops.attention(q, k, v, causal=causal)  # (B, S, H, hd)
    out = o.reshape(o.shape[0], o.shape[1], -1) @ p["w_o"]
    return out, (k, v)


def attn_decode(p, x, cfg: ModelConfig, cache_k, cache_v, cur_len: int, rope):
    """One-token decode against a KV cache, which is updated in place.

    x (B, 1, D); cache_k / cache_v (B, S_max, KVH, hd); ``cur_len`` tokens
    are already in the cache. The new K/V row is written at ``cur_len``:
    the JAX package rebuilds the whole cache with an iota mask instead
    (``_masked_insert``, for its sharded cache), with the same result.
    ``rope``: the :func:`rope_tables` of position ``cur_len``. Returns the
    block's output (B, 1, D).
    """
    if cfg.kv_cache_dtype != "bfloat16":
        raise NotImplementedError(
            f"{cfg.kv_cache_dtype} KV cache comes with a later slice of the port"
        )
    B = x.shape[0]
    q, k, v = attn_project_qkv(p, x, cfg, rope)
    cache_k[:, cur_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cur_len] = v[:, 0].to(cache_v.dtype)
    o = ops.decode_attention(q, cache_k, cache_v, cur_len + 1)
    return o.reshape(B, 1, -1) @ p["w_o"]


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
    if "w3" in p:
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    else:
        h = F.gelu(x @ p["w1"], approximate="tanh")  # jax.nn.gelu's default
    return h @ p["w2"]


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
