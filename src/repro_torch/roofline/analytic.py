"""Exact analytic FLOP / HBM-byte accounting per (config x shape): a copy
of :mod:`repro.roofline.analytic` over the port's ``ModelConfig``.

The same float arithmetic in the same order, so each function returns the
JAX package's value exactly: matmul-exact for every block type (attention,
MLA, MLP, MoE with its capacity padding, Mamba with its scan, RWKV6), the
remat and train multipliers applied explicitly. The counts describe the
architecture, not a device; :mod:`repro_torch.roofline.report` divides them
by one card's rates.
"""

from __future__ import annotations

import math

from repro_torch.models.config import ModelConfig


def _attn_proj_flops_per_tok(cfg: ModelConfig) -> float:
    if cfg.attn_type == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        f = (
            cfg.d_model * cfg.q_lora_rank
            + cfg.q_lora_rank * cfg.num_heads * qk
            + cfg.d_model * (cfg.kv_lora_rank + cfg.qk_rope_dim)
            + cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
            + cfg.num_heads * cfg.v_head_dim * cfg.d_model
        )
        return 2.0 * f
    f = cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * cfg.d_model
    return 2.0 * f


def _attn_score_flops_per_tok(cfg: ModelConfig, kv_len: float) -> float:
    """QKᵀ + PV per token attending over kv_len keys."""
    if cfg.attn_type == "mla":
        # latent-space attention: scores vs kv_lora (+rope), values in latent
        d_eff = cfg.kv_lora_rank + cfg.qk_rope_dim + cfg.kv_lora_rank
        return 2.0 * cfg.num_heads * kv_len * d_eff
    return 4.0 * cfg.num_heads * kv_len * cfg.head_dim


def _ffn_flops_per_tok(cfg: ModelConfig, pos: int, capacity_factor=1.25) -> float:
    moe = (
        cfg.n_experts > 0 and pos % cfg.moe_every == cfg.moe_offset
    )
    nmat = 3 if cfg.mlp_act == "swiglu" else 2
    if not moe:
        return 2.0 * nmat * cfg.d_model * cfg.d_ff
    f = 2.0 * nmat * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff)
    tot = f * cfg.top_k * capacity_factor  # dispatched (incl. capacity pad)
    if cfg.n_shared_experts:
        tot += f * cfg.n_shared_experts
    tot += 2.0 * cfg.d_model * cfg.n_experts  # router
    return tot


def _mixer_flops_per_tok(cfg: ModelConfig, kind: str, kv_len: float) -> float:
    if kind == "attn":
        return _attn_proj_flops_per_tok(cfg) + _attn_score_flops_per_tok(cfg, kv_len)
    if kind == "mamba":
        DI, DS = cfg.d_inner, cfg.mamba_d_state
        R = max(1, math.ceil(cfg.d_model / 16))
        return 2.0 * (
            cfg.d_model * 2 * DI
            + cfg.mamba_d_conv * DI
            + DI * (R + 2 * DS)
            + R * DI
            + 4 * DI * DS  # ssm scan work
            + DI * cfg.d_model
        )
    if kind == "rwkv":
        D = cfg.d_model
        chunk = 64.0
        wkv = 2.0 * 2.0 * chunk * D  # intra-chunk A@ and @v per token
        lora = max(32, D // 32)
        return 2.0 * (5 * D * D + 2 * D * lora) + wkv + 2.0 * (
            D * cfg.d_ff + cfg.d_ff * D + D * D
        )
    raise ValueError(kind)


def forward_flops(cfg: ModelConfig, n_tokens: float, kv_len: float,
                  batch: float = 1.0) -> float:
    """One forward pass, all layers + head, for n_tokens each seeing
    kv_len context (kv_len = S/2 average for causal training). ``batch``
    sizes the encoder pass for enc-dec archs (frontend_len frames per
    sequence)."""
    per_tok = 0.0
    for g in range(cfg.num_groups):
        for i, kind in enumerate(cfg.block_pattern):
            per_tok += _mixer_flops_per_tok(cfg, kind, kv_len)
            if kind != "rwkv":
                per_tok += _ffn_flops_per_tok(cfg, i)
    per_tok += 2.0 * cfg.d_model * cfg.vocab_size  # head
    total = per_tok * n_tokens
    if cfg.has_encoder:
        # encoder runs once per sequence over frontend_len frames
        enc_per_tok = cfg.encoder_layers * (
            _attn_proj_flops_per_tok(cfg)
            + _attn_score_flops_per_tok(cfg, cfg.frontend_len)
            + 2.0 * 2 * cfg.d_model * cfg.d_ff
        )
        total += enc_per_tok * cfg.frontend_len * batch
        # cross attention for decoder tokens
        total += n_tokens * cfg.num_layers * (
            2.0 * cfg.d_model * cfg.q_dim * 2
            + _attn_score_flops_per_tok(cfg, cfg.frontend_len)
        )
    return total


_REMAT_FW = {"none": 0.0, "dots": 0.5, "full": 1.0}


def cell_flops(cfg: ModelConfig, kind: str, batch: int, seq: int,
               remat: str = "full") -> float:
    """Total HLO-equivalent FLOPs of one step of the cell."""
    if kind == "train":
        fw = forward_flops(cfg, batch * seq, kv_len=seq / 2, batch=batch)
        return fw * (3.0 + _REMAT_FW.get(remat, 1.0))  # fw + 2x bw + remat
    if kind == "prefill":
        return forward_flops(cfg, batch * seq, kv_len=seq / 2, batch=batch)
    # decode: one token per sequence, attending over the full cache;
    # enc-dec archs re-read only the cross cache (encoder already ran)
    return forward_flops(cfg, batch * 1, kv_len=seq, batch=0.0)


def param_bytes(cfg: ModelConfig, n_params: int) -> float:
    return float(n_params) * 2.0  # bf16


def cell_hbm_bytes(cfg: ModelConfig, kind: str, batch: int, seq: int,
                   n_params: int, remat: str = "full",
                   opt_bytes_per_param: float = 8.0) -> float:
    """HBM traffic of one step (global, all chips): weight reads, optimizer
    update traffic, activation reads/writes, and (for decode) the KV/state
    cache sweep — the decode-dominant term."""
    pb = param_bytes(cfg, n_params)
    act_per_tok_layer = 12.0 * cfg.d_model * 2.0  # reads+writes, bf16
    n_attn = sum(1 for k in cfg.block_pattern if k == "attn") * cfg.num_groups
    if kind == "train":
        reads = pb * (2.0 + _REMAT_FW.get(remat, 1.0))  # fw + bw + remat
        grads = pb * 2.0
        opt = n_params * opt_bytes_per_param * 2.0 + pb * 2.0
        acts = act_per_tok_layer * cfg.num_layers * batch * seq * 2.0
        return reads + grads + opt + acts
    if kind == "prefill":
        return pb + act_per_tok_layer * cfg.num_layers * batch * seq
    # decode
    kv_bytes = 1.0 + 2.0 / 128 if cfg.kv_cache_dtype == "int8" else 2.0
    if cfg.attn_type == "mla":
        kv_per_tok_layer = (cfg.kv_lora_rank + cfg.qk_rope_dim) * kv_bytes
    else:
        kv_per_tok_layer = 2.0 * cfg.kv_dim * kv_bytes
    cache = kv_per_tok_layer * n_attn * batch * seq
    # SSM/RWKV states are O(1) per layer
    state = 0.0
    for kind_ in cfg.block_pattern:
        if kind_ == "mamba":
            state += cfg.d_inner * cfg.mamba_d_state * 4.0 * 2
        if kind_ == "rwkv":
            H = cfg.d_model // cfg.rwkv_head_dim
            state += H * cfg.rwkv_head_dim ** 2 * 4.0 * 2
    state *= cfg.num_groups * batch
    return pb + cache + state + act_per_tok_layer * cfg.num_layers * batch
