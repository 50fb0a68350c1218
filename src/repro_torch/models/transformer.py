"""Model assembly: embedding -> blocks -> head (counterpart of
:mod:`repro.models.transformer`), for the ``attn`` blocks (GQA or MLA
attention, then an MLP or, on the layers ``moe_every`` / ``moe_offset``
pick, an MoE), the ``mamba`` blocks (the selective SSM, then an MLP or an
MoE likewise: Jamba's group is one ``attn`` and seven ``mamba`` blocks)
and the ``rwkv`` blocks (time mix + channel mix), with an
encoder and cross-attention for an encoder-decoder arch (Whisper: frames
in, ``frames``) and a prefix of patch embeddings for a VLM (InternVL2:
``extra_embeds``); the frontends that would make those embeddings are
stubs, as in the JAX package.

The JAX package stacks each block group's parameters on a leading ``G``
axis and iterates with ``jax.lax.scan``; the port keeps one parameter dict
per layer (``params["layers"]``) and loops over them in Python. The decode
state keeps the JAX layout (``b{i}_k`` etc., stacked over groups) and is
updated in place.

* :func:`forward` -- full sequence (training and prefill), through the
  flash-attention and WKV6 kernels; returns (logits, aux loss: the MoE
  layers' Switch losses summed, 0 without MoE). Autograd
  differentiates it (the kernels' backward are kernels too), with
  ``remat`` in ``none`` | ``full`` | ``dots``: activation checkpointing of
  each layer group, as ``jax.checkpoint`` of the scanned group does in the
  JAX package. ``full`` keeps only the group's input and recomputes the
  rest in the backward (``torch.utils.checkpoint``, non-reentrant);
  ``dots`` keeps the matrix products' outputs as well (a selective
  checkpoint saving ``aten.mm``, ``aten.bmm`` and ``aten.addmm``).
* :func:`encode` -- the encoder over frame embeddings (B, T, D): a learned
  ``pos_embed`` added, non-causal self-attention layers at RoPE positions
  (the JAX config's noted deviation from Whisper, kept), the final norm.
  Its output feeds each decoder layer's cross-attention
  (:func:`cross_state` writes those keys and values into a decode state).
* :func:`decode_step` -- one token against the decode state made by
  :func:`init_decode_state` (with ``kv_cache_dtype == "int8"`` the GQA
  caches hold int8 values and bfloat16 scales ``b{i}_ks`` / ``b{i}_vs``;
  an encoder arch's ``b{i}_xk`` / ``b{i}_xv`` hold the cross keys and
  values; a Mamba block's ``b{i}_conv`` / ``b{i}_ssm`` its last conv
  inputs and its SSM state).
* :func:`prefill` -- fills the decode state from a prompt by one
  ``forward`` that writes each block's keys and values (MLA: the
  compressed ``c_kv`` and ``k_rope``), last mix inputs and final WKV
  state, each Mamba block's last conv inputs and final SSM state (its scan
  runs in chunks over the sequence, ``layers.MAMBA_CHUNK``), and returns
  the last position's logits. The JAX ``prefill`` runs
  a full ``forward``, throws its logits away and fills the state by a scan
  of decode steps; :func:`prefill_stepwise` is that loop, kept as the
  oracle. A decode step's MoE routes B tokens with the capacity of B
  tokens, so the fill's MoE layers route each position's B tokens as a
  group of their own (``moe_apply(per_position=True)``): for an MoE arch
  the fill's last logits are the decode loop's, not ``forward``'s (whose
  capacity spans all B * S tokens, as the JAX ``forward``'s and the serve
  fns' ``prefill`` do). Likewise the fill's attention reads an int8
  cache's keys and values quantized and dequantized, as decode steps do,
  so its last logits are the decode loop's. Two more choices, where the
  JAX ``prefill`` leaves its caches short of what ``forward`` computed
  (``ROADMAP.md`` Queue 3): given ``frames``, the fill writes the cross
  state from the encoder (the JAX ``prefill`` keeps the caller's, zeros
  from ``init_decode_state``); given ``extra_embeds``, it writes all P + S
  positions, the P prefix embeddings first, so decoding goes on at
  ``cur_len = P + S`` and the fill's last logits are ``forward``'s (the
  JAX ``prefill`` steps over the S tokens alone, at positions 0 .. S-1;
  :func:`prefill_stepwise` keeps that).
* :func:`active_param_count`, :func:`model_flops` and
  :func:`active_param_count_shapes` -- the roofline's parameter and FLOP
  counts, routed experts counted ``top_k / n_experts``.

:func:`decode_step`, :func:`prefill` and the serve fns run under
``torch.inference_mode``.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


BLOCK_KINDS = ("attn", "mamba", "rwkv")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block kind the model does not know (the
    JAX ``_mixer_init`` raises it at init); every kind of the JAX package
    runs."""
    unknown = [kind for kind in cfg.block_pattern if kind not in BLOCK_KINDS]
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {unknown}; known: {BLOCK_KINDS}")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The block kind of each layer, in order."""
    return [cfg.block_pattern[i % cfg.group_size] for i in range(cfg.num_layers)]


def _is_moe_layer(cfg: ModelConfig, pos_in_group: int) -> bool:
    """Whether block ``pos_in_group`` of each group has an MoE FFN."""
    if cfg.n_experts <= 0:
        return False
    if cfg.group_size % cfg.moe_every:
        raise ValueError("moe_every must divide the block-pattern length")
    return pos_in_group % cfg.moe_every == cfg.moe_offset


def _ffn_init(cfg: ModelConfig, generator, dev, pos: int):
    if _is_moe_layer(cfg, pos):
        return L.moe_init(cfg, generator, dev)
    return L.mlp_init(cfg, generator, dev)


def _mixer_init(cfg: ModelConfig, generator, dev, kind: str):
    if kind == "attn":
        if cfg.attn_type == "mla":
            return L.mla_init(cfg, generator, dev)
        return L.attn_init(cfg, generator, dev)
    if kind == "mamba":
        return L.mamba_init(cfg, generator, dev)
    return L.rwkv_init(cfg, generator, dev)


# ------------------------------------------------------------------- params
def init_model(cfg: ModelConfig, *, generator: torch.Generator, device=None):
    """Random weights drawn from ``generator`` (on ``device``; ``None``
    means the card), with the JAX package's scales: normal / sqrt(fan_in)
    for dense weights, ones and zeros for norms, the RWKV6 constants."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, weights go to {dev}")
    return _init(cfg, generator, dev)


def param_shapes(cfg: ModelConfig):
    """The parameter tree of :func:`init_model` as meta tensors: shapes and
    dtypes, no memory and no draws."""
    check_supported(cfg)
    return _init(cfg, torch.Generator(), torch.device("meta"))


def _layer_init(cfg: ModelConfig, generator, dev, kind: str, pos: int, cross: bool):
    """One layer's parameters: ``ln1``, ``mix``, ``ln2``, ``ffn`` (not for
    RWKV, whose channel mix is in ``mix``) and, for a decoder ``attn``
    layer of an encoder arch, the
    cross-attention's ``lnx`` and ``xattn`` (the JAX ``b{i}_lnx`` /
    ``b{i}_xattn``)."""
    lp = {"ln1": L.norm_init(cfg, cfg.d_model, dev),
          "ln2": L.norm_init(cfg, cfg.d_model, dev),
          "mix": _mixer_init(cfg, generator, dev, kind)}
    if kind != "rwkv":
        lp["ffn"] = _ffn_init(cfg, generator, dev, pos)
    if kind == "attn" and cross:
        lp["lnx"] = L.norm_init(cfg, cfg.d_model, dev)
        lp["xattn"] = L.attn_init(cfg, generator, dev)
    return lp


def _init(cfg: ModelConfig, generator, dev):
    dt = L.param_dtype(cfg)
    params = {
        "embed": L.dense_init((cfg.vocab_size, cfg.d_model), dt, 1, generator, dev),
        "final_norm": L.norm_init(cfg, cfg.d_model, dev),
        "layers": [_layer_init(cfg, generator, dev, kind, layer % cfg.group_size,
                               cfg.has_encoder)
                   for layer, kind in enumerate(layer_kinds(cfg))],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init((cfg.d_model, cfg.vocab_size), dt, 0,
                                         generator, dev)
    if cfg.has_encoder:
        # the JAX package's encoder: one "attn" block a layer, with an MLP
        params["encoder"] = {
            "layers": [_layer_init(cfg, generator, dev, "attn", 0, False)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": L.norm_init(cfg, cfg.d_model, dev),
            "pos_embed": L.dense_init((max(cfg.frontend_len, 8), cfg.d_model), dt, 1,
                                      generator, dev),
        }
    return params


def _named_leaves(tree, prefix=""):
    """(path, tensor) of every leaf, the path's keys joined by '/'."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def param_count(params) -> int:
    return sum(t.numel() for _, t in _named_leaves(params))


def active_param_count(params, cfg: ModelConfig) -> int:
    """Parameters touched per token (routed experts counted top_k/E)."""
    total = 0
    for path, t in _named_leaves(params):
        if cfg.n_experts and any(s in path for s in ("we1", "we2", "we3")):
            total += int(t.numel() * cfg.top_k / cfg.n_experts)
        else:
            total += t.numel()
    return total


def model_flops(params, cfg: ModelConfig, n_tokens: int) -> float:
    """MODEL_FLOPS = 6 * N_active * D (the roofline's 'useful' flops)."""
    return 6.0 * active_param_count(params, cfg) * n_tokens


def active_param_count_shapes(cfg: ModelConfig) -> int:
    """Active params from :func:`param_shapes` (meta tensors, no memory)."""
    return active_param_count(param_shapes(cfg), cfg)


# ------------------------------------------------------------------ forward
def _embed(params, cfg: ModelConfig, tokens, extra_embeds=None):
    """The tokens' embeddings times sqrt(D), after ``extra_embeds`` (B, P,
    D), which are prepended unscaled."""
    with obs.span("rt.embed"):
        x = params["embed"][tokens].to(L.compute_dtype(cfg))
        x = x * math.sqrt(cfg.d_model)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        return x


def _head(params, cfg: ModelConfig, x):
    with obs.span("rt.head"):
        x = L.norm_apply(params["final_norm"], x, cfg)
        if cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["lm_head"]


REMAT_POLICIES = ("none", "full", "dots")
# the matrix products whose outputs remat="dots" keeps (JAX's
# dots_with_no_batch_dims_saveable keeps dot_general outputs)
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                  torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def forward(params, cfg: ModelConfig, tokens, extra_embeds=None, frames=None,
            remat: str = "none"):
    """Full-sequence forward over ``tokens`` (B, S). Returns (logits
    (B, S, V), aux loss); the aux loss is 0 without MoE.

    ``extra_embeds`` -- VLM patch embeddings (B, P, D) prepended to the
    sequence; their positions' logits are dropped. ``frames`` -- the
    encoder's frame embeddings (B, T, D), required by an encoder arch.
    ``remat`` checkpoints each layer group for training (see the module's
    docstring)."""
    check_supported(cfg)
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {remat!r}")
    logits, aux = _forward(params, cfg, tokens, remat=remat, extra_embeds=extra_embeds,
                           frames=frames)
    if extra_embeds is not None:
        logits = logits[:, extra_embeds.shape[1]:]
    return logits, aux


def encode(params, cfg: ModelConfig, frames):
    """The encoder over ``frames`` (B, T, D), T at most ``max(frontend_len,
    8)``: ``pos_embed[:T]`` added, then each layer's non-causal
    self-attention at RoPE positions 0 .. T-1 (through ``ops.attention``,
    the flash-attention kernel on the card) and MLP, then the final norm
    (the JAX ``encode``)."""
    check_supported(cfg)
    enc = params["encoder"]
    B, T, _ = frames.shape
    x = frames.to(L.compute_dtype(cfg))
    x = x + enc["pos_embed"][None, :T].to(x.dtype)
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    rope = L.rope_tables(positions, cfg)
    for lp in enc["layers"]:
        a, _ = L.attn_apply(lp["mix"], L.norm_apply(lp["ln1"], x, cfg), cfg, rope,
                            causal=False)
        x = x + a
        x = x + L.mlp_apply(lp["ffn"], L.norm_apply(lp["ln2"], x, cfg), cfg)
    return L.norm_apply(enc["final_norm"], x, cfg)


def _cross_kv(params, cfg: ModelConfig, enc_out):
    """Each layer group's cross-attention keys and values from the
    encoder's output: a list of G pairs (B, T, KVH, hd). As in the JAX
    ``_cross_kv``, a group's pair comes from its block 0's ``xattn`` and
    serves every ``attn`` block of the group."""
    n = cfg.group_size
    return [L.cross_kv(params["layers"][g * n]["xattn"], enc_out, cfg)
            for g in range(cfg.num_groups)]


def _write_cross(state, cfg: ModelConfig, cross) -> None:
    for g, (ck, cv) in enumerate(cross):
        for i, kind in enumerate(cfg.block_pattern):
            if kind == "attn":
                state[f"b{i}_xk"][g] = ck
                state[f"b{i}_xv"][g] = cv


def cross_state(params, cfg: ModelConfig, state, frames):
    """Write into ``state`` (from :func:`init_decode_state` with ``enc_len =
    T``) the cross-attention keys and values of ``frames`` (B, T, D): the
    JAX ``_cross_kv(encode(frames))`` in the ``b{i}_xk`` / ``b{i}_xv``
    layout. The JAX package never fills them (its ``init_decode_state``
    zeroes them and its ``prefill`` keeps them); :func:`prefill` and
    :func:`prefill_stepwise` call this. Returns ``state``."""
    with torch.inference_mode():
        _write_cross(state, cfg, _cross_kv(params, cfg, encode(params, cfg, frames)))
    return state


def _ffn(lp, h, cfg: ModelConfig, i: int, per_position: bool = False):
    """Block ``i``'s FFN over h: (out, the MoE aux loss or None for an MLP)."""
    if _is_moe_layer(cfg, i):
        return L.moe_apply(lp["ffn"], h, cfg, per_position=per_position)
    return L.mlp_apply(lp["ffn"], h, cfg), None


def _block(x, kind, lp, cfg: ModelConfig, rope, state=None, g=0, i=0, cross=None):
    """One block over x (B, S, D): (x, aux loss or None); with ``state``,
    writes what the decode steps would leave there (see :func:`_forward`)
    and routes an MoE FFN position by position, as they do. ``cross``:
    the group's cross-attention keys and values, for an encoder arch."""
    h = L.norm_apply(lp["ln1"], x, cfg)
    if kind == "rwkv":
        t, (tm_x, wkv) = L.rwkv_time_mix(lp["mix"], h, cfg)
        x = x + t
        c, cm_x = L.rwkv_channel_mix(lp["mix"], L.norm_apply(lp["ln2"], x, cfg), cfg)
        if state is not None:
            state[f"b{i}_tm_x"][g] = tm_x
            state[f"b{i}_wkv"][g] = wkv
            state[f"b{i}_cm_x"][g] = cm_x
        return x + c, None
    if kind == "mamba":
        m, (conv, ssm) = L.mamba_apply(lp["mix"], h, cfg)
        if state is not None:
            state[f"b{i}_conv"][g] = conv
            state[f"b{i}_ssm"][g] = ssm
        x = x + m
    else:
        S = x.shape[1]
        if cfg.attn_type == "mla":
            a, (ckv, krope) = L.mla_apply(lp["mix"], h, cfg, rope)
            if state is not None:
                state[f"b{i}_ckv"][g, :, :S] = ckv
                state[f"b{i}_krope"][g, :, :S] = krope
        elif state is not None and cfg.kv_cache_dtype == "int8":
            a, cache = L.attn_apply_int8(lp["mix"], h, cfg, rope)
            for name, t in zip(("k", "ks", "v", "vs"), cache):
                state[f"b{i}_{name}"][g, :, :S] = t
        else:
            a, (k, v) = L.attn_apply(lp["mix"], h, cfg, rope)
            if state is not None:
                state[f"b{i}_k"][g, :, :S] = k
                state[f"b{i}_v"][g, :, :S] = v
        x = x + a
        if cross is not None:
            x = x + L.cross_attn_apply(lp["xattn"], L.norm_apply(lp["lnx"], x, cfg),
                                       *cross, cfg)
    f, aux = _ffn(lp, L.norm_apply(lp["ln2"], x, cfg), cfg, i,
                  per_position=state is not None)
    return x + f, aux


def _group(x, layers, cfg: ModelConfig, rope, state=None, g=0, cross=None):
    """The blocks of layer group ``g`` (``cfg.block_pattern``) over x:
    (x, the group's aux loss summed, float32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (kind, lp) in enumerate(zip(cfg.block_pattern, layers)):
        x, a = _block(x, kind, lp, cfg, rope, state, g, i, cross)
        if a is not None:
            aux = aux + a
    return x, aux


def _forward(params, cfg: ModelConfig, tokens, state=None, remat: str = "none",
             extra_embeds=None, frames=None):
    """The blocks over ``extra_embeds`` (if any, P positions) then
    ``tokens`` (B, S); (logits (B, P + S, V), aux loss). With ``state`` (a
    decode state of at least P + S positions), each block also writes what
    the decode steps would leave there after the P + S positions: the keys
    and values (MLA: ``c_kv`` and ``k_rope``; int8: quantized with their
    scales) at positions 0 .. P+S-1, the time and channel mixes' last
    inputs and the final WKV state, a Mamba block's last conv inputs and
    final SSM state, and, for an encoder arch, the cross
    keys and values of ``frames``; its MoE layers then route position by
    position (the aux loss is then 0), and with an int8 cache its
    attention reads the keys and values quantized, as the decode steps
    read their cache."""
    x = _embed(params, cfg, tokens, extra_embeds)
    B, S, _ = x.shape
    cross = [None] * cfg.num_groups
    if cfg.has_encoder:
        if frames is None:
            raise ValueError("enc-dec model requires frames")
        cross = _cross_kv(params, cfg, encode(params, cfg, frames))
        if state is not None:
            _write_cross(state, cfg, cross)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    rope = L.rope_tables(positions, cfg)
    n = cfg.group_size
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.num_groups):
        layers = params["layers"][g * n:(g + 1) * n]
        if remat == "none":
            x, a = _group(x, layers, cfg, rope, state, g, cross[g])
        else:
            kw = ({"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                   _save_dots)} if remat == "dots" else {})
            x, a = checkpoint(_group, x, layers, cfg, rope, cross=cross[g],
                              use_reentrant=False, **kw)
        aux = aux + a
    return _head(params, cfg, x), aux


# ------------------------------------------------------------------- decode
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int = 0, device=None):
    """Zeroed decode state in the JAX layout, stacked over groups on axis 0:
    ``b{i}_k`` / ``b{i}_v`` (G, B, max_len, KV, hd) for GQA blocks (int8
    with ``kv_cache_dtype == "int8"``, beside their bfloat16 scales
    ``b{i}_ks`` / ``b{i}_vs`` (G, B, max_len, KV, 1)), ``b{i}_ckv`` (G, B,
    max_len, kv_lora_rank) and ``b{i}_krope`` (G, B, max_len, qk_rope_dim)
    for MLA blocks, ``b{i}_conv`` (G, B, d_conv - 1, d_inner) in the
    compute dtype and ``b{i}_ssm`` (G, B, d_inner, d_state) float32 for
    Mamba blocks, ``b{i}_tm_x`` / ``b{i}_cm_x`` (G, B, 1, D) and
    ``b{i}_wkv`` (G, B, H, hd, hd) float32 for RWKV blocks; an encoder
    arch's ``attn`` blocks also get the cross keys and values ``b{i}_xk``
    / ``b{i}_xv`` (G, B, enc_len, KV, hd)."""
    check_supported(cfg)
    dev = resolve_device(device)
    G, dt = cfg.num_groups, L.compute_dtype(cfg)
    state = {}

    def zeros(name, shape, dtype=dt):
        state[name] = torch.zeros(shape, dtype=dtype, device=dev)

    for i, kind in enumerate(cfg.block_pattern):
        if kind == "attn" and cfg.attn_type == "mla":
            zeros(f"b{i}_ckv", (G, batch, max_len, cfg.kv_lora_rank))
            zeros(f"b{i}_krope", (G, batch, max_len, cfg.qk_rope_dim))
        elif kind == "attn":
            shape = (G, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            kv_dt = torch.int8 if cfg.kv_cache_dtype == "int8" else dt
            zeros(f"b{i}_k", shape, kv_dt)
            zeros(f"b{i}_v", shape, kv_dt)
            if cfg.kv_cache_dtype == "int8":
                zeros(f"b{i}_ks", shape[:-1] + (1,), torch.bfloat16)
                zeros(f"b{i}_vs", shape[:-1] + (1,), torch.bfloat16)
        elif kind == "mamba":
            zeros(f"b{i}_conv", (G, batch, cfg.mamba_d_conv - 1, cfg.d_inner))
            zeros(f"b{i}_ssm", (G, batch, cfg.d_inner, cfg.mamba_d_state), torch.float32)
        else:
            H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
            zeros(f"b{i}_tm_x", (G, batch, 1, cfg.d_model))
            zeros(f"b{i}_wkv", (G, batch, H, hd, hd), torch.float32)
            zeros(f"b{i}_cm_x", (G, batch, 1, cfg.d_model))
        if kind == "attn" and cfg.has_encoder:
            shape = (G, batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
            zeros(f"b{i}_xk", shape)
            zeros(f"b{i}_xv", shape)
    return state


def decode_step(params, cfg: ModelConfig, state, token, cur_len: int):
    """One decode step. ``token`` (B, 1) int; ``cur_len`` (int) tokens are
    already in the state. Updates ``state`` in place (the JAX function
    returns a new one) and returns (logits (B, 1, V), state). An encoder
    arch's layers attend over the cross state (``b{i}_xk`` / ``b{i}_xv``,
    all of it) after their self-attention, one query over T keys through
    ``ops.attention``."""
    check_supported(cfg)
    cur_len = int(cur_len)
    int8 = cfg.kv_cache_dtype == "int8"
    with torch.inference_mode(), obs.span("rt.decode.step"):
        x = _embed(params, cfg, token)
        positions = torch.full(token.shape, cur_len, dtype=torch.int64, device=x.device)
        rope = L.rope_tables(positions, cfg)
        for layer, (kind, lp) in enumerate(zip(layer_kinds(cfg), params["layers"])):
            g, i = divmod(layer, cfg.group_size)
            h = L.norm_apply(lp["ln1"], x, cfg)
            if kind == "rwkv":
                tm_x, wkv, cm_x = (state[f"b{i}_{n}"][g] for n in ("tm_x", "wkv", "cm_x"))
                t, (new_tm_x, new_wkv) = L.rwkv_time_mix(lp["mix"], h, cfg,
                                                         state=(tm_x, wkv))
                tm_x.copy_(new_tm_x)
                wkv.copy_(new_wkv)
                x = x + t
                c, new_cm_x = L.rwkv_channel_mix(lp["mix"], L.norm_apply(lp["ln2"], x, cfg),
                                                 cfg, prev=cm_x)
                cm_x.copy_(new_cm_x)
                x = x + c
                continue
            if kind == "mamba":
                conv, ssm = state[f"b{i}_conv"][g], state[f"b{i}_ssm"][g]
                m, (new_conv, new_ssm) = L.mamba_apply(lp["mix"], h, cfg, state=(conv, ssm))
                conv.copy_(new_conv)
                ssm.copy_(new_ssm)
                x = x + m
            else:
                if cfg.attn_type == "mla":
                    x = x + L.mla_decode(lp["mix"], h, cfg, state[f"b{i}_ckv"][g],
                                         state[f"b{i}_krope"][g], cur_len, rope)
                else:
                    scales = ((state[f"b{i}_ks"][g], state[f"b{i}_vs"][g]) if int8
                              else (None, None))
                    x = x + L.attn_decode(lp["mix"], h, cfg, state[f"b{i}_k"][g],
                                          state[f"b{i}_v"][g], cur_len, rope, *scales)
                if cfg.has_encoder:
                    x = x + L.cross_attn_apply(
                        lp["xattn"], L.norm_apply(lp["lnx"], x, cfg),
                        state[f"b{i}_xk"][g], state[f"b{i}_xv"][g], cfg)
            x = x + _ffn(lp, L.norm_apply(lp["ln2"], x, cfg), cfg, i)[0]
        logits = _head(params, cfg, x)
    return logits, state


def _check_prompt(cfg: ModelConfig, tokens, frames) -> None:
    if tokens.shape[1] < 1:
        raise ValueError("prefill needs at least one prompt token")
    if cfg.has_encoder and frames is None:
        raise ValueError("enc-dec model requires frames")


def prefill(params, cfg: ModelConfig, tokens, state, extra_embeds=None, frames=None):
    """Fill ``state`` from the prompt by one forward (the flash-attention /
    WKV6 kernels on the card), which writes each block's keys (int8 ones
    quantized), values, last mix inputs and final WKV state into it, its
    MoE layers routing position by position as decode steps do; returns
    (the last position's logits (B, 1, V), state).

    The prompt is ``extra_embeds`` (B, P, D), if given, then ``tokens`` (B,
    S >= 1): all P + S positions are written, so the next decode step is
    at ``cur_len = P + S`` and, without MoE or an int8 cache, the last
    logits are ``forward``'s last position (the JAX serve fns'
    ``prefill``). With an int8 cache, the fill's attention reads the keys
    and values quantized, as decode steps over the cache read them, so its
    last logits are the decode loop's, not ``forward``'s. An
    encoder arch needs ``frames`` (B, T, D), and the fill writes their
    cross keys and values (:func:`cross_state`) into the state. Both go
    past the JAX ``prefill`` (see the module's docstring).
    :func:`prefill_stepwise` is the same fill by S decode steps, where the
    prompt has no ``extra_embeds``."""
    check_supported(cfg)
    _check_prompt(cfg, tokens, frames)
    with torch.inference_mode(), obs.span("rt.prefill"):
        logits, _ = _forward(params, cfg, tokens, state=state, extra_embeds=extra_embeds,
                             frames=frames)
    return logits[:, -1:], state


def prefill_stepwise(params, cfg: ModelConfig, tokens, state, extra_embeds=None,
                     frames=None):
    """The decode-loop fill: ``state`` from ``tokens`` (B, S >= 1) by S
    decode steps at positions 0 .. S-1, as the JAX ``prefill`` scans them;
    returns (the last step's logits (B, 1, V), state). The oracle
    :func:`prefill` is held against; one decode step a token, so slow on
    long prompts. Given ``frames``, the cross state is written first
    (:func:`cross_state`), as the one-forward fill writes it; the
    ``extra_embeds`` are not stepped over, as in the JAX ``prefill``
    (whose scan covers the tokens alone), so with them this fill is not
    :func:`prefill`'s."""
    _check_prompt(cfg, tokens, frames)
    if cfg.has_encoder:
        cross_state(params, cfg, state, frames)
    logits = None
    for t in range(tokens.shape[1]):
        logits, state = decode_step(params, cfg, state, tokens[:, t:t + 1], t)
    return logits, state
