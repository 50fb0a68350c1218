"""Model assembly: embedding -> blocks -> head (counterpart of
:mod:`repro.models.transformer`), for the ``attn`` blocks (GQA or MLA
attention, then an MLP or, on the layers ``moe_every`` / ``moe_offset``
pick, an MoE) and the ``rwkv`` blocks (time mix + channel mix).

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
* :func:`decode_step` -- one token against the decode state made by
  :func:`init_decode_state`.
* :func:`prefill` -- fills the decode state from a prompt by one
  ``forward`` that writes each block's keys and values (MLA: the
  compressed ``c_kv`` and ``k_rope``), last mix inputs and final WKV
  state, and returns the last position's logits. The JAX ``prefill`` runs
  a full ``forward``, throws its logits away and fills the state by a scan
  of decode steps; :func:`prefill_stepwise` is that loop, kept as the
  oracle. A decode step's MoE routes B tokens with the capacity of B
  tokens, so the fill's MoE layers route each position's B tokens as a
  group of their own (``moe_apply(per_position=True)``): for an MoE arch
  the fill's last logits are the decode loop's, not ``forward``'s (whose
  capacity spans all B * S tokens, as the JAX ``forward``'s and the serve
  fns' ``prefill`` do).
* :func:`active_param_count`, :func:`model_flops` and
  :func:`active_param_count_shapes` -- the roofline's parameter and FLOP
  counts, routed experts counted ``top_k / n_experts``.

:func:`decode_step`, :func:`prefill` and the serve fns run under
``torch.inference_mode``.

Not ported yet (later slices): Mamba, the encoder and cross-attention,
the frontends (VLM ``extra_embeds``, audio frames) and the int8 KV cache;
each raises ``NotImplementedError``.
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

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run."""
    missing = []
    if any(kind not in ("attn", "rwkv") for kind in cfg.block_pattern):
        missing.append("Mamba blocks")
    if cfg.has_encoder:
        missing.append("the encoder and cross-attention")
    if cfg.frontend != "none":
        missing.append(f"the {cfg.frontend} frontend")
    if cfg.kv_cache_dtype != "bfloat16":
        missing.append(f"the {cfg.kv_cache_dtype} KV cache")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} come with a later slice of the port"
        )


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


def _init(cfg: ModelConfig, generator, dev):
    dt = L.param_dtype(cfg)
    params = {
        "embed": L.dense_init((cfg.vocab_size, cfg.d_model), dt, 1, generator, dev),
        "final_norm": L.norm_init(cfg, cfg.d_model, dev),
        "layers": [],
    }
    for layer, kind in enumerate(layer_kinds(cfg)):
        lp = {"ln1": L.norm_init(cfg, cfg.d_model, dev),
              "ln2": L.norm_init(cfg, cfg.d_model, dev),
              "mix": _mixer_init(cfg, generator, dev, kind)}
        if kind == "attn":
            lp["ffn"] = _ffn_init(cfg, generator, dev, layer % cfg.group_size)
        params["layers"].append(lp)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init((cfg.d_model, cfg.vocab_size), dt, 0,
                                         generator, dev)
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
def _embed(params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens].to(L.compute_dtype(cfg))
    return x * math.sqrt(cfg.d_model)


def _head(params, cfg: ModelConfig, x):
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
    (B, S, V), aux loss); the aux loss is 0 without MoE. ``remat``
    checkpoints each layer group for training (see the module's
    docstring)."""
    check_supported(cfg)
    if extra_embeds is not None or frames is not None:
        raise NotImplementedError(
            "VLM extra_embeds and audio frames come with a later slice of the port"
        )
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got {remat!r}")
    return _forward(params, cfg, tokens, remat=remat)


def _ffn(lp, h, cfg: ModelConfig, i: int, per_position: bool = False):
    """Block ``i``'s FFN over h: (out, the MoE aux loss or None for an MLP)."""
    if _is_moe_layer(cfg, i):
        return L.moe_apply(lp["ffn"], h, cfg, per_position=per_position)
    return L.mlp_apply(lp["ffn"], h, cfg), None


def _block(x, kind, lp, cfg: ModelConfig, rope, state=None, g=0, i=0):
    """One block over x (B, S, D): (x, aux loss or None); with ``state``,
    writes what the decode steps would leave there (see :func:`_forward`)
    and routes an MoE FFN position by position, as they do."""
    h = L.norm_apply(lp["ln1"], x, cfg)
    if kind == "attn":
        S = x.shape[1]
        if cfg.attn_type == "mla":
            a, (ckv, krope) = L.mla_apply(lp["mix"], h, cfg, rope)
            if state is not None:
                state[f"b{i}_ckv"][g, :, :S] = ckv
                state[f"b{i}_krope"][g, :, :S] = krope
        else:
            a, (k, v) = L.attn_apply(lp["mix"], h, cfg, rope)
            if state is not None:
                state[f"b{i}_k"][g, :, :S] = k
                state[f"b{i}_v"][g, :, :S] = v
        x = x + a
        f, aux = _ffn(lp, L.norm_apply(lp["ln2"], x, cfg), cfg, i,
                      per_position=state is not None)
        return x + f, aux
    t, (tm_x, wkv) = L.rwkv_time_mix(lp["mix"], h, cfg)
    x = x + t
    c, cm_x = L.rwkv_channel_mix(lp["mix"], L.norm_apply(lp["ln2"], x, cfg), cfg)
    if state is not None:
        state[f"b{i}_tm_x"][g] = tm_x
        state[f"b{i}_wkv"][g] = wkv
        state[f"b{i}_cm_x"][g] = cm_x
    return x + c, None


def _group(x, layers, cfg: ModelConfig, rope, state=None, g=0):
    """The blocks of layer group ``g`` (``cfg.block_pattern``) over x:
    (x, the group's aux loss summed, float32)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (kind, lp) in enumerate(zip(cfg.block_pattern, layers)):
        x, a = _block(x, kind, lp, cfg, rope, state, g, i)
        if a is not None:
            aux = aux + a
    return x, aux


def _forward(params, cfg: ModelConfig, tokens, state=None, remat: str = "none"):
    """The blocks over ``tokens`` (B, S); (logits (B, S, V), aux loss).
    With ``state`` (a decode state of at least S positions), each block
    also writes what the decode steps would leave there after the S
    tokens: the keys and values (MLA: ``c_kv`` and ``k_rope``) at
    positions 0 .. S-1, the time and channel mixes' last inputs and the
    final WKV state; its MoE layers then route position by position (the
    aux loss is then 0)."""
    x = _embed(params, cfg, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    rope = L.rope_tables(positions, cfg)
    n = cfg.group_size
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.num_groups):
        layers = params["layers"][g * n:(g + 1) * n]
        if remat == "none":
            x, a = _group(x, layers, cfg, rope, state, g)
        else:
            kw = ({"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                   _save_dots)} if remat == "dots" else {})
            x, a = checkpoint(_group, x, layers, cfg, rope, use_reentrant=False, **kw)
        aux = aux + a
    return _head(params, cfg, x), aux


# ------------------------------------------------------------------- decode
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int = 0, device=None):
    """Zeroed decode state in the JAX layout, stacked over groups on axis 0:
    ``b{i}_k`` / ``b{i}_v`` (G, B, max_len, KV, hd) for GQA blocks,
    ``b{i}_ckv`` (G, B, max_len, kv_lora_rank) and ``b{i}_krope``
    (G, B, max_len, qk_rope_dim) for MLA blocks, ``b{i}_tm_x`` /
    ``b{i}_cm_x`` (G, B, 1, D) and ``b{i}_wkv`` (G, B, H, hd, hd) float32
    for RWKV blocks."""
    check_supported(cfg)
    if enc_len:
        raise NotImplementedError("cross-attention state comes with a later slice")
    dev = resolve_device(device)
    G, dt = cfg.num_groups, L.compute_dtype(cfg)
    state = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "attn" and cfg.attn_type == "mla":
            state[f"b{i}_ckv"] = torch.zeros((G, batch, max_len, cfg.kv_lora_rank),
                                             dtype=dt, device=dev)
            state[f"b{i}_krope"] = torch.zeros((G, batch, max_len, cfg.qk_rope_dim),
                                               dtype=dt, device=dev)
        elif kind == "attn":
            shape = (G, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            state[f"b{i}_k"] = torch.zeros(shape, dtype=dt, device=dev)
            state[f"b{i}_v"] = torch.zeros(shape, dtype=dt, device=dev)
        else:
            H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
            state[f"b{i}_tm_x"] = torch.zeros((G, batch, 1, cfg.d_model), dtype=dt, device=dev)
            state[f"b{i}_wkv"] = torch.zeros((G, batch, H, hd, hd), dtype=torch.float32,
                                             device=dev)
            state[f"b{i}_cm_x"] = torch.zeros((G, batch, 1, cfg.d_model), dtype=dt, device=dev)
    return state


def decode_step(params, cfg: ModelConfig, state, token, cur_len: int):
    """One decode step. ``token`` (B, 1) int; ``cur_len`` (int) tokens are
    already in the state. Updates ``state`` in place (the JAX function
    returns a new one) and returns (logits (B, 1, V), state)."""
    check_supported(cfg)
    cur_len = int(cur_len)
    with torch.inference_mode():
        x = _embed(params, cfg, token)
        positions = torch.full(token.shape, cur_len, dtype=torch.int64, device=x.device)
        rope = L.rope_tables(positions, cfg)
        for layer, (kind, lp) in enumerate(zip(layer_kinds(cfg), params["layers"])):
            g, i = divmod(layer, cfg.group_size)
            h = L.norm_apply(lp["ln1"], x, cfg)
            if kind == "attn":
                if cfg.attn_type == "mla":
                    x = x + L.mla_decode(lp["mix"], h, cfg, state[f"b{i}_ckv"][g],
                                         state[f"b{i}_krope"][g], cur_len, rope)
                else:
                    x = x + L.attn_decode(lp["mix"], h, cfg, state[f"b{i}_k"][g],
                                          state[f"b{i}_v"][g], cur_len, rope)
                x = x + _ffn(lp, L.norm_apply(lp["ln2"], x, cfg), cfg, i)[0]
            else:
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
        logits = _head(params, cfg, x)
    return logits, state


def _check_prompt(tokens, extra_embeds, frames) -> None:
    if extra_embeds is not None or frames is not None:
        raise NotImplementedError(
            "VLM extra_embeds and audio frames come with a later slice of the port"
        )
    if tokens.shape[1] < 1:
        raise ValueError("prefill needs at least one prompt token")


def prefill(params, cfg: ModelConfig, tokens, state, extra_embeds=None, frames=None):
    """Fill ``state`` from the prompt ``tokens`` (B, S >= 1) by one forward
    (the flash-attention / WKV6 kernels on the card), which writes each
    block's keys, values, last mix inputs and final WKV state into it, its
    MoE layers routing position by position as decode steps do; returns
    (the last position's logits (B, 1, V), state). :func:`prefill_stepwise`
    is the same fill by S decode steps."""
    check_supported(cfg)
    _check_prompt(tokens, extra_embeds, frames)
    with torch.inference_mode():
        logits, _ = _forward(params, cfg, tokens, state=state)
    return logits[:, -1:], state


def prefill_stepwise(params, cfg: ModelConfig, tokens, state, extra_embeds=None,
                     frames=None):
    """The decode-loop fill: ``state`` from ``tokens`` (B, S >= 1) by S
    decode steps, as the JAX ``prefill`` scans them; returns (the last
    step's logits (B, 1, V), state). The oracle :func:`prefill` is held
    against; one decode step a token, so slow on long prompts."""
    _check_prompt(tokens, extra_embeds, frames)
    logits = None
    for t in range(tokens.shape[1]):
        logits, state = decode_step(params, cfg, state, tokens[:, t:t + 1], t)
    return logits, state
