"""Blockwise attention for prefill (and training-mode forward).

:func:`flash_attention` attends ``q`` (B, S, H, hd) over ``k``/``v``
(B, T, KV, hd) with grouped-query heads (query head ``h`` reads KV head
``h // (H // KV)``), an optional causal mask with right-aligned queries
(query ``s`` sits at key position ``s + T - S``) and a float32 softmax. On
a CUDA tensor it launches the hand-written Hopper kernel
``csrc/flash_attention.cu``, which replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` (``pallas_call`` at
``flash_attention.py:110``); on a CPU tensor it takes
:func:`flash_attention_plain`, which follows ``ref.attention``. There is no
fallback from one to the other.

A query row that sees no key (causal with ``S > T``) gives zeros in both
versions; ``ref.attention`` gives NaN there and the TPU kernel the mean of
V over the padded tile. The model never makes such a row (``S == T``).

Bound: operations (about 69 GFLOP a layer at Qwen3-1.7B's 4 x 2,048-token
prefill, 0.07 ms at the tensor cores' rate). The kernel has one design per
dtype, and the wrapper dispatches by dtype: bfloat16 (the model's path)
runs FlashAttention-2 on the tensor cores (``mma.sync`` m16n8k16, bf16 in
and float32 accumulate, P kept in registers, K/V tiles in a ``cp.async``
ring); float32 runs float32 FMAs without tensor cores, because TF32 would
not hold the float32 checks. The times are in ``PERF.md``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of ``ref.attention``: repeat KV heads for the
    query groups, float32 scores and softmax, right-aligned causal mask,
    cast to ``q``'s dtype. Rows with no visible key give zeros."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kx = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vx = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kx.float()) / math.sqrt(hd)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
        kpos = torch.arange(T, device=q.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)  # rows with every key masked
    o = torch.einsum("bhst,bthd->bshd", w, vx.float())
    return o.to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernel's vector loads
    need (a no-op for the model's operands)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"want q (B,S,H,hd) and k/v (B,T,KV,hd), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, H, hd = q.shape
    Bk, T, KV, hd_k = k.shape
    if Bk != B or hd_k != hd or KV == 0 or H % KV:
        raise ValueError(
            f"{H} query heads of size {hd} (batch {B}) over {KV} KV heads of "
            f"size {hd_k} (batch {Bk})"
        )
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k and v must share one of {list(_DTYPES)}, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    smem = _build.function("flash_attention", "flash_attention_smem_bytes",
                           [ctypes.c_int] * 2, ctypes.c_longlong)(_DTYPES[q.dtype], hd)
    if not 0 < smem <= _SMEM_LIMIT:
        raise ValueError(f"a block would need {smem} bytes of shared memory")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention", "flash_attention_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        *[ctypes.c_int] * 8, ctypes.c_float, ctypes.c_void_p,
    ])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, S, T, H, KV, hd, int(bool(causal)),
                1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention over full sequences.

    ``q`` (B, S, H, hd); ``k``, ``v`` (B, T, KV, hd) with ``H % KV == 0``;
    bfloat16 or float32 (one dtype for all three), ``hd`` in
    :data:`HEAD_DIMS` on the card. Returns (B, S, H, hd) in ``q``'s dtype.

    ``flash_attention.launches`` counts the CUDA kernel's launches; the CPU
    path never adds to it.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _launch(q, k, v, causal)


flash_attention.launches = 0
