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

Gradients: on a CPU tensor autograd differentiates the plain version. On a
CUDA tensor that needs a gradient, :class:`FlashAttention` launches the
forward kernel, which then also writes each row's log-sum-exp, and its
backward launches the hand-written kernel ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_bwd`). The JAX package has no backward kernel:
``jax.grad`` through its Pallas kernel raises and ``repro/kernels/ops.py``
trains through ``ref.attention`` (``ref.py:16``), whose gradient this is.
Without a gradient (serving) the forward kernel runs alone, as before.

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


def flash_attention_bwd_plain(q, k, v, dout, causal: bool = True):
    """(dq, dk, dv): autograd of :func:`flash_attention_plain` at ``dout``,
    each in its input's dtype (dk and dv summed over each KV head's query
    group, as the repeat's gradient sums them)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal=causal)
        return torch.autograd.grad(out, leaves, dout)


def _check(q, k, v) -> None:
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


def _launch(q, k, v, causal: bool, with_lse: bool = False):
    """The forward kernel: ``(out, lse)``, lse None unless ``with_lse``
    (then (B, H, S) float32, each row's log-sum-exp of its scores times
    ``log2(e) / sqrt(hd)``, +inf for a row that sees no key)."""
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    smem = _build.function("flash_attention", "flash_attention_smem_bytes",
                           [ctypes.c_int] * 2, ctypes.c_longlong)(_DTYPES[q.dtype], hd)
    if not 0 < smem <= _SMEM_LIMIT:
        raise ValueError(f"a block would need {smem} bytes of shared memory")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    fn = _build.function("flash_attention", "flash_attention_launch", [
        *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 8, ctypes.c_float, ctypes.c_void_p,
    ])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                _DTYPES[q.dtype], B, S, T, H, KV, hd, int(bool(causal)),
                1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out, lse


def _launch_bwd(q, k, v, out, lse, dout, causal: bool):
    _check(q, k, v)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (B, H, S):
        raise ValueError(
            f"want out and dout like q {tuple(q.shape)} and lse {(B, H, S)}, got "
            f"{tuple(out.shape)}, {tuple(dout.shape)}, {tuple(lse.shape)}"
        )
    if lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32, got {lse.dtype}")
    smem = _build.function("flash_attention_bwd", "flash_attention_bwd_smem_bytes",
                           [ctypes.c_int], ctypes.c_longlong)(hd)
    if not 0 < smem <= _SMEM_LIMIT:
        raise ValueError(f"a backward block would need {smem} bytes of shared memory")
    q, k, v, out, dout, lse = map(_aligned, (q, k, v, out, dout.to(q.dtype), lse))
    for name, t in (("out", out), ("dout", dout), ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd_launch", [
        *[ctypes.c_void_p] * 10, *[ctypes.c_int] * 8, ctypes.c_float, ctypes.c_void_p,
    ])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), _DTYPES[q.dtype], B, S, T, H, KV, hd, int(bool(causal)),
                1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True):
    """(dq, dk, dv) of :func:`flash_attention` at ``dout``, from the
    forward's ``out`` and ``lse`` (what :class:`FlashAttention` keeps). On
    a CUDA tensor it launches ``csrc/flash_attention_bwd.cu``: float32
    arithmetic whatever the input dtype, no atomics (every call gives the
    same bits); on a CPU tensor it takes :func:`flash_attention_bwd_plain`
    (``out`` and ``lse`` unused). ``flash_attention_bwd.launches`` counts
    the CUDA launches.

    Bound: operations, 2.5 times the forward's: 10 flops per (query, key,
    hd) pair seen (the kernels do 14)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {q.device}")
    return _launch_bwd(q, k, v, out, lse, dout, causal)


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """The forward kernel (writing each row's log-sum-exp) and, for the
    gradient, the backward kernel, on CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _launch(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention over full sequences.

    ``q`` (B, S, H, hd); ``k``, ``v`` (B, T, KV, hd) with ``H % KV == 0``;
    bfloat16 or float32 (one dtype for all three), ``hd`` in
    :data:`HEAD_DIMS` on the card. Returns (B, S, H, hd) in ``q``'s dtype.

    ``flash_attention.launches`` counts the CUDA kernel's launches; the CPU
    path never adds to it. Where autograd records (grad mode on and an
    input that requires a gradient) the CUDA path goes through
    :class:`FlashAttention`, whose backward is the backward kernel.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    return _launch(q, k, v, causal)[0]


flash_attention.launches = 0
