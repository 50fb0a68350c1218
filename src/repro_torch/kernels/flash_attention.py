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
backward launches the hand-written kernels ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_bwd`): a dQ kernel, then a dK dV kernel, all five
products on the tensor cores in bfloat16 (float32 FMAs in float32).
:func:`flash_bwd_walk` mirrors the (query rows, key rows) pieces each of
them computes. The JAX package has no backward kernel: ``jax.grad`` through
its Pallas kernel raises and ``repro/kernels/ops.py`` trains through
``ref.attention`` (``ref.py:16``), whose gradient this is. Without a
gradient (serving) the forward kernel runs alone, as before.

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
# csrc/flash_attention_bwd.cu's bfloat16 kernels: warps a block (16 owned
# rows a warp) of the dQ and the dK dV kernel, and rows of the tiles each
# streams; _launch_bwd checks them against the library
BWD_DQ_WARPS = 4
BWD_DKDV_WARPS = 4
BWD_TILE = 64
BWD_KEY_STEP = 64  # keys the dQ kernel takes at a time from a streamed tile


def flash_bwd_walk(S: int, T: int, causal: bool, dq_warps: int = BWD_DQ_WARPS,
                   dkdv_warps: int = BWD_DKDV_WARPS, tile: int = BWD_TILE):
    """The pieces of one head's score matrix that the bfloat16 backward
    kernels compute, in launch order, as the kernels' index arithmetic
    walks them: ``{"dq": [...], "dkdv": [...]}``, each piece ``(q0, q1, k0,
    k1)``, query rows ``q0 .. q1 - 1`` against keys ``k0 .. k1 - 1`` (cut to
    ``S`` and ``T``). The dQ kernel's blocks (heaviest causal tiles first)
    own ``16 * dq_warps`` query rows, 16 a warp, and stream key tiles of
    ``tile`` keys, ``BWD_KEY_STEP`` at a time; the dK dV kernel's own ``16 *
    dkdv_warps`` keys and stream query tiles. A warp skips a step or tile
    none of whose valid rows sees any of its keys."""
    off = T - S
    dq, dkdv = [], []
    own = 16 * dq_warps
    blocks = -(-S // own)
    for bx in range(blocks):
        q0 = (blocks - 1 - bx) * own
        kend = min(T, q0 + own + off) if causal else T
        for kt in range(-(-kend // tile) if kend > 0 else 0):
            for w in range(dq_warps):
                wq0 = q0 + 16 * w
                qlast = min(wq0 + 16, S) - 1 + off
                for k0 in range(kt * tile, (kt + 1) * tile, BWD_KEY_STEP):
                    if wq0 < S and k0 < T and (not causal or k0 <= qlast):
                        dq.append((wq0, min(wq0 + 16, S), k0, min(k0 + BWD_KEY_STEP, T)))
    own = 16 * dkdv_warps
    n_q = -(-S // tile)
    for bx in range(-(-T // own)):
        k0 = bx * own
        first = max(0, k0 - off) // tile if causal else 0
        for qt in range(first, n_q):
            q0 = qt * tile
            qlast = min(q0 + tile, S) - 1 + off
            for w in range(dkdv_warps):
                kw0 = k0 + 16 * w
                if kw0 < T and (not causal or kw0 <= qlast):
                    dkdv.append((q0, min(q0 + tile, S), kw0, min(kw0 + 16, T)))
    return {"dq": dq, "dkdv": dkdv}


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
    lib = _build.load("flash_attention_bwd")
    geometry = (lib.flash_attention_bwd_tile(), lib.flash_attention_bwd_key_step(),
                lib.flash_attention_bwd_dq_warps(), lib.flash_attention_bwd_dkdv_warps())
    mine = (BWD_TILE, BWD_KEY_STEP, BWD_DQ_WARPS, BWD_DKDV_WARPS)
    if geometry != mine:
        raise RuntimeError(f"csrc/flash_attention_bwd.cu has (tile, key step, dq warps, dkdv "
                           f"warps) {geometry}, this module {mine}")
    smem = _build.function("flash_attention_bwd", "flash_attention_bwd_smem_bytes",
                           [ctypes.c_int] * 2, ctypes.c_longlong)(_DTYPES[q.dtype], hd)
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
    a CUDA tensor it launches ``csrc/flash_attention_bwd.cu``: in bfloat16
    every product on the tensor cores (bf16 in, float32 accumulate, P and dS
    rounded to bf16 as the products' inputs), in float32 float32 FMAs; no
    atomics (every call gives the same bits). On a CPU tensor it takes
    :func:`flash_attention_bwd_plain` (``out`` and ``lse`` unused).
    ``flash_attention_bwd.launches`` counts the CUDA launches.

    Bound: operations, 2.5 times the forward's: 10 flops per (query, key,
    hd) pair seen (the kernels do 14)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {q.device}")
    return _launch_bwd(q, k, v, out, lse, dout, causal)


flash_attention_bwd.launches = 0


def flash_bwd_kernel_launches() -> dict:
    """Launches of each of ``csrc/flash_attention_bwd.cu``'s four kernels
    since its library was loaded, by ``__global__`` name, as the library
    counts them where it launches them: float32 runs the ``_fma_kernel``
    pair, bfloat16 the ``_mma_kernel`` pair. Builds the library on first
    use, so it needs ``nvcc``."""
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd_kernel_launches",
                         [ctypes.c_int] * 2, ctypes.c_longlong)
    return {f"flash_bwd_{kernel}_{route}_kernel": fn(dtype, which)
            for route, dtype in (("fma", 0), ("mma", 1))
            for kernel, which in (("dq", 0), ("dkdv", 1))}


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
