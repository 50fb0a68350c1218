"""One-token decode attention over a paged KV cache.

:func:`paged_decode_attention` attends each sequence's query heads over
the K/V pages its page table names (``-1`` marks a hole), masked to its
length, with grouped-query heads and a float32 softmax. On a CUDA tensor it
launches the hand-written Hopper kernel ``csrc/paged_attention.cu``, which
replaces the TPU kernel ``repro/kernels/paged_attention.py::
paged_decode_attention`` (``pallas_call`` at ``paged_attention.py:113``); on
a CPU tensor it takes :func:`paged_decode_attention_plain`, which follows
``ref.paged_decode_attention``. There is no fallback from one to the other.

A sequence with no valid token gives zeros, as the reference does; the TPU
kernel would give the mean of a masked page's V there.

The pools may be strided views (page, token and head strides, the head
dimension contiguous), so K and V of one layer group can be read straight
out of a serving pool whose pages hold every group.

Bound: bytes (the valid tokens' K and V rows, read once). The times are in
``PERF.md``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths):
    """Plain PyTorch version of ``ref.paged_decode_attention``: gather each
    sequence's pages, repeat KV heads for the query groups, masked float32
    softmax (all-masked rows give zeros), cast to ``q``'s dtype."""
    B, H, hd = q.shape
    _, page_size, KV, _ = k_pages.shape
    ppseq = page_table.shape[1]
    rep = H // KV
    table = page_table.to(device=k_pages.device, dtype=torch.int64)
    safe = table.clamp(min=0)
    k = k_pages[safe].reshape(B, ppseq * page_size, KV, hd)
    v = v_pages[safe].reshape(B, ppseq * page_size, KV, hd)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bhd,bthd->bht", q.float(), k.float()) / math.sqrt(hd)
    tpos = torch.arange(ppseq * page_size, device=q.device)[None, None, :]
    lens = lengths.to(device=q.device, dtype=torch.int64)
    valid = (tpos < lens[:, None, None]) & (
        (table >= 0).repeat_interleave(page_size, dim=1)[:, None, :]
    )
    scores = scores.masked_fill(~valid, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    w = torch.where(torch.isnan(w), torch.zeros_like(w), w)
    o = torch.einsum("bht,bthd->bhd", w, v.float())
    return o.to(q.dtype)


def _launch(q, k_pages, v_pages, page_table, lengths) -> torch.Tensor:
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"want q (B,H,hd) and k/v pages (P,page_size,KV,hd), got "
            f"{tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}"
        )
    B, H, hd = q.shape
    _, page_size, KV, hd_k = k_pages.shape
    if hd_k != hd or KV == 0 or H % KV:
        raise ValueError(f"{H} query heads of size {hd} over {KV} KV heads of size {hd_k}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(
            f"q, k and v must share one of {list(_DTYPES)}, got "
            f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}"
        )
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
    if page_table.dim() != 2 or page_table.shape[0] != B or lengths.numel() != B:
        raise ValueError("page_table must be (B, ppseq) and lengths (B,)")
    smem = _build.function(
        "paged_attention", "paged_attention_smem_bytes",
        [ctypes.c_int] * 3, ctypes.c_longlong,
    )(H // KV, hd, page_size)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a block would need {smem} bytes of shared memory")
    dev = q.device
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    if B == 0:
        return out
    table = _build.to_device(page_table.to(torch.int32).contiguous(), dev)
    lens = _build.to_device(lengths.reshape(B).to(torch.int32).contiguous(), dev)
    fn = _build.function("paged_attention", "paged_attention_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        *[ctypes.c_longlong] * 10, ctypes.c_float, ctypes.c_void_p,
    ])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), lens.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            B, H, KV, hd, page_size, page_table.shape[1],
            q.stride(0), q.stride(1),
            k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
            v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
            out.stride(0), out.stride(1), 1.0 / math.sqrt(hd), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"paged_decode_attention kernel launch failed: CUDA error {rc}"
        )
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over paged K/V.

    ``q`` (B, H, hd); ``k_pages`` / ``v_pages`` (P, page_size, KV, hd), any
    strides with the last dimension contiguous; ``page_table`` (B, ppseq)
    page ids (-1 = hole; ids of a CUDA table are not range-checked);
    ``lengths`` (B,) valid token counts. Returns (B, H, hd) in ``q``'s
    dtype (bfloat16 or float32 on the card).

    ``paged_decode_attention.launches`` counts the CUDA kernel's launches;
    the CPU path never adds to it.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    if page_table.device.type == "cpu" and page_table.numel() and (
        int(page_table.max()) >= k_pages.shape[0]
    ):
        raise IndexError(f"page_table names a page >= {k_pages.shape[0]}")
    return _launch(q, k_pages, v_pages, page_table, lengths)


paged_decode_attention.launches = 0
