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

Bound: bytes (the valid tokens' K and V rows, read once). At serving
shapes that is microseconds, so the kernel splits each sequence's page list
into runs of :func:`pages_per_split` pages, one block per (sequence, KV
head, split) with every load issued up front, and a second kernel merges
the splits' float32 partials (m, l, o) by log-sum-exp.
:func:`paged_decode_attention_split_plain` is that split-and-merge in plain
PyTorch, for the tests; nothing on the serving path calls it. The times are
in ``PERF.md``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
# split blocks the grid aims at on each SM: enough to keep every SM's loads
# in flight through the latency of one split
BLOCKS_PER_SM = 4


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


def paged_decode_attention_split_plain(q, k_pages, v_pages, page_table, lengths,
                                       pages_per_split: int):
    """The kernel's split-and-merge in plain PyTorch: each run of
    ``pages_per_split`` pages of the table gives a float32 partial (m, l,
    o) -- the split's max score, its sum of exp(score - m) and its
    unnormalised output; a split with no valid token has m = -inf, l = 0
    and o = 0 -- and the partials merge by log-sum-exp. A sequence with no
    valid token gives zeros. Same arguments and result as
    :func:`paged_decode_attention_plain`."""
    if pages_per_split < 1:
        raise ValueError(f"pages_per_split must be >= 1, got {pages_per_split}")
    B, H, hd = q.shape
    _, page_size, KV, _ = k_pages.shape
    ppseq = page_table.shape[1]
    rep = H // KV
    dev = k_pages.device
    table = page_table.to(device=dev, dtype=torch.int64)
    lens = lengths.to(device=dev, dtype=torch.int64).reshape(B)
    if ppseq == 0:
        return torch.zeros_like(q)
    qf = q.float().reshape(B, KV, rep, hd)
    ms, ls, os = [], [], []
    for p0 in range(0, ppseq, pages_per_split):
        part = table[:, p0:p0 + pages_per_split]
        n = part.shape[1] * page_size
        k = k_pages[part.clamp(min=0)].reshape(B, n, KV, hd).float()
        v = v_pages[part.clamp(min=0)].reshape(B, n, KV, hd).float()
        s = torch.einsum("bgrd,btgd->bgrt", qf, k) / math.sqrt(hd)
        pos = p0 * page_size + torch.arange(n, device=dev)
        valid = (pos[None, :] < lens[:, None]) & (
            part >= 0).repeat_interleave(page_size, dim=1)
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        m = s.amax(dim=-1)
        p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        os.append(torch.einsum("bgrt,btgd->bgrd", p, v))
    m, l, o = torch.stack(ms), torch.stack(ls), torch.stack(os)
    top = m.amax(dim=0)
    w = torch.exp(m - torch.where(torch.isinf(top), 0.0, top))  # 0 where m = -inf
    den = (w * l).sum(dim=0)
    num = (w[..., None] * o).sum(dim=0)
    out = torch.where(den[..., None] > 0, num / den.clamp(min=1e-30)[..., None], 0.0)
    return out.reshape(B, H, hd).to(q.dtype)


def pages_per_split(ppseq: int, batch: int, kv_heads: int, sm_count: int,
                    max_pages: int) -> int:
    """Pages of the table each block of the kernel takes: few enough that
    the grid of (batch, kv_heads, ceil(ppseq / pages)) blocks reaches
    ``BLOCKS_PER_SM`` blocks an SM, or one block a page where the table is
    shorter, and at most ``max_pages`` (what one block may stage in shared
    memory)."""
    if ppseq <= 0:
        return 1
    want = -(-BLOCKS_PER_SM * sm_count // max(1, batch * kv_heads))
    return max(1, min(ppseq // want, max_pages))


@functools.lru_cache(maxsize=None)
def _max_rows(dtype_code: int, rep: int, hd: int) -> int:
    return _build.function("paged_attention", "paged_attention_max_rows",
                           [ctypes.c_int] * 3)(dtype_code, rep, hd)


@functools.lru_cache(maxsize=None)
def _launcher():
    return _build.function("paged_attention", "paged_attention_launch", [
        *[ctypes.c_void_p] * 7, *[ctypes.c_int] * 8,
        *[ctypes.c_longlong] * 10, ctypes.c_float, ctypes.c_void_p,
    ])


def card_pages_per_split(q, k_pages, page_table) -> int:
    """The pages each block takes when these CUDA operands go through the
    kernel (:func:`pages_per_split` on this card's SM count and the kernel's
    shared-memory limit)."""
    B, H, hd = q.shape
    _, page_size, KV, _ = k_pages.shape
    max_pages = _max_rows(_DTYPES[q.dtype], H // KV, hd) // page_size
    if max_pages < 1:
        raise ValueError(f"a page of {page_size} tokens does not fit a block's "
                         "shared memory")
    return pages_per_split(page_table.shape[1], B, KV, _build.sm_count(q.device.index),
                           max_pages)


def _index_operand(t, dev):
    """``t`` as a contiguous int32 tensor on ``dev``."""
    if t.dtype != torch.int32 or not t.is_contiguous():
        t = t.to(torch.int32).contiguous()
    return _build.to_device(t, dev)


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
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} not in {HEAD_DIMS}")
    dev = q.device
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    if B == 0 or H == 0:
        return out
    ppseq = page_table.shape[1]
    pps = card_pages_per_split(q, k_pages, page_table)
    n_splits = -(-ppseq // pps) if ppseq else 1
    part = (torch.empty(B * H * n_splits * (hd + 2), dtype=torch.float32, device=dev)
            if n_splits > 1 else None)
    # A call is host-bound at serving shapes (about 10 us on the card against
    # tens of us of wrapper): convert the index operands only where they are
    # not contiguous int32 already, enter the device context only where
    # ``dev`` is not current, and read the stream's raw handle without
    # building a Stream object.
    table = _index_operand(page_table, dev)
    lens = _index_operand(lengths if lengths.dim() == 1 else lengths.reshape(B), dev)
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        rc = _launcher()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), lens.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), _DTYPES[q.dtype],
            B, H, KV, hd, page_size, ppseq, pps,
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
