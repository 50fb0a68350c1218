"""One-token decode attention over a paged KV cache, and over a model's
contiguous decode cache.

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

:func:`contiguous_decode_attention` launches the same kernel over a model's
decode cache (B, S_max, KV, hd) with no page table: sequence b is page b,
read in place through the cache's batch, token and head strides up to one
``valid_len`` for every sequence (``kernels/ops.py::decode_attention`` on
the card).

Bound: bytes (the valid tokens' K and V rows, read once). Each block walks
a run of consecutive positions of one (sequence, KV head) through a ring of
cp.async tiles with its softmax online in registers; :func:`pages_per_split`
sizes the runs (in pages, or in tiles of a contiguous cache): long, and
never fewer than fill the card once. A second kernel merges the runs'
float32 partials (m, l, o) by log-sum-exp.
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
# a block's run covers at least this many bytes of K and V where the
# context allows (2,048 positions of one bfloat16 KV head of 128)
MIN_RUN_BYTES = 1 << 20


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
                    blocks_per_sm: int, min_pages: int) -> int:
    """Pages of the table (or tiles of a contiguous cache) each block of the
    kernel walks: ``ppseq`` cut into equal runs of at least ``min_pages``
    where the table is long enough, and never into fewer runs than fill
    the card once with blocks of (batch, kv_heads, run) (``blocks_per_sm *
    sm_count`` at once; ``kv_heads`` counts a KV head's blocks of query
    heads), one a page where the table is shorter. A grid that fits the
    card in one go has no tail of long runs on a few SMs; past it, long
    runs keep a block's start and merge a small share of its time (the
    measurements are in ``PERF.md``)."""
    if ppseq <= 0:
        return 1
    fit = max(1, blocks_per_sm * sm_count // max(1, batch * kv_heads))
    splits = min(ppseq, max(fit, ppseq // max(1, min_pages)))
    return -(-ppseq // splits)


@functools.lru_cache(maxsize=None)
def _plan(dtype_code: int, hd: int, rep: int, device_index: int) -> tuple:
    """(tokens of a tile, blocks of query heads a KV head, split blocks an
    SM holds at once) of the kernel for these operands on this device."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        rc = _build.function("paged_attention", "paged_attention_plan", [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ])(dtype_code, hd, rep, ctypes.addressof(out))
    if rc != 0 or out[2] < 1:
        raise RuntimeError(f"paged_attention_plan failed: CUDA error {rc}, "
                           f"{out[2]} blocks an SM")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _launcher():
    return _build.function("paged_attention", "paged_attention_launch", [
        *[ctypes.c_void_p] * 7, *[ctypes.c_int] * 10,
        *[ctypes.c_longlong] * 10, ctypes.c_float, ctypes.c_void_p,
    ])


def card_pages_per_split(q, k, units: int, unit_tokens: int) -> int:
    """:func:`pages_per_split` for ``units`` pages (or tiles) of
    ``unit_tokens`` positions when ``q`` and K/V like ``k`` go through the
    kernel on ``q``'s card: its SM count, the kernel's occupancy there, and
    runs of at least ``MIN_RUN_BYTES`` of K and V."""
    B, H, hd = q.shape
    KV = k.shape[2]
    _, groups, per_sm = _plan(_DTYPES[q.dtype], hd, H // KV, q.device.index)
    unit_bytes = 2 * unit_tokens * hd * q.element_size()
    return pages_per_split(units, B, KV * groups, _build.sm_count(q.device.index), per_sm,
                           -(-MIN_RUN_BYTES // unit_bytes))


def _index_operand(t, dev):
    """``t`` as a contiguous int32 tensor on ``dev``."""
    if t.dtype != torch.int32 or not t.is_contiguous():
        t = t.to(torch.int32).contiguous()
    return _build.to_device(t, dev)


def _check(q, k, v, what: str):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"want q (B,H,hd) and k/v {what}, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, hd = q.shape
    KV, hd_k = k.shape[2], k.shape[3]
    if hd_k != hd or KV == 0 or H % KV:
        raise ValueError(f"{H} query heads of size {hd} over {KV} KV heads of size {hd_k}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k and v must share one of {list(_DTYPES)}, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dimension must be contiguous")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} not in {HEAD_DIMS}")


def _launch(q, k, v, table, lens, page_size: int, ppseq: int, valid_len: int):
    """Both modes' launch: paged with ``table`` and ``lens`` (device int32),
    contiguous with both None. Returns (out (B, H, hd), splits)."""
    B, H, hd = q.shape
    KV = k.shape[2]
    dev = q.device
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    if B == 0 or H == 0:
        return out, 0
    tile = _plan(_DTYPES[q.dtype], hd, H // KV, dev.index)[0]
    if table is None:
        unit, units = tile, -(-valid_len // tile)
    else:
        unit, units = page_size, ppseq
    per = card_pages_per_split(q, k, units, unit)
    n_splits = -(-units // per) if units else 1
    part = (torch.empty(B * H * n_splits * (hd + 2), dtype=torch.float32, device=dev)
            if n_splits > 1 else None)
    # A call is host-bound at serving shapes (about 10 us on the card against
    # tens of us of wrapper): enter the device context only where ``dev`` is
    # not current, and read the stream's raw handle without building a
    # Stream object.
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        rc = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if table is None else table.data_ptr(),
            None if lens is None else lens.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), _DTYPES[q.dtype],
            B, H, KV, hd, page_size, ppseq, valid_len, per * unit, n_splits,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), 1.0 / math.sqrt(hd), stream,
        )
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: CUDA error {rc}")
    return out, n_splits


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
    _check(q, k_pages, v_pages, "pages (P,page_size,KV,hd)")
    B = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != B or lengths.numel() != B:
        raise ValueError("page_table must be (B, ppseq) and lengths (B,)")
    # convert the index operands only where they are not contiguous int32
    # already
    table = _index_operand(page_table, q.device)
    lens = _index_operand(lengths if lengths.dim() == 1 else lengths.reshape(B), q.device)
    out, _ = _launch(q, k_pages, v_pages, table, lens, k_pages.shape[1],
                     page_table.shape[1], 0)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def contiguous_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, valid_len: int) -> tuple:
    """The kernel over a decode cache read in place, on the card.

    ``q`` (B, H, hd); ``k_cache`` / ``v_cache`` (B, S_max, KV, hd), any
    strides with the last dimension contiguous, of ``q``'s dtype (bfloat16
    or float32); the first ``valid_len`` positions of every sequence are
    attended. Returns ((B, H, hd) in ``q``'s dtype, the number of splits
    the positions were cut into). Raises for anything the kernel does not
    take; there is no CPU path (``ops.decode_attention`` has it)."""
    if q.device.type != "cuda":
        raise ValueError(f"contiguous_decode_attention runs on cuda, not {q.device}")
    _check(q, k_cache, v_cache, "caches (B,S_max,KV,hd)")
    if k_cache.shape[0] != q.shape[0]:
        raise ValueError(f"a cache of {k_cache.shape[0]} sequences for {q.shape[0]} queries")
    if not 0 <= valid_len <= k_cache.shape[1]:
        raise ValueError(f"valid_len {valid_len} outside a cache of {k_cache.shape[1]}")
    return _launch(q, k_cache, v_cache, None, None, 1, 0, int(valid_len))
