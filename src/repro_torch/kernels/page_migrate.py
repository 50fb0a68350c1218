"""Batched page migration between two page pools.

:func:`migrate_pages` copies page ``src_idx[i]`` of ``src_pool`` onto page
``dst_idx[i]`` of ``dst_pool``, in place, and leaves every other
destination page untouched: the tier-migration copy behind the tiered KV
cache (:mod:`repro_torch.serving.kv_cache`). On a CUDA operand it launches
the hand-written Hopper kernel ``csrc/page_migrate.cu``, which replaces the
TPU kernel ``repro/kernels/page_migrate.py::migrate_pages``
(``pallas_call`` at ``page_migrate.py:44``); when both pools lie on the CPU
it takes :func:`migrate_pages_plain`. There is no fallback from one to the
other.

One pool may be pinned host memory (``pin_memory=True``) while the other is
on the card: the kernel then reads or writes the host pool in place
through unified virtual addressing. Promotion (host pool -> HBM pool) and
demotion (HBM pool -> host pool) are each one launch, with no staging copy.

Bound: bytes. A page is read once and written once; across PCIe the link's
64 GB/s per direction (Gen5 x16) bounds a batch at
``n * page_bytes / 64 GB/s``, between two HBM pools the card's 3.35 TB/s
at ``2 * n * page_bytes / 3.35 TB/s``. The kernel cuts pages into chunks of
:data:`CHUNK_BYTES` and spreads the (page, chunk) items over a persistent
grid; :func:`copy_plan` is that work plan in plain Python and
:func:`migrate_pages_planned_plain` runs it in plain PyTorch. The times are
in ``PERF.md``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build

# The kernel's work plan (kChunk, kBlocksPerSm, kInline in the source)
CHUNK_BYTES = 8192  # bytes of a page one item copies
BLOCKS_PER_SM = 6  # persistent grid: at most this many blocks an SM
INLINE_PAGES = 256  # host page ids up to this many go in a kernel parameter


def migrate_pages_plain(dst_pool: torch.Tensor, src_pool: torch.Tensor,
                        dst_idx: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``dst_pool[dst_idx] = src_pool[src_idx]``
    (gather first, then scatter), in place; returns ``dst_pool``. Pools on
    two devices go through a staging copy of the gathered pages."""
    rows = src_pool.index_select(0, src_idx.to(src_pool.device))
    dst_pool.index_copy_(0, dst_idx.to(dst_pool.device), rows.to(dst_pool.device))
    return dst_pool


def copy_plan(n: int, page_bytes: int, sm_count: int,
              chunk_bytes: int = CHUNK_BYTES,
              blocks_per_sm: int = BLOCKS_PER_SM) -> list[list[tuple[int, int, int]]]:
    """The kernel's work plan for ``n`` pages of ``page_bytes``: each page
    cut into chunks of ``chunk_bytes`` (the last one short), item
    ``k = i * chunks_per_page + c`` is chunk ``c`` of the ``i``-th named
    page, and block ``b`` of a grid of ``min(items, blocks_per_sm *
    sm_count)`` blocks takes items ``b, b + grid, b + 2 grid, ...``.
    Returns, for each block, its ``(i, begin, end)`` byte ranges in order."""
    if chunk_bytes < 1 or blocks_per_sm < 1:
        raise ValueError("chunk_bytes and blocks_per_sm must be >= 1")
    per_page = -(-page_bytes // chunk_bytes)
    items = n * per_page
    grid = min(items, blocks_per_sm * max(sm_count, 1))
    plan = [[] for _ in range(grid)]
    for item in range(items):
        i, c = divmod(item, per_page)
        begin = c * chunk_bytes
        plan[item % grid].append((i, begin, min(begin + chunk_bytes, page_bytes)))
    return plan


def migrate_pages_planned_plain(dst_pool: torch.Tensor, src_pool: torch.Tensor,
                                dst_idx, src_idx, sm_count: int,
                                chunk_bytes: int = CHUNK_BYTES,
                                blocks_per_sm: int = BLOCKS_PER_SM) -> torch.Tensor:
    """The kernel's decomposition in plain PyTorch: :func:`copy_plan`'s
    byte ranges copied block by block between the pools' raw bytes, in
    place; returns ``dst_pool``. Equal to :func:`migrate_pages_plain` for
    distinct destination pages. Both pools on the CPU."""
    di = _indices(dst_idx, dst_pool.shape[0], "dst_idx").tolist()
    si = _indices(src_idx, src_pool.shape[0], "src_idx").tolist()
    page_bytes = math.prod(dst_pool.shape[1:]) * dst_pool.element_size()
    dst_b = dst_pool.view(dst_pool.shape[0], -1).view(torch.uint8)
    src_b = src_pool.view(src_pool.shape[0], -1).view(torch.uint8)
    for block in copy_plan(len(di), page_bytes, sm_count, chunk_bytes, blocks_per_sm):
        for i, begin, end in block:
            dst_b[di[i], begin:end] = src_b[si[i], begin:end]
    return dst_pool


def _indices(idx, n_pages: int, what: str) -> torch.Tensor:
    """``idx`` as an int64 tensor, range-checked when it lies on the host."""
    if isinstance(idx, torch.Tensor):
        t = idx.reshape(-1)
        if t.dtype != torch.int64:
            t = t.to(torch.int64)
        if t.device.type != "cpu":
            return t
        a = t.numpy()
    else:
        a = np.asarray(idx, dtype=np.int64).reshape(-1)
        t = torch.from_numpy(a)
    if a.size and (a.min() < 0 or a.max() >= n_pages):
        raise IndexError(f"{what} outside [0, {n_pages})")
    return t


def _unit(*values: int) -> int:
    """The widest access (16, 8, 4, 2 or 1 bytes) dividing every value."""
    for w in (16, 8, 4, 2):
        if all(v % w == 0 for v in values):
            return w
    return 1


def _pages_contiguous(pool: torch.Tensor) -> bool:
    return pool.dim() >= 1 and (
        pool.is_contiguous() or pool.shape[0] == 0 or pool[0].is_contiguous()
    )


@functools.lru_cache(maxsize=None)
def _launcher():
    return _build.function("page_migrate", "migrate_pages_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ])


def _launch(dst_pool, src_pool, dst_idx, src_idx) -> torch.Tensor:
    if dst_pool.dtype != src_pool.dtype or dst_pool.shape[1:] != src_pool.shape[1:]:
        raise ValueError(
            f"pools differ: dst {dst_pool.dtype} {tuple(dst_pool.shape)}, "
            f"src {src_pool.dtype} {tuple(src_pool.shape)}"
        )
    for name, pool in (("dst", dst_pool), ("src", src_pool)):
        if not _pages_contiguous(pool):
            raise ValueError(f"{name} pool: each page must be contiguous")
    dev = dst_pool.device if dst_pool.device.type == "cuda" else src_pool.device
    if src_pool.device.type == "cuda" and src_pool.device != dev:
        raise ValueError(f"pools on {dst_pool.device} and {src_pool.device}")
    if dst_idx.numel() != src_idx.numel():
        raise ValueError(
            f"{dst_idx.numel()} destination and {src_idx.numel()} source pages"
        )
    n = dst_idx.numel()
    if n == 0:
        return dst_pool
    on_host = dst_idx.device.type == "cpu" and src_idx.device.type == "cpu"
    if (
        on_host
        and dst_pool.untyped_storage().data_ptr() == src_pool.untyped_storage().data_ptr()
        and np.intersect1d(dst_idx.numpy(), src_idx.numpy()).size
    ):
        raise ValueError("a page is both read and written within one pool")
    esize = dst_pool.element_size()
    page_bytes = math.prod(dst_pool.shape[1:]) * esize
    dst_stride = dst_pool.stride(0) * esize
    src_stride = src_pool.stride(0) * esize
    dst_addr = _build.device_address("page_migrate", dst_pool)
    src_addr = _build.device_address("page_migrate", src_pool)
    if on_host and n <= INLINE_PAGES and max(dst_pool.shape[0], src_pool.shape[0]) < 2**31:
        # the ids ride in the kernel's parameters (as int32): no copy to the card
        host = (dst_idx.contiguous(), src_idx.contiguous())
        dev_ptrs = (None, None)
        host_ptrs = (host[0].data_ptr(), host[1].data_ptr())
    else:
        if on_host:  # one copy to the card for both id vectors
            ids = _build.to_device(torch.stack((dst_idx, src_idx)), dev)
            di, si = ids[0], ids[1]
        else:
            di, si = (_build.to_device(t, dev).contiguous() for t in (dst_idx, src_idx))
        dev_ptrs = (di.data_ptr(), si.data_ptr())
        host_ptrs = (None, None)
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        rc = _launcher()(
            dst_addr, src_addr, *dev_ptrs, *host_ptrs, n, page_bytes,
            dst_stride, src_stride,
            _unit(dst_addr, src_addr, page_bytes, dst_stride, src_stride),
            _build.sm_count(dev.index),
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    if rc != 0:
        raise RuntimeError(f"migrate_pages kernel launch failed: CUDA error {rc}")
    migrate_pages.launches += 1
    return dst_pool


def migrate_pages(dst_pool: torch.Tensor, src_pool: torch.Tensor,
                  dst_idx, src_idx) -> torch.Tensor:
    """Copy ``src_pool[src_idx[i]]`` onto ``dst_pool[dst_idx[i]]`` in place;
    returns ``dst_pool``.

    Pools are ``(pages, *page_shape)`` of one dtype and page shape, each
    page contiguous; indices are int tensors or arrays of equal length.
    ``dst_idx`` must not repeat a page (two copies would race on the card;
    the JAX reference leaves that case unspecified too), and within one pool
    no page may be both read and written. Exact for every dtype.

    ``migrate_pages.launches`` counts the CUDA kernel's launches; the CPU
    path never adds to it.
    """
    dst_idx = _indices(dst_idx, dst_pool.shape[0], "dst_idx")
    src_idx = _indices(src_idx, src_pool.shape[0], "src_idx")
    types = {dst_pool.device.type, src_pool.device.type}
    if types == {"cpu"}:
        return migrate_pages_plain(dst_pool, src_pool, dst_idx, src_idx)
    if not types <= {"cpu", "cuda"}:
        raise ValueError(
            f"migrate_pages runs on cuda or cpu, not {dst_pool.device} / "
            f"{src_pool.device}"
        )
    return _launch(dst_pool, src_pool, dst_idx, src_idx)


migrate_pages.launches = 0
