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
``n * page_bytes / 64 GB/s``. The times are in ``PERF.md``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build


def migrate_pages_plain(dst_pool: torch.Tensor, src_pool: torch.Tensor,
                        dst_idx: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``dst_pool[dst_idx] = src_pool[src_idx]``
    (gather first, then scatter), in place; returns ``dst_pool``. Pools on
    two devices go through a staging copy of the gathered pages."""
    rows = src_pool.index_select(0, src_idx.to(src_pool.device))
    dst_pool.index_copy_(0, dst_idx.to(dst_pool.device), rows.to(dst_pool.device))
    return dst_pool


def _indices(idx, n_pages: int, what: str) -> torch.Tensor:
    """``idx`` as an int64 tensor, range-checked when it lies on the host."""
    if isinstance(idx, torch.Tensor):
        t = idx.reshape(-1).to(torch.int64)
    else:
        t = torch.from_numpy(np.asarray(idx, dtype=np.int64).reshape(-1))
    if t.device.type == "cpu" and t.numel() and (
        int(t.min()) < 0 or int(t.max()) >= n_pages
    ):
        raise IndexError(f"{what} outside [0, {n_pages})")
    return t


def _unit(*values: int) -> int:
    """The widest access (16, 8, 4, 2 or 1 bytes) dividing every value."""
    for w in (16, 8, 4, 2):
        if all(v % w == 0 for v in values):
            return w
    return 1


def _launch(dst_pool, src_pool, dst_idx, src_idx) -> torch.Tensor:
    if dst_pool.dtype != src_pool.dtype or dst_pool.shape[1:] != src_pool.shape[1:]:
        raise ValueError(
            f"pools differ: dst {dst_pool.dtype} {tuple(dst_pool.shape)}, "
            f"src {src_pool.dtype} {tuple(src_pool.shape)}"
        )
    for name, pool in (("dst", dst_pool), ("src", src_pool)):
        if pool.dim() < 1 or (pool.shape[0] and not pool[0].is_contiguous()):
            raise ValueError(f"{name} pool: each page must be contiguous")
    devices = {p.device for p in (dst_pool, src_pool) if p.device.type == "cuda"}
    if len(devices) != 1:
        raise ValueError(f"pools on {dst_pool.device} and {src_pool.device}")
    dev = devices.pop()
    if dst_idx.numel() != src_idx.numel():
        raise ValueError(
            f"{dst_idx.numel()} destination and {src_idx.numel()} source pages"
        )
    n = dst_idx.numel()
    if n == 0:
        return dst_pool
    if (
        dst_pool.untyped_storage().data_ptr() == src_pool.untyped_storage().data_ptr()
        and dst_idx.device.type == "cpu" and src_idx.device.type == "cpu"
        and np.intersect1d(dst_idx.numpy(), src_idx.numpy()).size
    ):
        raise ValueError("a page is both read and written within one pool")
    di = _build.to_device(dst_idx, dev)
    si = _build.to_device(src_idx, dev)
    page_bytes = dst_pool[0].numel() * dst_pool.element_size()
    dst_stride = dst_pool.stride(0) * dst_pool.element_size()
    src_stride = src_pool.stride(0) * src_pool.element_size()
    dst_addr = _build.device_address("page_migrate", dst_pool)
    src_addr = _build.device_address("page_migrate", src_pool)
    fn = _build.function("page_migrate", "migrate_pages_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            dst_addr, src_addr, di.data_ptr(), si.data_ptr(), n, page_bytes,
            dst_stride, src_stride,
            _unit(dst_addr, src_addr, page_bytes, dst_stride, src_stride),
            stream,
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
