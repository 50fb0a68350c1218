"""Tuna's micro-benchmark probe over a fast and a slow page pool.

:func:`strided_probe` streams ``nf`` fast-pool pages and then ``ns``
slow-pool pages, runs ``ai_iters`` steps of ``acc * 1.000001 + x`` on every
element (the arithmetic-intensity knob of the paper's micro-benchmark,
section 3.2) and sums the results over the pages into a
``(1, page_elems)`` float32 checksum. On a CUDA operand it launches the
hand-written Hopper kernel ``csrc/strided_probe.cu``, which replaces the TPU
kernel ``repro/kernels/strided_probe.py::strided_probe`` (``pallas_call`` at
``strided_probe.py:73``); when both pools lie on the CPU it takes
:func:`strided_probe_plain`. There is no fallback from one to the other.

One pool may be pinned host memory (``pin_memory=True``), read in place
through unified virtual addressing: the micro-benchmark on this card's two
real tiers, HBM and host memory over PCIe.

Where the TPU kernel is undefined the port follows ``ref.strided_probe``:
with ``nf == 0`` or ``ns == 0`` the missing pool contributes nothing (the
TPU kernel clips an index into ``[0, -1]`` there), and with no page at all
the checksum is zeros.

Bound: the larger of the pages' bytes over the reading tier's rate and
``ai_iters`` FMAs an element over the scalar float32 rate. The times are in
``PERF.md``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

# blocks the kernel aims to have in flight per SM (segments are cut to it)
_BLOCKS_PER_SM = 16
# fewest pages a segment walks, so partial rows stay a small share of reads
_MIN_SEGMENT_PAGES = 32
_COLUMNS_PER_BLOCK = 256  # kThreads of csrc/strided_probe.cu
_C = float(np.float32(1.000001))  # the probe's multiplier, as float32


def strided_probe_plain(fast_pool: torch.Tensor, slow_pool: torch.Tensor,
                        fast_idx: torch.Tensor, slow_idx: torch.Tensor,
                        ai_iters: int, dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version (``ref.strided_probe``) on the fast pool's
    device, with the float32 constant ``1.000001f``.

    In float32 each step is one fused multiply-add, as in the kernel and
    in XLA's contraction of ``ref``'s loop: the product and the sum are
    formed in float64 (the float32 product is exact there) and rounded to
    float32 once. ``dtype=torch.float64`` runs the whole probe in float64,
    the reference the kernel is held to on the card."""
    dev = fast_pool.device
    x = torch.cat([
        fast_pool[fast_idx.to(dev)].to(torch.float64),
        slow_pool[slow_idx.to(slow_pool.device)].to(device=dev, dtype=torch.float64),
    ])
    acc = torch.zeros_like(x, dtype=dtype)
    for _ in range(int(ai_iters)):
        acc = (acc.to(torch.float64) * _C + x).to(dtype)
    return acc.sum(dim=0, keepdim=True)


def _indices(idx) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        return idx.reshape(-1).to(torch.int64)
    return torch.from_numpy(np.asarray(idx, dtype=np.int64).reshape(-1))


def segments(n_pages: int, page_elems: int, sm_count: int) -> int:
    """Pages per segment for ``n_pages`` pages of ``page_elems`` columns on
    a card with ``sm_count`` SMs: enough segments for about
    ``_BLOCKS_PER_SM`` blocks an SM, none shorter than
    ``_MIN_SEGMENT_PAGES`` pages (unless there are fewer pages)."""
    col_blocks = -(-page_elems // _COLUMNS_PER_BLOCK)
    want = max(1, -(-sm_count * _BLOCKS_PER_SM // col_blocks))
    n_seg = max(1, min(want, n_pages // _MIN_SEGMENT_PAGES, 65535))
    return -(-n_pages // n_seg)


def _launch(fast_pool, slow_pool, fast_idx, slow_idx, ai_iters) -> torch.Tensor:
    for name, pool in (("fast", fast_pool), ("slow", slow_pool)):
        if pool.dtype != torch.float32 or pool.dim() != 2 or pool.stride(1) != 1:
            raise ValueError(
                f"{name} pool must be 2-D float32 with contiguous rows, got "
                f"{pool.dtype} {tuple(pool.shape)}"
            )
    if fast_pool.shape[1] != slow_pool.shape[1]:
        raise ValueError("fast and slow pages differ in size")
    devices = {p.device for p in (fast_pool, slow_pool) if p.device.type == "cuda"}
    if len(devices) != 1:
        raise ValueError(f"pools on {fast_pool.device} and {slow_pool.device}")
    dev = devices.pop()
    page_elems = fast_pool.shape[1]
    nf, ns = fast_idx.numel(), slow_idx.numel()
    out = torch.zeros((1, page_elems), dtype=torch.float32, device=dev)
    if nf + ns == 0 or page_elems == 0:
        return out
    for idx, pool, what in ((fast_idx, fast_pool, "fast_idx"),
                            (slow_idx, slow_pool, "slow_idx")):
        if idx.device.type == "cpu" and idx.numel() and (
            int(idx.min()) < 0 or int(idx.max()) >= pool.shape[0]
        ):
            raise IndexError(f"{what} outside [0, {pool.shape[0]})")
    fi = _build.to_device(fast_idx, dev) if nf else torch.zeros(1, dtype=torch.int64, device=dev)
    si = _build.to_device(slow_idx, dev) if ns else torch.zeros(1, dtype=torch.int64, device=dev)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    per_seg = segments(nf + ns, page_elems, sm_count)
    n_seg = -(-(nf + ns) // per_seg)
    partial = (
        torch.empty((n_seg, page_elems), dtype=torch.float32, device=dev)
        if n_seg > 1 else out
    )
    fn = _build.function("strided_probe", "strided_probe_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            _build.device_address("strided_probe", fast_pool),
            _build.device_address("strided_probe", slow_pool),
            fi.data_ptr(), si.data_ptr(), nf, ns, page_elems,
            fast_pool.stride(0), slow_pool.stride(0), max(0, int(ai_iters)),
            per_seg, partial.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"strided_probe kernel launch failed: CUDA error {rc}")
    strided_probe.launches += 1
    return out


def strided_probe(fast_pool: torch.Tensor, slow_pool: torch.Tensor,
                  fast_idx, slow_idx, ai_iters: int) -> torch.Tensor:
    """The ``(1, page_elems)`` float32 checksum of the probe.

    ``fast_pool`` / ``slow_pool`` are ``(pages, page_elems)`` float32
    pools, ``fast_idx`` (nf) / ``slow_idx`` (ns) page ids, visited fast
    first, each list in order. Page ids in a CUDA index tensor are not
    range-checked.

    ``strided_probe.launches`` counts the CUDA kernel's launches; the CPU
    path never adds to it.
    """
    fast_idx, slow_idx = _indices(fast_idx), _indices(slow_idx)
    types = {fast_pool.device.type, slow_pool.device.type}
    if types == {"cpu"}:
        return strided_probe_plain(fast_pool, slow_pool, fast_idx, slow_idx, ai_iters)
    if not types <= {"cpu", "cuda"}:
        raise ValueError(
            f"strided_probe runs on cuda or cpu, not {fast_pool.device} / "
            f"{slow_pool.device}"
        )
    return _launch(fast_pool, slow_pool, fast_idx, slow_idx, ai_iters)


strided_probe.launches = 0
