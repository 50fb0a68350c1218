"""Per-size victim selection over the shared demotion ranking.

The sweep step (:mod:`repro_torch.sim.torch_engine`) ranks every page once
per interval by the shared demotion key, ``argsort`` over
``(effective heat, page id)``, which is the same at every fast-memory size.
Each size then demotes the first ``demand[s]`` pages of that ranking that
sit in *its* fast tier. In rank-order coordinates that is a scan per size
row: a running count of fast-tier entries compared with the size's demand.

:func:`victim_partition` is the entry point. On a CUDA tensor it launches
the hand-written Hopper kernel ``csrc/victim_partition.cu``, which
replaces the TPU kernel ``repro/kernels/demote_rank.py::
_victim_partition_pallas`` (``pallas_call`` at ``demote_rank.py:71``);
on a CPU tensor it takes :func:`victim_partition_plain`, the same function
in plain PyTorch. There is no fallback from one to the other: a CUDA
tensor launches the kernel or raises.

Bound: bytes. The function writes the mask (int32) whole and reads
``fast01`` (int32) up to where each row's running count reaches its demand:
at the main path's ``[20, 3,250,585]`` 0.26 GB written and up to 0.26 GB
read, 0.08-0.16 ms at the H100's 3.35 TB/s. The kernel splits every row
into tiles of :data:`TILE` elements, one block a tile, joined by a decoupled
look-back; :func:`victim_partition_tiled_plain` is that decomposition in
plain PyTorch. The times are in ``PERF.md``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# elements of a row one block of the kernel takes (kTile in the source)
TILE = 8192


def victim_partition_plain(fast01: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``(fast01 > 0) & (cumsum(fast01) <= demand)``
    per row, as int32 (the running count in int32, as on the TPU)."""
    cum = torch.cumsum(fast01, dim=1, dtype=torch.int32)
    d = demand.to(device=fast01.device, dtype=torch.int32)[:, None]
    return ((fast01 > 0) & (cum <= d)).to(torch.int32)


def victim_partition_tiled_plain(fast01: torch.Tensor, demand: torch.Tensor,
                                 tile: int = None) -> torch.Tensor:
    """The kernel's decomposition in plain PyTorch: each row cut into tiles
    of ``tile`` elements (default :data:`TILE`), the count of each tile,
    the exclusive running count before each tile (what the look-back
    gives a block), and the early stop: a tile whose count before it has
    reached the demand (or whose demand is <= 0) is zeros, unread. Equal
    to :func:`victim_partition_plain` for ``fast01`` of 0s and 1s."""
    tile = TILE if tile is None else int(tile)
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    n_rows, n_cols = fast01.shape
    n_tiles = -(-n_cols // tile)
    f = torch.nn.functional.pad(fast01.to(torch.int32), (0, n_tiles * tile - n_cols))
    f = f.view(n_rows, n_tiles, tile)
    counts = f.sum(dim=2, dtype=torch.int32)
    before = torch.cumsum(counts, dim=1, dtype=torch.int32) - counts
    d = demand.to(device=fast01.device, dtype=torch.int32).reshape(n_rows, 1)
    unread = before >= d
    within = torch.cumsum(torch.where(unread[:, :, None], 0, f), dim=2,
                          dtype=torch.int32)
    mask = (f > 0) & ~unread[:, :, None] & (before[:, :, None] + within <= d[:, :, None])
    return mask.reshape(n_rows, n_tiles * tile)[:, :n_cols].to(torch.int32)


def _aligned(t: torch.Tensor) -> int:
    """1 when every row of ``t`` starts on a 16-byte boundary (int4 access)."""
    return int(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0)


@functools.lru_cache(maxsize=None)
def _scratch_words():
    return _build.function("victim_partition", "victim_partition_scratch_words",
                           [ctypes.c_longlong, ctypes.c_longlong], ctypes.c_longlong)


@functools.lru_cache(maxsize=None)
def _launcher():
    return _build.function("victim_partition", "victim_partition_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ])


def _launch(fast01: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
    if fast01.dtype != torch.int32 or fast01.dim() != 2:
        raise ValueError(
            f"fast01 must be a 2-D int32 tensor, got {fast01.dtype} "
            f"{tuple(fast01.shape)}"
        )
    n_rows, n_cols = fast01.shape
    if fast01.stride(1) != 1 and n_cols > 1:
        raise ValueError("fast01 rows must be contiguous (stride(1) == 1)")
    if demand.device != fast01.device:
        raise ValueError(
            f"demand is on {demand.device}, fast01 on {fast01.device}"
        )
    if demand.numel() != n_rows:
        raise ValueError(
            f"demand has {demand.numel()} entries for {n_rows} rows"
        )
    d = demand.reshape(n_rows).to(torch.int32).contiguous()
    # rows padded to a multiple of 4 elements so every row is int4-aligned
    ld_out = -(-n_cols // 4) * 4
    out = torch.empty(
        (n_rows, ld_out), dtype=torch.int32, device=fast01.device
    )[:, :n_cols]
    if n_rows == 0 or n_cols == 0:
        return out
    # tile counter, status words and per-row flags of the look-back, zeroed
    scratch = torch.zeros(
        _scratch_words()(n_rows, n_cols), dtype=torch.int64, device=fast01.device
    )
    with torch.cuda.device(fast01.device):
        stream = torch.cuda.current_stream(fast01.device).cuda_stream
        rc = _launcher()(
            fast01.data_ptr(), d.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            n_rows, n_cols, fast01.stride(0), out.stride(0),
            _aligned(fast01), _aligned(out), TILE, stream,
        )
    if rc != 0:
        raise RuntimeError(f"victim_partition kernel launch failed: CUDA error {rc}")
    victim_partition.launches += 1
    return out


def victim_partition(fast01: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
    """Victim selection mask per size row, in demotion-rank order.

    ``fast01[s, i]`` is 1 when the page at rank position ``i`` is in size
    ``s``'s fast tier (0 otherwise); ``demand[s]`` is that size's reclaim
    demand (int32 semantics). Returns an int32 mask that marks, per row,
    the first ``demand[s]`` fast positions. Exact on both devices.

    ``victim_partition.launches`` counts the CUDA kernel's launches; the
    CPU path never adds to it.
    """
    if fast01.device.type == "cpu":
        return victim_partition_plain(fast01, demand)
    if fast01.device.type != "cuda":
        raise ValueError(f"victim_partition runs on cuda or cpu, not {fast01.device}")
    return _launch(fast01, demand)


victim_partition.launches = 0
