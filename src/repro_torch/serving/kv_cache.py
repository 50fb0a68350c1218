"""Two-tier paged KV cache: an HBM pool and a host pool, Tuna-managed.

Counterpart of :mod:`repro.serving.kv_cache`. A logical page holds one
``page_size``-token slice of K and V for every layer group. The management
state is the port's standalone :class:`~repro_torch.tiering.page_pool.
TieredPagePool` (tiers, heat, watermarks): pages of sessions being decoded
are HBM-resident, idle sessions cool down and the watermark reclaimer
demotes them to host memory, resumes promote them back. Tuna's tuner sets
the HBM page budget through the watermarks.

The physical pools are real tiers on the card: the HBM pool is a device
tensor ``[hbm_capacity, elems_per_page]`` and the host pool a pinned CPU
tensor ``[total_pages, elems_per_page]``. Promotion and demotion are each
one launch of :func:`repro_torch.kernels.page_migrate.migrate_pages`, which
reads or writes the pinned host pool in place (the JAX package stages
promotions through a device copy of the host rows and gathers demotions
back in numpy). With ``device="cpu"`` both pools are plain CPU tensors and
the copies take the plain version. The control plane stays numpy and
matches the JAX package decision for decision.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.page_migrate import migrate_pages
from repro_torch.tiering.page_pool import Tier, TieredPagePool
from repro_torch.tiering.policy import TPPPolicy


@dataclass
class KVPageConfig:
    n_groups: int
    page_size: int  # tokens per page
    kv_heads: int
    head_dim: int
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def elems_per_page(self) -> int:
        return self.n_groups * 2 * self.page_size * self.kv_heads * self.head_dim

    @property
    def bytes_per_page(self) -> int:
        itemsize = torch.empty((), dtype=self.torch_dtype).element_size()
        return self.elems_per_page * itemsize


class TieredPagedKV:
    """Physical two-tier page store with slot allocators + page table.

    ``device=None`` means the card (and raises without one); the host pool
    is then pinned, so the migration kernel reads and writes it in place.
    """

    def __init__(
        self,
        cfg: KVPageConfig,
        total_pages: int,
        hbm_capacity: int,
        hot_thr: int = 2,
        seed: int = 0,
        device=None,
    ):
        self.cfg = cfg
        self.total_pages = total_pages
        self.device = resolve_device(device)
        # management state (tiers, heat, watermarks)
        self.pool = TieredPagePool(
            num_pages=total_pages,
            hw_capacity=hbm_capacity,
            page_bytes=cfg.bytes_per_page,
            seed=seed,
        )
        self.policy = TPPPolicy(hot_thr=hot_thr)
        flat = (cfg.elems_per_page,)
        dt = cfg.torch_dtype
        # physical pools: HBM (device) and host (pinned on a CUDA device)
        self.hbm = torch.zeros((hbm_capacity,) + flat, dtype=dt, device=self.device)
        self.host = torch.zeros(
            (total_pages,) + flat, dtype=dt,
            pin_memory=self.device.type == "cuda",
        )
        self.hbm_slot = np.full(total_pages, -1, np.int64)  # page -> hbm slot
        self._free_hbm = list(range(hbm_capacity - 1, -1, -1))
        self.migrated_in = 0
        self.migrated_out = 0

    # ---------------------------------------------------------------- state
    def tier_of(self, page: int) -> Tier:
        return Tier(self.pool.tier[page])

    def hbm_view(self, pages: np.ndarray) -> torch.Tensor:
        """HBM slots for resident pages (must all be FAST), on the device."""
        slots = self.hbm_slot[pages]
        if np.any(slots < 0):
            raise RuntimeError("page not HBM-resident; promote first")
        return torch.as_tensor(slots, device=self.device)

    # ------------------------------------------------------------ migration
    def promote(self, pages: np.ndarray) -> int:
        """host → HBM (the copy in). Returns pages actually promoted."""
        pages = np.asarray(
            [p for p in np.atleast_1d(pages) if self.pool.tier[p] != Tier.FAST],
            dtype=np.int64,
        )
        n = min(len(self._free_hbm), pages.size)
        pages = pages[:n]
        if n == 0:
            return 0
        dst = np.array([self._free_hbm.pop() for _ in range(n)], np.int64)
        migrate_pages(self.hbm, self.host, dst, pages)
        self.hbm_slot[pages] = dst
        self.pool.place(pages, Tier.FAST)
        self.migrated_in += n
        return n

    def demote(self, pages: np.ndarray) -> int:
        """HBM → host (the copy out, kswapd's work)."""
        pages = np.asarray(
            [p for p in np.atleast_1d(pages) if self.pool.tier[p] == Tier.FAST],
            dtype=np.int64,
        )
        if pages.size == 0:
            return 0
        slots = self.hbm_slot[pages]
        migrate_pages(self.host, self.hbm, pages, slots)
        for s in slots:
            self._free_hbm.append(int(s))
        self.hbm_slot[pages] = -1
        self.pool.place(pages, Tier.SLOW)
        self.migrated_out += pages.size
        return int(pages.size)

    def reclaim_to_watermark(self) -> int:
        """Demote coldest pages until the HBM free count satisfies the
        watermark (Tuna's actuation path after set_fm_size)."""
        demoted = 0
        wm = self.pool.watermarks
        while len(self._free_hbm) < wm.low_free:
            fast = self.pool.fast_pages()
            if fast.size == 0:
                break
            # the JAX package's unstable sort: ties fall in fast-index order
            order = np.argsort(self.pool.heat_of(fast))
            batch = fast[order[: max(1, min(64, wm.high_free - len(self._free_hbm)))]]
            demoted += self.demote(batch)
        return demoted

    # ------------------------------------------------------------- writes
    def ensure_resident(self, pages: np.ndarray) -> tuple[int, int]:
        """Promote any non-resident pages (session resume). Returns
        (promoted, failures): failures when HBM has no free slot even after
        reclaim (TPP's migration failure)."""
        pages = np.atleast_1d(pages).astype(np.int64)
        need = pages[self.pool.tier[pages] != Tier.FAST]
        # unallocated pages are first-touch allocated straight into HBM
        fails = 0
        if need.size:
            got = self.promote(need)
            if got < need.size:
                self.reclaim_to_watermark()
                got += self.promote(need[got:])
            fails = need.size - got
            self.pool.stats.pgpromote_fail += max(0, fails)
        return int(need.size - fails), int(fails)

    def write_tokens(self, pages: np.ndarray, data: torch.Tensor) -> None:
        """Write new KV data into resident pages (decode appends)."""
        slots = self.hbm_view(pages)
        self.hbm[slots] = data.reshape(len(slots), -1).to(
            device=self.device, dtype=self.hbm.dtype
        )

    def touch(self, pages: np.ndarray, counts=None) -> None:
        pages = np.atleast_1d(pages).astype(np.int64)
        c = np.ones(pages.size, np.int64) if counts is None else counts
        self.pool.apply_accesses(pages, c, c)

    def end_interval(self):
        self.pool.end_interval()
