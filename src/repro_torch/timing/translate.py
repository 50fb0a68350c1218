"""Page translation table: the timing engine's view of page placement.

Counterpart of :mod:`repro.timing.translate`, copied (numpy on the host).

In tracehm-style simulators the memory front-end resolves every access
through a translation table mapping the application's page to the device
currently backing it; migrations rewrite entries. Here the table maps
page id -> tier (fast/slow) and is driven by the *same* migration
schedules the interval engine commits: the runner re-executes the
deterministic pool + policy stack on identical inputs and mirrors each
interval's placement diff into the table, so the two clocks time the
exact same migration history without sharing any simulator state.
"""

from __future__ import annotations

import numpy as np

UNALLOC = -1
FAST = 0
SLOW = 1


class TranslationTable:
    """Dense page -> tier map with migration accounting.

    Pages start unallocated; :meth:`allocate` records first-touch
    placement (not a migration), :meth:`migrate` records tier moves and
    tallies promotions/demotions. :meth:`lookup` resolves an access batch
    to the tiers backing it *at access time*.
    """

    def __init__(self, num_pages: int) -> None:
        self.num_pages = int(num_pages)
        self.tiers = np.full(self.num_pages, UNALLOC, dtype=np.int8)
        self.promoted = 0
        self.demoted = 0
        self.allocated = 0

    # ------------------------------------------------------------- updates
    def allocate(self, pages: np.ndarray, tiers: np.ndarray) -> None:
        """First-touch placement of previously unallocated pages."""
        if pages.size == 0:
            return
        if np.any(self.tiers[pages] != UNALLOC):
            raise ValueError("allocate() got already-allocated pages")
        self.tiers[pages] = tiers
        self.allocated += int(pages.size)

    def migrate(self, pages: np.ndarray, tiers: np.ndarray) -> tuple[int, int]:
        """Move allocated pages to ``tiers``; returns (promoted, demoted)."""
        if pages.size == 0:
            return 0, 0
        old = self.tiers[pages]
        if np.any(old == UNALLOC):
            raise ValueError("migrate() got unallocated pages")
        pr = int(np.count_nonzero((old == SLOW) & (tiers == FAST)))
        de = int(np.count_nonzero((old == FAST) & (tiers == SLOW)))
        self.tiers[pages] = tiers
        self.promoted += pr
        self.demoted += de
        return pr, de

    def sync(self, reference: np.ndarray) -> tuple[int, int]:
        """Mirror a full placement vector into the table.

        ``reference`` is a read-only per-page tier array (e.g. the pool's
        public ``tier`` view). Newly allocated pages are adopted as
        first-touch placements; tier changes of already-allocated pages
        are counted as migrations. Returns (promoted, demoted) this sync.
        """
        changed = np.flatnonzero(self.tiers != reference)
        if changed.size == 0:
            return 0, 0
        was_un = self.tiers[changed] == UNALLOC
        self.allocate(changed[was_un], reference[changed[was_un]])
        return self.migrate(changed[~was_un], reference[changed[~was_un]])

    # -------------------------------------------------------------- reads
    def lookup(self, pages: np.ndarray) -> np.ndarray:
        t = self.tiers[pages]
        if np.any(t == UNALLOC):
            raise ValueError("lookup() hit unallocated pages")
        return t

    def snapshot(self) -> dict:
        return {
            "allocated": self.allocated,
            "promoted": self.promoted,
            "demoted": self.demoted,
            "fast_pages": int(np.count_nonzero(self.tiers == FAST)),
            "slow_pages": int(np.count_nonzero(self.tiers == SLOW)),
        }
