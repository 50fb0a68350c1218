"""Page-access traces: the interface between workloads and the tiering stack.

A trace is a sequence of profiling intervals; each interval is a page-access
histogram (page ids + access counts) plus the arithmetic work (FLOPS+IOPS)
performed over those accesses. Counterpart of :mod:`repro.core.trace`
without the store channel and the ``.npz`` persistence, which no part of
this slice reads.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

import numpy as np


@dataclass
class IntervalAccess:
    """One profiling interval's accesses.

    ``counts`` are memory accesses in cache-line units (what bandwidth and
    latency are charged for); ``touches`` are fault-like touch events (what
    a page-management system actually observes and thresholds on).
    ``touches`` defaults to ``counts``. ``rand_frac`` is the fraction of
    accesses that are effectively random (latency-exposed).
    """

    pages: np.ndarray  # int64 page ids (unique)
    counts: np.ndarray  # int64 access counts per page (cache lines)
    ops: float  # arithmetic ops performed this interval
    rand_frac: float = 1.0
    touches: np.ndarray | None = None  # fault-like events per page

    def __post_init__(self) -> None:
        self.pages = np.asarray(self.pages, dtype=np.int64)
        self.counts = np.asarray(self.counts, dtype=np.int64)
        if self.pages.shape != self.counts.shape:
            raise ValueError("pages/counts shape mismatch")
        if self.touches is None:
            self.touches = self.counts
        else:
            self.touches = np.asarray(self.touches, dtype=np.int64)
            if self.touches.shape != self.pages.shape:
                raise ValueError("pages/touches shape mismatch")


@dataclass
class Trace:
    """A named sequence of interval accesses over an RSS of pages.

    ``slow_pages``, when set, are pages the workload explicitly binds to the
    slow tier at initialization (the micro-benchmark's slow array); all other
    pages are first-touch allocated.
    """

    name: str
    rss_pages: int
    intervals: list = field(default_factory=list)
    num_threads: int = 1
    slow_pages: np.ndarray | None = None

    def fast_only(self) -> "Trace":
        """Copy of this trace with no explicit slow placement (the
        NP_slow = 0 baseline variant, paper Section 3.2)."""
        return Trace(
            name=self.name + ":fast_only",
            rss_pages=self.rss_pages,
            intervals=self.intervals,
            num_threads=self.num_threads,
            slow_pages=None,
        )

    def append(self, ia: IntervalAccess) -> None:
        self.intervals.append(ia)

    def __iter__(self) -> Iterator[IntervalAccess]:
        return iter(self.intervals)

    def __len__(self) -> int:
        return len(self.intervals)


def histogram(page_ids: np.ndarray, ops_per_access: float) -> IntervalAccess:
    """Build an IntervalAccess from a raw (possibly repeated) page-id stream."""
    page_ids = np.asarray(page_ids, dtype=np.int64)
    pages, counts = np.unique(page_ids, return_counts=True)
    return IntervalAccess(pages=pages, counts=counts, ops=ops_per_access * page_ids.size)
