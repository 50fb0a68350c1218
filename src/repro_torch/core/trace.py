"""Page-access traces: the interface between workloads and the tiering stack.

A trace is a sequence of profiling intervals; each interval is a page-access
histogram (page ids + access counts) plus the arithmetic work (FLOPS+IOPS)
performed over those accesses. Counterpart of :mod:`repro.core.trace`,
with the same store channel and the same ``.npz`` format: a trace saved
by either package loads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

import numpy as np


@dataclass
class IntervalAccess:
    """One profiling interval's accesses.

    ``counts`` are memory accesses in cache-line units (what bandwidth and
    latency are charged for); ``touches`` are fault-like touch events (what
    a page-management system actually observes and thresholds on).
    ``touches`` defaults to ``counts``. ``rand_frac`` is the fraction of
    accesses that are effectively random (latency-exposed). ``writes`` is
    an optional per-page count of store accesses (a subset of ``counts``);
    ``None`` means all-reads. The interval cost model ignores it.
    """

    pages: np.ndarray  # int64 page ids (unique)
    counts: np.ndarray  # int64 access counts per page (cache lines)
    ops: float  # arithmetic ops performed this interval
    rand_frac: float = 1.0
    touches: np.ndarray | None = None  # fault-like events per page
    writes: np.ndarray | None = None  # store accesses per page (<= counts)

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
        if self.writes is not None:
            self.writes = np.asarray(self.writes, dtype=np.int64)
            if self.writes.shape != self.pages.shape:
                raise ValueError("pages/writes shape mismatch")
            if np.any(self.writes < 0) or np.any(self.writes > self.counts):
                raise ValueError("writes must satisfy 0 <= writes <= counts")

    @property
    def total_accesses(self) -> int:
        return int(self.counts.sum())


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

    @property
    def total_accesses(self) -> int:
        return sum(ia.total_accesses for ia in self.intervals)

    @property
    def mean_ai(self) -> float:
        acc = self.total_accesses
        return sum(ia.ops for ia in self.intervals) / acc if acc else 0.0


def save_trace(trace: Trace, path) -> None:
    """Persist a trace to .npz (variable-length intervals flattened)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    empty = np.empty(0, np.int64)
    pages = np.concatenate([ia.pages for ia in trace]) if len(trace) else empty
    counts = np.concatenate([ia.counts for ia in trace]) if len(trace) else empty
    touches = np.concatenate([ia.touches for ia in trace]) if len(trace) else empty
    lens = np.array([ia.pages.size for ia in trace], dtype=np.int64)
    ops = np.array([ia.ops for ia in trace])
    rand = np.array([ia.rand_frac for ia in trace])
    # the store channel: one dense flat array and a per-interval presence
    # flag, so all-read intervals load back with writes=None
    has_writes = np.array([ia.writes is not None for ia in trace], dtype=bool)
    writes = (
        np.concatenate(
            [ia.writes if ia.writes is not None else np.zeros(ia.pages.size, np.int64)
             for ia in trace]
        )
        if len(trace)
        else empty
    )
    np.savez_compressed(
        path,
        name=trace.name,
        rss_pages=trace.rss_pages,
        num_threads=trace.num_threads,
        slow_pages=trace.slow_pages if trace.slow_pages is not None else empty,
        has_slow=trace.slow_pages is not None,
        pages=pages,
        counts=counts,
        touches=touches,
        writes=writes,
        has_writes=has_writes,
        lens=lens,
        ops=ops,
        rand=rand,
    )


def load_trace(path) -> Trace:
    """A trace saved by :func:`save_trace` (of either package)."""
    z = np.load(path, allow_pickle=False)
    trace = Trace(
        name=str(z["name"]),
        rss_pages=int(z["rss_pages"]),
        num_threads=int(z["num_threads"]),
        slow_pages=z["slow_pages"] if bool(z["has_slow"]) else None,
    )
    lens = z["lens"]
    starts = np.concatenate([[0], np.cumsum(lens)])
    # files written before the store channel existed are all-reads
    has_writes = z["has_writes"] if "has_writes" in z.files else np.zeros(len(lens), bool)
    for i in range(len(lens)):
        s, e = starts[i], starts[i + 1]
        trace.append(
            IntervalAccess(
                pages=z["pages"][s:e],
                counts=z["counts"][s:e],
                ops=float(z["ops"][i]),
                rand_frac=float(z["rand"][i]),
                touches=z["touches"][s:e],
                writes=z["writes"][s:e] if bool(has_writes[i]) else None,
            )
        )
    return trace


def histogram(page_ids: np.ndarray, ops_per_access: float) -> IntervalAccess:
    """Build an IntervalAccess from a raw (possibly repeated) page-id stream."""
    page_ids = np.asarray(page_ids, dtype=np.int64)
    pages, counts = np.unique(page_ids, return_counts=True)
    return IntervalAccess(pages=pages, counts=counts, ops=ops_per_access * page_ids.size)
