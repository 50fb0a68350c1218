"""Page-level instrumentation shared by the workload implementations
(counterpart of :mod:`repro.sim.workloads.base`; the traces are identical)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.trace import IntervalAccess, Trace

CACHELINE = 64


@dataclass
class _Region:
    name: str
    base_page: int
    elem_bytes: int
    n_elems: int
    page_bytes: int = 4096


class PageMapper:
    """Maps named arrays onto a flat page-id space and records accesses.

    Workloads register their data structures (``region``), then log element
    accesses (``touch`` for gathers/scatters, ``touch_range`` for dense
    scans); ``end_interval`` flushes the accumulated histograms into the
    trace.

    Units: *counts* are cache-line accesses (what bandwidth/latency cost);
    *touches* are fault-like events (what a page-management system samples
    and thresholds on). A random gather is one cache line and one touch per
    element; a sequential scan is ``elem_bytes/64`` cache lines per element
    but only one touch per page per scan.

    ``write_frac`` on an access marks that fraction of its cache lines as
    stores (deterministic expected-value accounting, no RNG draw — a
    ``write_frac=0.0`` workload emits bit-identical traces with or without
    the knob). Intervals with no stores flush with ``writes=None``.
    """

    def __init__(self, name: str, page_bytes: int = 4096, num_threads: int = 1):
        self.page_bytes = page_bytes
        self._regions: dict[str, _Region] = {}
        self._next_page = 0
        self._ops = 0.0
        self._rand_acc = 0.0
        self._seq_acc = 0.0
        self._counts_vec: np.ndarray | None = None  # cache-line accesses
        self._touch_vec: np.ndarray | None = None  # fault-like events
        self._write_vec: np.ndarray | None = None  # store cache lines
        self.trace = Trace(name=name, rss_pages=0, num_threads=num_threads)

    # ------------------------------------------------------------ regions
    def region(self, name: str, n_elems: int, elem_bytes: int) -> "PageMapper":
        n_pages = max(1, -(-(n_elems * elem_bytes) // self.page_bytes))
        self._regions[name] = _Region(
            name=name,
            base_page=self._next_page,
            elem_bytes=elem_bytes,
            n_elems=n_elems,
            page_bytes=self.page_bytes,
        )
        self._next_page += n_pages
        self.trace.rss_pages = self._next_page
        self._counts_vec = np.zeros(self._next_page, dtype=np.float64)
        self._touch_vec = np.zeros(self._next_page, dtype=np.float64)
        self._write_vec = np.zeros(self._next_page, dtype=np.float64)
        return self

    def pages_of(self, name: str, idx: np.ndarray) -> np.ndarray:
        r = self._regions[name]
        idx = np.asarray(idx)
        return r.base_page + (idx.astype(np.int64) * r.elem_bytes) // self.page_bytes

    # ----------------------------------------------------------- accesses
    def touch(
        self,
        name: str,
        idx: np.ndarray,
        ops_per_access: float = 0.0,
        sequential: bool = False,
        write_frac: float = 0.0,
    ) -> None:
        """Record element accesses into region ``name`` (vectorized)."""
        r = self._regions[name]
        pages = self.pages_of(name, idx)
        if pages.size == 0:
            return
        if sequential:
            # burst: elem_bytes/64 cache lines per element, 1 touch/page
            cl_per_elem = max(r.elem_bytes / CACHELINE, 1.0 / (CACHELINE // max(r.elem_bytes, 1)))
            hist = np.bincount(pages, minlength=self._counts_vec.size)
            self._counts_vec += hist * cl_per_elem
            self._touch_vec += (hist > 0)
            self._seq_acc += pages.size * cl_per_elem
            if write_frac > 0.0:
                self._write_vec += hist * (cl_per_elem * write_frac)
        else:
            hist = np.bincount(pages, minlength=self._counts_vec.size)
            self._counts_vec += hist
            self._touch_vec += hist
            self._rand_acc += pages.size
            if write_frac > 0.0:
                self._write_vec += hist * write_frac
        self._ops += ops_per_access * pages.size

    def touch_range(
        self,
        name: str,
        lo: int,
        hi: int,
        ops_per_access: float = 0.0,
        write_frac: float = 0.0,
    ):
        """Record a dense sequential scan of elements [lo, hi)."""
        r = self._regions[name]
        n = max(0, hi - lo)
        if n == 0:
            return
        p0 = int(r.base_page + (lo * r.elem_bytes) // self.page_bytes)
        p1 = int(r.base_page + ((hi - 1) * r.elem_bytes) // self.page_bytes)
        cl_per_page = self.page_bytes // CACHELINE
        total_cl = max(1.0, n * r.elem_bytes / CACHELINE)
        cl_here = min(cl_per_page, total_cl / (p1 - p0 + 1))
        self._counts_vec[p0 : p1 + 1] += cl_here
        self._touch_vec[p0 : p1 + 1] += 1
        if write_frac > 0.0:
            self._write_vec[p0 : p1 + 1] += cl_here * write_frac
        self._seq_acc += total_cl
        self._ops += ops_per_access * n

    def ops(self, n: float) -> None:
        """Record arithmetic work not tied to a specific access."""
        self._ops += float(n)

    # ---------------------------------------------------------- intervals
    def end_interval(self) -> None:
        """Histogram this interval's touches and append to the trace."""
        pages = np.flatnonzero(self._counts_vec)
        if pages.size == 0 and self._ops == 0.0:
            return
        counts = np.maximum(1, np.rint(self._counts_vec[pages])).astype(np.int64)
        touches = np.maximum(1, np.rint(self._touch_vec[pages])).astype(np.int64)
        writes = None
        if np.any(self._write_vec):
            writes = np.minimum(
                counts, np.rint(self._write_vec[pages]).astype(np.int64)
            )
        tot = self._rand_acc + self._seq_acc
        rand_frac = (self._rand_acc / tot) if tot else 1.0
        self.trace.append(
            IntervalAccess(
                pages=pages,
                counts=counts,
                ops=self._ops,
                rand_frac=rand_frac,
                touches=touches,
                writes=writes,
            )
        )
        self._counts_vec[:] = 0.0
        self._touch_vec[:] = 0.0
        self._write_vec[:] = 0.0
        self._ops = 0.0
        self._rand_acc = 0.0
        self._seq_acc = 0.0


def zipf_weights(n: int, s: float, rng: np.random.Generator) -> np.ndarray:
    """Zipf-like popularity over n items with a random permutation."""
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), s)
    w /= w.sum()
    return w[rng.permutation(n)]


def power_law_graph(
    n: int, avg_deg: int, alpha: float, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """CSR (offsets, edges) of a random power-law multigraph.

    Degrees ~ Zipf(alpha) scaled to the requested edge budget; endpoints are
    drawn proportionally to degree (configuration-model style), which yields
    the hub structure that makes graph workloads tiering-friendly.
    """
    rng = np.random.default_rng(seed)
    w = zipf_weights(n, alpha, rng)
    m = n * avg_deg
    deg = rng.multinomial(m, w)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offsets[1:])
    edges = rng.choice(n, size=m, p=w).astype(np.int32)
    return offsets, edges
