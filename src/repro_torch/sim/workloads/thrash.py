"""Thrash: a rotating working set sized ~2x the fast tier (counterpart of
:mod:`repro.sim.workloads.thrash`; the traces are identical).

The regime where tiering systems live or die (and where the Tuna knee
sits): the instantaneous hot set does not fit in fast memory, so every
profiling interval promotes far more pages than the reclaim headroom and
kswapd demotes pages that were promoted moments earlier.

Implemented as a cache-churning table scan: a contiguous (wrapping) window
over one large table is gathered repeatedly (every window page crosses the
promotion threshold each interval) while the window origin advances by a
fraction of its length per interval. A sparse background sprinkle keeps the
demotion ranking's cold tail populated.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.trace import Trace
from repro_torch.sim.workloads.base import PageMapper

ELEM_BYTES = 8


def thrash_trace(
    n_intervals: int = 60,
    rss_pages: int = 20_000,
    hot_frac: float = 0.7,
    rotate_frac: float = 0.25,
    reps: int = 6,
    seed: int = 23,
    page_bytes: int = 4096,
) -> Trace:
    """Rotating-window churn over a table of ``rss_pages`` pages.

    ``hot_frac`` sizes the instantaneous window (the hot set) as a
    fraction of the RSS; ``rotate_frac`` advances its origin per interval
    as a fraction of the window; ``reps`` random gathers per window page
    per interval put every window page past the default promotion
    threshold (``hot_thr=4``).
    """
    rng = np.random.default_rng(seed)
    pm = PageMapper("thrash", page_bytes=page_bytes, num_threads=8)
    elems_per_page = page_bytes // ELEM_BYTES
    n_elems = rss_pages * elems_per_page
    pm.region("table", n_elems, ELEM_BYTES)
    # init: physical allocation pass
    pm.touch_range("table", 0, n_elems)
    pm.end_interval()

    hot_pages = max(1, int(rss_pages * hot_frac))
    step = max(1, int(hot_pages * rotate_frac))
    bg_n = max(1, rss_pages // 50)
    for i in range(n_intervals):
        start = (i * step) % rss_pages
        win = (start + np.arange(hot_pages, dtype=np.int64)) % rss_pages
        # ~reps random gathers per hot page (hash-probe style): one cache
        # line and one fault-like touch per gather
        idx = np.repeat(win, reps) * elems_per_page + rng.integers(
            0, elems_per_page, size=hot_pages * reps
        )
        pm.touch("table", idx, ops_per_access=4.0)
        # sparse cold-tail sprinkle: single touches stay far below the
        # promotion threshold but keep the whole RSS in the ranking
        bg = rng.choice(rss_pages, size=bg_n, replace=False).astype(np.int64)
        pm.touch(
            "table",
            bg * elems_per_page + rng.integers(0, elems_per_page, size=bg_n),
            ops_per_access=2.0,
        )
        pm.end_interval()
    return pm.trace
