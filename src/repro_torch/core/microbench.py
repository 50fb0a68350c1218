"""Micro-benchmark generator (paper Section 3.2, Eqs. 1–4).

Given a target configuration vector measured from an application, synthesize
a workload that — when run under the same page-management system at the same
fast-memory size — reproduces the application's page accesses (``pacc_f``,
``pacc_s``), migrations (``pm_pr``, ``pm_de``), and arithmetic intensity
(``AI``), over the same RSS:

* a **hot set** of ``NP_fast`` pages, each accessed ``hot_thr`` times;
* a **warm set** of ``NP_slow`` pages, each accessed ``hot_thr − 1`` times;
* a **churn set**: every interval ``pm_pr`` cold pages cross the threshold
  (promoted) while the previous interval's promotions go cold (demoted).

Counterpart of :mod:`repro.core.microbench`; the traces are identical.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.telemetry import ConfigVector
from repro_torch.core.trace import IntervalAccess, Trace


@dataclass(frozen=True)
class MicrobenchSpec:
    """Page-level layout of the generated workload (all counts in pages)."""

    np_fast: int  # hot set size (Eq. 3)
    np_slow: int  # warm set size (Eq. 4)
    pm_pr: int  # promotions per interval
    pm_de: int  # demotions per interval
    rss_pages: int
    hot_thr: int
    ai: float  # ops per page access
    num_threads: int
    intensity: float = 1.0  # cache lines per touch (the stride knob)
    # graded warm tail observed in the fast tier (below hot_thr), shaped as
    # an extra rotating set so shrinking the fast tier exposes gradual loss
    tail_pages: int = 0
    tail_touches: int = 1

    @property
    def touched_per_interval(self) -> int:
        return self.np_fast + self.np_slow + 2 * self.pm_pr

    def accesses_per_interval(self) -> tuple[int, int]:
        """(pacc_f, pacc_s) this spec should reproduce at the reference size."""
        pacc_f = self.np_fast * self.hot_thr + self.pm_de * 1
        pacc_s = self.np_slow * (self.hot_thr - 1) + self.pm_pr * self.hot_thr
        return pacc_f, pacc_s


def spec_from_config(cv: ConfigVector) -> MicrobenchSpec:
    """Invert Eqs. 1–4: configuration vector → micro-benchmark layout."""
    hot_thr = max(2, int(round(cv.hot_thr)))
    pm_pr = max(0, int(round(cv.pm_pr)))
    pm_de = max(0, int(round(cv.pm_de)))
    # warm tail (metadata): subtract its touches before Eq. 3 sizes the
    # always-hot set
    tail_pages = max(0, int(round(cv.warm_pages)))
    tail_total = max(0.0, float(cv.warm_touches))
    tail_touches = max(1, int(round(tail_total / tail_pages))) if tail_pages else 1
    # Eq. 1: remove demotion-induced fast accesses (1 access per demoted page)
    pacc_f = max(0.0, cv.pacc_f - pm_de * 1 - tail_total)
    # Eq. 2: remove promotion-induced slow accesses (hot_thr per promoted page)
    pacc_s = max(0.0, cv.pacc_s - pm_pr * hot_thr)
    np_fast = int(pacc_f // hot_thr)  # Eq. 3
    np_slow = int(pacc_s // (hot_thr - 1))  # Eq. 4
    rss = int(round(cv.rss_pages))
    # The layout must fit in RSS; churn pages live in the remaining cold area.
    need = np_fast + tail_pages + np_slow + 4 * max(pm_pr, pm_de, 1)
    rss = max(rss, need)
    return MicrobenchSpec(
        np_fast=np_fast,
        np_slow=np_slow,
        pm_pr=pm_pr,
        pm_de=pm_de,
        rss_pages=rss,
        hot_thr=hot_thr,
        ai=float(cv.ai),
        num_threads=max(1, int(round(cv.num_threads))),
        intensity=float(cv.intensity),
        tail_pages=tail_pages,
        tail_touches=min(tail_touches, hot_thr - 1),
    )


def generate_microbench(
    cv: ConfigVector,
    n_intervals: int = 20,
    warmup_intervals: int = 2,
) -> Trace:
    """Generate the micro-benchmark trace for a configuration vector.

    The first ``warmup_intervals`` touch the whole RSS once (the paper's
    initialization phase), then the steady-state intervals follow the
    hot/warm/churn structure above.
    """
    spec = spec_from_config(cv)
    return generate_from_spec(spec, n_intervals, warmup_intervals)


def generate_from_spec(
    spec: MicrobenchSpec,
    n_intervals: int = 20,
    warmup_intervals: int = 2,
) -> Trace:
    rss = spec.rss_pages
    # Two arrays whose physical consumption equals RSS (paper Section 3.2):
    #   fast array = [hot | cold filler]    — first-touch allocated;
    #   slow array = [warm | churn region]  — explicitly bound to slow.
    # Page-id layout: [hot | warm | churn region | tail zone]; each interval
    # a rotating window of `tail_pages` of the tail zone is touched below
    # the promotion threshold.
    hot = np.arange(0, spec.np_fast, dtype=np.int64)
    warm_lo = spec.np_fast
    warm = np.arange(warm_lo, warm_lo + spec.np_slow, dtype=np.int64)
    churn_lo = warm_lo + spec.np_slow
    # enough churn pages that the rotating promotion cursor does not revisit
    # a page still resident in fast memory, bounded to half the remaining
    # RSS so cold filler keeps the fast tier pinned at its watermark
    churn_want = max(spec.pm_pr * (n_intervals + 1), spec.pm_pr + spec.pm_de, 1)
    churn_len = int(np.clip(churn_want, 1, max(1, (rss - churn_lo) // 2)))
    filler_lo = min(rss, churn_lo + churn_len)
    tailzone_len = max(1, rss - filler_lo)
    trace = Trace(
        name="microbench",
        rss_pages=rss,
        num_threads=spec.num_threads,
        slow_pages=np.arange(warm_lo, filler_lo, dtype=np.int64),
    )

    # Initialization: touch every page once so first-touch allocation mirrors
    # the application's RSS split at the current fast-memory size.
    all_pages = np.arange(rss, dtype=np.int64)
    per_warm = math.ceil(rss / max(warmup_intervals, 1))
    for w in range(warmup_intervals):
        chunk = all_pages[w * per_warm : (w + 1) * per_warm]
        if chunk.size:
            trace.append(
                IntervalAccess(
                    pages=chunk,
                    counts=np.ones_like(chunk),
                    ops=spec.ai * chunk.size,
                )
            )

    cursor = 0
    tail_cursor = 0
    prev_promoted = np.empty(0, dtype=np.int64)
    for _ in range(n_intervals):
        pages_list = []
        counts_list = []
        if hot.size:
            pages_list.append(hot)
            counts_list.append(np.full(hot.size, spec.hot_thr, dtype=np.int64))
        if spec.tail_pages > 0:
            tidx = (tail_cursor + np.arange(
                min(spec.tail_pages, tailzone_len)
            )) % tailzone_len
            tail_cursor = (tail_cursor + spec.tail_pages) % tailzone_len
            pages_list.append(filler_lo + tidx)
            counts_list.append(
                np.full(tidx.size, spec.tail_touches, dtype=np.int64)
            )
        if warm.size:
            pages_list.append(warm)
            counts_list.append(np.full(warm.size, spec.hot_thr - 1, dtype=np.int64))
        # churn: new promotion candidates (rotating cursor through cold area)
        if spec.pm_pr > 0:
            idx = (cursor + np.arange(spec.pm_pr)) % churn_len
            promo = churn_lo + idx
            cursor = (cursor + spec.pm_pr) % churn_len
            pages_list.append(promo)
            counts_list.append(np.full(promo.size, spec.hot_thr, dtype=np.int64))
        else:
            promo = np.empty(0, dtype=np.int64)
        # last interval's promoted pages: one touch, then they go cold and
        # become the watermark reclaimer's demotion victims
        if prev_promoted.size:
            pages_list.append(prev_promoted)
            counts_list.append(np.ones(prev_promoted.size, dtype=np.int64))
        prev_promoted = promo
        pages = np.concatenate(pages_list) if pages_list else np.empty(0, np.int64)
        touches = (
            np.concatenate(counts_list) if counts_list else np.empty(0, np.int64)
        )
        # the stride knob: each touch moves `intensity` cache lines
        counts = np.maximum(1, np.rint(touches * spec.intensity)).astype(np.int64)
        trace.append(
            IntervalAccess(
                pages=pages, counts=counts,
                ops=spec.ai * touches.sum(), touches=touches,
            )
        )
    return trace
