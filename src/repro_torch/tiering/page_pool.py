"""Tiered page pool of the port: allocation state, heat, watermarks and the
host migration path.

Counterpart of :mod:`repro.tiering.page_pool`, in two shapes:

* the **standalone pool** (:class:`TieredPagePool` with the JAX package's
  constructor): tiers, the swap-remove fast-tier index (:class:`_FastSet`),
  lazily decayed heat (:class:`LazyHeat`), first-touch allocation, the
  interval fold and the migration path the per-size engine
  (:mod:`repro_torch.sim.engine`) and the timing lane drive: promotion,
  watermark reclaim over the per-interval victim queue
  (:class:`_DemoteQueue`) and the bulk policy step
  (:meth:`TieredPagePool._try_bulk_step`), copied line for line. The tiered
  KV cache (:mod:`repro_torch.serving.kv_cache`) runs on it too. It stays
  numpy on the host: its victim order hangs on unstable ``np.argsort`` /
  ``np.partition`` ties in the order the fast index's swap-remove leaves,
  so the index and the sorts are the same code as in the JAX package.
* the **slice pool** of the device sweep (:meth:`TieredPagePool.for_slice`).
  The tier state of every swept fast-memory size lives on the device in
  :mod:`repro_torch.sim.torch_engine`, as one stacked
  ``[n_sizes, rss_pages]`` int8 array; each size keeps a slice pool here
  for its control plane: hardware capacity, kswapd budget, watermarks, the
  occupancy counters and the cumulative stats the profilers and tuners
  read. Its host ``tier`` row holds the placement before the run
  (:meth:`TieredPagePool.place`) and the device state imported after it.
  It has no heat and no migration path of its own.

The TPP schedule recurrence (:func:`_bulk_schedule`,
:func:`_bulk_schedule_batch`) and the thrash-regime victim resolver
(:func:`_resolve_step_victims`) are copied unchanged: the bulk step runs
them on the host pool, and the device step over integers pulled from the
device. The JAX package's interval-wide ranking of its numpy sweep
(``GlobalDemoteRank``, ``LazyGrankBox``) has no counterpart: the device
step ranks on the card.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class Tier(enum.IntEnum):
    UNALLOCATED = -1
    FAST = 0
    SLOW = 1


_UNALLOC = int(Tier.UNALLOCATED)
_FAST = int(Tier.FAST)
_SLOW = int(Tier.SLOW)


@dataclass
class Watermarks:
    """Watermarks expressed in *free fast pages* (kernel convention).

    The paper sets ``low = high = new_fm`` and ``min = 0.8 * low`` in
    fast-memory-size units; translated to free-page units against a fixed
    hardware capacity ``cap`` this is ``low_free = high_free = cap - new_fm``
    and ``min_free = 0.8 * low_free``.
    """

    min_free: int
    low_free: int
    high_free: int

    @classmethod
    def for_size(cls, hw_capacity: int, new_fm: int) -> "Watermarks":
        new_fm = int(max(1, min(hw_capacity, new_fm)))
        low = hw_capacity - new_fm
        return cls(min_free=int(0.8 * low), low_free=low, high_free=low)


@dataclass
class PoolStats:
    """Cumulative counters (the /proc/vmstat analogue)."""

    pgpromote_success: int = 0
    pgpromote_fail: int = 0  # paper's "page migration failures"
    pgdemote_kswapd: int = 0
    pgdemote_direct: int = 0
    direct_reclaim_events: int = 0
    alloc_fast: int = 0
    alloc_slow: int = 0  # first-touch spill

    def snapshot(self) -> dict:
        return dict(self.__dict__)


class LazyHeat:
    """Decayed per-page touch counters with O(touched) maintenance.

    Each page stores its value as of the last interval it was refreshed
    (``stamp``); reads apply the pending decay steps as the same sequence
    of scalar multiplies a dense ``heat * decay + touch`` performs (not
    ``value * decay**k``, whose single rounding differs in the last ulp),
    so values stay bit-identical to the dense update.
    """

    def __init__(self, num_pages: int, decay: float) -> None:
        self.decay = float(decay)
        self.value = np.zeros(num_pages, dtype=np.float64)
        # number of end-of-interval decay steps incorporated into ``value``
        self.stamp = np.zeros(num_pages, dtype=np.int64)
        self.t = 0  # completed intervals

    def _refresh(self, pages: np.ndarray) -> np.ndarray:
        """Catch ``pages`` up to ``t`` decay steps, sequentially, in place.
        Returns the refreshed values (a fresh array)."""
        vals = self.value[pages]
        if pages.size == 0:
            return vals
        k = self.t - self.stamp[pages]
        kmax = int(k.max())
        if kmax <= 0:
            return vals
        if kmax == 1 and int(k.min()) == 1:
            vals = vals * self.decay  # the steady-state fast path
        else:
            live = (k > 0) & (vals != 0.0)
            for step in range(1, kmax + 1):
                if not np.any(live):
                    break
                vals = np.where(live, vals * self.decay, vals)
                live = live & (k > step) & (vals != 0.0)
        self.value[pages] = vals
        self.stamp[pages] = self.t
        return vals

    def fold(self, pages: np.ndarray, touches: np.ndarray) -> None:
        """End one interval: decay + fold ``touches`` for ``pages`` (the
        interval's touched set; duplicates are harmless)."""
        if pages.size:
            vals = self._refresh(pages)
            self.value[pages] = vals * self.decay + touches
            self.stamp[pages] = self.t + 1
        self.t += 1

    def fold_dense(self, touches_dense: np.ndarray) -> None:
        """Dense-interval fold: ``value = value * decay + touches_dense``,
        re-synchronizing every stamp."""
        stale = np.flatnonzero(self.stamp < self.t)
        if stale.size:
            self._refresh(stale)
        self.value *= self.decay
        self.value += touches_dense
        self.stamp[:] = self.t + 1
        self.t += 1

    def _peek(self, pages: np.ndarray) -> np.ndarray:
        """Refreshed values without the write-back scatters when staleness
        is homogeneous (the every-interval-read steady state); falls back
        to :meth:`_refresh` so heterogeneous catch-up work is never redone."""
        vals = self.value[pages]
        if pages.size == 0:
            return vals
        k = self.t - self.stamp[pages]
        kmax = int(k.max())
        if kmax <= 0:
            return vals
        if kmax == 1 and int(k.min()) == 1:
            return vals * self.decay
        return self._refresh(pages)

    def current(self, pages: np.ndarray) -> np.ndarray:
        """Heat as of the last completed interval."""
        return self._peek(pages)

    def lookahead(self, pages: np.ndarray) -> np.ndarray:
        """Heat decayed through the *current* interval (the demotion-ranking
        term)."""
        return self._peek(pages) * self.decay

    def dense(self) -> np.ndarray:
        """Materialize the full heat array (O(num_pages); telemetry only)."""
        self._refresh(np.arange(self.value.size))
        return self.value.copy()


class _DemoteQueue:
    """Per-interval victim queue for :meth:`TieredPagePool.demote_coldest`.

    Reclaim is invoked many times per interval (once per promotion chunk in
    the policy loop), but the ranking inputs (lazy heat and the interval's
    touch counters) are constant between invocations. So the fast tier is
    ranked **once** per interval in lexicographic (effective heat, page id)
    order, and successive demotions consume the queue front. Pages promoted
    mid-interval enter as *pending* entries and are merged during selection.

    Invariant: every queue entry at or after ``pos`` is still in the fast
    tier. Demotions only ever consume the queue front, ``promote`` cannot
    touch fast pages, and any other tier transition (``place``,
    first-touch allocation) invalidates the whole queue, so ``pop`` is
    pure front slicing, with no validity rescans.
    """

    def __init__(self, ids: np.ndarray, eff: np.ndarray, want: int) -> None:
        # unsorted remainder: every entry ranks strictly after the sorted
        # block, so sorting is paid only for pages actually demoted
        self._rest_ids = ids
        self._rest_eff = eff
        self.ids = np.empty(0, dtype=np.int64)
        self.eff = np.empty(0, dtype=np.float64)
        self.pos = 0
        self._pend_ids: list[np.ndarray] = []
        self._pend_eff: list[np.ndarray] = []
        self._pend_min = np.inf  # lower bound on pending eff
        self.pend_n = 0  # total pending entries (rebuild heuristic)
        self._extend(want)

    def add_pending(self, ids: np.ndarray, eff: np.ndarray) -> None:
        self._pend_ids.append(ids)
        self._pend_eff.append(eff)
        self.pend_n += ids.size
        if eff.size:
            self._pend_min = min(self._pend_min, float(eff.min()))

    def _extend(self, want: int) -> bool:
        """Carve the ``>= want`` coldest remainder entries (complete tie
        classes, via ``np.partition``'s boundary value) into the sorted
        block. Keeps the block an exact lexicographic prefix of the
        remaining fast tier."""
        rid, reff = self._rest_ids, self._rest_eff
        if rid.size == 0:
            return False
        want = min(int(want), rid.size)
        if want < rid.size:
            kth = np.partition(reff, want - 1)[want - 1]
            take = reff <= kth
            blk_ids, blk_eff = rid[take], reff[take]
            self._rest_ids, self._rest_eff = rid[~take], reff[~take]
        else:
            blk_ids, blk_eff = rid, reff
            self._rest_ids = np.empty(0, dtype=np.int64)
            self._rest_eff = np.empty(0, dtype=np.float64)
        order = np.lexsort((blk_ids, blk_eff))
        self.ids = np.concatenate([self.ids, blk_ids[order]])
        self.eff = np.concatenate([self.eff, blk_eff[order]])
        return True

    def _ensure(self, n: int) -> None:
        """Grow the sorted block until ``n`` entries are consumable (or the
        remainder is exhausted)."""
        while self.ids.size - self.pos < n:
            if not self._extend(2 * n + 1024):
                break

    def pop(self, n: int) -> np.ndarray:
        """The ``n`` lexicographically-coldest current fast pages."""
        self._ensure(n)
        avail = self.ids.size - self.pos
        if not self._pend_ids or (
            # pending entries are just-promoted (hot) pages; when even the
            # coldest of them is strictly hotter than the whole main window
            # the merge cannot select any of them: pure front slicing
            avail >= n
            and self._pend_min > self.eff[self.pos + n - 1]
        ):
            take = min(n, avail)
            victims = self.ids[self.pos : self.pos + take]
            self.pos += take
            return victims
        take_main = min(n, avail)
        m_ids = self.ids[self.pos : self.pos + take_main]
        m_eff = self.eff[self.pos : self.pos + take_main]
        p_ids = np.concatenate(self._pend_ids)
        p_eff = np.concatenate(self._pend_eff)
        cand_ids = np.concatenate([m_ids, p_ids])
        cand_eff = np.concatenate([m_eff, p_eff])
        order = np.lexsort((cand_ids, cand_eff))[:n]
        victims = cand_ids[order]
        # taken main entries are always a prefix of the main window (the
        # main queue is sorted), so the pointer advances past them
        self.pos += int(np.count_nonzero(order < take_main))
        keep = np.ones(p_ids.size, dtype=bool)
        keep[order[order >= take_main] - take_main] = False
        if np.any(keep):
            kept_eff = p_eff[keep]
            self._pend_ids = [p_ids[keep]]
            self._pend_eff = [kept_eff]
            self._pend_min = float(kept_eff.min())
            self.pend_n = kept_eff.size
        else:
            self._pend_ids = []
            self._pend_eff = []
            self._pend_min = np.inf
            self.pend_n = 0
        return victims


class _FastSet:
    """Swap-remove membership index over the fast tier.

    ``ids[:n]`` are the fast-tier page ids in arbitrary order; ``slot``
    maps page id -> position in ``ids`` (-1 = not a member). Batch add and
    remove are O(batch). The order it leaves is what
    :meth:`TieredPagePool.fast_pages` returns, and callers' unstable sorts
    break ties by it, so this is the JAX package's code unchanged.
    """

    def __init__(self, num_pages: int) -> None:
        self.ids = np.empty(num_pages, dtype=np.int64)
        self.slot = np.full(num_pages, -1, dtype=np.int64)
        self.n = 0

    def add(self, pages: np.ndarray) -> None:
        k = pages.size
        if k == 0:
            return
        self.ids[self.n : self.n + k] = pages
        self.slot[pages] = np.arange(self.n, self.n + k, dtype=np.int64)
        self.n += k

    def remove(self, pages: np.ndarray) -> None:
        k = pages.size
        if k == 0:
            return
        slots = self.slot[pages]
        self.slot[pages] = -1
        n_new = self.n - k
        # surviving members stranded in the tail move into freed head slots
        tail = self.ids[n_new : self.n]
        movers = tail[self.slot[tail] >= 0]
        dest = slots[slots < n_new]
        self.ids[dest] = movers
        self.slot[movers] = dest
        self.n = n_new

    def members(self) -> np.ndarray:
        """View of the current members (arbitrary order; do not mutate)."""
        return self.ids[: self.n]


def _bulk_schedule(
    free: int,
    fast_count: int,
    min_free: int,
    low_free: int,
    high_free: int,
    kswapd_batch: int,
    n_cand: int,
    events_out: list | None = None,
) -> tuple[int, int, int, int, int, int]:
    """Scalar TPP promote/reclaim schedule for one policy step.

    The TPP interleaving (promote into the headroom above the min
    watermark, reclaim, repeat) is a recurrence over ``fast_free`` and the
    watermarks: chunk sizes, reclaim amounts and failure counts never look
    at page identity. This computes the whole step's outcome with plain
    integers; the device step then applies the array work once. Returns ``(pm_pr, pm_de, pm_fail, direct_total, events,
    d_demand)``.

    ``events_out``, when given, receives one ``(promoted_prefix, demand)``
    tuple per demoting reclaim invocation, in step order (the direct and
    kswapd portions of one invocation are fused: no promotion happens
    between them, so they select victims from the same availability set).
    ``promoted_prefix`` is how many candidates had been promoted when the
    reclaim ran — the availability horizon the thrash-regime victim
    resolver (:func:`_resolve_step_victims`) partitions against.
    """
    done = pm_de = pm_fail = direct_total = events = 0
    d_demand = 0
    while done < n_cand:
        headroom = free - min_free
        if headroom <= 0:
            # run_reclaim(allow_direct=True)
            d_event = 0
            if free < min_free:
                n = min(min_free - free, fast_count)
                if n > 0:
                    d_demand += n
                    d_event += n
                    fast_count -= n
                    free += n
                    pm_de += n
                    direct_total += n
                events += 1
            if free < low_free:
                n = min(high_free - free, kswapd_batch, fast_count)
                if n > 0:
                    d_demand += n
                    d_event += n
                    fast_count -= n
                    free += n
                    pm_de += n
            if events_out is not None and d_event:
                events_out.append((done, d_event))
            headroom = free - min_free
            if headroom <= 0:
                pm_fail = n_cand - done
                break
        chunk = min(headroom, n_cand - done)
        done += chunk
        free -= chunk
        fast_count += chunk
    # final run_reclaim() — kswapd only
    if free < low_free:
        n = min(high_free - free, kswapd_batch, fast_count)
        if n > 0:
            d_demand += n
            fast_count -= n
            free += n
            pm_de += n
            if events_out is not None:
                events_out.append((done, n))
    return done, pm_de, pm_fail, direct_total, events, d_demand


def _bulk_schedule_batch(
    free: np.ndarray,
    fast_count: np.ndarray,
    min_free: np.ndarray,
    low_free: np.ndarray,
    high_free: np.ndarray,
    kswapd_batch: np.ndarray,
    n_cand: np.ndarray,
):
    """:func:`_bulk_schedule` across a whole size vector at once.

    Every scalar of the recurrence becomes an ``[n_sizes]`` int64 vector
    and the while-loop runs until every size's schedule has terminated, so
    the sweep pays one vectorized pass instead of ``n_sizes`` Python
    loops. Arithmetic is integer and identical to the scalar version —
    ``tests/test_engine_equivalence.py`` pins per-lane equality — which is
    what keeps the cross-size batched policy step bit-exact.

    Returns six ``[n_sizes]`` int64 arrays in :func:`_bulk_schedule`'s
    order: ``(pm_pr, pm_de, pm_fail, direct_total, events, d_demand)``.
    """
    free = np.asarray(free, dtype=np.int64).copy()
    fast_count = np.asarray(fast_count, dtype=np.int64).copy()
    min_free = np.asarray(min_free, dtype=np.int64)
    low_free = np.asarray(low_free, dtype=np.int64)
    high_free = np.asarray(high_free, dtype=np.int64)
    kswapd_batch = np.asarray(kswapd_batch, dtype=np.int64)
    n_cand = np.asarray(n_cand, dtype=np.int64)
    zeros = np.zeros_like(free)
    done = zeros.copy()
    pm_de = zeros.copy()
    pm_fail = zeros.copy()
    direct_total = zeros.copy()
    events = zeros.copy()
    d_demand = zeros.copy()
    active = done < n_cand
    while bool(active.any()):
        headroom = free - min_free
        reclaim = active & (headroom <= 0)
        if bool(reclaim.any()):
            # run_reclaim(allow_direct=True): direct to min, kswapd to high
            dm = reclaim & (free < min_free)
            n = np.where(dm, np.minimum(min_free - free, fast_count), 0)
            n = np.maximum(n, 0)
            d_demand += n
            fast_count -= n
            free += n
            pm_de += n
            direct_total += n
            events += dm  # one direct-reclaim event even when n == 0
            km = reclaim & (free < low_free)
            n = np.where(
                km,
                np.minimum(
                    np.minimum(high_free - free, kswapd_batch), fast_count
                ),
                0,
            )
            n = np.maximum(n, 0)
            d_demand += n
            fast_count -= n
            free += n
            pm_de += n
            headroom = free - min_free
            fail = reclaim & (headroom <= 0)
            pm_fail = np.where(fail, n_cand - done, pm_fail)
            active &= ~fail
        chunk = np.where(active, np.minimum(headroom, n_cand - done), 0)
        done += chunk
        free -= chunk
        fast_count += chunk
        active = active & (done < n_cand)
    # final run_reclaim() — kswapd only
    km = free < low_free
    n = np.where(
        km,
        np.minimum(np.minimum(high_free - free, kswapd_batch), fast_count),
        0,
    )
    n = np.maximum(n, 0)
    d_demand += n
    fast_count -= n
    free += n
    pm_de += n
    return done, pm_de, pm_fail, direct_total, events, d_demand


def _resolve_step_victims(
    base_eff: np.ndarray,
    base_ids: np.ndarray,
    cand_eff: np.ndarray,
    cand_ids: np.ndarray,
    events: list,
) -> tuple[int, np.ndarray]:
    """Victim identities for a bulk step whose reclaim demand reaches into
    the same step's promotions (the thrash regime).

    The chunked loop interleaves promotion chunks with reclaim; each
    reclaim demotes the lexicographically (effective heat, page id)
    coldest *current* fast pages — a set that, under pressure, includes
    candidates promoted by earlier chunks of the same step. Because the
    ranking key is frozen for the whole interval, that interleaving is a
    pure merge process between two key-sorted streams:

    * ``base_ids``/``base_eff`` — the pre-step fast tier in ranking
      order (only the coldest ``sum(d for _, d in events)`` entries are
      ever consumed, so callers pass a window that long);
    * the promoted candidates (``cand_ids``/``cand_eff``, in promotion
      order), each entering the merge at its ``events`` availability
      horizon — a candidate is demotable only by reclaims that ran after
      its promotion chunk.

    Per event the ``d`` globally-coldest available pages are a prefix of
    each stream, found by an O(log d) boundary search; the candidate
    stream is maintained as one key-sorted pending array re-partitioned
    at each availability horizon. No per-page replay, no tier writes —
    the caller commits both streams' victims in single array operations.

    Returns ``(n_base, cand_taken)``: the step demotes
    ``base_ids[:n_base]`` and ``cand_ids[cand_taken]`` (mask in
    promotion order).
    """
    order = np.lexsort((cand_ids, cand_eff))
    inv = np.empty(order.size, dtype=np.int64)
    inv[order] = np.arange(order.size, dtype=np.int64)
    s_eff = cand_eff[order]
    s_ids = cand_ids[order]
    taken = np.zeros(order.size, dtype=bool)  # by key-sorted position
    pend = np.empty(0, dtype=np.int64)  # available, key-sorted positions
    b = 0  # consumed prefix of the base stream
    p_prev = 0
    n_base = base_ids.size
    for p, d in events:
        if p > p_prev:
            new = np.sort(inv[p_prev:p])
            pend = np.insert(pend, np.searchsorted(pend, new), new)
            p_prev = p
        # split d = x base + y pending, prefix-wise in key order: binary
        # search for the unique boundary (keys are distinct: ids tie-break)
        lo = max(0, d - pend.size)
        hi = min(d, n_base - b)
        while lo < hi:
            mid = (lo + hi) // 2
            j = pend[d - mid - 1]
            if (s_eff[j], s_ids[j]) > (base_eff[b + mid], base_ids[b + mid]):
                lo = mid + 1
            else:
                hi = mid
        x = lo
        y = d - x
        if y:
            taken[pend[:y]] = True
            pend = pend[y:]
        b += x
    return b, taken[inv]


class TieredPagePool:
    """Two-tier page pool with hotness tracking and watermark reclaim.

    ``num_pages`` is the number of addressable pages, ``hw_capacity`` the
    fast tier's hardware capacity in pages (the effective size is whatever
    the watermarks allow), ``page_bytes`` the migration unit.
    ``hotness_halflife`` is the number of intervals over which the decayed
    touch counter halves; ``kswapd_batch`` the background reclaim budget
    per invocation (default ``max(128, hw_capacity // 64)``). ``seed`` is
    the JAX package's constructor argument; neither pool draws a random
    number. ``tier`` is a read-only view: tier moves go through
    :meth:`place`.

    The device sweep's slice pools are built by :meth:`for_slice` instead;
    they have no heat, no interval counters and no fast index.
    """

    def __init__(
        self,
        num_pages: int,
        hw_capacity: int,
        page_bytes: int = 4096,
        hotness_halflife: float = 2.0,
        kswapd_batch: int | None = None,
        seed: int = 0,
    ) -> None:
        if num_pages <= 0 or hw_capacity <= 0:
            raise ValueError("num_pages and hw_capacity must be positive")
        self._init_common(
            np.full(int(num_pages), _UNALLOC, dtype=np.int8),
            hw_capacity, page_bytes, kswapd_batch,
        )
        self.decay = 0.5 ** (1.0 / max(hotness_halflife, 1e-9))
        self._heat = LazyHeat(self.num_pages, self.decay)
        # cache-line accesses in the current interval (telemetry/cost)
        self.interval_acc = np.zeros(self.num_pages, dtype=np.int64)
        # fault-like touch events in the current interval (policy input)
        self.interval_touch = np.zeros(self.num_pages, dtype=np.int64)
        self._fast = _FastSet(self.num_pages)
        self._touched: list[np.ndarray] = []  # page batches this interval
        self._dq: _DemoteQueue | None = None  # per-interval victim queue

    @classmethod
    def for_slice(
        cls,
        tier_row: np.ndarray,
        hw_capacity: int,
        page_bytes: int = 4096,
        kswapd_batch: int | None = None,
    ) -> "TieredPagePool":
        """The control plane of one fast-memory size in a device sweep.

        ``tier_row`` is this size's row of the sweep's stacked host tier
        array (``UNALLOCATED``/``FAST``/``SLOW`` per page); the pool writes
        it only through :meth:`place` and :meth:`_import_tier_stack`.
        """
        if tier_row.ndim != 1 or tier_row.dtype != np.int8:
            raise ValueError("tier_row must be a 1-D int8 array")
        if tier_row.size <= 0 or hw_capacity <= 0:
            raise ValueError("num_pages and hw_capacity must be positive")
        pool = cls.__new__(cls)
        pool._init_common(tier_row, hw_capacity, page_bytes, kswapd_batch)
        pool._fast = None  # the device sweep keeps the tiers; no index
        return pool

    def _init_common(self, tier_row, hw_capacity, page_bytes, kswapd_batch) -> None:
        self.num_pages = int(tier_row.size)
        self.hw_capacity = int(hw_capacity)
        self.page_bytes = int(page_bytes)
        # kswapd demotion budget per reclaim invocation: background reclaim
        # is rate-limited, which is what lets promotions outrun it and fail
        self.kswapd_batch = (
            int(kswapd_batch)
            if kswapd_batch is not None
            else max(128, self.hw_capacity // 64)
        )
        self._tier = tier_row
        # public read-only view: tier moves go through place()
        self.tier = tier_row.view()
        self.tier.flags.writeable = False
        self.watermarks = Watermarks.for_size(self.hw_capacity, self.hw_capacity)
        self.stats = PoolStats()
        self._fast_used = int(np.count_nonzero(tier_row == _FAST))
        self._rss_pages = int(np.count_nonzero(tier_row != _UNALLOC))

    # ------------------------------------------------------------------ state
    @property
    def fast_used(self) -> int:
        return self._fast_used

    @property
    def fast_free(self) -> int:
        return self.hw_capacity - self._fast_used

    @property
    def rss_pages(self) -> int:
        return self._rss_pages

    @property
    def heat(self) -> np.ndarray:
        """Current decayed heat, materialized densely (O(num_pages)): a
        fresh array. Use :meth:`heat_of` for indexed reads."""
        return self._heat.dense()

    @property
    def effective_fm_size(self) -> int:
        """Fast-memory size currently permitted by the watermarks."""
        return self.hw_capacity - self.watermarks.low_free

    def set_fm_size(self, new_fm_pages: int) -> None:
        """Retune the fast-tier size via watermarks (paper Section 4)."""
        self.watermarks = Watermarks.for_size(self.hw_capacity, new_fm_pages)

    def fast_pages(self) -> np.ndarray:
        """Fast-tier page ids in the fast index's order (a copy)."""
        return self._fast.members().copy()

    def heat_of(self, pages: np.ndarray) -> np.ndarray:
        """Decayed heat of ``pages`` as of the last completed interval."""
        return self._heat.current(np.asarray(pages, dtype=np.int64))

    def _sync_index(self, pages: np.ndarray) -> None:
        """Reconcile the fast index + counter with ``tier`` for ``pages``
        (must be unique). O(batch)."""
        is_fast = self.tier[pages] == _FAST
        in_set = self._fast.slot[pages] >= 0
        rem = pages[in_set & ~is_fast]
        add = pages[is_fast & ~in_set]
        self._fast.remove(rem)
        self._fast.add(add)
        self._fast_used += add.size - rem.size

    def place(self, pages: np.ndarray, tier: Tier) -> None:
        """Explicitly move ``pages`` into ``tier`` (numactl/membind
        analogue: the micro-benchmark places its slow array this way, the
        KV cache its promoted and demoted pages)."""
        pages = np.unique(np.asarray(pages, dtype=np.int64))
        if pages.size == 0:
            return
        self._dq = None  # arbitrary tier moves invalidate the victim queue
        was_alloc = self._tier[pages] != _UNALLOC
        was_fast = int(np.count_nonzero(self._tier[pages] == _FAST))
        self._tier[pages] = int(tier)
        if tier == Tier.UNALLOCATED:
            self._rss_pages -= int(np.count_nonzero(was_alloc))
        else:
            self._rss_pages += int(np.count_nonzero(~was_alloc))
        if self._fast is None:
            self._fast_used += (pages.size if tier == Tier.FAST else 0) - was_fast
        else:
            self._sync_index(pages)

    # -------------------------------------------------------------- accesses
    def apply_accesses(
        self,
        pages: np.ndarray,
        counts: np.ndarray,
        touches: np.ndarray | None = None,
        touch_cap: int | None = None,
    ) -> tuple[int, int, int, int, int, int]:
        """Record an interval's page accesses; allocate on first touch.

        ``counts`` are cache-line accesses (cost model); ``touches`` are
        fault-like events the policy thresholds on; ``touch_cap`` saturates
        the reported per-page touch count. Returns ``(pacc_fast_cl,
        pacc_slow_cl, ptouch_fast, ptouch_slow, warm_pages_fast,
        warm_touches_fast)``. First-touch allocation goes to the fast tier
        while free pages remain above the low watermark, then spills slow.
        """
        pages = np.asarray(pages, dtype=np.int64)
        counts = np.asarray(counts, dtype=np.int64)
        touches = counts if touches is None else np.asarray(touches, dtype=np.int64)
        if pages.size == 0:
            return 0, 0, 0, 0, 0, 0
        self._dq = None  # new touches change the demotion ranking
        # first-touch allocation for unallocated pages, in access order
        new_mask = self.tier[pages] == _UNALLOC
        if np.any(new_mask):
            self._first_touch_alloc(pages[new_mask])
        self.interval_acc[pages] += counts
        self.interval_touch[pages] += touches
        self._touched.append(pages)
        tiers = self.tier[pages]
        fast_m = tiers == _FAST
        slow_m = tiers == _SLOW
        pacc_f = int(counts[fast_m].sum())
        pacc_s = int(counts[slow_m].sum())
        rep = touches if touch_cap is None else np.minimum(touches, touch_cap)
        ptouch_f = int(rep[fast_m].sum())
        ptouch_s = int(rep[slow_m].sum())
        cap = touch_cap if touch_cap is not None else 4
        warm_m = fast_m & (rep < cap)
        warm_pages_f = int(np.count_nonzero(warm_m))
        warm_touch_f = int(rep[warm_m].sum())
        return (pacc_f, pacc_s, ptouch_f, ptouch_s, warm_pages_f, warm_touch_f)

    def _first_touch_alloc(self, new_pages: np.ndarray) -> None:
        """Allocate ``new_pages`` (currently UNALLOCATED, in access order):
        fast while free pages stay above the low watermark, then slow."""
        budget = max(0, self.fast_free - self.watermarks.low_free)
        n_fast = min(budget, new_pages.size)
        self._tier[new_pages[:n_fast]] = _FAST
        self._tier[new_pages[n_fast:]] = _SLOW
        self.stats.alloc_fast += int(n_fast)
        self.stats.alloc_slow += int(new_pages.size - n_fast)
        uniq = np.unique(new_pages)
        self._rss_pages += int(uniq.size)
        self._sync_index(uniq)

    def end_interval(self) -> None:
        """Fold the interval counters into the decayed heat and reset.
        O(pages touched this interval), or dense once they reach an eighth
        of the pool."""
        self._dq = None  # heat fold changes the demotion ranking
        n_touched = sum(batch.size for batch in self._touched)
        if n_touched >= self.num_pages // 8:
            self._heat.fold_dense(self.interval_touch)
            self.interval_acc[:] = 0
            self.interval_touch[:] = 0
            self._touched.clear()
        elif n_touched:
            touched = (
                self._touched[0]
                if len(self._touched) == 1
                else np.concatenate(self._touched)
            )
            # duplicate ids are fine: fancy assignment gathers the operands
            # first, so a page folds once no matter how often it appears
            self._heat.fold(touched, self.interval_touch[touched])
            self.interval_acc[touched] = 0
            self.interval_touch[touched] = 0
            self._touched.clear()
        else:
            self._heat.fold(np.empty(0, np.int64), np.empty(0, np.int64))

    # ------------------------------------------------------------- migration
    def promote(self, pages: np.ndarray) -> tuple[int, int]:
        """Attempt to promote ``pages`` (slow to fast), hottest first.

        Promotions beyond the free fast capacity *fail*. Returns
        ``(n_promoted, n_failed)``.
        """
        pages = np.asarray(pages, dtype=np.int64)
        pages = pages[self.tier[pages] == _SLOW]
        if pages.size == 0:
            return 0, 0
        free = self.fast_free
        if pages.size <= free:
            # every page fits: the hottest-first ranking cannot change the
            # outcome, so skip it
            n_ok = pages.size
            winners = pages
        else:
            order = np.argsort(-self._heat.current(pages), kind="stable")
            pages = pages[order]
            n_ok = free
            winners = pages[:n_ok]
        self._tier[winners] = _FAST
        if n_ok:
            uniq = np.unique(winners)
            self._fast_used += uniq.size
            # winners were slow, hence not in the fast index: direct add
            self._fast.add(uniq)
            if self._dq is not None:
                # mid-interval promotions join the active victim queue
                self._dq.add_pending(
                    uniq,
                    self._heat.lookahead(uniq) + self.interval_touch[uniq],
                )
        n_fail = pages.size - n_ok
        self.stats.pgpromote_success += int(n_ok)
        self.stats.pgpromote_fail += int(n_fail)
        return int(n_ok), int(n_fail)

    def _promote_cand(self, pages: np.ndarray) -> tuple[int, int]:
        """:meth:`promote` minus the slow filter and duplicate guard, for
        policy promotion chunks whose invariants (unique ids, all currently
        slow) the caller has verified. Outcome-identical to ``promote``."""
        if pages.size == 0:
            return 0, 0
        free = self.fast_free
        if pages.size <= free:
            n_ok = pages.size
            winners = pages
        else:
            order = np.argsort(-self._heat.current(pages), kind="stable")
            winners = pages[order][:free]
            n_ok = free
        self._tier[winners] = _FAST
        if n_ok:
            self._fast_used += n_ok
            self._fast.add(winners)
            if self._dq is not None:
                self._dq.add_pending(
                    winners,
                    self._heat.lookahead(winners) + self.interval_touch[winners],
                )
        n_fail = pages.size - n_ok
        self.stats.pgpromote_success += int(n_ok)
        self.stats.pgpromote_fail += int(n_fail)
        return int(n_ok), int(n_fail)

    def demote_coldest(self, n: int, direct: bool = False) -> int:
        """Demote up to ``n`` coldest fast pages (fast to slow).

        Victims are the ``n`` lexicographically smallest fast pages by
        (effective heat, page id), served from a per-interval
        :class:`_DemoteQueue` built over the fast index only: one ranking
        pass amortizes across every reclaim invocation of the interval.
        """
        if n <= 0:
            return 0
        size = self._fast_used
        if size == 0:
            return 0
        n = min(n, size)
        # rebuild when mid-interval promotions dominate the queue: the
        # ranking inputs are interval-constant, so a rebuild selects the
        # same victims while restoring cheap front-slice pops
        if self._dq is None or self._dq.pend_n > max(4 * n, 4096):
            ids = self._fast.members().copy()
            # rank victims by *effective* heat (decayed history + the
            # current interval's touches), so pages promoted moments ago
            # are not the first demotion victims
            eff = self._heat.lookahead(ids) + self.interval_touch[ids]
            self._dq = _DemoteQueue(ids, eff, want=2 * n)
        victims = self._dq.pop(n)
        self._tier[victims] = _SLOW
        self._fast.remove(victims)
        # victims.size == n whenever the occupancy invariants hold; the
        # realized count keeps the stats self-consistent regardless
        n_done = int(victims.size)
        self._fast_used -= n_done
        if direct:
            self.stats.pgdemote_direct += n_done
        else:
            self.stats.pgdemote_kswapd += n_done
        return n_done

    def run_reclaim(self, allow_direct: bool = False) -> tuple[int, int]:
        """Watermark-driven reclaim (paper Section 4): kswapd toward the high
        watermark, rate limited per invocation; direct (blocking) reclaim
        to the min watermark only when the caller needs space synchronously
        (``allow_direct``). Returns ``(demoted_background, demoted_direct)``.
        """
        demoted_bg = demoted_direct = 0
        free = self.fast_free
        if allow_direct and free < self.watermarks.min_free:
            demoted_direct = self.demote_coldest(
                self.watermarks.min_free - free, direct=True
            )
            self.stats.direct_reclaim_events += 1
            free = self.fast_free
        if free < self.watermarks.low_free:
            want = min(self.watermarks.high_free - free, self.kswapd_batch)
            demoted_bg = self.demote_coldest(want)
        return demoted_bg, demoted_direct

    def _try_bulk_step(self, cand: np.ndarray, _sched=None):
        """Whole-policy-step bulk path for :class:`~repro_torch.tiering.
        policy.TPPPolicy` and its subclasses: returns ``(pm_pr, pm_de,
        pm_fail, direct)``, or ``None`` only when the queue state was
        perturbed from outside a policy step (stray pending entries,
        corrupted supply).

        The TPP promote/reclaim interleaving is a scalar recurrence over
        ``fast_free`` and the watermarks (:func:`_bulk_schedule`), so the
        whole step's schedule is computed with plain integers first and
        the array work applied once: promotions are a prefix of ``cand``
        and victims come from the front of the demotion queue. When the
        coldest promoted candidate is not strictly hotter than the queue's
        ``D``-th entry (the thrash regime), the step's reclaim events are
        replayed as availability horizons (:meth:`_schedule_events`) and
        :func:`_resolve_step_victims` merges the queue against the
        same-step promotions: the victim set the chunked loop would demote
        page by page. ``cand`` must be unique (the caller checks).
        """
        dq = self._dq
        if dq is None:
            ids = self._fast.members().copy()
            eff = self._heat.lookahead(ids) + self.interval_touch[ids]
            self._dq = dq = _DemoteQueue(ids, eff, want=2 * self.kswapd_batch)
        elif dq.pend_n:
            return None  # pending entries from outside a policy step
        if _sched is None:
            wm = self.watermarks
            _sched = _bulk_schedule(
                self.fast_free,
                self._fast_used,
                wm.min_free,
                wm.low_free,
                wm.high_free,
                self.kswapd_batch,
                int(cand.size),
            )
        pm_pr, pm_de, pm_fail, direct_total, events, d_demand = _sched
        winners = cand[:pm_pr]
        # --- victim identity: fast path when every victim provably comes
        # from the pre-step fast tier; the thrash path resolves the
        # same-step promote/demote interleaving otherwise
        eff_cand = None
        victims = None  # base-stream victims (pre-step fast tier)
        kept = winners  # promoted candidates still fast at step end
        kept_eff = None
        base_consumed = 0  # queue entries consumed by the thrash path
        if d_demand:
            dq._ensure(d_demand)
            avail = dq.ids.size - dq.pos
            interferes = avail < d_demand
            if not interferes and pm_pr:
                eff_cand = self._heat.lookahead(cand) + self.interval_touch[cand]
                interferes = bool(
                    float(eff_cand[:pm_pr].min()) <= dq.eff[dq.pos + d_demand - 1]
                )
            if interferes:
                if avail + pm_pr < d_demand:
                    return None  # supply mismatch: corrupted state
                if eff_cand is None:
                    eff_cand = (
                        self._heat.lookahead(cand) + self.interval_touch[cand]
                    )
                w = dq.pos + min(avail, d_demand)
                base_n, cand_taken = _resolve_step_victims(
                    dq.eff[dq.pos : w],
                    dq.ids[dq.pos : w],
                    eff_cand[:pm_pr],
                    winners,
                    self._schedule_events(cand.size),
                )
                victims = dq.ids[dq.pos : dq.pos + base_n]
                base_consumed = base_n
                keep_m = ~cand_taken
                kept = winners[keep_m]
                kept_eff = eff_cand[:pm_pr][keep_m]
        # --- commit: one batched demote + one batched (prefix) promote
        if d_demand:
            if victims is None:
                victims = dq.pop(d_demand)
            else:
                dq.pos += base_consumed
            self._fast.remove(victims)
            self._tier[victims] = _SLOW
            self._fast_used -= d_demand
            self.stats.pgdemote_direct += direct_total
            self.stats.pgdemote_kswapd += pm_de - direct_total
        self.stats.direct_reclaim_events += events
        if pm_pr:
            self._tier[kept] = _FAST
            self._fast_used += pm_pr
            self._fast.add(kept)
            if kept_eff is not None:
                dq.add_pending(kept, kept_eff)
            elif eff_cand is not None:
                dq.add_pending(kept, eff_cand[:pm_pr])
            else:
                dq.add_pending(
                    kept, self._heat.lookahead(kept) + self.interval_touch[kept]
                )
        self.stats.pgpromote_success += pm_pr
        # pm_fail is reported to the policy outcome only: the chunked loop
        # never calls promote() on the reclaim-exhausted tail, so the pool
        # counter (what the profiler snapshots) must not include it either
        return pm_pr, pm_de, pm_fail, direct_total

    # ------------------------------------------------------ sweep bookkeeping
    def _first_touch(self, n_new: int) -> int:
        """Account ``n_new`` first-touched pages (the interval's new pages,
        in access order): the first ``n_fast`` go fast while free pages stay
        above the low watermark, the rest spill slow. Returns ``n_fast``;
        the engine writes the tier rows on the device."""
        budget = max(0, self.fast_free - self.watermarks.low_free)
        n_fast = min(budget, int(n_new))
        self.stats.alloc_fast += int(n_fast)
        self.stats.alloc_slow += int(n_new - n_fast)
        self._rss_pages += int(n_new)
        self._fast_used += int(n_fast)
        return n_fast

    def _commit_step(
        self, pm_pr: int, pm_de: int, direct_total: int, events: int,
        d_demand: int,
    ) -> None:
        """Fold one policy step's schedule into the counters (what the JAX
        package's bulk step books; pm_fail reaches the policy outcome only)."""
        self._fast_used += int(pm_pr) - int(d_demand)
        st = self.stats
        st.pgdemote_direct += int(direct_total)
        st.pgdemote_kswapd += int(pm_de) - int(direct_total)
        st.direct_reclaim_events += int(events)
        st.pgpromote_success += int(pm_pr)

    def _schedule_events(self, n_cand: int) -> list:
        """Re-run the scalar schedule recurrence on this pool's current
        (pre-step) state to recover the per-reclaim availability horizons
        consumed by :func:`_resolve_step_victims`. Pure integer work; only
        paid on the thrash path, and must run before the step's commit.
        """
        wm = self.watermarks
        events: list = []
        _bulk_schedule(
            self.fast_free,
            self._fast_used,
            wm.min_free,
            wm.low_free,
            wm.high_free,
            self.kswapd_batch,
            int(n_cand),
            events_out=events,
        )
        return events

    @staticmethod
    def _export_tier_stack(pools) -> np.ndarray:
        """The pools' tier rows as one stacked ``[n_sizes, rss]`` int8
        array (a copy: the device transfer source)."""
        if not pools:
            raise ValueError("_export_tier_stack needs at least one pool")
        num_pages = pools[0].num_pages
        if any(p.num_pages != num_pages for p in pools):
            raise ValueError("pools must share num_pages to stack tiers")
        return np.stack([np.asarray(p.tier, dtype=np.int8) for p in pools])

    @staticmethod
    def _import_tier_stack(pools, tier_stack: np.ndarray) -> None:
        """Write a stacked ``[n_sizes, rss]`` tier array back into the
        pools' rows and recount each pool's occupancy counters."""
        tier_stack = np.asarray(tier_stack, dtype=np.int8)
        if tier_stack.shape != (len(pools), pools[0].num_pages if pools else 0):
            raise ValueError(
                f"tier stack shape {tier_stack.shape} does not match "
                f"{len(pools)} pools x {pools[0].num_pages if pools else 0} pages"
            )
        for pool, row in zip(pools, tier_stack):
            pool._tier[:] = row
            pool._fast_used = int(np.count_nonzero(row == _FAST))
            pool._rss_pages = int(np.count_nonzero(row != _UNALLOC))
