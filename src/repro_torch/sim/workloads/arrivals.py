"""Arrival-driven session workload: the fleet's production traffic shape
(counterpart of :mod:`repro.sim.workloads.arrivals`; the traces are
identical).

Production tiered-memory hosts do not see a steady working set — they see
*sessions* (requests, user contexts, KV-cache lifetimes) arriving under a
time-varying rate and holding memory for a long-tailed duration. This
module generates that shape as a standard
:class:`~repro_torch.core.trace.Trace` so every engine path can consume
it:

* **arrival process** — open loop (Poisson with a time-varying rate) or
  closed loop (a fixed user population with exponential think times, so
  arrivals throttle themselves under load);
* **rate modulation** — a diurnal sinusoid (period ``diurnal_period``
  intervals) times seeded flash-crowd bursts (``flash_crowds`` windows at
  ``flash_mult`` the base rate) — :func:`modulated_rates` exposes the
  deterministic rate curve for tests and capacity math;
* **session lifetime** — ``1 + Pareto(session_tail) * session_mean``
  intervals, the classic long-tail: most sessions are short, a few pin
  their pages for a large fraction of the run;
* **memory shape** — each session owns a private slot of
  ``pages_per_session`` pages (gather-touched past the promotion
  threshold every interval it is live, then instantly cold — the
  promote/demote churn tiering must absorb), over a Zipf-popular shared
  region (model weights / common prefixes) that stays durably hot.

Everything is seeded: the flash-crowd placement, the Poisson draws, the
session lengths, and the per-interval gather offsets all derive from the
single ``seed`` argument, so two calls with equal arguments produce
bit-identical traces (the trace-determinism invariant, TUNA007).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.trace import Trace
from repro_torch.sim.workloads.base import PageMapper, zipf_weights

ELEM_BYTES = 8


def modulated_rates(
    n_intervals: int,
    base_rate: float = 3.0,
    diurnal_amp: float = 0.6,
    diurnal_period: int = 48,
    flash_crowds: int = 2,
    flash_mult: float = 6.0,
    flash_len: int = 3,
    seed: int = 29,
) -> np.ndarray:
    """Per-interval arrival rate: diurnal sinusoid x flash-crowd bursts.

    ``rate[i] = base_rate * (1 + diurnal_amp * sin(2*pi*i/diurnal_period))``,
    multiplied by ``flash_mult`` inside each of ``flash_crowds`` seeded
    burst windows of ``flash_len`` intervals (placed uniformly without
    replacement, deterministically from ``seed``). Rates are floored at a
    small positive value so the closed-loop think-time scaling stays
    defined through the diurnal trough.
    """
    i = np.arange(n_intervals, dtype=np.float64)
    rates = base_rate * (
        1.0 + diurnal_amp * np.sin(2.0 * np.pi * i / diurnal_period)
    )
    if flash_crowds > 0 and n_intervals > flash_len:
        rng = np.random.default_rng(seed)
        starts = rng.choice(
            max(1, n_intervals - flash_len),
            size=min(flash_crowds, max(1, n_intervals - flash_len)),
            replace=False,
        )
        for s in starts:
            rates[int(s) : int(s) + flash_len] *= flash_mult
    return np.maximum(rates, 0.05)


def open_arrivals(rates: np.ndarray, seed: int = 29) -> np.ndarray:
    """Open-loop arrival counts: one Poisson draw per interval rate."""
    rng = np.random.default_rng(seed)
    return rng.poisson(np.asarray(rates, dtype=np.float64))


def session_lengths(n: int, session_mean: float, session_tail: float,
                    rng: np.random.Generator) -> np.ndarray:
    """Long-tail session durations (intervals): 1 + Pareto-scaled mean."""
    if n == 0:
        return np.empty(0, dtype=np.int64)
    raw = 1.0 + rng.pareto(session_tail, size=n) * session_mean
    return np.maximum(1, np.rint(raw)).astype(np.int64)


def arrivals_trace(
    n_intervals: int = 72,
    rss_pages: int = 24_000,
    mode: str = "open",
    base_rate: float = 3.0,
    n_users: int = 24,
    think_time: float = 2.0,
    diurnal_amp: float = 0.6,
    diurnal_period: int = 48,
    flash_crowds: int = 2,
    flash_mult: float = 6.0,
    flash_len: int = 3,
    session_mean: float = 4.0,
    session_tail: float = 1.6,
    pages_per_session: int = 600,
    shared_frac: float = 0.25,
    reps: int = 5,
    seed: int = 29,
    page_bytes: int = 4096,
) -> Trace:
    """Session-arrival workload over a shared + per-session page arena.

    ``mode="open"`` draws Poisson arrivals at the :func:`modulated_rates`
    curve; ``mode="closed"`` runs ``n_users`` users that alternate
    exponential think times (mean ``think_time`` intervals, consumed
    faster when the rate curve is high) with sessions — arrivals are then
    bounded by the population, the load-throttling shape open-loop traces
    cannot express. Each arriving session claims a private page slot
    (evicting the oldest live session when the heap is full — capacity
    eviction, part of the workload, not the tiering layer) and gathers
    ``reps`` random touches per slot page per live interval, so its slot
    rides above the default promotion threshold exactly while the session
    lives. A Zipf-popular shared region (``shared_frac`` of the RSS)
    absorbs per-session lookups and stays durably hot; a sparse uniform
    sprinkle keeps the cold tail ranked.
    """
    if mode not in ("open", "closed"):
        raise ValueError(f"arrivals_trace mode must be 'open'/'closed', got {mode!r}")
    rng = np.random.default_rng(seed)
    pm = PageMapper("arrivals", page_bytes=page_bytes, num_threads=8)
    elems_per_page = page_bytes // ELEM_BYTES
    n_elems = rss_pages * elems_per_page
    pm.region("arena", n_elems, ELEM_BYTES)
    # init: physical allocation pass
    pm.touch_range("arena", 0, n_elems)
    pm.end_interval()

    shared_pages = max(1, int(rss_pages * shared_frac))
    slot_pages = max(1, min(pages_per_session, rss_pages - shared_pages))
    n_slots = max(1, (rss_pages - shared_pages) // slot_pages)
    shared_w = zipf_weights(shared_pages, 1.1, rng)

    rates = modulated_rates(
        n_intervals, base_rate, diurnal_amp, diurnal_period,
        flash_crowds, flash_mult, flash_len, seed=seed,
    )
    arrivals = (
        open_arrivals(rates, seed=seed + 1) if mode == "open" else None
    )
    mean_rate = float(rates.mean())
    if mode == "closed":
        think = rng.exponential(think_time, size=n_users)
        busy = np.zeros(n_users, dtype=np.int64)

    # live sessions: parallel arrays slot id / remaining intervals / age
    live_slot: list[int] = []
    live_left: list[int] = []
    free_slots = list(range(n_slots))
    bg_n = max(1, rss_pages // 200)

    for i in range(n_intervals):
        if mode == "open":
            n_new = int(arrivals[i])
        else:
            # closed loop: high-rate periods consume think time faster
            busy = np.maximum(busy - 1, 0)
            idle = busy == 0
            think = np.where(idle, think - rates[i] / max(mean_rate, 1e-9), think)
            ready = np.flatnonzero(idle & (think <= 0.0))
            n_new = ready.size
        lengths = session_lengths(n_new, session_mean, session_tail, rng)
        if mode == "closed" and n_new:
            busy[ready] = lengths
            think[ready] = rng.exponential(think_time, size=n_new)
        for ln in lengths:
            if free_slots:
                slot = free_slots.pop()
            else:
                # heap full: capacity-evict the oldest live session
                oldest = int(np.argmin(live_left))
                slot = live_slot.pop(oldest)
                live_left.pop(oldest)
            live_slot.append(slot)
            live_left.append(int(ln))

        if live_slot:
            slots = np.asarray(live_slot, dtype=np.int64)
            base = shared_pages + slots * slot_pages
            win = (base[:, None] + np.arange(slot_pages, dtype=np.int64)).ravel()
            idx = np.repeat(win, reps) * elems_per_page + rng.integers(
                0, elems_per_page, size=win.size * reps
            )
            pm.touch("arena", idx, ops_per_access=3.0)
            # per-session shared-region lookups (Zipf-popular: durably hot)
            n_shared = slots.size * slot_pages
            sp = rng.choice(shared_pages, size=n_shared, p=shared_w).astype(
                np.int64
            )
            pm.touch(
                "arena",
                sp * elems_per_page
                + rng.integers(0, elems_per_page, size=n_shared),
                ops_per_access=4.0,
            )
        # sparse cold-tail sprinkle (also keeps idle intervals non-empty)
        bg = rng.choice(rss_pages, size=bg_n, replace=False).astype(np.int64)
        pm.touch(
            "arena",
            bg * elems_per_page + rng.integers(0, elems_per_page, size=bg_n),
            ops_per_access=2.0,
        )
        pm.end_interval()

        # age the live sessions; finished ones release their slots
        keep_slot, keep_left = [], []
        for slot, left in zip(live_slot, live_left):
            if left > 1:
                keep_slot.append(slot)
                keep_left.append(left - 1)
            else:
                free_slots.append(slot)
        live_slot, live_left = keep_slot, keep_left
    return pm.trace
