"""Address-level timing engine: event replay with bounded MLP, on the card.

Counterpart of :mod:`repro.timing.engine`. One interval's accesses are
expanded into a deterministic stream of memory events and replayed against
a two-channel (fast/slow) memory model:

* each event occupies its tier's channel for ``occupancy`` seconds, so
  concurrent events on one tier serialize through its bandwidth;
* each event then waits its tier's access latency; latency is hidden
  across the in-flight window (at most ``mlp x num_threads`` events) but
  exposed along per-page dependence chains (a page's random accesses
  issue back to back);
* sequential runs are prefetched: one latency exposure per page run.

Very large intervals are coarsened deterministically: every event stands
for ``scale`` real accesses and the window shrinks to ``W / scale`` slots,
so at most about ``max_events`` random events are materialized an interval
(every touched page keeps at least one).

The event streams are built on ``device`` in torch (``repeat_interleave``,
int64 cumsums and one sort on the unique key ``pos * n + perm[page]``, the
order of the JAX package's ``np.lexsort((perm[page_rep], pos))``), with
every float step the JAX package's own IEEE operation, so the streams are
bit-identical. The replay is :func:`repro_torch.kernels.timing_replay.
timing_replay`: the CUDA kernel on the card, which replays many intervals
in one launch (:meth:`AddressTimingEngine.replay_intervals`), or its plain
version on the CPU.

Determinism: the only randomness is the page interleave permutation,
drawn on the host from ``np.random.default_rng((seed, interval_index))``,
the JAX package's draw, so replays are bit-identical across runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.timing_replay import timing_replay
from repro_torch.timing.latency import FAST, SLOW, TimingParams, absorb_llc


@dataclass(frozen=True)
class TimedInterval:
    """Realized timing of one interval (comparable 1:1 with IntervalCosts)."""

    total: float  # realized seconds, all terms composed
    t_app: float  # event-replay makespan (memory side)
    t_compute: float  # arithmetic term (overlaps t_app)
    t_migrate: float  # migration software overhead
    t_stall: float  # direct-reclaim + failed-promotion stalls
    events: int  # events materialized for the replay
    scale: float  # accesses represented per event (coarsening factor)
    bytes_fast: int  # application bytes served by the fast tier
    bytes_slow: int  # application bytes served by the slow tier

    @property
    def t_mem(self) -> float:
        return self.t_app


@dataclass
class EventStream:
    """One interval's ordered events on the device, ready to replay."""

    page: torch.Tensor  # int32 index into the interval's pages
    tier: torch.Tensor  # int8, FAST / SLOW
    occ: torch.Tensor  # float64 channel seconds
    lat: torch.Tensor  # float64 seconds
    scale: float
    n_pages: int


class AddressTimingEngine:
    """Replays intervals event by event; seeded-deterministic. ``device``
    (``None`` = the card, ``"cpu"`` for the plain path) is where the event
    streams are built and replayed."""

    def __init__(self, params: TimingParams, seed: int = 0, device=None) -> None:
        self.params = params
        self.seed = int(seed)
        self.device = resolve_device(device)

    # ------------------------------------------------------------ replay
    def replay_interval(
        self,
        index: int,
        pages: np.ndarray,
        counts: np.ndarray,
        tiers: np.ndarray,
        ops: float,
        num_threads: int = 1,
        rand_frac: float = 1.0,
        writes: np.ndarray | None = None,
        pm_pr: int = 0,
        pm_de: int = 0,
        pm_fail: int = 0,
        direct_reclaimed: int = 0,
    ) -> TimedInterval:
        """Time one interval's accesses against the given placement.

        ``tiers`` gives the tier backing each page *at access time*
        (0 fast, 1 slow); ``writes`` is the per-page store count (``None``
        = all reads). Migrations preload channel occupancy and add their
        software overhead; stalls are additive, compute overlaps with
        memory (the interval model's roofline composition: the clocks
        differ in the memory term only).
        """
        return self.replay_intervals([dict(
            index=index, pages=pages, counts=counts, tiers=tiers, ops=ops,
            num_threads=num_threads, rand_frac=rand_frac, writes=writes,
            pm_pr=pm_pr, pm_de=pm_de, pm_fail=pm_fail,
            direct_reclaimed=direct_reclaimed,
        )])[0]

    def replay_intervals(self, jobs) -> list[TimedInterval]:
        """:meth:`replay_interval` for each of ``jobs`` (dicts of its
        keyword arguments), with every non-empty interval's events built
        first and all of them replayed in one :func:`timing_replay` call."""
        parts, streams = [], []
        for job in jobs:
            part, ev = self._prepare(**job)
            parts.append(part)
            if ev is not None:
                streams.append(ev)
        t_apps = iter(self._replay_all(streams).tolist() if streams else ())
        out = []
        for part in parts:
            t_app = next(t_apps) if part["events"] else 0.0
            total = (
                max(part["t_compute"], t_app) + part["t_migrate"] + part["t_stall"]
                if part["events"]
                else part["t_compute"] + part["t_migrate"] + part["t_stall"]
            )
            out.append(TimedInterval(total=total, t_app=t_app, **part))
        return out

    def _prepare(self, index, pages, counts, tiers, ops, num_threads=1,
                 rand_frac=1.0, writes=None, pm_pr=0, pm_de=0, pm_fail=0,
                 direct_reclaimed=0):
        """The host terms of one interval and, when it has accesses, its
        event stream with the replay's window and channel preload."""
        p = self.params
        threads = max(1, int(num_threads))
        counts = absorb_llc(
            np.asarray(counts, dtype=np.int64),
            p.llc_pages,
            max(1, p.page_bytes // p.access_bytes),
        )
        tiers = np.asarray(tiers)
        if tiers.shape != counts.shape or (
            tiers.size and not np.all((tiers == FAST) | (tiers == SLOW))
        ):
            raise ValueError("tiers must be 0/1 and aligned with counts")
        if writes is None:
            writes = np.zeros_like(counts)
        else:
            writes = np.minimum(np.asarray(writes, dtype=np.int64), counts)
        part = dict(
            t_compute=ops / (p.ops_per_s * threads),
            t_migrate=(pm_pr + pm_de) * p.migrate_page_overhead / threads,
            t_stall=(
                direct_reclaimed * p.direct_reclaim_stall
                + pm_fail * p.promote_fail_penalty
            ),
            events=0,
            scale=1.0,
            bytes_fast=int(counts[tiers == FAST].sum()) * p.access_bytes,
            bytes_slow=int(counts[tiers == SLOW].sum()) * p.access_bytes,
        )
        if counts.size == 0 or counts.sum() == 0:
            return part, None
        ev = self._build_events(index, counts, tiers, writes, rand_frac)
        part["events"] = int(ev.page.numel())
        part["scale"] = float(ev.scale)
        w_slots = max(1, int(round(p.window * threads / ev.scale)))
        chan = p.migration_channel_seconds(pm_pr, pm_de)
        return part, (ev, w_slots, chan)

    def _replay_all(self, streams) -> torch.Tensor:
        """Concatenate the streams and replay them in one call."""
        dev = self.device
        evs = [s[0] for s in streams]
        sizes = [ev.page.numel() for ev in evs]
        ev_off = torch.zeros(len(evs) + 1, dtype=torch.int64)
        ev_off[1:] = torch.cumsum(torch.tensor(sizes, dtype=torch.int64), dim=0)
        return timing_replay(
            torch.cat([ev.page for ev in evs]),
            torch.cat([ev.tier for ev in evs]),
            torch.cat([ev.occ for ev in evs]),
            torch.cat([ev.lat for ev in evs]),
            ev_off.to(dev),
            torch.tensor([s[1] for s in streams], dtype=torch.int64, device=dev),
            torch.tensor([s[2] for s in streams], dtype=torch.float64, device=dev),
            torch.tensor([ev.n_pages for ev in evs], dtype=torch.int64, device=dev),
        )

    # ----------------------------------------------------- event stream
    def _build_events(self, index, counts, tiers, writes, rand_frac) -> EventStream:
        """Expand per-page histograms into an ordered event stream.

        Per page: a chain of random-access events (back to back on the
        page) followed by one prefetched sequential burst if the page has
        a sequential share. Chains from different pages are interleaved
        round-robin in a seeded-permutation order.
        """
        p = self.params
        dev = self.device
        n = counts.size
        f64 = torch.float64
        counts_d = torch.from_numpy(counts).to(dev)
        writes_d = torch.from_numpy(np.ascontiguousarray(writes, dtype=np.int64)).to(dev)
        rand = torch.round(
            counts_d.to(f64) * float(np.clip(rand_frac, 0.0, 1.0))
        ).to(torch.int64)
        seq = counts_d - rand
        wr_rand = torch.minimum(writes_d, rand)
        wr_seq = writes_d - wr_rand

        total_rand = int(rand.sum())
        scale = max(1.0, total_rand / max(1, p.max_events))
        n_ev = torch.ceil(rand.to(f64) / scale).to(torch.int64)  # random events a page
        has_seq = seq > 0
        chain_len = n_ev + has_seq

        page_rep = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int64, device=dev), chain_len
        )
        total = page_rep.numel()
        off = torch.repeat_interleave(torch.cumsum(chain_len, dim=0) - chain_len, chain_len)
        pos = torch.arange(total, dtype=torch.int64, device=dev) - off  # in chain

        is_seq_ev = pos == n_ev[page_rep]
        # lines represented by each event (floats; conserves counts exactly)
        lines_rand = torch.where(
            n_ev > 0, rand.to(f64) / n_ev.clamp(min=1).to(f64), 0.0
        )
        lines = torch.where(is_seq_ev, seq[page_rep].to(f64), lines_rand[page_rep])
        # write flags: the last wr-share of each page's random chain, plus
        # the sequential burst when stores dominate its lines
        n_wr_ev = torch.round(torch.where(
            rand > 0, (n_ev * wr_rand).to(f64) / rand.clamp(min=1).to(f64), 0.0
        )).to(torch.int64)
        is_wr = ~is_seq_ev & (pos >= (n_ev - n_wr_ev)[page_rep])
        is_wr |= is_seq_ev & (wr_seq[page_rep] * 2 > seq[page_rep])

        t = torch.from_numpy(np.asarray(tiers, dtype=np.int64)).to(dev)[page_rep]
        occ_rd = torch.tensor(p.occ_rd, dtype=f64, device=dev)
        occ_wr = torch.tensor(p.occ_wr, dtype=f64, device=dev)
        lat_rd = torch.tensor(p.lat_rd, dtype=f64, device=dev)
        lat_wr = torch.tensor(p.lat_wr, dtype=f64, device=dev)
        occ_unit = torch.where(is_wr, occ_wr[t], occ_rd[t])
        lat = torch.where(is_wr, lat_wr[t], lat_rd[t])

        rng = np.random.default_rng((self.seed, int(index)))
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        # np.lexsort((perm[page_rep], pos)): pos first, then the page's
        # permuted rank; perm < n makes pos * n + perm a unique key
        order = torch.argsort(pos * n + perm[page_rep])
        return EventStream(
            page=page_rep[order].to(torch.int32),
            tier=t[order].to(torch.int8),
            occ=(lines * occ_unit)[order],
            lat=lat[order],
            scale=scale,
            n_pages=n,
        )
