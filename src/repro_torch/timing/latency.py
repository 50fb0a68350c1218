"""Timing parameters: HardwareProfile -> per-event latency/occupancy knobs.

Counterpart of :mod:`repro.timing.latency`, copied (host float arithmetic).

The timing engine charges each memory *event* two separable costs:

* **occupancy** — the seconds of tier-channel time its bytes consume
  (``access_bytes / bw``); events on one tier serialize through that
  tier's channel (the ``avail_cycle`` model);
* **latency** — the seconds between the channel accepting the event and
  its data arriving; latency is overlapped across the bounded in-flight
  window but is exposed along per-page dependence chains.

Writes resolve through the asymmetric write-path fields of
:class:`repro_torch.sim.costmodel.HardwareProfile` when set (``lat_fast_write``
/ ``lat_slow_write`` / ``bw_slow_write``), else fall back to the read
path. Calibration scales (see :mod:`repro_torch.timing.calibrate`) multiply
latencies and divide occupancies so the engine agrees with the analytic
best case on even-spread microbenchmark streams.

This module also carries the engine's own LLC absorption front-end
(:func:`absorb_llc`), mirroring the ``llc_pages`` semantics of the
interval model's front-end without importing the simulator: the hottest
``llc_pages`` pages per interval cost at most one cold fetch per cache
line, whichever tier backs them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.sim.costmodel import HardwareProfile

FAST = 0
SLOW = 1


@dataclass(frozen=True)
class TimingParams:
    """Resolved per-tier event costs plus the replay discretization knobs.

    ``lat_rd``/``lat_wr`` are (fast, slow) per-access latencies in
    seconds; ``occ_rd``/``occ_wr`` are (fast, slow) channel seconds per
    cache line. ``window`` is the per-thread in-flight budget (the MLP
    bound); the replay multiplies it by the trace's thread count.
    ``max_events`` bounds the events materialized per interval — larger
    intervals are replayed at a coarser, deterministically chosen
    granularity (see :class:`repro_torch.timing.engine.AddressTimingEngine`).
    """

    lat_rd: tuple[float, float]
    lat_wr: tuple[float, float]
    occ_rd: tuple[float, float]
    occ_wr: tuple[float, float]
    window: float  # in-flight accesses per thread (hw.mlp)
    page_bytes: int
    access_bytes: int
    llc_pages: int
    ops_per_s: float
    migrate_page_overhead: float
    direct_reclaim_stall: float
    promote_fail_penalty: float
    max_events: int = 50_000

    @classmethod
    def from_profile(
        cls,
        hw: HardwareProfile,
        calibration=None,
        max_events: int = 50_000,
    ) -> "TimingParams":
        lat_rd = (hw.lat_fast, hw.lat_slow)
        lat_wr = (
            hw.lat_fast_write if hw.lat_fast_write is not None else hw.lat_fast,
            hw.lat_slow_write if hw.lat_slow_write is not None else hw.lat_slow,
        )
        bw_rd = (hw.bw_fast, hw.bw_slow)
        bw_wr = (
            hw.bw_fast,  # DRAM-class fast tiers are read/write symmetric
            hw.bw_slow_write if hw.bw_slow_write is not None else hw.bw_slow,
        )
        ls = (1.0, 1.0)
        bs = (1.0, 1.0)
        if calibration is not None:
            ls = (calibration.lat_scale_fast, calibration.lat_scale_slow)
            bs = (calibration.bw_scale_fast, calibration.bw_scale_slow)
        return cls(
            lat_rd=(lat_rd[0] * ls[0], lat_rd[1] * ls[1]),
            lat_wr=(lat_wr[0] * ls[0], lat_wr[1] * ls[1]),
            occ_rd=(
                hw.access_bytes / (bw_rd[0] * bs[0]),
                hw.access_bytes / (bw_rd[1] * bs[1]),
            ),
            occ_wr=(
                hw.access_bytes / (bw_wr[0] * bs[0]),
                hw.access_bytes / (bw_wr[1] * bs[1]),
            ),
            window=float(hw.mlp),
            page_bytes=hw.page_bytes,
            access_bytes=hw.access_bytes,
            llc_pages=hw.llc_pages,
            ops_per_s=hw.ops_per_s,
            migrate_page_overhead=hw.migrate_page_overhead,
            direct_reclaim_stall=hw.direct_reclaim_stall,
            promote_fail_penalty=hw.promote_fail_penalty,
            max_events=int(max_events),
        )

    def migration_channel_seconds(self, pm_pr: int, pm_de: int) -> tuple[float, float]:
        """Channel occupancy a batch of migrations preloads on each tier.

        A promotion reads ``page_bytes`` from slow and writes them to
        fast; a demotion reads fast and writes slow — both compete with
        the application's events for the tier channels (the paper's
        characterization #1).
        """
        per_line_pages = self.page_bytes / self.access_bytes
        fast = per_line_pages * (pm_pr * self.occ_wr[FAST] + pm_de * self.occ_rd[FAST])
        slow = per_line_pages * (pm_pr * self.occ_rd[SLOW] + pm_de * self.occ_wr[SLOW])
        return float(fast), float(slow)


def absorb_llc(
    counts: np.ndarray, llc_pages: int, cl_per_page: int = 64
) -> np.ndarray:
    """Cap the hottest ``llc_pages`` pages at one cold fetch per line.

    The timing engine's own cache front-end: same observable semantics as
    the interval model's ``llc_pages`` knob (a page hammered within an
    interval is LLC-resident; its re-references never reach memory),
    implemented here independently so the two clocks share no simulator
    code.
    """
    if llc_pages <= 0:
        return counts
    if counts.size <= llc_pages:
        return np.minimum(counts, cl_per_page)
    kth = np.partition(counts, counts.size - llc_pages)[counts.size - llc_pages]
    out = counts.copy()
    hot = counts >= kth
    out[hot] = np.minimum(counts[hot], cl_per_page)
    return out
