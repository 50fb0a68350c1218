"""Calibrate the timing engine against the microbenchmark sweeps.

Counterpart of :mod:`repro.timing.calibrate`, over the port's
:func:`repro_torch.core.microbench.generate_from_spec`; each probe's
intervals replay in one call of the engine's batched entry, on ``device``.

The perfdb is built by running even-spread microbenchmark traces
(:mod:`repro_torch.core.microbench`) through the page-management stack; the
paper's premise is that this even spread achieves the hardware's *best*
memory performance. Calibration closes the loop for the second clock:
replay the same generator's steady-state intervals through the timing
engine on a fixed single-tier placement and fit one latency scale and
one bandwidth scale per tier so the realized times match the analytic
best case derived from the :class:`~repro_torch.sim.costmodel.HardwareProfile`
(``N x lat / (mlp x threads)`` in the latency-bound probe, ``bytes/bw``
in the sequential bandwidth probe).

After calibration the two clocks agree on microbenchmark streams *by
construction*, so any divergence on application traces isolates exactly
the application-vs-microbenchmark gap (skewed participation, dependence
chains, write asymmetry, migration interference) — the quantity Table 2
bounds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.microbench import MicrobenchSpec, generate_from_spec
from repro_torch.sim.costmodel import HardwareProfile
from repro_torch.timing.engine import AddressTimingEngine
from repro_torch.timing.latency import FAST, SLOW, TimingParams


@dataclass(frozen=True)
class TimingCalibration:
    """Fitted knobs: latency multipliers and bandwidth multipliers per tier.

    ``residuals`` holds the post-fit relative error of each probe —
    a fidelity-contract input (see ``benchmarks/fig_model_fidelity.py``).
    """

    lat_scale_fast: float = 1.0
    lat_scale_slow: float = 1.0
    bw_scale_fast: float = 1.0
    bw_scale_slow: float = 1.0
    residuals: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "lat_scale_fast": self.lat_scale_fast,
            "lat_scale_slow": self.lat_scale_slow,
            "bw_scale_fast": self.bw_scale_fast,
            "bw_scale_slow": self.bw_scale_slow,
            "residuals": dict(self.residuals),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TimingCalibration":
        return cls(**d)


def _probe_trace(n_pages: int, hot_thr: int, num_threads: int):
    """Even-spread steady intervals from the perfdb's own generator."""
    spec = MicrobenchSpec(
        np_fast=n_pages,
        np_slow=0,
        pm_pr=0,
        pm_de=0,
        rss_pages=n_pages + 8,
        hot_thr=hot_thr,
        ai=0.0,
        num_threads=num_threads,
        intensity=1.0,
    )
    tr = generate_from_spec(spec, n_intervals=4, warmup_intervals=1)
    # steady-state intervals only (skip the allocation warmup)
    return [ia for ia in tr][1:], spec


def _mean_makespan(engine, intervals, tier, num_threads, rand_frac):
    times = [
        ti.t_app
        for ti in engine.replay_intervals([
            dict(
                index=i,
                pages=ia.pages,
                counts=ia.counts,
                tiers=np.full(ia.pages.size, tier, dtype=np.int8),
                ops=0.0,
                num_threads=num_threads,
                rand_frac=rand_frac,
            )
            for i, ia in enumerate(intervals)
        ])
    ]
    return float(np.mean(times))


def calibrate(
    hw: HardwareProfile,
    n_pages: int = 1536,
    hot_thr: int = 4,
    num_threads: int = 4,
    max_events: int = 50_000,
    seed: int = 0,
    device=None,
) -> TimingCalibration:
    """Fit per-tier latency/bandwidth scales for ``hw``; deterministic.
    The probes replay on ``device`` (``None`` = the card)."""
    intervals, _ = _probe_trace(n_pages, hot_thr, num_threads)
    raw = TimingParams.from_profile(hw, calibration=None, max_events=max_events)
    engine = AddressTimingEngine(raw, seed=seed, device=device)
    mlp = hw.mlp * num_threads

    def targets(ia, tier):
        counts = np.minimum(ia.counts, hw.page_bytes // hw.access_bytes)
        n = float(counts.sum()) if hw.llc_pages else float(ia.counts.sum())
        lat = (hw.lat_fast, hw.lat_slow)[tier]
        bw = (hw.bw_fast, hw.bw_slow)[tier]
        return (
            max(n * hw.access_bytes / bw, n * lat / mlp),  # random stream
            n * hw.access_bytes / bw,  # sequential stream
        )

    t_lat = {FAST: [], SLOW: []}
    t_bw = {FAST: [], SLOW: []}
    for tier in (FAST, SLOW):
        for ia in intervals:
            tl, tb = targets(ia, tier)
            t_lat[tier].append(tl)
            t_bw[tier].append(tb)

    lat_scale = {}
    bw_scale = {}
    for tier in (FAST, SLOW):
        m_lat = _mean_makespan(engine, intervals, tier, num_threads, 1.0)
        m_bw = _mean_makespan(engine, intervals, tier, num_threads, 0.0)
        lat_scale[tier] = float(np.mean(t_lat[tier])) / m_lat
        bw_scale[tier] = m_bw / float(np.mean(t_bw[tier]))

    cal = TimingCalibration(
        lat_scale_fast=lat_scale[FAST],
        lat_scale_slow=lat_scale[SLOW],
        bw_scale_fast=bw_scale[FAST],
        bw_scale_slow=bw_scale[SLOW],
    )
    # post-fit residuals: how well the calibrated engine reproduces the
    # analytic best case on the probes it was fitted to
    fitted = AddressTimingEngine(
        TimingParams.from_profile(hw, calibration=cal, max_events=max_events),
        seed=seed,
        device=engine.device,
    )
    residuals = {}
    for tier, label in ((FAST, "fast"), (SLOW, "slow")):
        m_lat = _mean_makespan(fitted, intervals, tier, num_threads, 1.0)
        m_bw = _mean_makespan(fitted, intervals, tier, num_threads, 0.0)
        residuals[f"lat_{label}"] = float(abs(m_lat / np.mean(t_lat[tier]) - 1.0))
        residuals[f"bw_{label}"] = float(abs(m_bw / np.mean(t_bw[tier]) - 1.0))
    return TimingCalibration(
        lat_scale_fast=cal.lat_scale_fast,
        lat_scale_slow=cal.lat_scale_slow,
        bw_scale_fast=cal.bw_scale_fast,
        bw_scale_slow=cal.bw_scale_slow,
        residuals=residuals,
    )
