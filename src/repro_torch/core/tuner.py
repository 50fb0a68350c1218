"""Tuna's online component: the runtime tuner (paper Sections 3.3, 4, 5).

Every tuning interval (default 2.5 s) the tuner:

1. collects the interval's telemetry (``ConfigVector``) from the profiler;
2. queries the performance database for the nearest execution record;
3. from that record, picks the **minimum fast-memory size whose predicted
   relative loss ≤ τ** (the user's performance-loss target); if no size
   qualifies, the current size is kept (paper Section 3.3);
4. actuates via the watermark controller, so reclamation happens in the
   background.

The offline component — sweeping configuration vectors through the
micro-benchmark across fast-memory sizes to populate the database — is
:func:`build_database`, which runs on the port's device sweep.

Counterpart of :mod:`repro.core.tuner` without the fault model's hooks and
the injected micro-benchmark backend, which later slices port; decisions
are identical.
"""

from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.microbench import generate_microbench
from repro_torch.core.perfdb import PerfDB, PerfDBUnavailable, PerfRecord
from repro_torch.core.telemetry import ConfigVector
from repro_torch.core.trace import Trace
from repro_torch.core.watermark import WatermarkController


@dataclass
class TunerConfig:
    target_loss: float = 0.05  # τ, the user's performance-loss target
    tuning_interval_s: float = 2.5  # paper default
    k_neighbors: int = 3  # records averaged for robustness
    min_fm_frac: float = 0.05  # never shrink below this fraction of peak
    # Closed-loop feedback guard (beyond-paper extension, DESIGN.md §8):
    # the paper's tuner is open loop against the database; when the
    # database's even-spread micro-benchmark underestimates deep-shrink
    # loss, this guard compares *measured* time-per-access against the
    # full-fm reference and grows the fast tier back once the target is
    # exceeded. Disable for the paper-faithful configuration.
    feedback: bool = True
    feedback_margin: float = 1.0  # grow when loss > margin × τ
    cooldown_windows: int = 3  # block DB shrink after a feedback grow
    # Degradation modes (robustness extension): consecutive PerfDB
    # failures tolerated (each retried at the next window, with
    # exponential backoff between attempts) before the tuner stops
    # querying every window and freezes the watermarks at the current
    # size until a query succeeds again.
    db_retry_limit: int = 3
    # Hysteresis clamp: a shrink request deeper than one controller step
    # below the current size must be confirmed by the *next* tuning
    # window before it proceeds, so a single noisy telemetry interval
    # cannot trigger a multi-step shrink. Off by default (bit-exact with
    # the pre-fault-model tuner); the fault injector arms it when
    # telemetry noise is configured.
    shrink_confirm: bool = False


@dataclass
class TunerDecision:
    t: float
    config: ConfigVector
    fm_frac: float | None  # chosen fraction (None = keep current)
    fm_pages: int  # actuated size
    predicted_loss: float | None
    # why this decision ran degraded, if it did: "telemetry_dropout",
    # "db_outage", "db_backoff", "db_outage_frozen", "shrink_unconfirmed"
    degraded: str | None = None


@dataclass
class TunaTuner:
    db: PerfDB
    controller: WatermarkController
    cfg: TunerConfig = field(default_factory=TunerConfig)
    peak_rss_pages: int | None = None
    decisions: list = field(default_factory=list)
    _ref_tpa: float | None = None  # time/access EMA at (near-)full fm
    _cooldown: int = 0
    _floor_frac: float = 0.0  # learned lower bound from feedback violations
    _db_fail_streak: int = 0  # consecutive PerfDB failures
    _db_backoff: int = 0  # windows left before the next query retry
    _shrink_armed: bool = False  # deep-shrink request awaiting confirmation

    def bind_pool(self, pool, peak_rss_pages: int | None = None) -> "TunaTuner":
        """Attach the pool this tuner actuates (via its controller).

        The tuned sweep (:func:`repro_torch.sim.sweep._sweep_tuned`) binds
        each size-slice's pool to that slice's tuner. ``peak_rss_pages``
        anchors the tuner's fm-fraction arithmetic (defaults to the pool's
        hardware capacity).
        Returns self.
        """
        self.controller.bind(pool)
        self.peak_rss_pages = (
            int(peak_rss_pages) if peak_rss_pages is not None
            else int(pool.hw_capacity)
        )
        return self

    def _hold(self, cv, t, degraded=None, predicted_loss=None) -> TunerDecision:
        """A keep-current-size decision (optionally marked degraded)."""
        d = TunerDecision(
            t=t, config=cv, fm_frac=None,
            fm_pages=self.controller.pool.effective_fm_size,
            predicted_loss=predicted_loss, degraded=degraded,
        )
        self.decisions.append(d)
        return d

    def step(
        self,
        cv: ConfigVector,
        t: float = 0.0,
        measured_tpa: float | None = None,
        telemetry_ok: bool = True,
    ) -> TunerDecision:
        """One tuning step: telemetry in, watermark actuation out.

        ``measured_tpa`` — measured time per memory access this tuning
        window; feeds the closed-loop guard when cfg.feedback is on.
        ``telemetry_ok=False`` marks this window's telemetry as missing
        or stale (profiler dropout): the tuner holds its last decision —
        neither the feedback guard nor the database may act on counters
        that never arrived.
        """
        peak = self.peak_rss_pages or self.controller.pool.hw_capacity
        cur_frac = self.controller.pool.effective_fm_size / peak
        if not telemetry_ok or cv is None:
            return self._hold(cv, t, degraded="telemetry_dropout")
        if self.cfg.feedback and measured_tpa is not None and measured_tpa > 0:
            if cur_frac >= 0.97:
                # conservative reference: the best (minimum) time-per-access
                # observed at (near-)full size — an EMA gets polluted by
                # post-thrash recovery intervals and then under-reports loss
                self._ref_tpa = (
                    measured_tpa
                    if self._ref_tpa is None
                    else min(self._ref_tpa, measured_tpa)
                )
            elif self._ref_tpa is not None:
                loss_now = measured_tpa / self._ref_tpa - 1.0
                if loss_now > self.cfg.feedback_margin * self.cfg.target_loss:
                    # measured violation: grow one controller step, learn a
                    # floor, and hold off database shrinks for a cooldown
                    # grow hard (two controller steps) — thrash is expensive
                    step_pages = max(
                        1, int(2 * self.controller.max_step_frac * peak)
                    )
                    new = self.controller.set_size(
                        self.controller.pool.effective_fm_size + step_pages, t=t
                    )
                    new = self.controller.set_size(
                        min(peak, new + step_pages), t=t
                    )
                    self._cooldown = self.cfg.cooldown_windows
                    self._floor_frac = max(self._floor_frac, new / peak)
                    d = TunerDecision(
                        t=t, config=cv, fm_frac=new / peak, fm_pages=new,
                        predicted_loss=loss_now,
                    )
                    self.decisions.append(d)
                    return d
        if self._cooldown > 0:
            self._cooldown -= 1
            return self._hold(cv, t)
        # --- PerfDB degradation: retry with backoff, then freeze.
        # Failed queries hold the current size (frozen watermarks); each
        # consecutive failure doubles the number of tuning windows skipped
        # before the next retry, and past cfg.db_retry_limit the decision
        # is surfaced as "db_outage_frozen" — the loop never raises.
        if self._db_backoff > 0:
            self._db_backoff -= 1
            return self._hold(cv, t, degraded="db_backoff")
        try:
            records = self.db.query(cv, k=self.cfg.k_neighbors)
        except PerfDBUnavailable:
            self._db_fail_streak += 1
            self._db_backoff = min(2 ** (self._db_fail_streak - 1), 8)
            frozen = self._db_fail_streak > self.cfg.db_retry_limit
            return self._hold(
                cv, t, degraded="db_outage_frozen" if frozen else "db_outage"
            )
        self._db_fail_streak = 0
        frac, loss = self._choose(records)
        if frac is None:
            decision = TunerDecision(
                t=t,
                config=cv,
                fm_frac=None,
                fm_pages=self.controller.pool.effective_fm_size,
                predicted_loss=None,
            )
        else:
            frac = max(frac, self.cfg.min_fm_frac, self._floor_frac)
            degraded = None
            if self.cfg.shrink_confirm:
                # hysteresis clamp: a multi-step shrink request must
                # repeat on the next window before it proceeds
                ms = self.controller.max_step_frac
                if frac < cur_frac - ms - 1e-12:
                    if not self._shrink_armed:
                        self._shrink_armed = True
                        frac = max(frac, cur_frac - ms)
                        degraded = "shrink_unconfirmed"
                else:
                    self._shrink_armed = False
            new_fm = int(round(frac * peak))
            actual = self.controller.set_size(new_fm, t=t)
            decision = TunerDecision(
                t=t, config=cv, fm_frac=frac, fm_pages=actual,
                predicted_loss=loss, degraded=degraded,
            )
        self.decisions.append(decision)
        return decision

    def _choose(self, records: Sequence[PerfRecord]):
        """Min fm fraction whose k-NN-averaged predicted loss ≤ τ."""
        if not records:
            return None, None
        # average loss curves over the k nearest records on a common grid;
        # drop records whose loss curve is non-finite (degraded microbench
        # runs: NaN/inf times, or a zero baseline) — one would poison the
        # whole average
        grid = records[0].fm_fracs
        losses = []
        for r in records:
            pl = r.predicted_loss()
            if not np.all(np.isfinite(pl)):
                warnings.warn(
                    "TunaTuner._choose: skipping record with non-finite "
                    f"loss curve (rss_pages={r.config.rss_pages:g})",
                    RuntimeWarning,
                    stacklevel=2,
                )
                continue
            if r.fm_fracs.shape == grid.shape and np.allclose(r.fm_fracs, grid):
                losses.append(pl)
            else:
                losses.append(
                    np.interp(grid[::-1], r.fm_fracs[::-1], pl[::-1])[::-1]
                )
        if not losses:
            return None, None
        loss = np.mean(losses, axis=0)
        ok = loss <= self.cfg.target_loss + 1e-12
        if not np.any(ok):
            return None, None
        i = int(np.argmin(np.where(ok, grid, np.inf)))
        return float(grid[i]), float(loss[i])


def scale_config(cv: ConfigVector, max_rss_pages: int) -> ConfigVector:
    """Scale a configuration down to a bounded RSS for micro-benchmarking.

    The database stores *relative* loss curves (Section 3.3), which are
    invariant to a uniform scaling of (pacc, pm, RSS): the micro-benchmark
    for a 3M-page workload and its 20K-page scaling predict the same
    loss-vs-fm_frac curve, at 150x the build cost difference. AI, hot_thr,
    and num_threads are intensive quantities and stay fixed.
    """
    lam = min(1.0, max_rss_pages / max(cv.rss_pages, 1.0))
    if lam >= 1.0:
        return cv
    v = cv.as_array()
    v[0:4] *= lam  # pacc_f, pacc_s, pm_de, pm_pr
    v[5] *= lam  # rss
    return ConfigVector.from_array(v)


def _microbench_trace(
    cv: ConfigVector, n_intervals: int, max_rss_pages: int
) -> Trace:
    """Scenario trace factory for one database record's micro-benchmark
    (generated lazily, inside the run)."""
    return generate_microbench(
        scale_config(cv, max_rss_pages), n_intervals=n_intervals
    )


def build_database(
    configs: Iterable[ConfigVector],
    fm_fracs: Sequence[float] | None = None,
    n_intervals: int = 20,
    max_rss_pages: int = 20_000,
    device=None,
) -> PerfDB:
    """Offline: populate the performance database.

    The whole build is **one declarative experiment** executed through
    :func:`repro_torch.sim.api.run` on ``device`` (``None`` = the card):
    one :class:`~repro_torch.sim.api.Scenario` per configuration (lazy
    micro-benchmark trace factory, ``fast_only_at_full`` for the
    NP_slow = 0 baseline variant at full size — paper Section 3.2/3.3)
    against the shared fm-size vector, each record's curve one batched
    sweep pass. Record times are identical to the JAX package's
    :func:`repro.core.tuner.build_database` on the same configurations.
    """
    if fm_fracs is None:
        fm_fracs = np.round(np.arange(1.0, 0.099, -0.02), 3)
    fm_fracs = np.asarray(fm_fracs, dtype=np.float64)
    configs = list(configs)
    db = PerfDB()
    if not configs:
        db.build()
        return db

    from repro_torch.sim.api import Experiment, PolicySpec, Scenario
    from repro_torch.sim.api import run as run_experiment

    scenario_names = [f"config[{i}]" for i in range(len(configs))]
    rs = run_experiment(
        Experiment(
            name="build_database",
            scenarios=[
                Scenario(
                    trace=functools.partial(
                        _microbench_trace, cv, n_intervals, max_rss_pages
                    ),
                    name=name,
                    fast_only_at_full=True,
                )
                for name, cv in zip(scenario_names, configs)
            ],
            fm_fracs=fm_fracs,
            policies=[PolicySpec()],
        ),
        device=device,
    )
    for name, cv in zip(scenario_names, configs):
        times = rs.total_times(scenario=name)
        db.add(PerfRecord(config=cv, fm_fracs=fm_fracs, times=times))
    db.build()
    return db
