"""``Scenario.runner`` adapter: the timing engine as a plug-in backend.

Counterpart of :mod:`repro.timing.runner`. :func:`timing_runner` has the
custom-runner signature ``(scenario, fm_frac, policy_spec, db) -> dict``:
pass it as ``Scenario(runner=...)``, its knobs (``device`` among them)
bound with :func:`functools.partial`.

Schedule parity without shared state: the runner re-executes the same
deterministic host :class:`~repro_torch.tiering.page_pool.TieredPagePool`
+ policy stack on identical inputs (same pages, touches and
``touch_cap``, same fm sizing, same seed), so the migration schedule is
bit-identical to the interval engine's. It mirrors each interval's
placement into the :class:`~repro_torch.timing.translate.TranslationTable`
and keeps the interval's replay inputs; at the end it replays every
interval in one batched call of :class:`~repro_torch.timing.engine.
AddressTimingEngine` (one kernel launch on the card). The payload follows
the ``RunSet.total_times`` interval-times protocol (``total_time`` and
``interval_times``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.tiering.page_pool import Tier, TieredPagePool
from repro_torch.timing.calibrate import TimingCalibration
from repro_torch.timing.engine import AddressTimingEngine
from repro_torch.timing.latency import TimingParams
from repro_torch.timing.translate import TranslationTable

PAYLOAD_PROTOCOL = "interval-times/v1"


def timing_runner(
    scenario,
    fm_frac: float,
    policy_spec,
    db=None,
    *,
    calibration: TimingCalibration | dict | None = None,
    max_events: int = 50_000,
    device=None,
) -> dict:
    """Replay ``scenario`` at ``fm_frac`` under the timing clock, on
    ``device`` (``None`` = the card; raises without one).

    Tuner-carrying specs are rejected (the timing lane measures a fixed
    policy, so divergence is the clock's, not the control decisions'), and
    fault injection is rejected for the same reason.
    """
    if policy_spec.tuner is not None:
        raise ValueError(
            "timing_runner measures untuned policies; drop the tuner from "
            f"spec {policy_spec.name!r} (the timing lane must replay the "
            "same schedule the interval lane commits)"
        )
    if scenario.faults is not None:
        raise ValueError("timing_runner does not support fault injection")
    hw = scenario.hw
    if isinstance(calibration, dict):
        calibration = TimingCalibration.from_dict(calibration)
    params = TimingParams.from_profile(
        hw, calibration=calibration, max_events=max_events
    )
    engine = AddressTimingEngine(params, seed=scenario.seed, device=device)
    trace = _resolve_trace(scenario, fm_frac)

    cap = int(scenario.hw_capacity_pages or trace.rss_pages)
    pool_factory = scenario.pool_factory or TieredPagePool
    pool = pool_factory(
        num_pages=trace.rss_pages,
        hw_capacity=cap,
        page_bytes=hw.page_bytes,
        seed=scenario.seed,
    )
    if scenario.kswapd_batch is not None:
        pool.kswapd_batch = int(scenario.kswapd_batch)
    pool.set_fm_size(int(round(fm_frac * cap)))
    if trace.slow_pages is not None:
        pool.place(trace.slow_pages, Tier.SLOW)
    policy = policy_spec.build_policy()
    table = TranslationTable(trace.rss_pages)
    table.sync(pool.tier)  # adopt the explicit slow-tier binding

    jobs = []
    promoted = demoted = 0
    for i, ia in enumerate(trace):
        counts_mem = ia.counts  # the engine applies its own LLC front-end
        pool.apply_accesses(
            ia.pages, counts_mem, ia.touches,
            touch_cap=getattr(policy, "hot_thr", 4),
        )
        # first-touch allocations land before any access is charged
        table.sync(pool.tier)
        tiers = table.lookup(ia.pages)
        before_direct = pool.stats.pgdemote_direct
        before_demote = pool.stats.pgdemote_kswapd + pool.stats.pgdemote_direct
        outcome = policy.step(pool, ia.pages)
        pr, de = table.sync(pool.tier)
        promoted += pr
        demoted += de
        jobs.append(dict(
            index=i,
            pages=ia.pages,
            counts=counts_mem,
            tiers=tiers,
            ops=ia.ops,
            num_threads=trace.num_threads,
            rand_frac=ia.rand_frac,
            writes=ia.writes,
            pm_pr=outcome.pm_pr,
            pm_de=(
                pool.stats.pgdemote_kswapd
                + pool.stats.pgdemote_direct
                - before_demote
            ),
            pm_fail=outcome.pm_fail,
            direct_reclaimed=pool.stats.pgdemote_direct - before_direct,
        ))
        pool.end_interval()
    timed = engine.replay_intervals(jobs)
    times = [ti.total for ti in timed]
    return {
        "protocol": PAYLOAD_PROTOCOL,
        "clock": "timing",
        "name": trace.name,
        "fm_frac": float(fm_frac),
        "fm_pages": int(pool.effective_fm_size),
        "total_time": float(np.sum(times)),
        "interval_times": [float(t) for t in times],
        "intervals": [
            {
                "total": ti.total,
                "t_app": ti.t_app,
                "t_compute": ti.t_compute,
                "t_migrate": ti.t_migrate,
                "t_stall": ti.t_stall,
                "events": ti.events,
                "scale": ti.scale,
                "bytes_fast": ti.bytes_fast,
                "bytes_slow": ti.bytes_slow,
            }
            for ti in timed
        ],
        "migrations": {"promoted": promoted, "demoted": demoted},
        "stats": pool.stats.snapshot(),
        "translation": table.snapshot(),
        "calibration": (
            calibration.to_dict() if calibration is not None else None
        ),
    }


def _resolve_trace(scenario, fm_frac: float):
    tr = scenario.trace
    if tr is None:
        raise ValueError("timing_runner needs a Scenario with a trace")
    if isinstance(tr, str):
        from repro_torch.sim.workloads import WORKLOADS

        tr = WORKLOADS[tr]()
    elif callable(tr):
        tr = tr()
    if scenario.fast_only_at_full and fm_frac >= 1.0 - 1e-9:
        tr = tr.fast_only()
    return tr
