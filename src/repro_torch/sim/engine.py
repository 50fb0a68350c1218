"""The per-size engine: one trace through one host pool, interval by interval.

Counterpart of :mod:`repro.sim.engine`. It runs a page-access trace
through a host pool (the port's :class:`~repro_torch.tiering.page_pool.
TieredPagePool`, or whatever ``pool_factory`` builds, such as the JAX
package's frozen ``ReferencePagePool`` golden model), the policy's host
:meth:`~repro_torch.tiering.policy.MigrationPolicy.step`, the watermarks
and, when given, a Tuna tuner, and prices each interval with the cost
model. Everything here runs on the host, as in the JAX package: the pool
is the caller's object.

The planner (:func:`repro_torch.sim.api.run`) takes this path for a
scenario with a custom ``pool_factory``; every registered policy kind
runs on the device sweep otherwise. The JAX package's deprecated
``simulate`` shim and its ``run_trace`` have no counterpart: the port's
database build prices traces on the device sweep.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.telemetry import ConfigVector, IntervalProfiler
from repro_torch.core.trace import Trace
from repro_torch.core.tuner import TunaTuner
from repro_torch.sim.costmodel import (
    HardwareProfile,
    IntervalCosts,
    OPTANE_LIKE,
    absorb_cache,
    effective_mlp,
    interval_time,
)
from repro_torch.sim.faults import FaultInjector, FaultSpec
from repro_torch.sim.sweep import SimResult
from repro_torch.tiering.page_pool import Tier, TieredPagePool
from repro_torch.tiering.policy import MigrationPolicy, TPPPolicy


def _simulate(
    trace: Trace,
    fm_frac: float = 1.0,
    policy: MigrationPolicy | None = None,
    hw: HardwareProfile = OPTANE_LIKE,
    hw_capacity_pages: int | None = None,
    tuner: TunaTuner | None = None,
    tune_every: int | None = None,
    seed: int = 0,
    pool_factory=TieredPagePool,
    faults: FaultSpec | FaultInjector | None = None,
) -> SimResult:
    """Run ``trace`` with the fast tier sized at ``fm_frac`` of its RSS.

    ``hw_capacity_pages`` defaults to the trace RSS. A ``tuner`` is
    stepped every ``tune_every`` intervals and drives the watermarks
    itself. ``pool_factory`` builds the pool (called as the JAX package
    calls it: ``num_pages``, ``hw_capacity``, ``page_bytes``, ``seed``).
    ``faults`` (a :class:`~repro_torch.sim.faults.FaultSpec` or a built
    injector) turns on the fault model; ``None`` keeps the fault-free path.
    """
    if policy is None:
        policy = TPPPolicy()
    inj: FaultInjector | None = None
    if faults is not None:
        inj = faults if isinstance(faults, FaultInjector) else FaultInjector(faults)
        policy.fault_injector = inj
    cap = int(hw_capacity_pages or trace.rss_pages)
    pool = pool_factory(
        num_pages=trace.rss_pages,
        hw_capacity=cap,
        page_bytes=hw.page_bytes,
        seed=seed,
    )
    pool.set_fm_size(int(round(fm_frac * cap)))
    if trace.slow_pages is not None:
        pool.place(trace.slow_pages, Tier.SLOW)
    if tuner is not None:
        tuner.bind_pool(pool, cap)
        if inj is not None:
            inj.wire_tuner(tuner)
    profiler = IntervalProfiler(
        hot_thr=getattr(policy, "hot_thr", 4), num_threads=trace.num_threads
    )
    times = []
    fm_sizes = []
    configs: list[ConfigVector] = []
    costs: list[IntervalCosts] = []
    t_now = 0.0
    for i, ia in enumerate(trace):
        # the on-chip cache absorbs re-references to the hottest pages
        # before they reach either memory tier
        counts_mem = absorb_cache(ia.counts, hw.llc_pages)
        (pacc_f, pacc_s, ptouch_f, ptouch_s, warm_pg, warm_tc) = (
            pool.apply_accesses(
                ia.pages, counts_mem, ia.touches,
                touch_cap=getattr(policy, "hot_thr", 4),
            )
        )
        profiler.record_accesses(ptouch_f, ptouch_s, ia.ops,
                                 cachelines=pacc_f + pacc_s,
                                 warm_pages=warm_pg, warm_touches=warm_tc)
        before_direct = pool.stats.pgdemote_direct
        if inj is not None:
            inj.begin_interval(pool)
            base_kb = pool.kswapd_batch
            eff_kb = inj.kswapd_budget(pool, base_kb)
            if eff_kb != base_kb:
                pool.kswapd_batch = eff_kb
            outcome = policy.step(pool, ia.pages)
            if eff_kb != base_kb:
                pool.kswapd_batch = base_kb
        else:
            outcome = policy.step(pool, ia.pages)
        profiler.record_policy(outcome)
        mlp_eff = effective_mlp(counts_mem, hw.mlp, trace.num_threads)
        cost = interval_time(
            hw,
            pacc_f=pacc_f,
            pacc_s=pacc_s,
            ops=ia.ops,
            pm_pr=outcome.pm_pr,
            pm_de=outcome.pm_de,
            pm_fail=outcome.pm_fail,
            direct_reclaimed=pool.stats.pgdemote_direct - before_direct,
            mlp_eff=mlp_eff,
            num_threads=trace.num_threads,
            rand_frac=ia.rand_frac,
        )
        cv = profiler.finish(pool)
        pool.end_interval()
        t_now += cost.total
        times.append(cost.total)
        costs.append(cost)
        fm_sizes.append(pool.effective_fm_size)
        configs.append(cv)
        if tuner is not None and tune_every and (i + 1) % tune_every == 0:
            window = costs[-tune_every:]
            acc = sum(c.pacc_f + c.pacc_s for c in configs[-tune_every:])
            tpa = sum(c.total for c in window) / max(acc, 1)
            if inj is not None:
                cv_t, tpa, ok = inj.telemetry(pool, cv, tpa)
                tuner.step(cv_t, t=t_now, measured_tpa=tpa, telemetry_ok=ok)
            else:
                tuner.step(cv, t=t_now, measured_tpa=tpa)
    return SimResult(
        name=trace.name,
        total_time=float(np.sum(times)),
        interval_times=np.array(times),
        configs=configs,
        fm_sizes=np.array(fm_sizes, dtype=np.int64),
        stats=pool.stats.snapshot(),
        costs=costs,
    )

