"""Fleet execution: tenants as slices of one device sweep pass.

Counterpart of :mod:`repro.fleet.runner`. The tuned sweep runs a vector of
independent slice pools, one per candidate fm size, against one trace in a
single pass on the device step. The fleet runner reuses it with the slice
axis reinterpreted: the tenant traces are merged onto disjoint page ranges
of one trace (:func:`merge_tenant_traces`), and each tenant becomes one
slice of the stacked ``[n_slices, rss]`` tier tensor (``page_owner`` tells
:func:`repro_torch.sim.torch_engine._sweep_run_torch` which slice owns each
page). Heat, the ranking and the ``victim_partition`` kernel stay shared;
disjoint ownership makes them exact per tenant. A one-tenant fleet at
``budget_frac=1.0`` with non-binding bounds equals the plain tuned sweep
bit for bit.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.trace import IntervalAccess, Trace
from repro_torch.fleet.arbiter import FleetTunaArbiter
from repro_torch.fleet.scenario import FleetScenario
from repro_torch.sim.faults import FaultInjector
from repro_torch.sim.torch_engine import _sweep_run_torch
from repro_torch.tiering.policy import device_kind


def merge_tenant_traces(
    traces, name: str = "fleet"
) -> tuple[Trace, np.ndarray, np.ndarray]:
    """Merge tenant traces onto disjoint page ranges of one trace.

    Returns ``(merged, page_owner, caps)``: tenant *t* owns pages
    ``[offsets[t], offsets[t] + caps[t])`` of the merged trace and
    ``page_owner[p]`` is the owner of page ``p``. Per merged interval the
    page lists stay sorted and unique, ops sum, and ``rand_frac`` is the
    access-weighted mean; with one contributing tenant both are that
    tenant's values unchanged. Tenants shorter than the longest trace stop
    contributing intervals (their pools idle).
    """
    traces = list(traces)
    if not traces:
        raise ValueError("merge_tenant_traces needs at least one trace")
    caps = np.array([int(t.rss_pages) for t in traces], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(caps)[:-1]])
    page_owner = np.repeat(np.arange(caps.size, dtype=np.int64), caps)
    n_intervals = max(len(t) for t in traces)

    slow_parts = [
        np.asarray(t.slow_pages, dtype=np.int64) + offsets[ti]
        for ti, t in enumerate(traces)
        if t.slow_pages is not None
    ]
    merged = Trace(
        name=name,
        rss_pages=int(caps.sum()),
        num_threads=max(t.num_threads for t in traces),
        slow_pages=np.concatenate(slow_parts) if slow_parts else None,
    )
    for i in range(n_intervals):
        parts = [
            (ti, t.intervals[i]) for ti, t in enumerate(traces) if i < len(t)
        ]
        if len(parts) == 1:
            ti, ia = parts[0]
            merged.append(
                IntervalAccess(
                    pages=ia.pages + offsets[ti],
                    counts=ia.counts,
                    ops=ia.ops,
                    rand_frac=ia.rand_frac,
                    touches=ia.touches,
                )
            )
            continue
        pages = np.concatenate([ia.pages + offsets[ti] for ti, ia in parts])
        counts = np.concatenate([ia.counts for _, ia in parts])
        touches = np.concatenate([ia.touches for _, ia in parts])
        acc = np.array(
            [max(int(ia.counts.sum()), 1) for _, ia in parts],
            dtype=np.float64,
        )
        rand = np.array([ia.rand_frac for _, ia in parts])
        merged.append(
            IntervalAccess(
                pages=pages,
                counts=counts,
                ops=float(sum(ia.ops for _, ia in parts)),
                rand_frac=float((rand * acc).sum() / acc.sum()),
                touches=touches,
            )
        )
    return merged, page_owner, caps


def _resolve_tenant_trace(tenant) -> Trace:
    tr = tenant.trace
    if isinstance(tr, Trace):
        return tr
    if isinstance(tr, str):
        from repro_torch.sim.workloads import WORKLOADS

        return WORKLOADS[tr]()
    return tr()


def static_partition(budget: int, caps, shares, floors, ceils) -> np.ndarray:
    """Share-weighted split of ``budget`` pages, clamped to the bounds.

    The fleet's static partitioning baseline and every fleet run's initial
    allocation. With one tenant, ``share=None`` and non-binding bounds this
    returns exactly ``budget``.
    """
    caps = np.asarray(caps, dtype=np.int64)
    w = np.array(
        [1.0 if s is None else float(s) for s in shares], dtype=np.float64
    )
    w = w / w.sum()
    alloc = np.rint(w * float(budget)).astype(np.int64)
    return np.minimum(
        np.maximum(alloc, np.asarray(floors, dtype=np.int64)),
        np.asarray(ceils, dtype=np.int64),
    )


def tenant_bounds(tenants, caps) -> tuple[np.ndarray, np.ndarray]:
    """Per-tenant ``(floors, ceils)`` in pages from the specs' fractions."""
    floors = np.maximum(
        1,
        np.rint([t.floor_frac * c for t, c in zip(tenants, caps)]).astype(
            np.int64
        ),
    )
    ceils = np.rint([t.ceil_frac * c for t, c in zip(tenants, caps)]).astype(
        np.int64
    )
    return floors, ceils


def run_fleet_scenario(
    scenario: FleetScenario,
    fm_fracs: tuple,
    policies: tuple,
    db,
    collect_configs: bool,
    device=None,
):
    """Execute every (policy, budget-scale) cell of one fleet scenario on
    ``device`` (``None`` = the card).

    Each experiment ``fm_frac`` scales the global budget ``B = fm_frac *
    budget_frac * sum(tenant RSS)``; every tenant yields one RunRecord per
    cell, named ``"{fleet}/{tenant}"``, in (policy-major, size, tenant)
    order. Tuned specs run per-tenant tuners plus the fleet arbiter;
    untuned specs hold the static share-weighted partition. Returns
    ``(records, chunked)`` like :func:`repro_torch.sim.api._run_scenario`.
    """
    from repro_torch.sim.api import RunRecord, _spec_fracs
    from repro_torch.sim.sweep import SimResult

    tenants = list(scenario.tenants)
    tnames = [t.resolved_name for t in tenants]
    traces = [_resolve_tenant_trace(t) for t in tenants]
    merged, page_owner, caps = merge_tenant_traces(
        traces, name=f"fleet:{scenario.name}"
    )
    n = len(tenants)
    floors, ceils = tenant_bounds(tenants, caps)
    shares = [t.share for t in tenants]
    total_cap = float(caps.sum())
    sname = scenario.resolved_name

    records: list = []
    chunked = 0
    for spec in policies:
        if device_kind(spec.policy_cls) is None:
            raise ValueError(
                f"fleet scenarios need policies the device step replicates; "
                f"{spec.kind!r} is not one"
            )
        for f in _spec_fracs(spec, fm_fracs):
            f = float(f)
            budget = int(round(f * scenario.budget_frac * total_cap))
            alloc0 = static_partition(budget, caps, shares, floors, ceils)
            # initial per-slice fracs round-trip to alloc0 exactly inside
            # the sweep step: round((alloc/cap) * cap) == alloc
            fracs = (alloc0 / caps).astype(np.float64)
            policy = spec.build_policy()
            inj = (
                FaultInjector(scenario.faults)
                if scenario.faults is not None
                else None
            )
            policy.fault_injector = inj
            tuned = spec.tuner is not None
            tuners = tes = arbiter = None
            if tuned:
                tuners = [spec.tuner.build(db) for _ in range(n)]
                # the isolation ceiling binds between arbiter steps too: the
                # controller is the one actuator tuner and arbiter drive
                for tn, ceil in zip(tuners, ceils):
                    tn.controller.max_fm_pages = int(ceil)
                tes = [spec.tuner.tune_every] * n
                arbiter = FleetTunaArbiter(
                    budget_pages=budget,
                    floors=floors,
                    ceils=ceils,
                    caps=caps,
                    controllers=[t.controller for t in tuners],
                    db=db,
                    spec=scenario.arbiter,
                    fault_injector=inj,
                )
            times, pools, configs_out, fm_sizes, costs = _sweep_run_torch(
                merged,
                fracs,
                policy,
                scenario.hw,
                None,
                scenario.seed,
                True,
                tuners=tuners,
                tune_everys=tes,
                kswapd_batch=scenario.kswapd_batch,
                faults=inj,
                page_owner=page_owner,
                slice_caps=caps,
                arbiter=arbiter,
                device=device,
            )
            arb_log = arbiter.log_dicts() if arbiter is not None else None
            for s in range(n):
                res = SimResult(
                    name=tnames[s],
                    total_time=float(np.sum(times[s])),
                    interval_times=times[s].copy(),
                    configs=configs_out[s],
                    fm_sizes=(
                        fm_sizes[s].copy()
                        if fm_sizes is not None
                        else np.full(times.shape[1], alloc0[s], np.int64)
                    ),
                    stats=pools[s].stats.snapshot(),
                    costs=costs[s],
                )
                records.append(
                    RunRecord(
                        f"{sname}/{tnames[s]}",
                        spec.name,
                        f,
                        "fleet",
                        res,
                        decisions=(
                            list(tuners[s].decisions) if tuned else None
                        ),
                        watermark_log=(
                            list(tuners[s].controller.log) if tuned else None
                        ),
                        fault_events=(
                            inj.events(pools[s]) if inj is not None else None
                        ),
                        arbiter_log=arb_log,
                    )
                )
            chunked += policy.chunked_steps
    return records, chunked
