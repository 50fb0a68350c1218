"""The sweep's interval step on the card: one trace pass over every size.

Counterpart of :mod:`repro.sim.jax_engine`. It executes the same
per-interval sequence as the numpy sweep of the JAX package
(:func:`repro.sim.sweep._sweep_run`, the equivalence oracle): first-touch
allocation, batched tier classification, heat decay, hot-set ranking, the
policy's candidate filter (admission, or the thrash guard's ping-pong
backoff with its per-size state on the device), the TPP promote/reclaim
schedule of every size, per-size victim selection over
the shared demotion ranking (the ``victim_partition`` CUDA kernel), and
the promote/demote commit. The first-touch kind (``policy.migrates`` is
False) stops after allocation and classification: no candidate pass,
schedule, victim selection or commit, as the JAX package's
``FirstTouchPolicy.step`` returns an empty outcome with reclaim off. The tier state of all sizes is one stacked
``[n_sizes, rss]`` int8 tensor on the device; the host keeps only what the
paper's control plane needs per interval: the integer counters for the
cost model, watermarks, pool stats, profilers and tuners.

Exactness contract (pinned by ``tests/test_torch_engine.py`` on the CPU
and by ``chip_smoke.py`` between the CPU and the card):

* integer counters, victim identities, ``ConfigVector``s, interval times
  and tuner decisions are **bit-exact** against the numpy sweep and the
  frozen ``ReferencePagePool`` of the JAX package, in every regime
  including thrash;
* heat is float64 and the recurrence ``heat*decay + touch`` runs as two
  separate operations (eager PyTorch never contracts them into an FMA),
  the sequence :class:`repro.tiering.page_pool.LazyHeat` performs; the
  classification product is float64 over integers below 2**53, exact in
  any summation order; both sorts are stable, which keeps numpy's tie
  order.

The schedule recurrence (:func:`~repro_torch.tiering.page_pool.
_bulk_schedule_batch`) runs on the host over one int64 per size pulled
from the device, and the thrash regime's victim identities are resolved on
the host (:func:`~repro_torch.tiering.page_pool._resolve_step_victims`)
for the interfering sizes only, from their gathered victim and winner
rows. Page ids are never padded: every index is in range.

Fault injection (``faults``, a :class:`repro_torch.sim.faults.
FaultInjector`) adds the JAX package's hooks at the same points: each
slice's interval cursor and kswapd budget before the schedule, the
promotion filter after admission and before the ``promote_batch`` cut (its
per-page retry state ``[n_slices, rss]`` on the device, its draws hashed on
the host), the telemetry channel at each tuner step. Fleet mode
(``page_owner``, :mod:`repro_torch.fleet`) makes the slices tenants over
disjoint page ranges: each row allocates and promotes only its own pages
(its row never holds another tenant's page, so the shared classification,
candidate and victim passes need no change), telemetry and cost are per
tenant, and a budget arbiter steps after the tuners.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.telemetry import IntervalProfiler
from repro_torch.device import resolve_device
from repro_torch.kernels.victim_partition import victim_partition
from repro_torch.sim.costmodel import absorb_cache, effective_mlp, interval_time
from repro_torch.sim.faults import FaultInjector
from repro_torch.tiering.page_pool import (
    Tier,
    TieredPagePool,
    _bulk_schedule_batch,
    _resolve_step_victims,
)
from repro_torch.tiering.policy import PolicyOutcome

_FAST = int(Tier.FAST)
_SLOW = int(Tier.SLOW)
_UNALLOC = int(Tier.UNALLOCATED)
# TieredPagePool's default hotness half-life of 2 intervals
_DECAY = 0.5 ** (1.0 / 2.0)


def _require_torch_runnable(trace, policy, faults) -> None:
    """The eligibility contract (mirrored by the api.py planner checks)."""
    if faults is not None and not isinstance(faults, FaultInjector):
        raise TypeError(
            "faults must be a repro_torch.sim.faults.FaultInjector, got "
            f"{type(faults).__name__}"
        )
    pf = getattr(policy, "fault_injector", None)
    if pf is not None and pf is not faults:
        raise ValueError(
            "the policy's fault_injector must be the injector passed to the "
            "sweep as faults (the device step keys both on one cursor)"
        )
    if not getattr(policy, "batchable", False):
        raise ValueError(
            f"policy kind '{policy.kind}' is not batchable; the torch sweep "
            "replicates the registered kinds only"
        )
    for i, ia in enumerate(trace):
        if ia.pages.size and np.unique(ia.pages).size != ia.pages.size:
            raise ValueError(
                f"the torch sweep requires unique page ids per interval; "
                f"interval {i} of trace '{trace.name}' repeats ids"
            )


def _as_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def _select_victims(tier, eff_all, d_demand_d):
    """Per-size victims: the first ``d_demand[s]`` fast pages of the shared
    (effective heat, page id) ranking. Returns ``(order, ranked, vic)``:
    the ranking, the tier rows in rank order and the victim mask."""
    n_sizes, num_pages = tier.shape
    order = torch.argsort(eff_all, stable=True)
    ranked = tier[:, order]
    # rows padded to a multiple of 4 elements: int4-aligned for the kernel
    fast01 = torch.empty(
        (n_sizes, -(-num_pages // 4) * 4), dtype=torch.int32, device=tier.device
    )[:, :num_pages]
    fast01.copy_(ranked == _FAST)
    vic = victim_partition(fast01, d_demand_d) > 0
    return order, ranked, vic


def _filter_promotions(admitted, hot_ids, draws_d, fail_count, blocked_until,
                       t: int, spec):
    """The fault model's promotion filter for every slice at once.

    ``admitted`` ``[n_slices, n_hot]`` are the admitted candidates (hot
    pages in hottest-first order), ``draws_d`` the promotion channel's draw
    per hot page at interval ``t``. A candidate in backoff is withheld
    without an attempt; an attempt fails when its draw is below the rate; a
    page's ``max_retries + 1``-th consecutive failure abandons it (its
    retry state resets), a retrying one backs off ``backoff_base *
    2**(streak - 1)`` intervals; a success clears the streak. Updates the
    retry state in place and returns the kept candidates and the per-slice
    ``[withheld, exhausted, transient, failed]`` counts.
    """
    bu = blocked_until[:, hot_ids]
    fc = fail_count[:, hot_ids]
    in_backoff = admitted & (bu > t)
    attempt = admitted & ~in_backoff
    fail = attempt & (draws_d < spec.promote_fail_rate)[None, :]
    fc_new = fc + fail.to(torch.int64)
    exhausted = fail & (fc_new > spec.max_retries)
    retrying = fail & ~exhausted
    fail_count[:, hot_ids] = torch.where(
        (attempt & ~fail) | exhausted, 0, fc_new
    )
    backoff = t + spec.backoff_base * torch.pow(2, (fc_new - 1).clamp(min=0))
    blocked_until[:, hot_ids] = torch.where(
        exhausted, 0, torch.where(retrying, backoff, bu)
    )
    counts = torch.stack([in_backoff.sum(dim=1), exhausted.sum(dim=1),
                          retrying.sum(dim=1), fail.sum(dim=1)])
    return attempt & ~fail, counts


def _sweep_run_torch(
    trace,
    fm_fracs: np.ndarray,
    policy,
    hw,
    hw_capacity_pages: int | None,
    seed: int,
    collect_configs: bool,
    tuners: list | None = None,
    tune_everys: list | None = None,
    kswapd_batch: int | None = None,
    faults=None,
    page_owner: np.ndarray | None = None,
    slice_caps: np.ndarray | None = None,
    arbiter=None,
    device=None,
):
    """Device-backed counterpart of the JAX package's ``_sweep_run``.

    Same signature (plus ``device``: ``None`` = the card, ``"cpu"`` for the
    plain PyTorch path), same ``(times, pools, configs_out, fm_sizes,
    costs)`` return, bit-exact results. ``seed`` is accepted for signature
    parity; the sweep draws no random numbers (fault draws are hashes).
    Fleet mode: ``page_owner[p]`` is the slice owning page ``p``,
    ``slice_caps`` each slice's hardware capacity, ``arbiter`` (a
    :class:`repro_torch.fleet.arbiter.FleetTunaArbiter`) is stepped every
    ``arbiter.every`` intervals after the tuner steps.
    """
    dev = resolve_device(device)
    _require_torch_runnable(trace, policy, faults)
    fm_fracs = np.asarray(fm_fracs, dtype=np.float64)
    n_sizes = int(fm_fracs.size)
    num_pages = int(trace.rss_pages)
    cap = int(hw_capacity_pages or trace.rss_pages)
    hot_thr = policy.hot_thr
    admit_margin = getattr(policy, "admit_margin", None)
    reuse_window = getattr(policy, "reuse_window", None)
    promote_batch = getattr(policy, "promote_batch", None)
    # the first-touch kind: allocation, classification and cost only
    migrates = getattr(policy, "migrates", True)
    fleet = page_owner is not None
    caps = (
        np.asarray(slice_caps, dtype=np.int64)
        if slice_caps is not None
        else np.full(n_sizes, cap, dtype=np.int64)
    )

    # host slice pools: the control plane the profilers and tuners read;
    # their tier rows hold the initial placement and, after the run, the
    # device state imported back
    tier_b = np.full((n_sizes, num_pages), _UNALLOC, dtype=np.int8)
    pools = []
    for s in range(n_sizes):
        pool = TieredPagePool.for_slice(
            tier_b[s], hw_capacity=int(caps[s]), page_bytes=hw.page_bytes,
            kswapd_batch=kswapd_batch,
        )
        pool.set_fm_size(int(round(float(fm_fracs[s]) * int(caps[s]))))
        if trace.slow_pages is not None:
            slow = trace.slow_pages
            if fleet:  # a tenant slice places only its own pages
                slow = slow[page_owner[slow] == s]
            if slow.size:
                pool.place(slow, Tier.SLOW)
        pools.append(pool)
    tuned = tuners is not None
    if tuned:
        for s, (pool, tuner) in enumerate(zip(pools, tuners)):
            if tuner is not None:
                tuner.bind_pool(pool, int(caps[s]))
                if faults is not None:
                    faults.wire_tuner(tuner)

    tier = _as_device(TieredPagePool._export_tier_stack(pools), dev)
    heat = torch.zeros(num_pages, dtype=torch.float64, device=dev)
    # first touch is size-independent; a fleet page lives in its owner's row
    allocated = (
        tier_b[page_owner, np.arange(num_pages)] if fleet else tier_b[0]
    ) != _UNALLOC
    slow8 = torch.tensor(_SLOW, dtype=torch.int8, device=dev)
    if reuse_window is not None:
        # ThrashGuardPolicy's per-size state: the step of each page's last
        # promotion, and the remaining backoff steps. One step per interval,
        # so the step counter is the interval index.
        last_promoted = torch.full(
            (n_sizes, num_pages), -(2**62), dtype=torch.int64, device=dev
        )
        cooldown = torch.zeros(n_sizes, dtype=torch.int64, device=dev)
    # the promotion filter is the policy's (as in the JAX package)
    retry = (
        migrates
        and policy.fault_injector is not None
        and policy.fault_injector.spec.promote_fail_rate > 0.0
    )
    if retry:
        # the promotion filter's per-slice retry state: each page's streak
        # of consecutive failures and the interval its backoff ends
        fail_count = torch.zeros(
            (n_sizes, num_pages), dtype=torch.int64, device=dev
        )
        blocked_until = torch.zeros_like(fail_count)

    n_intervals = len(trace)
    times = np.zeros((n_sizes, n_intervals), dtype=np.float64)
    profilers = configs_out = None
    if collect_configs:
        profilers = [
            IntervalProfiler(hot_thr=hot_thr, num_threads=trace.num_threads)
            for _ in range(n_sizes)
        ]
        configs_out = [[] for _ in range(n_sizes)]
    costs = [[] for _ in range(n_sizes)]
    fm_sizes = t_now = None
    if tuned:
        fm_sizes = np.zeros((n_sizes, n_intervals), dtype=np.int64)
        t_now = [0.0] * n_sizes

    for i, ia in enumerate(trace):
        pages = ia.pages
        counts_mem = absorb_cache(ia.counts, hw.llc_pages)
        mlp_eff = effective_mlp(counts_mem, hw.mlp, trace.num_threads)
        rep = np.minimum(ia.touches, hot_thr)
        # --- first-touch bookkeeping on the host: the new-page set is
        # size-independent, each size's fast prefix is its watermark budget
        # (a tenant's prefix is taken within its own new pages)
        new_pages = pages[~allocated[pages]]
        n_fast = np.zeros(n_sizes, dtype=np.int64)
        if new_pages.size:
            if fleet:
                new_owner = page_owner[new_pages]
                new_rank = np.empty(new_pages.size, dtype=np.int64)
                for s, pool in enumerate(pools):
                    own = np.flatnonzero(new_owner == s)
                    new_rank[own] = np.arange(own.size)
                    n_fast[s] = pool._first_touch(own.size)
            else:
                for s, pool in enumerate(pools):
                    n_fast[s] = pool._first_touch(new_pages.size)
            allocated[new_pages] = True
        if faults is not None:
            # each slice advances its fault cursor; its background-reclaim
            # budget may be stalled or shed for this interval
            base_kb = [pool.kswapd_batch for pool in pools]
            for pool in pools:
                faults.begin_interval(pool)
                pool.kswapd_batch = faults.kswapd_budget(pool, pool.kswapd_batch)
        # --- schedule inputs: post-allocation, pre-step pool state
        free_a = np.array([p.fast_free for p in pools], dtype=np.int64)
        fastc_a = np.array([p.fast_used for p in pools], dtype=np.int64)
        minf_a = np.array([p.watermarks.min_free for p in pools], dtype=np.int64)
        lowf_a = np.array([p.watermarks.low_free for p in pools], dtype=np.int64)
        highf_a = np.array([p.watermarks.high_free for p in pools], dtype=np.int64)
        kswapd_a = np.array([p.kswapd_batch for p in pools], dtype=np.int64)

        pages_d = _as_device(pages, dev)
        touches_d = _as_device(ia.touches, dev)
        # --- first-touch allocation: per size a prefix of the new pages
        # (access order) goes fast, the rest slow
        if new_pages.size and fleet:
            first = np.where(new_rank < n_fast[new_owner], _FAST, _SLOW)
            tier[_as_device(new_owner, dev), _as_device(new_pages, dev)] = (
                _as_device(first.astype(np.int8), dev)
            )
        elif new_pages.size:
            rank = torch.arange(new_pages.size, device=dev)
            tier[:, _as_device(new_pages, dev)] = torch.where(
                rank[None, :] < _as_device(n_fast, dev)[:, None], _FAST, _SLOW
            ).to(torch.int8)
        # --- batched tier classification of the touched pages; float64
        # product over integers < 2**53 is exact in any summation order
        rep_d = torch.clamp(touches_d, max=hot_thr)
        warm_d = (rep_d < hot_thr).to(torch.int64)
        cols = torch.stack(
            [_as_device(counts_mem, dev), rep_d, warm_d, rep_d * warm_d], dim=1
        ).to(torch.float64)
        sums_d = (tier[:, pages_d] == _FAST).to(torch.float64) @ cols
        if migrates:
            # --- effective heat: the interval-frozen demotion key and the
            # post-fold heat; the multiply and the add stay separate operations
            eff_all = heat * _DECAY
            eff_all.index_add_(0, pages_d, touches_d.to(torch.float64))
            # --- hot candidates, hottest first, access order within ties
            hot_pos = torch.nonzero(touches_d >= hot_thr).squeeze(1)
            hot_ids = pages_d[
                hot_pos[torch.argsort(-touches_d[hot_pos], stable=True)]
            ]
            eff_h = eff_all[hot_ids]
            slow_cand = tier[:, hot_ids] == _SLOW
            if admit_margin is not None:
                # AdmissionTPPPolicy: trace-pure, size-independent
                admitted = slow_cand & (eff_h >= admit_margin * hot_thr)[None, :]
            elif reuse_window is not None:
                # ThrashGuardPolicy: a candidate promoted within the last
                # reuse_window steps is slow again, so it ping-ponged. Past
                # churn_frac of the candidates the size backs off, and while
                # it backs off its ping-pong candidates are suppressed.
                recent = slow_cand & (last_promoted[:, hot_ids] >= i - reuse_window)
                n_ping = recent.sum(dim=1)
                churn = n_ping.to(torch.float64) > policy.churn_frac * slow_cand.sum(
                    dim=1
                ).to(torch.float64)
                cooldown = torch.where(churn, policy.backoff_intervals, cooldown)
                suppress = (cooldown > 0) & (n_ping > 0)
                admitted = slow_cand & ~(recent & suppress[:, None])
            else:
                admitted = slow_cand
            rejected_d = slow_cand.sum(dim=1) - admitted.sum(dim=1)
            counts_d = [rejected_d]
            if retry:
                # injected transient promotion failures, after admission and
                # before the promote_batch cut; the draw of a page depends only
                # on (page, interval), hashed on the host over the hot pages
                draws_d = _as_device(
                    faults.promotion_draws(hot_ids.cpu().numpy(), i), dev
                )
                admitted, fault_counts_d = _filter_promotions(
                    admitted, hot_ids, draws_d, fail_count, blocked_until, i,
                    faults.spec,
                )
                counts_d.extend(fault_counts_d)
            if promote_batch is not None:
                admitted = admitted & (torch.cumsum(admitted, dim=1) <= promote_batch)
            n_cand_d = admitted.sum(dim=1)
            # --- the promote/reclaim schedule of every size, on the host
            n_cand, rejected, *fault_counts = (
                torch.stack([n_cand_d, *counts_d]).cpu().numpy()
            )
            injected = np.zeros(n_sizes, dtype=np.int64)
            if retry:
                withheld, exhausted, transient, injected = fault_counts
                for s, pool in enumerate(pools):
                    faults.record_promotion_faults(
                        pool, withheld[s], exhausted[s], transient[s]
                    )
            pm_pr, pm_de, pm_fail, direct_total, events, d_demand = (
                _bulk_schedule_batch(
                    free_a, fastc_a, minf_a, lowf_a, highf_a, kswapd_a, n_cand
                )
            )
            # --- winners: the first pm_pr admitted candidates per size
            pm_pr_d = _as_device(pm_pr, dev)
            win_mask = admitted & (torch.cumsum(admitted, dim=1) <= pm_pr_d[:, None])
            interf = np.zeros(n_sizes, dtype=bool)
            if d_demand.any():
                # --- victims in the shared ranking (the CUDA kernel) and the
                # provisional demotion commit, exact for non-interfering sizes
                d_demand_d = _as_device(d_demand, dev)
                order, ranked, vic = _select_victims(tier, eff_all, d_demand_d)
                vcount = vic.sum(dim=1)
                posr = torch.arange(num_pages, device=dev)
                last_pos = torch.where(vic, posr, -1).amax(dim=1)
                last_eff = torch.where(
                    last_pos >= 0, eff_all[order[last_pos.clamp(min=0)]], -torch.inf
                )
                if hot_ids.numel():
                    win_eff_min = torch.where(win_mask, eff_h, torch.inf).amin(dim=1)
                else:
                    win_eff_min = torch.full_like(last_eff, torch.inf)
                # interference: demand reaching into same-step promotions, the
                # bulk step's exact precondition (ties count as interference)
                interf = (
                    (d_demand_d > 0)
                    & ((vcount < d_demand_d) | ((pm_pr_d > 0) & (win_eff_min <= last_eff)))
                ).cpu().numpy()
                tier[:, order] = torch.where(vic, slow8, ranked)
            win_rows, win_cols = torch.nonzero(win_mask, as_tuple=True)
            tier[win_rows, hot_ids[win_cols]] = _FAST
            if reuse_window is not None:
                # the guard's post-step hook: stamp this step's promotions
                # (same-step demotions of winners included), count down
                last_promoted[win_rows, hot_ids[win_cols]] = i
                cooldown = torch.clamp(cooldown - 1, min=0)
            # --- thrash regime: resolve interfering sizes' victim identities on
            # the host (before the counter commit: the resolver replays the
            # pre-step schedule) and patch their tier rows
            for s in np.flatnonzero(interf):
                victims_d = order[vic[s]]  # walk order
                winners_d = hot_ids[win_mask[s]]  # promotion order
                if victims_d.numel() + winners_d.numel() < d_demand[s]:
                    raise RuntimeError(
                        "torch sweep: victim supply mismatch (corrupted tier state)"
                    )
                base_n, cand_taken = _resolve_step_victims(
                    eff_all[victims_d].cpu().numpy(),
                    victims_d.cpu().numpy(),
                    eff_all[winners_d].cpu().numpy(),
                    winners_d.cpu().numpy(),
                    pools[s]._schedule_events(int(n_cand[s])),
                )
                tier[int(s), victims_d[base_n:]] = _FAST
                tier[int(s), winners_d[_as_device(cand_taken, dev)]] = _SLOW
            heat = eff_all
        else:
            # first touch: no candidate pass, schedule, victims or commit
            # (the policy never migrates and reclaim is off)
            pm_pr = pm_de = pm_fail = direct_total = events = d_demand = (
                np.zeros(n_sizes, dtype=np.int64)
            )
            rejected = injected = pm_pr
        # --- counters to the host pools, then per-size telemetry and cost
        # (host, the JAX package's arithmetic)
        for s, pool in enumerate(pools):
            pool._commit_step(
                pm_pr[s], pm_de[s], direct_total[s], events[s], d_demand[s]
            )
        if faults is not None:
            for pool, kb in zip(pools, base_kb):
                pool.kswapd_batch = kb
        sums = sums_d.cpu().numpy().astype(np.int64)
        pacc_f_all = sums[:, 0]
        ptouch_f_all = sums[:, 1]
        warm_pages_all = sums[:, 2]
        warm_touch_all = sums[:, 3]
        if fleet:
            # per-tenant totals: only the pages a slice owns are its slow
            # complement; the interval's ops split by access share
            owner_t = page_owner[pages]
            tot_counts = np.bincount(
                owner_t, weights=counts_mem.astype(np.float64), minlength=n_sizes
            ).astype(np.int64)
            pacc_s_all = tot_counts - pacc_f_all
            ptouch_s_all = np.bincount(
                owner_t, weights=rep.astype(np.float64), minlength=n_sizes
            ).astype(np.int64) - ptouch_f_all
            total_c = int(counts_mem.sum())
            ops_share = (
                tot_counts / total_c
                if total_c > 0
                else np.zeros(n_sizes, dtype=np.float64)
            )
        else:
            pacc_s_all = int(counts_mem.sum()) - pacc_f_all
            ptouch_s_all = int(rep.sum()) - ptouch_f_all
        for s, pool in enumerate(pools):
            ops_s = ia.ops * float(ops_share[s]) if fleet else ia.ops
            outcome = PolicyOutcome(
                pm_pr=int(pm_pr[s]),
                pm_de=int(pm_de[s]),
                pm_fail=int(pm_fail[s]) + int(injected[s]),
                direct_reclaim=int(direct_total[s]),
                pm_admit_fail=int(rejected[s]),
            )
            if profilers is not None:
                profilers[s].record_accesses(
                    int(ptouch_f_all[s]),
                    int(ptouch_s_all[s]),
                    ops_s,
                    cachelines=int(pacc_f_all[s]) + int(pacc_s_all[s]),
                    warm_pages=int(warm_pages_all[s]),
                    warm_touches=int(warm_touch_all[s]),
                )
                profilers[s].record_policy(outcome)
                configs_out[s].append(profilers[s].finish(pool))
            cost = interval_time(
                hw,
                pacc_f=int(pacc_f_all[s]),
                pacc_s=int(pacc_s_all[s]),
                ops=ops_s,
                pm_pr=outcome.pm_pr,
                pm_de=outcome.pm_de,
                pm_fail=outcome.pm_fail,
                direct_reclaimed=int(direct_total[s]),
                mlp_eff=mlp_eff,
                num_threads=trace.num_threads,
                rand_frac=ia.rand_frac,
            )
            times[s, i] = cost.total
            costs[s].append(cost)
            if tuned:
                fm_sizes[s, i] = pool.effective_fm_size
                t_now[s] += cost.total
        # --- per-slice tuner steps, after the heat fold (simulate() order)
        if tuned:
            for s, tuner in enumerate(tuners):
                te = tune_everys[s]
                if tuner is not None and te and (i + 1) % te == 0:
                    window = costs[s][-te:]
                    acc = sum(
                        c.pacc_f + c.pacc_s for c in configs_out[s][-te:]
                    )
                    tpa = sum(c.total for c in window) / max(acc, 1)
                    cv, ok = configs_out[s][-1], True
                    if faults is not None:
                        cv, tpa, ok = faults.telemetry(pools[s], cv, tpa)
                    tuner.step(cv, t=t_now[s], measured_tpa=tpa, telemetry_ok=ok)
        # --- fleet budget arbitration, after the tuner steps
        if arbiter is not None and (i + 1) % arbiter.every == 0:
            arbiter.step(pools, configs_out=configs_out, t_now=t_now, interval=i)
    # --- import the final device state into the host pools, and check it
    # against the counters the host kept
    final_fast = [pool.fast_used for pool in pools]
    final_rss = [pool.rss_pages for pool in pools]
    TieredPagePool._import_tier_stack(pools, tier.cpu().numpy())
    for s, pool in enumerate(pools):
        if pool.fast_used != final_fast[s] or pool.rss_pages != final_rss[s]:
            raise RuntimeError(
                "torch sweep: host/device tier accounting diverged "
                f"(size {s}: fast_used {final_fast[s]} vs {pool.fast_used}, "
                f"rss {final_rss[s]} vs {pool.rss_pages})"
            )
    return times, pools, configs_out, fm_sizes, costs
