"""Fleet-level Tuna: water-filling the global fm budget across tenants.

Counterpart of :mod:`repro.fleet.arbiter`: host code, copied unchanged.

The per-tenant Tuna tuners answer "how much fast memory does *this*
tenant need for loss <= tau?" independently — nothing stops their
demands from summing past the host's budget. The
:class:`FleetTunaArbiter` closes that loop: every ``ArbiterSpec.every``
intervals it collects the tenants' unconstrained demands (their pools'
current ``effective_fm_size``, i.e. where the tuners have steered), and

1. **within budget** → hold. Nobody is constrained; actuating would only
   fight the tuners (and would break the single-tenant degenerate case's
   bit-exactness with the plain tuned sweep).
2. **over budget** → clamp demands to per-tenant floors/ceilings; if the
   clamped demands fit, grant them (the ceiling alone was the problem —
   the noisy-neighbor case).
3. **still over** → *water-fill on predicted loss*: query the perf
   database per tenant (k-NN on its latest telemetry), and find the
   smallest common loss level ``lam`` such that granting every tenant
   ``min_fm(loss <= lam)`` fits the budget. This equalizes marginal pain
   — the fleet analogue of Tuna's per-pool "min size with predicted loss
   <= tau" rule, with tau replaced by the budget-clearing loss level.
   Tenants whose database is unreachable (fault layer) or whose
   telemetry is missing are *degraded*: held at their clamped demand
   rather than shrunk blind.
4. **infeasible** (floors + degraded demands exceed the budget) →
   proportional shrink of the slack above floors; floors are never cut.

Small re-divisions are churn, not signal: if no tenant would move by at
least ``hysteresis_frac`` of its RSS, the arbiter holds. Grants actuate
through each tenant's own rate-limited
:class:`~repro_torch.core.watermark.WatermarkController` —
:meth:`FleetTunaArbiter.apply` is the only legal write path for
per-tenant budgets in fleet code (analysis rule TUNA009).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

import numpy as np

from repro_torch.core.perfdb import PerfDBUnavailable


@dataclass(frozen=True)
class ArbiterSpec:
    """Fleet arbitration policy knobs (JSON-serializable provenance)."""

    every: int = 6  # arbitrate every N intervals
    hysteresis_frac: float = 0.02  # min move, as a fraction of tenant RSS
    k_neighbors: int = 3  # perfdb k-NN width for the loss curves

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"ArbiterSpec.every must be >= 1, got {self.every}")
        if self.hysteresis_frac < 0:
            raise ValueError("ArbiterSpec.hysteresis_frac must be >= 0")


@dataclass
class FleetAllocationEvent:
    """One arbitration outcome (``asdict`` → RunRecord.arbiter_log)."""

    interval: int
    t: float
    mode: str  # within_budget | ceiling_clamp | water_fill |
    # proportional | hysteresis_hold
    desired: list  # per-tenant demand (pages) at arbitration time
    granted: list  # per-tenant grant (pages); == desired on holds
    degraded: bool = False  # any tenant held due to db/telemetry outage


def _mean_loss_curve(records) -> tuple | None:
    """k-NN-averaged (fm_fracs desc, predicted_loss) curve, or None."""
    if not records:
        return None
    grid = np.asarray(records[0].fm_fracs, dtype=np.float64)
    losses = np.zeros_like(grid)
    for r in records:
        loss = np.asarray(r.predicted_loss(), dtype=np.float64)
        fr = np.asarray(r.fm_fracs, dtype=np.float64)
        if fr.shape == grid.shape and np.allclose(fr, grid):
            losses += loss
        else:  # mismatched grid: interpolate onto the first record's
            losses += np.interp(grid[::-1], fr[::-1], loss[::-1])[::-1]
    return grid, losses / len(records)


def _min_frac_at(curve: tuple, lam: float) -> float:
    """Smallest fm fraction on ``curve`` with predicted loss <= lam."""
    fracs, loss = curve
    ok = loss <= lam + 1e-12
    return float(fracs[ok].min()) if ok.any() else 1.0


def water_fill(
    desired,
    floors,
    ceils,
    caps,
    budget: int,
    curves=None,
) -> tuple[np.ndarray, str]:
    """Divide ``budget`` pages across tenants; returns ``(alloc, mode)``.

    ``desired`` are the tenants' unconstrained demands, ``floors`` /
    ``ceils`` hard per-tenant page bounds, ``caps`` the tenants' RSS
    sizes, and ``curves[i]`` an optional ``(fm_fracs desc, loss)`` pair
    from the perf database (``None`` = degraded: hold at clamped
    demand). Pure function — the arbiter's policy core, reused verbatim
    by the serving-layer rebalancer.
    """
    desired = np.asarray(desired, dtype=np.int64)
    floors = np.asarray(floors, dtype=np.int64)
    ceils = np.asarray(ceils, dtype=np.int64)
    caps = np.asarray(caps, dtype=np.int64)
    budget = int(budget)
    hi = np.minimum(np.maximum(desired, floors), ceils)
    if int(hi.sum()) <= budget:
        return hi.copy(), "ceiling_clamp"

    n = desired.size
    if curves is None:
        curves = [None] * n
    with_curve = [i for i in range(n) if curves[i] is not None]

    def alloc_at(lam: float) -> np.ndarray:
        # degraded tenants hold their clamped demand; the rest shrink to
        # the smallest size whose predicted loss clears the level
        a = hi.copy()
        for i in with_curve:
            want = int(round(_min_frac_at(curves[i], lam) * caps[i]))
            a[i] = min(int(hi[i]), max(int(floors[i]), want))
        return a

    alloc = hi.copy()
    if with_curve:
        # candidate levels: the union of the curves' own loss values —
        # alloc_at() is a step function of lam, so scanning these exactly
        # finds the smallest feasible level (levels are few: k-NN grids)
        lams = np.unique(
            np.concatenate([np.asarray(curves[i][1]) for i in with_curve])
        )
        lams = lams[np.isfinite(lams)]
        for lam in lams:  # ascending: first fit == minimal shared loss
            a = alloc_at(float(lam))
            if int(a.sum()) <= budget:
                return a, "water_fill"
        alloc = alloc_at(np.inf)
        if int(alloc.sum()) <= budget:
            return alloc, "water_fill"

    # infeasible even at max shrink: cut the slack above the floors
    # proportionally (floors themselves are never cut)
    excess = int(alloc.sum()) - budget
    slack = alloc - floors
    tot = int(slack.sum())
    if tot > 0:
        cut = np.minimum(slack, (excess * slack) // tot)
        alloc = alloc - cut
        r = int(alloc.sum()) - budget
        for i in np.argsort(-(alloc - floors)):  # residue: trim most-slack
            if r <= 0:
                break
            d = int(min(r, alloc[i] - floors[i]))
            alloc[i] -= d
            r -= d
    return alloc, "proportional"


@dataclass
class FleetTunaArbiter:
    """Periodic budget re-division across tenant pools (module docstring).

    ``controllers[i]`` is tenant *i*'s watermark controller — the same
    instance its Tuna tuner actuates through, so arbiter grants and tuner
    moves share one rate-limited, logged write path. Between
    arbitrations the tuners drift back toward their unconstrained
    demands (rate-limited); the arbiter re-converges the fleet at each
    step, so transient overage is bounded by
    ``every * max_step_frac * rss`` per tenant.
    """

    budget_pages: int
    floors: np.ndarray
    ceils: np.ndarray
    caps: np.ndarray
    controllers: list
    db: object | None = None
    spec: ArbiterSpec = field(default_factory=ArbiterSpec)
    fault_injector: object | None = None
    events: list = field(default_factory=list)
    _step_idx: int = field(default=-1, repr=False)

    @property
    def every(self) -> int:
        return self.spec.every

    # ------------------------------------------------------------ policy
    def step(self, pools, configs_out=None, t_now=None, interval=-1):
        """One arbitration: read demands/telemetry, re-divide, actuate."""
        self._step_idx += 1
        desired = np.array(
            [p.effective_fm_size for p in pools], dtype=np.int64
        )
        t = float(np.max(t_now)) if t_now is not None else 0.0
        if int(desired.sum()) <= self.budget_pages:
            # nobody is constrained — holding keeps the tuners' own
            # trajectories (and the single-tenant case) untouched
            self._record(interval, t, desired, desired, "within_budget")
            return

        curves, degraded = [], False
        for s, pool in enumerate(pools):
            curve = None
            cv = None
            if configs_out is not None and configs_out[s]:
                cv = configs_out[s][-1]
            if cv is not None and self.db is not None:
                outage = self.fault_injector is not None and (
                    self.fault_injector.db_outage(pool, self._step_idx)
                )
                if not outage:
                    try:
                        curve = _mean_loss_curve(
                            self.db.query(cv, k=self.spec.k_neighbors)
                        )
                    except PerfDBUnavailable:
                        outage = True
                degraded = degraded or outage
            else:
                degraded = True  # no telemetry / no db: hold this tenant
            curves.append(curve)

        granted, mode = water_fill(
            desired, self.floors, self.ceils, self.caps,
            self.budget_pages, curves,
        )
        moves = np.abs(granted - desired)
        min_move = np.maximum(
            1, (self.spec.hysteresis_frac * self.caps).astype(np.int64)
        )
        if mode != "within_budget" and np.all(moves < min_move):
            self._record(
                interval, t, desired, desired, "hysteresis_hold", degraded
            )
            return
        self.apply(granted, t_now=t_now)
        self._record(interval, t, desired, granted, mode, degraded)

    def rebalance(self, demands, t: float = 0.0, interval: int = -1):
        """Demand-driven re-division without a performance database.

        The serving layer's entry point (:class:`repro_torch.serving.fleet_kv.
        MultiTenantKV`): ``demands`` are observed per-tenant hot-page
        demands rather than tuner trajectories, so the division is the
        clamp → water-fill(no curves) → hysteresis path — degraded-style
        holds at clamped demand, proportional shrink when infeasible.
        Returns the granted allocation (current sizes on a hold).
        """
        self._step_idx += 1
        desired = np.asarray(demands, dtype=np.int64)
        cur = np.array(
            [ctl.pool.effective_fm_size for ctl in self.controllers],
            dtype=np.int64,
        )
        granted, mode = water_fill(
            desired, self.floors, self.ceils, self.caps,
            self.budget_pages, None,
        )
        min_move = np.maximum(
            1, (self.spec.hysteresis_frac * self.caps).astype(np.int64)
        )
        if np.all(np.abs(granted - cur) < min_move):
            self._record(interval, t, desired, cur, "hysteresis_hold")
            return cur
        self.apply(granted, t_now=np.full(cur.size, t))
        self._record(interval, t, desired, granted, mode)
        return granted

    # --------------------------------------------------------- actuation
    def apply(self, granted, t_now=None):
        """Drive every tenant's controller to its grant (TUNA009: the
        fleet's single budget write path). Each ``set_size`` call is
        rate-limited to ``max_step_frac`` of the tenant's RSS, so loop
        until the target (or a deadband/no-progress fixpoint) is
        reached."""
        for s, ctl in enumerate(self.controllers):
            target = int(granted[s])
            t = float(t_now[s]) if t_now is not None else 0.0
            prev = None
            for _ in range(64):
                got = int(ctl.set_size(target, t=t))
                if got == target or got == prev:
                    break
                prev = got

    def _record(self, interval, t, desired, granted, mode, degraded=False):
        self.events.append(
            FleetAllocationEvent(
                interval=int(interval),
                t=float(t),
                mode=mode,
                desired=[int(x) for x in desired],
                granted=[int(x) for x in granted],
                degraded=bool(degraded),
            )
        )

    def log_dicts(self) -> list:
        """The event log as plain dicts (RunSet JSON provenance)."""
        return [asdict(e) for e in self.events]
