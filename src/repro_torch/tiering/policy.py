"""Page-management policies of the port: the parameter surface the device
sweep step reads, and the registry :class:`repro_torch.sim.api.PolicySpec`
resolves kinds through (counterpart of :mod:`repro.tiering.policy`).

The decision semantics live in the device step
(:mod:`repro_torch.sim.torch_engine`), which replicates the TPP candidate
contract (hot-threshold promotion, watermark reclaim), the trace-pure
admission criterion of :class:`AdmissionTPPPolicy` and the per-size
ping-pong backoff of :class:`ThrashGuardPolicy` for every swept size at
once, and the fault model's promotion filter when ``fault_injector`` is
set. The policy objects here carry only their parameters and flags. The
non-migrating first-touch kind waits for a later slice, with the per-size
engine it runs on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PolicyOutcome:
    """Per-interval migration telemetry (feeds the Tuna config vector)."""

    pm_pr: int = 0  # successful promotions
    pm_de: int = 0  # demotions (background + direct)
    pm_fail: int = 0  # promotion failures (fast tier full, reclaim spent)
    direct_reclaim: int = 0
    # candidates the policy itself declined to promote (admission control)
    # — distinct from pm_fail, which counts *attempted* promotions the pool
    # could not place
    pm_admit_fail: int = 0


class TPPPolicy:
    """Hot-threshold promotion + watermark demotion (the paper's TPP).

    ``hot_thr`` is the touch count within a profiling interval that makes a
    page a promotion candidate; ``promote_batch`` bounds promotions per
    interval (``None`` = unbounded). ``chunked_steps`` counts executions of
    a per-chunk fallback loop; the device step has none, so it stays 0 and
    is kept as the run's provenance, as in the JAX package.
    ``fault_injector`` is the :class:`repro_torch.sim.faults.FaultInjector`
    whose promotion filter the device step applies after admission (set
    by the planner for fault-injected runs; ``None`` keeps the fault-free
    step).
    """

    kind = "tpp"
    batchable = True
    tunable = True

    def __init__(self, hot_thr: int = 4, promote_batch: int | None = None) -> None:
        if hot_thr < 2:
            raise ValueError("hot_thr must be >= 2 (paper Eq. 4 divides by hot_thr-1)")
        self.hot_thr = int(hot_thr)
        self.promote_batch = promote_batch
        self.chunked_steps = 0
        self.fault_injector = None


class AdmissionTPPPolicy(TPPPolicy):
    """TPP with TierBPF-style migration admission control: a candidate is
    promoted only when its effective heat (decayed history + this
    interval's touches) reaches ``admit_margin * hot_thr``; the rest are
    reported as ``PolicyOutcome.pm_admit_fail``."""

    kind = "admission"

    def __init__(
        self,
        hot_thr: int = 4,
        promote_batch: int | None = None,
        admit_margin: float = 2.0,
    ) -> None:
        super().__init__(hot_thr=hot_thr, promote_batch=promote_batch)
        self.admit_margin = float(admit_margin)
        if not np.isfinite(self.admit_margin) or self.admit_margin < 0:
            raise ValueError("admit_margin must be a finite non-negative float")


class ThrashGuardPolicy(TPPPolicy):
    """TPP with a Jenga-style thrash guard.

    A promotion candidate that this policy promoted within the last
    ``reuse_window`` steps is slow again, so it was demoted in between: it
    ping-ponged. When ping-pong candidates exceed ``churn_frac`` of the
    interval's candidates, the policy enters a ``backoff_intervals``-step
    backoff during which ping-pong candidates are suppressed (reported as
    :attr:`PolicyOutcome.pm_admit_fail`). Outside backoff it is plain TPP.
    The state (a last-promotion stamp per page, the step and backoff
    counters) is per swept size and lives on the device in the sweep step.
    """

    kind = "thrash_guard"

    def __init__(
        self,
        hot_thr: int = 4,
        promote_batch: int | None = None,
        reuse_window: int = 2,
        churn_frac: float = 0.25,
        backoff_intervals: int = 2,
    ) -> None:
        super().__init__(hot_thr=hot_thr, promote_batch=promote_batch)
        self.reuse_window = int(reuse_window)
        self.churn_frac = float(churn_frac)
        self.backoff_intervals = int(backoff_intervals)
        if self.reuse_window < 1:
            raise ValueError("reuse_window must be >= 1 (steps)")
        if not 0.0 <= self.churn_frac <= 1.0:
            raise ValueError("churn_frac must be within [0, 1]")
        if self.backoff_intervals < 1:
            raise ValueError("backoff_intervals must be >= 1")


# kind -> policy class
POLICIES: dict[str, type] = {
    cls.kind: cls for cls in (TPPPolicy, AdmissionTPPPolicy, ThrashGuardPolicy)
}
# kinds of the JAX package that a later slice of the port brings over
LATER_KINDS = ("first_touch",)


def resolve_policy(kind: str) -> type:
    """The policy class for ``kind``. A kind a later slice ports raises
    :class:`NotImplementedError`; an unknown kind raises ``ValueError``."""
    if kind in POLICIES:
        return POLICIES[kind]
    if kind in LATER_KINDS:
        raise NotImplementedError(
            f"policy kind {kind!r} is not ported yet; a later slice of the "
            "port brings the non-batchable policies"
        )
    raise ValueError(
        f"unknown policy kind {kind!r}; registered kinds: "
        f"{', '.join(sorted(POLICIES))}"
    )
