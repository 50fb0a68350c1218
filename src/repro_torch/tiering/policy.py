"""Page-management policies of the port: the parameter surface the device
sweep step reads, and the registry :class:`repro_torch.sim.api.PolicySpec`
resolves kinds through (counterpart of :mod:`repro.tiering.policy`).

The decision semantics live in the device step
(:mod:`repro_torch.sim.torch_engine`), which replicates the TPP candidate
contract (hot-threshold promotion, watermark reclaim) and the trace-pure
admission criterion of :class:`AdmissionTPPPolicy` for every swept size at
once. The policy objects here carry only their parameters and flags. The
stateful thrash guard and first-touch kinds wait for a later slice.
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


# kind -> policy class
POLICIES: dict[str, type] = {
    cls.kind: cls for cls in (TPPPolicy, AdmissionTPPPolicy)
}
# kinds of the JAX package that later slices of the port bring over
LATER_KINDS = ("thrash_guard", "first_touch")


def resolve_policy(kind: str) -> type:
    """The policy class for ``kind``. A kind a later slice ports raises
    :class:`NotImplementedError`; an unknown kind raises ``ValueError``."""
    if kind in POLICIES:
        return POLICIES[kind]
    if kind in LATER_KINDS:
        raise NotImplementedError(
            f"policy kind {kind!r} is not ported yet; a later slice of the "
            "port brings the stateful and non-batchable policies"
        )
    raise ValueError(
        f"unknown policy kind {kind!r}; registered kinds: "
        f"{', '.join(sorted(POLICIES))}"
    )
