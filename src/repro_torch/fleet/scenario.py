"""Declarative fleet layer: tenants sharing one host's fast tier.

Counterpart of :mod:`repro.fleet.scenario`. A :class:`FleetScenario` is
the multi-tenant counterpart of :class:`repro_torch.sim.api.Scenario`: N
:class:`TenantSpec` pools share one global fast-memory budget
(``budget_frac`` of the fleet's total RSS, scaled by the experiment's
``fm_frac`` axis). The runner (:mod:`repro_torch.fleet.runner`) maps each
tenant onto one slice of the device step's stacked ``[n_slices, rss]``
tier tensor over a disjoint page range of the merged trace.

Budget semantics per tenant:

* ``share``: weight of the static partition the fleet starts from (and
  that the untuned baseline keeps); ``None`` means equal weight. Static
  allocations are clamped to the floor/ceiling bounds.
* ``floor_frac`` / ``ceil_frac``: hard per-tenant bounds, as fractions of
  the tenant's own RSS, that the fleet arbiter respects when it re-divides
  the budget.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, ClassVar, Sequence

from repro_torch.core.trace import Trace
from repro_torch.fleet.arbiter import ArbiterSpec
from repro_torch.sim.costmodel import OPTANE_LIKE, HardwareProfile
from repro_torch.sim.faults import FaultSpec


@dataclass(frozen=True)
class TenantSpec:
    """One tenant pool: its workload plus its slice of the budget policy.

    ``trace`` accepts the forms of ``Scenario.trace`` (a
    :class:`~repro_torch.core.trace.Trace`, a name of
    :data:`repro_torch.sim.workloads.WORKLOADS`, or a zero-argument
    callable) minus ``None``: every tenant must bring a workload.
    """

    trace: Trace | str | Callable[[], Trace]
    name: str | None = None
    share: float | None = None  # static-partition weight (None = equal)
    floor_frac: float = 0.05  # min fm as a fraction of tenant RSS
    ceil_frac: float = 1.0  # max fm as a fraction of tenant RSS

    def __post_init__(self):
        if self.trace is None:
            raise ValueError("TenantSpec.trace is required")
        if self.share is not None and self.share <= 0:
            raise ValueError(f"TenantSpec.share must be > 0, got {self.share}")
        if not (0.0 < self.floor_frac <= self.ceil_frac <= 1.0):
            raise ValueError(
                "TenantSpec needs 0 < floor_frac <= ceil_frac <= 1, got "
                f"floor_frac={self.floor_frac} ceil_frac={self.ceil_frac}"
            )

    @property
    def resolved_name(self) -> str:
        if self.name is not None:
            return self.name
        if isinstance(self.trace, Trace):
            return self.trace.name
        if isinstance(self.trace, str):
            return self.trace
        f = getattr(self.trace, "func", self.trace)
        return getattr(f, "__name__", "tenant")


@dataclass
class FleetScenario:
    """N tenant pools sharing ``budget_frac`` of the fleet's total RSS.

    Routed by :func:`repro_torch.sim.api.run` to the fleet backend: each
    experiment ``fm_frac`` scales the global budget, every tenant yields its
    own :class:`~repro_torch.sim.api.RunRecord` named ``"{fleet}/{tenant}"``.
    Tuned policy specs run the per-tenant Tuna tuners plus the fleet
    arbiter; untuned specs hold the static ``share``-weighted partition.
    With one tenant, ``share=None`` and non-binding floors/ceilings the
    fleet path equals the plain (tuned) sweep bit for bit.
    """

    tenants: Sequence[TenantSpec] = ()
    name: str = "fleet"
    budget_frac: float = 0.5  # global fm budget / total fleet RSS
    hw: HardwareProfile = OPTANE_LIKE
    seed: int = 0
    kswapd_batch: int | None = None
    arbiter: ArbiterSpec = field(default_factory=ArbiterSpec)
    faults: FaultSpec | None = None

    is_fleet: ClassVar[bool] = True

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("FleetScenario needs at least one tenant")
        names = [t.resolved_name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in fleet: {names}")
        if not (0.0 < self.budget_frac <= 1.0):
            raise ValueError(
                f"budget_frac must be in (0, 1], got {self.budget_frac}"
            )

    @property
    def resolved_name(self) -> str:
        return self.name
