"""Fleet-scale multi-tenant tiering on the card: many tenant pools, one
fast tier (counterpart of :mod:`repro.fleet`).

* :class:`~repro_torch.fleet.scenario.TenantSpec` /
  :class:`~repro_torch.fleet.scenario.FleetScenario`: each tenant brings
  its own trace, static-partition share and floor/ceiling bounds; the
  scenario carries the global budget fraction and the arbitration policy.
  A ``FleetScenario`` drops into :class:`repro_torch.sim.api.Experiment`
  beside plain scenarios (``backend="fleet"``, one RunRecord per tenant).
* tenants as slices (:mod:`repro_torch.fleet.runner`): the tenant traces
  are merged over disjoint page ranges and each tenant becomes one slice
  of the device step's stacked ``[n_slices, rss]`` tier tensor, with its
  own pool, Tuna tuner and watermark controller, in one trace pass.
* :class:`~repro_torch.fleet.arbiter.FleetTunaArbiter`: every
  ``ArbiterSpec.every`` intervals it re-divides the global budget by
  water-filling the predicted loss across tenants;
  :meth:`~repro_torch.fleet.arbiter.FleetTunaArbiter.apply` is the only
  write path for per-tenant budgets (analysis rule TUNA009).
"""

from repro_torch.fleet.arbiter import (
    ArbiterSpec,
    FleetAllocationEvent,
    FleetTunaArbiter,
    water_fill,
)
from repro_torch.fleet.scenario import FleetScenario, TenantSpec
from repro_torch.fleet.runner import merge_tenant_traces, run_fleet_scenario

__all__ = [
    "ArbiterSpec",
    "FleetAllocationEvent",
    "FleetScenario",
    "FleetTunaArbiter",
    "TenantSpec",
    "merge_tenant_traces",
    "run_fleet_scenario",
    "water_fill",
]
