"""Multi-tenant tiered KV serving: N paged KV pools, one HBM budget.

Counterpart of :mod:`repro.serving.fleet_kv`. Each tenant (a model
replica, a customer namespace) owns its own two-tier paged KV store
(:class:`~repro_torch.serving.kv_cache.TieredPagedKV`: an HBM slot tensor
and a pinned host pool on the card, pages copied by the ``migrate_pages``
kernel), but HBM is one host-level budget. The per-tenant stores size
their physical HBM slot tensors at the tenant's ceiling; the usable share
is enacted purely through watermarks, actuated by the same
:class:`repro_torch.fleet.arbiter.FleetTunaArbiter` the simulator's fleet
lanes run. :meth:`MultiTenantKV.rebalance` feeds it observed hot-page
demands, the arbiter water-fills the budget under per-tenant
floors/ceilings with hysteresis, then each tenant's reclaimer demotes down
to its new watermark. Every budget write flows through the arbiter's
``apply`` (analysis rule TUNA009).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.watermark import WatermarkController
from repro_torch.fleet.arbiter import ArbiterSpec, FleetTunaArbiter
from repro_torch.fleet.runner import static_partition
from repro_torch.serving.kv_cache import KVPageConfig, TieredPagedKV


class MultiTenantKV:
    """Tenant-named :class:`TieredPagedKV` pools under one HBM budget.

    ``tenant_pages`` maps tenant name -> total (host) pages; the HBM budget
    starts share-weighted (``shares``, ``None`` = equal) and is re-divided
    by :meth:`rebalance`. ``floor_frac`` / ``ceil_frac`` bound every
    tenant's share as fractions of its own page count (scalars, or
    per-tenant sequences in ``tenant_pages`` order). ``device=None`` puts
    every tenant's HBM pool on the card (and raises without one).
    """

    def __init__(
        self,
        cfg: KVPageConfig,
        tenant_pages: dict,
        hbm_budget: int,
        floor_frac=0.05,
        ceil_frac=1.0,
        shares=None,
        arbiter_spec: ArbiterSpec | None = None,
        hot_thr: int = 2,
        seed: int = 0,
        device=None,
    ):
        self.names = list(tenant_pages)
        n = len(self.names)
        if n == 0:
            raise ValueError("MultiTenantKV needs at least one tenant")
        caps = np.array(
            [int(tenant_pages[t]) for t in self.names], dtype=np.int64
        )
        floor_frac = np.broadcast_to(
            np.asarray(floor_frac, dtype=np.float64), (n,)
        )
        ceil_frac = np.broadcast_to(
            np.asarray(ceil_frac, dtype=np.float64), (n,)
        )
        floors = np.maximum(1, np.rint(floor_frac * caps).astype(np.int64))
        ceils = np.minimum(caps, np.rint(ceil_frac * caps).astype(np.int64))
        self.hbm_budget = int(hbm_budget)
        # physical slot tensors sized at the ceiling: a later grant up to
        # ceil_frac needs no reallocation, only a watermark move
        self.kvs = {
            name: TieredPagedKV(
                cfg,
                total_pages=int(caps[i]),
                hbm_capacity=int(ceils[i]),
                hot_thr=hot_thr,
                seed=seed + i,
                device=device,
            )
            for i, name in enumerate(self.names)
        }
        controllers = [
            WatermarkController().bind(self.kvs[name].pool)
            for name in self.names
        ]
        self.arbiter = FleetTunaArbiter(
            budget_pages=self.hbm_budget,
            floors=floors,
            ceils=ceils,
            caps=caps,
            controllers=controllers,
            spec=arbiter_spec or ArbiterSpec(),
        )
        self._fail_base = np.zeros(n, dtype=np.int64)
        alloc0 = static_partition(
            self.hbm_budget,
            caps,
            list(shares) if shares is not None else [None] * n,
            floors,
            ceils,
        )
        self.arbiter.apply(alloc0)

    def __getitem__(self, name: str) -> TieredPagedKV:
        return self.kvs[name]

    # ------------------------------------------------------------- demand
    def demands(self) -> np.ndarray:
        """Per-tenant hot-page demand: HBM-resident pages plus the
        promotions that failed for lack of slots since the last rebalance
        (the pressure a bigger share would have absorbed)."""
        resident = np.array(
            [self.kvs[t].pool.fast_pages().size for t in self.names],
            dtype=np.int64,
        )
        fails = np.array(
            [self.kvs[t].pool.stats.pgpromote_fail for t in self.names],
            dtype=np.int64,
        )
        d = resident + (fails - self._fail_base)
        self._fail_base = fails
        return d

    # ---------------------------------------------------------- rebalance
    def rebalance(self, t: float = 0.0, interval: int = -1) -> np.ndarray:
        """Re-divide the HBM budget from observed demand and reclaim.

        Returns the granted per-tenant allocation (in ``names`` order); the
        arbiter's event log (``self.arbiter.events``) records the division
        mode. Each tenant then demotes down to its new watermark, freeing
        annexed slots for the growing tenants' next promotions.
        """
        granted = self.arbiter.rebalance(self.demands(), t=t, interval=interval)
        for name in self.names:
            self.kvs[name].reclaim_to_watermark()
        return granted

    # ------------------------------------------------------------ metrics
    def hbm_in_use(self) -> int:
        return int(sum(self.kvs[t].pool.fast_pages().size for t in self.names))

    def stranded_pages(self) -> int:
        """Budget pages no tenant is actually using (what fleet-level
        arbitration exists to reclaim)."""
        return max(0, self.hbm_budget - self.hbm_in_use())
