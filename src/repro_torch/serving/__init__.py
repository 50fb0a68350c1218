"""Tiered KV serving of the port (counterpart of :mod:`repro.serving`):
the two-tier paged KV cache on HBM and pinned host memory, continuous
batching, the decode service with the Tuna loop closed, and the
multi-tenant cache (``MultiTenantKV``: N tenants' KV pools under one HBM
budget, divided by the fleet arbiter)."""

from repro_torch.serving.fleet_kv import MultiTenantKV
from repro_torch.serving.kv_cache import KVPageConfig, TieredPagedKV
from repro_torch.serving.scheduler import ContinuousBatcher, Session
from repro_torch.serving.server import RoundStats, TieredServer

__all__ = ["KVPageConfig", "TieredPagedKV", "MultiTenantKV", "Session",
           "ContinuousBatcher", "RoundStats", "TieredServer"]
