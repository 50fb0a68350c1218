"""Tiered KV serving of the port (counterpart of :mod:`repro.serving`):
the two-tier paged KV cache on HBM and pinned host memory, continuous
batching, and the decode service with the Tuna loop closed. The
multi-tenant cache (``MultiTenantKV``) comes with the fleet layer."""

from repro_torch.serving.kv_cache import KVPageConfig, TieredPagedKV
from repro_torch.serving.scheduler import ContinuousBatcher, Session
from repro_torch.serving.server import RoundStats, TieredServer

__all__ = ["KVPageConfig", "TieredPagedKV", "Session", "ContinuousBatcher",
           "RoundStats", "TieredServer"]
