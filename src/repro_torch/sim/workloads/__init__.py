"""Workload trace generators of the port (counterpart of
:mod:`repro.sim.workloads`). This slice carries the thrash table scan, the
trace ``chip_smoke.py`` drives at the paper's BFS RSS."""

from repro_torch.sim.workloads.thrash import thrash_trace

__all__ = ["thrash_trace"]
