"""The paper's evaluation workloads (Table 1) and two stressors, as trace
generators of the port (counterpart of :mod:`repro.sim.workloads`).

Each workload runs its actual algorithm (numpy-vectorized, on the host:
a trace is the simulator's input, not device work) over synthetic inputs,
instrumented at page granularity. The same arguments and seed give the
same arrays as the JAX package's generators. RSS values are scaled down
from the paper's 10-24 GB to tens of MB at the defaults:

| workload | paper RSS | here (default) | access pattern              |
|----------|-----------|----------------|-----------------------------|
| bfs      | 12.4 G    | ~50 MB         | frontier bursts, power law  |
| sssp     | 23.5 G    | ~80 MB         | relaxation rounds           |
| pagerank | 15.8 G    | ~60 MB         | full sweeps, power law      |
| xsbench  | 16.4 G    | ~60 MB         | random lookups, high AI     |
| btree    | 10.8 G    | ~45 MB         | Zipf lookups, hot root      |

``thrash`` is the adversarial rotating working set (~2x the fast tier)
that pins the migration-failure regime; ``arrivals`` is the session
arrival shape (Poisson + diurnal + flash crowds, long-tail lifetimes).
"""

from repro_torch.sim.workloads.base import PageMapper
from repro_torch.sim.workloads.graphs import bfs_trace, pagerank_trace, sssp_trace
from repro_torch.sim.workloads.xsbench import xsbench_trace
from repro_torch.sim.workloads.btree import btree_trace
from repro_torch.sim.workloads.thrash import thrash_trace
from repro_torch.sim.workloads.arrivals import arrivals_trace

WORKLOADS = {
    "bfs": bfs_trace,
    "sssp": sssp_trace,
    "pagerank": pagerank_trace,
    "xsbench": xsbench_trace,
    "btree": btree_trace,
    "thrash": thrash_trace,
    "arrivals": arrivals_trace,
}

__all__ = ["WORKLOADS", "PageMapper", "bfs_trace", "sssp_trace",
           "pagerank_trace", "xsbench_trace", "btree_trace", "thrash_trace",
           "arrivals_trace"]
