"""Btree: in-memory index lookups (the mitosis-project btree workload;
counterpart of :mod:`repro.sim.workloads.btree`, the traces are identical).

A complete implicit B-tree (fanout F, BFS node layout) over sorted keys;
queries follow a Zipf popularity distribution whose permutation drifts over
time (phased hot set). Upper tree levels are extremely hot — the classic
tiering-friendly index shape; leaf/value pages are cold and Zipf-skewed.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.trace import Trace
from repro_torch.sim.workloads.base import PageMapper, zipf_weights

FANOUT = 16
LEVELS = 6  # 16^5 ≈ 1M leaf slots
QUERIES_PER_INTERVAL = 80_000


def btree_trace(
    n_intervals: int = 120,
    queries: int = QUERIES_PER_INTERVAL,
    levels: int = LEVELS,
    zipf_s: float = 1.25,
    phase_every: int = 30,
    seed: int = 23,
    page_bytes: int = 4096,
) -> Trace:
    rng = np.random.default_rng(seed)
    n_leaves = FANOUT ** (levels - 1)
    # level lvl has FANOUT^lvl nodes; node = FANOUT keys of 8 bytes
    level_nodes = [FANOUT**lvl for lvl in range(levels)]
    level_base = np.concatenate([[0], np.cumsum(level_nodes)])  # node ids
    total_nodes = int(level_base[-1])

    pm = PageMapper("btree", page_bytes=page_bytes, num_threads=24)
    pm.region("nodes", total_nodes * FANOUT, 8)  # keys, node-major
    pm.region("values", n_leaves, 256)  # payloads
    pm.touch_range("nodes", 0, total_nodes * FANOUT)
    pm.touch_range("values", 0, n_leaves)
    pm.end_interval()

    popularity = zipf_weights(n_leaves, zipf_s, rng)
    for it in range(n_intervals):
        if it and it % phase_every == 0:
            # phase change: the hot key set drifts (drives promotions)
            popularity = zipf_weights(n_leaves, zipf_s, rng)
        leaf = rng.choice(n_leaves, size=queries, p=popularity)
        # walk root→leaf: node index at level lvl is the leaf's prefix
        node_path = np.zeros(queries, dtype=np.int64)
        for lvl in range(levels):
            digit = leaf // (FANOUT ** (levels - 1 - lvl))
            node = level_base[lvl] + digit
            # within-node binary search touches ~log2(F) key slots; charge
            # one page access at the node's first key slot (nodes are 128 B,
            # well under a page) + compare ops
            pm.touch("nodes", node * FANOUT, ops_per_access=np.log2(FANOUT) * 2)
            node_path = node
        pm.touch("values", leaf, ops_per_access=4.0)
        pm.end_interval()
    return pm.trace
