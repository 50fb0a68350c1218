"""Graph workloads from the GAP benchmark suite: BFS, SSSP, PageRank
(counterpart of :mod:`repro.sim.workloads.graphs`; the traces are identical).

The algorithms run for real (numpy-vectorized CSR traversals over a
synthetic power-law graph); every array access is logged at page
granularity. Hubs make the access distribution heavy-tailed — the property
that lets a page-migration system keep the hot working set in fast memory.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.trace import Trace
from repro_torch.sim.workloads.base import PageMapper, power_law_graph

# Scaled-down defaults (paper: 10-24 GB RSS; here ~50-80 MB → same ratios).
N_NODES = 400_000
AVG_DEG = 16
ALPHA = 1.00  # Zipf exponent of the degree distribution (twitter-like hubs)
EDGE_CHUNK = 250_000  # edge traversals per profiling interval
NUM_THREADS = 24  # the paper's 24-core socket (GAP runs use OpenMP)


def _expand_frontier(offsets, edges, frontier):
    """All neighbor positions of the frontier in the CSR edge array."""
    starts = offsets[frontier]
    lens = offsets[frontier + 1] - starts
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int32)
    base = np.repeat(starts, lens)
    csum = np.cumsum(lens) - lens
    pos = base + (np.arange(total, dtype=np.int64) - np.repeat(csum, lens))
    return pos, edges[pos]


def bfs_trace(
    n: int = N_NODES,
    avg_deg: int = AVG_DEG,
    seed: int = 7,
    n_sources: int = 32,
    dist_cache_rate: int = 8,
    page_bytes: int = 4096,
    write_frac: float = 0.0,
) -> Trace:
    """Direction-optimizing BFS (GAP): top-down gathers for small
    frontiers, bottom-up sweeps with a frontier *bitmap* for large ones.

    Allocation order mirrors the GAP binaries - CSR first, per-trial
    property arrays last - so a reduced fast tier spills ``dist`` under
    first-touch. The bitmap (n bits, a handful of pages) is what bottom-up
    neighbour checks hit, so the spilled ``dist`` costs streaming bandwidth
    rather than random latency; a migrating policy promotes the gathered
    property pages back (the paper's Fig. 1 contrast)."""
    offsets, edges = power_law_graph(n, avg_deg, ALPHA, seed)
    pm = PageMapper("bfs", page_bytes=page_bytes, num_threads=NUM_THREADS)
    pm.region("offsets", n + 1, 8)
    pm.region("edges", edges.size, 4)
    pm.region("dist", n, 4)
    pm.region("bitmap", n // 8 + 1, 1)
    # init: touch everything once (physical allocation, CSR load order)
    pm.touch_range("offsets", 0, n + 1)
    pm.touch_range("edges", 0, edges.size)
    pm.touch_range("dist", 0, n)
    pm.touch_range("bitmap", 0, n // 8 + 1)
    pm.end_interval()
    rng = np.random.default_rng(seed + 1)
    bottom_up_thresh = n // 24  # GAP's alpha heuristic, simplified
    for src in rng.choice(n, size=n_sources, replace=False):
        dist = np.full(n, -1, dtype=np.int32)
        dist[src] = 0
        frontier = np.array([src], dtype=np.int64)
        level = 0
        budget = 0
        while frontier.size:
            if frontier.size < bottom_up_thresh:
                # ---- top-down: random gathers into dist (hub repeats are
                # absorbed by the CPU cache -> sampled 1/rate)
                pos, neigh = _expand_frontier(offsets, edges, frontier)
                pm.touch("offsets", frontier, ops_per_access=1.0)
                pm.touch("edges", pos, ops_per_access=1.0, sequential=True)
                pm.touch("dist", neigh[::dist_cache_rate], ops_per_access=2.0)
                unvisited = neigh[dist[neigh] < 0]
                nxt = np.unique(unvisited)
                pm.touch("dist", nxt, ops_per_access=1.0,
                         write_frac=write_frac)
                pm.touch("bitmap", nxt // 8, ops_per_access=1.0,
                         write_frac=write_frac)
                budget += pos.size
            else:
                # ---- bottom-up: every unvisited vertex scans its edges and
                # checks the frontier *bitmap*; dist is swept sequentially
                unvis = np.flatnonzero(dist < 0)
                pos, neigh = _expand_frontier(offsets, edges, unvis)
                in_frontier = dist[neigh] == level
                owner = np.repeat(unvis, offsets[unvis + 1] - offsets[unvis])
                nxt = np.unique(owner[in_frontier])
                pm.touch_range("offsets", 0, n + 1, ops_per_access=1.0)
                pm.touch("edges", pos, ops_per_access=1.0, sequential=True)
                pm.touch("bitmap", (neigh[::dist_cache_rate] // 8),
                         ops_per_access=1.0)
                pm.touch_range("dist", 0, n, ops_per_access=1.0,
                               write_frac=write_frac)
                pm.touch("bitmap", nxt // 8, ops_per_access=1.0,
                         write_frac=write_frac)
                budget += pos.size
            dist[nxt] = level + 1
            frontier = nxt.astype(np.int64)
            level += 1
            if budget >= EDGE_CHUNK or frontier.size == 0:
                pm.end_interval()
                budget = 0
        pm.end_interval()
    return pm.trace


def sssp_trace(
    n: int = N_NODES,
    avg_deg: int = AVG_DEG,
    seed: int = 11,
    n_sources: int = 12,
    delta: float = 0.1,
    page_bytes: int = 4096,
    write_frac: float = 0.0,
) -> Trace:
    """Single-source shortest path via bucketed (delta-stepping-style)
    frontier relaxation over weighted edges."""
    offsets, edges = power_law_graph(n, avg_deg, ALPHA, seed)
    rng = np.random.default_rng(seed + 1)
    weights = rng.uniform(0.01, 1.0, size=edges.size).astype(np.float32)
    pm = PageMapper("sssp", page_bytes=page_bytes, num_threads=NUM_THREADS)
    pm.region("dist", n, 4)
    pm.region("offsets", n + 1, 8)
    pm.region("edges", edges.size, 4)
    pm.region("weights", weights.size, 4)
    pm.touch_range("dist", 0, n)
    pm.touch_range("offsets", 0, n + 1)
    pm.touch_range("edges", 0, edges.size)
    pm.touch_range("weights", 0, weights.size)
    pm.end_interval()
    for src in rng.choice(n, size=n_sources, replace=False):
        dist = np.full(n, np.inf, dtype=np.float32)
        dist[src] = 0.0
        active = np.array([src], dtype=np.int64)
        rounds = 0
        budget = 0
        while active.size and rounds < 200:
            pos, neigh = _expand_frontier(offsets, edges, active)
            pm.touch("offsets", active, ops_per_access=1.0)
            pm.touch("edges", pos, ops_per_access=1.0, sequential=True)
            pm.touch("weights", pos, ops_per_access=1.0, sequential=True)
            pm.touch("dist", neigh, ops_per_access=3.0)  # load, add, min
            cand = dist[np.repeat(active, offsets[active + 1] - offsets[active])]
            new_d = cand + weights[pos]
            better = new_d < dist[neigh]
            upd_nodes = neigh[better]
            upd_vals = new_d[better]
            # resolve duplicates: keep the min per node
            order = np.argsort(upd_nodes, kind="stable")
            upd_nodes, upd_vals = upd_nodes[order], upd_vals[order]
            uniq, start = np.unique(upd_nodes, return_index=True)
            mins = np.minimum.reduceat(upd_vals, start)
            improved = mins < dist[uniq]
            uniq, mins = uniq[improved], mins[improved]
            dist[uniq] = mins
            pm.touch("dist", uniq, ops_per_access=1.0,
                     write_frac=write_frac)
            active = uniq.astype(np.int64)
            rounds += 1
            budget += pos.size
            if budget >= EDGE_CHUNK or active.size == 0:
                pm.end_interval()
                budget = 0
        pm.end_interval()
    return pm.trace


def pagerank_trace(
    n: int = N_NODES,
    avg_deg: int = AVG_DEG,
    seed: int = 13,
    iters: int = 12,
    damping: float = 0.85,
    page_bytes: int = 4096,
    write_frac: float = 0.0,
) -> Trace:
    """Power-iteration PageRank; each iteration is split into edge-range
    chunks that map onto profiling intervals."""
    offsets, edges = power_law_graph(n, avg_deg, ALPHA, seed)
    deg = (offsets[1:] - offsets[:-1]).astype(np.float64)
    deg[deg == 0] = 1.0
    pm = PageMapper("pagerank", page_bytes=page_bytes, num_threads=NUM_THREADS)
    pm.region("rank", n, 8)
    pm.region("contrib", n, 8)
    pm.region("offsets", n + 1, 8)
    pm.region("edges", edges.size, 4)
    pm.touch_range("rank", 0, n)
    pm.touch_range("contrib", 0, n)
    pm.touch_range("offsets", 0, n + 1)
    pm.touch_range("edges", 0, edges.size)
    pm.end_interval()
    # src node of each edge position (for the gather side)
    src_of_pos = np.repeat(
        np.arange(n, dtype=np.int64), (offsets[1:] - offsets[:-1])
    )
    rank = np.full(n, 1.0 / n)
    m = edges.size
    for _ in range(iters):
        contrib = rank / deg
        pm.touch_range("rank", 0, n, ops_per_access=1.0)
        pm.touch_range("contrib", 0, n, ops_per_access=1.0)
        new_rank = np.zeros(n)
        for lo in range(0, m, EDGE_CHUNK):
            hi = min(m, lo + EDGE_CHUNK)
            seg = slice(lo, hi)
            np.add.at(new_rank, edges[seg], contrib[src_of_pos[seg]])
            pm.touch_range("edges", lo, hi, ops_per_access=1.0)
            # gather of contrib[src] is sequential-ish; scatter to rank[dst]
            # is the random, tiering-sensitive stream
            pm.touch("contrib", src_of_pos[seg][:: max(1, (hi - lo) // 200_000)],
                     ops_per_access=0.0, sequential=True)
            pm.touch("rank", edges[seg], ops_per_access=2.0,
                     write_frac=write_frac)
            pm.end_interval()
        rank = (1.0 - damping) / n + damping * new_rank
    return pm.trace
