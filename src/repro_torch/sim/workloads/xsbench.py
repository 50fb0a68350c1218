"""XSBench: the Monte Carlo neutron-transport macroscopic cross-section
lookup kernel (Tramm et al.), implemented for real (counterpart of
:mod:`repro.sim.workloads.xsbench`; the traces are identical).

Per particle history: sample (energy, material) → binary-search the
unionized energy grid → for every nuclide in the material, gather the
cross-section row at the found grid index and interpolate 5 reaction
channels. Access pattern: the binary-search probes concentrate on a small
hot set (the top levels of the search tree) while the xs-table gathers are
near-uniform over a large array; arithmetic intensity is the highest of the
evaluation suite (the paper's metric #3), which is what lets Tuna shrink its
fast memory aggressively (overall loss 1.8% in the paper).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.trace import Trace
from repro_torch.sim.workloads.base import PageMapper

N_GRID = 1_200_000  # unionized energy grid points
N_NUCLIDES = 68  # H-M large has 355; scaled with RSS
NUC_GRID = 40_000  # per-nuclide energy points
N_MATS = 12
LOOKUPS_PER_INTERVAL = 120_000
FLOPS_PER_INTERP = 18.0  # 5 channels x (1 sub, 1 div, 1 mul, ~0.6 add)


def xsbench_trace(
    n_intervals: int = 100,
    lookups: int = LOOKUPS_PER_INTERVAL,
    seed: int = 17,
    page_bytes: int = 4096,
) -> Trace:
    rng = np.random.default_rng(seed)
    pm = PageMapper("xsbench", page_bytes=page_bytes, num_threads=24)
    pm.region("mats", 4096, 8)
    pm.region("egrid", N_GRID, 8)  # unionized energies (f64)
    pm.region("index_grid", N_GRID, 4)  # per-point nuclide index entry
    pm.region("nuc_grids", N_NUCLIDES * NUC_GRID, 8)
    pm.region("xs_tables", N_NUCLIDES * NUC_GRID, 6 * 8)  # 5 channels + pad
    # init: physical allocation pass
    pm.touch_range("mats", 0, 4096)
    pm.touch_range("egrid", 0, N_GRID)
    pm.touch_range("index_grid", 0, N_GRID)
    pm.touch_range("nuc_grids", 0, N_NUCLIDES * NUC_GRID)
    pm.touch_range("xs_tables", 0, N_NUCLIDES * NUC_GRID)
    pm.end_interval()

    # material → nuclide lists (small, hot); lookup frequency follows the
    # H-M benchmark's material distribution (fuel dominates)
    mat_nucs = [
        rng.choice(N_NUCLIDES, size=rng.integers(3, 12), replace=False)
        for _ in range(N_MATS)
    ]
    mat_pop = np.array([0.40, 0.14, 0.10, 0.08, 0.06, 0.05, 0.04, 0.04,
                        0.03, 0.03, 0.02, 0.01])
    mat_pop = mat_pop / mat_pop.sum()
    depth = int(np.ceil(np.log2(N_GRID)))
    for _ in range(n_intervals):
        e = rng.beta(2.0, 5.0, size=lookups)  # flux-spectrum-shaped energies
        mats = rng.choice(N_MATS, size=lookups, p=mat_pop)
        # --- binary search on the unionized grid: probe sequence touches
        # lo..hi midpoints; level k probes one of 2^k positions (hot top).
        lo = np.zeros(lookups, dtype=np.int64)
        hi = np.full(lookups, N_GRID, dtype=np.int64)
        for _lvl in range(depth):
            mid = (lo + hi) // 2
            pm.touch("egrid", mid, ops_per_access=2.0)  # load + compare
            go_right = mid.astype(np.float64) / N_GRID < e
            lo = np.where(go_right, mid + 1, lo)
            hi = np.where(go_right, hi, mid)
        idx = np.minimum(lo, N_GRID - 1)
        pm.touch("index_grid", idx, ops_per_access=1.0)
        # --- per-nuclide gathers + interpolation
        for m in range(N_MATS):
            sel = np.flatnonzero(mats == m)
            if sel.size == 0:
                continue
            frac = idx[sel].astype(np.float64) / N_GRID
            for nuc in mat_nucs[m]:
                nuc_idx = nuc * NUC_GRID + (frac * NUC_GRID).astype(np.int64)
                pm.touch("nuc_grids", nuc_idx, ops_per_access=3.0)
                pm.touch("xs_tables", nuc_idx, ops_per_access=FLOPS_PER_INTERP)
        pm.touch("mats", mats % 4096, ops_per_access=1.0)
        pm.end_interval()
    return pm.trace
