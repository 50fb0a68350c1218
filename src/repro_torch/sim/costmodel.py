"""Interval cost model for two-tier memory (the simulator's clock).

Per profiling interval the model charges the *maximum* of a compute term and
a memory term (the classic roofline composition), plus explicit migration
and reclaim-stall overheads — mirroring the paper's characterization
(Section 3): migration competes with the application for tier bandwidth, and
arithmetic intensity determines how insensitive the application is to memory
performance.

Memory term per tier = bandwidth time (app access bytes + migration bytes
crossing that tier, over tier bandwidth) combined with a latency-bound term
divided by the achievable memory-level parallelism. The paper's stated
limitation — the micro-benchmark spreads accesses evenly and therefore
models the *best* memory performance — appears here as the participation
ratio: skewed per-page access histograms reduce effective MLP, which is
exactly the application-vs-microbenchmark gap that produces the (bounded)
model error in Table 2.

Counterpart of :mod:`repro.sim.costmodel`: host float arithmetic, copied
unchanged so that interval times stay bit-identical to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    bw_fast: float  # B/s — fast-tier bandwidth (DRAM / HBM)
    bw_slow: float  # B/s — slow-tier bandwidth (Optane / host link)
    lat_fast: float  # s   — per-access latency, fast tier
    lat_slow: float  # s   — per-access latency, slow tier
    ops_per_s: float  # FLOPS+IOPS per second per thread
    mlp: float  # max in-flight memory accesses per thread
    page_bytes: int  # migration unit
    access_bytes: int  # bytes moved per page access (cache line / vector)
    migrate_page_overhead: float  # s — fixed SW cost per migrated page
    direct_reclaim_stall: float  # s — blocking stall per direct-reclaimed page
    promote_fail_penalty: float  # s — wasted work per failed promotion
    # on-chip cache absorption: the hottest `llc_pages` pages per interval
    # contribute at most one cold fetch per cache line (their re-references
    # hit LLC, regardless of which tier backs them). 0 disables.
    llc_pages: int = 0
    # cross-tier overlap: tiers serve multithreaded streams concurrently,
    # but dependent chains serialize a fraction of the smaller tier's time
    # behind the larger one. 0 = perfect overlap, 1 = fully serial.
    cross_tier_serial: float = 0.4
    # write-path asymmetry (None = same as the read path). The interval
    # cost model is read-modeled and never reads these; they are kept so a
    # profile is the same object as in the JAX package.
    lat_fast_write: float | None = None
    lat_slow_write: float | None = None
    bw_slow_write: float | None = None


# Calibrated to reproduce the paper's testbed behaviour (Xeon Gold 6252 +
# DRAM/Optane): DRAM ~100 GB/s, Optane ~15 GB/s read-dominated, ~3x latency.
OPTANE_LIKE = HardwareProfile(
    name="optane_like",
    bw_fast=100e9,
    bw_slow=30e9,  # 6-DIMM Optane, read-dominated mix
    lat_fast=90e-9,
    lat_slow=350e-9,
    ops_per_s=50e9,
    mlp=10.0,
    page_bytes=4096,
    access_bytes=64,
    migrate_page_overhead=2.0e-6,
    direct_reclaim_stall=4.0e-6,
    promote_fail_penalty=1.5e-6,
    llc_pages=1024,  # LLC scaled with the workloads (~4 MB of 4 KB pages)
    # Optane's write path is far worse than its read path (~3x latency,
    # ~1/4 bandwidth); DRAM writes are roughly symmetric.
    lat_fast_write=90e-9,
    lat_slow_write=1000e-9,
    bw_slow_write=8e9,
)

# One H100 SXM with pinned host memory as the slow tier: the serving tier
# of the port's tiered KV cache. Bandwidths and the compute rate are data
# sheet figures, not measurements: bw_fast is HBM3's 3.35 TB/s and
# ops_per_s the 989 TFLOP/s dense bf16 tensor-core rate (NVIDIA H100 SXM
# data sheet); bw_slow is PCIe Gen5 x16's 64 GB/s per direction (PCI-SIG
# Gen5 specification, as the H100 data sheet quotes it). The latencies, MLP
# and per-page software costs are OPTANE_LIKE's (the paper testbed's
# calibration); none of them was measured on this card. page_bytes and
# access_bytes are a 4 KiB page consumed whole; a caller sets them to its
# KV page with dataclasses.replace.
H100_HOST_TIER = HardwareProfile(
    name="h100_host_tier",
    bw_fast=3.35e12,
    bw_slow=64e9,
    lat_fast=OPTANE_LIKE.lat_fast,
    lat_slow=OPTANE_LIKE.lat_slow,
    ops_per_s=989e12,
    mlp=OPTANE_LIKE.mlp,
    page_bytes=4096,
    access_bytes=4096,  # KV pages are consumed whole by attention
    migrate_page_overhead=OPTANE_LIKE.migrate_page_overhead,
    direct_reclaim_stall=OPTANE_LIKE.direct_reclaim_stall,
    promote_fail_penalty=OPTANE_LIKE.promote_fail_penalty,
    llc_pages=0,  # no cache absorption for copied, whole-page KV reads
)


@dataclass(frozen=True)
class IntervalCosts:
    t_compute: float
    t_fast: float
    t_slow: float
    t_migrate: float
    t_stall: float

    serial_frac: float = 0.4

    @property
    def total(self) -> float:
        # compute overlaps with memory (roofline max). The two tiers serve
        # multithreaded access streams concurrently — the slow tier adds
        # bandwidth (the premise of tiered/interleaved memory) — but
        # dependent chains serialize `serial_frac` of the smaller tier's
        # time behind the larger. Migration SW overhead and blocking stalls
        # are additive.
        t_mem = max(self.t_fast, self.t_slow) + self.serial_frac * min(
            self.t_fast, self.t_slow
        )
        return max(self.t_compute, t_mem) + self.t_migrate + self.t_stall


def absorb_cache(counts: np.ndarray, llc_pages: int, cl_per_page: int = 64) -> np.ndarray:
    """Cap the hottest ``llc_pages`` pages at one cold fetch per line.

    Models on-chip cache residency: a page hammered within an interval is
    LLC-resident and its re-references never reach memory — whichever tier
    backs it. Policy-visible *touches* (NUMA hint faults) are unaffected.
    """
    if llc_pages <= 0 or counts.size <= llc_pages:
        return np.minimum(counts, cl_per_page) if llc_pages > 0 else counts
    kth = np.partition(counts, counts.size - llc_pages)[counts.size - llc_pages]
    out = counts.copy()
    hot = counts >= kth
    # cap only the top ~llc_pages pages
    out[hot] = np.minimum(counts[hot], cl_per_page)
    return out


def effective_mlp(counts: np.ndarray, hw_mlp: float, num_threads: int) -> float:
    """MLP achievable given the per-page access histogram.

    Participation ratio PR = (Σc)²/Σc² is the effective number of
    equally-loaded pages; accesses serialized onto few pages cannot overlap
    beyond PR. The micro-benchmark's even spread gives PR ≈ pages touched,
    i.e. the hardware maximum (the paper's best-performance limitation).
    """
    if counts.size == 0:
        return hw_mlp * num_threads
    s1 = float(counts.sum())
    s2 = float(np.square(counts, dtype=np.float64).sum())
    pr = (s1 * s1) / s2 if s2 > 0 else 1.0
    return min(hw_mlp * num_threads, max(1.0, pr))


def interval_time(
    hw: HardwareProfile,
    pacc_f: int,
    pacc_s: int,
    ops: float,
    pm_pr: int,
    pm_de: int,
    pm_fail: int,
    direct_reclaimed: int,
    mlp_eff: float,
    num_threads: int = 1,
    rand_frac: float = 1.0,
) -> IntervalCosts:
    """Charge one profiling interval."""
    threads = max(1, num_threads)
    # --- compute term
    t_compute = ops / (hw.ops_per_s * threads)
    # --- per-tier memory bytes: app accesses + migration traffic crossing it.
    # A promotion reads page_bytes from slow and writes them to fast; a
    # demotion reads fast, writes slow. Both compete with the app for the
    # tier's bandwidth (the paper's characterization #1).
    mig_bytes = (pm_pr + pm_de) * hw.page_bytes
    bytes_fast = pacc_f * hw.access_bytes + mig_bytes
    bytes_slow = pacc_s * hw.access_bytes + mig_bytes
    # bandwidth-bound and latency-bound components per tier; MLP hides
    # latency up to mlp_eff outstanding accesses, and only the random
    # fraction of accesses is latency-exposed (sequential bursts are
    # prefetched).
    t_fast = max(
        bytes_fast / hw.bw_fast, pacc_f * rand_frac * hw.lat_fast / mlp_eff
    )
    t_slow = max(
        bytes_slow / hw.bw_slow, pacc_s * rand_frac * hw.lat_slow / mlp_eff
    )
    # --- migration software overhead + blocking stalls
    t_migrate = (pm_pr + pm_de) * hw.migrate_page_overhead / threads
    t_stall = (
        direct_reclaimed * hw.direct_reclaim_stall
        + pm_fail * hw.promote_fail_penalty
    )
    return IntervalCosts(
        t_compute=t_compute,
        t_fast=t_fast,
        t_slow=t_slow,
        t_migrate=t_migrate,
        t_stall=t_stall,
        serial_frac=hw.cross_tier_serial,
    )
