#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA device and
the CUDA toolkit::

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. build every CUDA source under ``src/repro_torch/csrc`` with nvcc, all
   at once;
2. every kernel against its plain PyTorch version on the card over seeded
   inputs: ``victim_partition`` and ``migrate_pages`` exactly (ragged rows,
   over-demand, strided rows, rows of one to three tiles with the demand on
   a tile boundary, 1,000 short rows, the main path's shape 20 times over;
   device, pinned-host and mixed pools, pages that are not a multiple of 16
   bytes, the full Qwen3-1.7B KV page, a batch of more pages than the copy
   kernel has blocks, host and device page ids), ``strided_probe`` against float64
   within its rounding bound, ``paged_decode_attention`` within a stated
   tolerance (holes, partial pages, grouped heads, a fully masked row,
   sequences over three or more splits ending mid-page, and against the
   plain version of its split-and-merge), ``flash_attention`` (causal and
   not, T > S, ragged tails, grouped heads, rows that see no key, multi-tile
   causal at 1,000 and 2,047 tokens) and ``wkv6`` (bf16 r, k, v beside f32
   w, strong decays, S from 1 to 2,048, every head size with its columns
   split over blocks, 10 bit-identical repeats) in bfloat16 and float32
   within stated tolerances; ``strided_probe`` also at page rows of 1,000
   and 1,001 floats, a pool base one float past alignment, page counts
   around its grid, one page, and 20 bit-identical repeats;
3. the CPU lane == the CUDA lane, bit for bit: the sweep through ``run``
   (an untuned sweep, a tuned shrink and an untuned ``thrash_guard`` sweep
   over four sizes, whose guard must suppress candidates), and the tiered serving loop at
   the demo's page counts and a narrow page (summary, history, tuner
   decisions, watermark log, slot map, tiers, heat, both pools' bits); and
   Qwen3-1.7B and RWKV6-3B at full width and 2 layers in float32, the same
   weights on both (forward logits, a short prefill's logits and state)
   within a stated tolerance;
4. the sweep's main path at full size through the entry points a user
   calls (``repro_torch.sim.api.run``, ``build_database``), with the
   ``victim_partition`` count set to 0 just before and read just after;
5. ``victim_partition`` timed on the main path's inputs: CUDA events
   around one call, the profiler's device time, the wrapper's host time;
6. tiered serving at full width through the port's public classes
   (``repro_torch.serving``): Qwen3-1.7B KV pages, a pinned host pool and
   an HBM pool, 800 tuned rounds, with the ``migrate_pages`` count set to
   0 just before and read just after; every page's content must survive;
7. the serving kernels on the inputs the card sees: ``paged_decode_
   attention`` over the last round's batch straight out of the HBM pool
   (every layer group driven once, counted), ``migrate_pages`` on the
   run's largest promotion and demotion and on one page each way (device
   time too, beside the copy engines), device to device beside
   ``index_copy_``, ``strided_probe`` over a 1 GiB HBM
   pool and a 1 GiB pinned host pool (six cases driven once, counted; the
   profiler's device time of each, and the copy engines' GB/s for one
   contiguous 0.5 GiB pinned block beside the probe's host reading);
   CUDA events, median of repeated runs, beside the plain version, the
   bound and a PyTorch yardstick where one call computes the same function;
8. model serving at full width through ``repro_torch.launch.serve.
   make_serve_fns``, Qwen3-1.7B then RWKV6-3B, each loaded from a seed on
   the card, served and freed: 4 requests of 2,048-token prompts and 32
   greedy new tokens. The prefill fn runs with the ``flash_attention`` and
   ``wkv6`` counts set to 0 just before and read just after (28 and 32
   launches); the kernel-path forward is held against the same forward
   through the plain versions on the card, within twice the distance of the
   plain bfloat16 forward from the plain float32 one; the decode loop fills
   the state
   (its last logits against the prefill fn's), then 32 decode steps;
9. ``flash_attention`` and ``wkv6`` timed on the first layer's serving
   inputs (CUDA events, and for ``wkv6`` the profiler's device time and
   ptxas's registers), beside the plain version, the bound and, for
   attention, ``scaled_dot_product_attention`` (a yardstick the port never
   calls);
10. the paper's experiment on the card (Figs. 3-7, after the JAX
    package's ``benchmarks/fig3_7_tuning.py`` and ``benchmarks/common.py::
    build_bench_db``, through ``repro_torch.sim.api.run``,
    ``build_database`` and ``repro_torch.sim.workloads.WORKLOADS``): the
    seven workloads at their default sizes generated in parallel processes,
    the 196-record database harvested from them, TPP vs TPP+Tuna at
    tau = 5% on bfs, sssp, pagerank, xsbench and btree, the thrash row and
    the knee block (tpp, admission, thrash_guard at full size and tuned
    from half), with the ``victim_partition`` count set to 0 just before
    and read just after; every one of those runs again on the CPU, bit
    for bit; the guard must suppress candidates; then TPP vs TPP+Tuna on
    ``btree_trace(levels=7)`` (1,607,817 pages), its largest
    ``victim_partition`` call held against the plain version. Per workload
    it prints pages, intervals, wall s, saving, loss, migrations and the
    trace's sha256; for pagerank and the large btree the profiler's wall
    against device ms an interval;
11. the fault model and the multi-tenant fleet on the card (after the JAX
    package's ``benchmarks/fig_fault_resilience.py`` and
    ``benchmarks/fig_fleet.py``, through ``repro_torch.sim.api.run``,
    ``repro_torch.fleet`` and ``repro_torch.serving.MultiTenantKV``), with
    the ``victim_partition`` and ``migrate_pages`` counts set to 0 just
    before each part and read just after: (a) phase 10's thrash trace under
    the levels none, mild and harsh (seed 7), kinds tpp, admission and
    thrash_guard at full size and tuned (tau 5%), on the card and on the
    CPU, bit for bit (fault events included); then phase 4's trace under
    harsh faults over the paper's 20 sizes with TPP+Tuna riding along; (b)
    the balanced, skewed and noisy mixes (48 intervals, tenants of 12,000
    pages, the noisy neighbour 8,000, budget 0.7 of the RSS, tau 0.2), the
    full-budget reference, static and fleet_tuna, on the card and on the
    CPU, bit for bit (the arbiter's log included), the noisy mix once more
    under harsh faults; then the skewed mix at phase 4's RSS (3,250,584
    pages) on the card; (c) ``MultiTenantKV`` (three tenants of 1,024, 512
    and 512 Qwen3-1.7B KV pages, 3.76 GB pinned, an HBM budget of 512
    slots) through 200 seeded rounds with a rebalance every 8, on the CPU
    and on the card at a narrow page, bit for bit, then at the full page
    with every page's content checked;
12. the per-size engine, custom runners and the timing engine on the card
    (after the JAX package's ``benchmarks/fig1_motivation.py`` and
    ``benchmarks/fig_model_fidelity.py``, through ``repro_torch.sim.api.
    run`` with the ``first_touch`` kind, ``Scenario.pool_factory`` and
    ``Scenario.runner``, and ``repro_torch.timing``), with the
    ``timing_replay`` and ``victim_partition`` counts set to 0 just before
    each part and read just after: (a) ``timing_replay`` against
    ``replay_ref`` bit for bit (every call of (b) and (c) against the CPU
    lanes' on the same inputs, W = 1 chains, one page hammered, writes,
    pages twice in a window, an empty replay; and, run by spawned processes
    beside the phase, the first launch of (d) with more than one block of
    replays, the first replay of (g) whole, and a launch of the first 4,000
    events of each of (g)'s 13 replays at their real sizes, repeated 10
    times bit-identical); its bound is the serial chain, with the latency of
    a dependent load and of a dependent float64 add measured in the run;
    (b) ``calibrate``, CPU
    lane == CUDA lane, residuals below 0.15; (c) the fidelity quick
    contract, CPU lane == CUDA lane; (d) the fidelity experiment at its
    defaults (7 workloads x 6 sizes, divergence per regime and per
    workload); (e) Fig. 1 at its defaults (bfs and thrash x 7 sizes x
    {tpp, first_touch}), CPU lane == CUDA lane, then over phase 4's trace;
    (f) a ``pool_factory`` scenario == the device sweep, every kind; (g)
    TPP at 0.75 over phase 4's trace through ``timing_runner``, every
    interval replayed in one launch, bytes conserved and each replay at
    least its channels' occupancy.

The last three lines of standard output are the kernels' JSON line, the
card's name and power limit (``nvidia-smi``), and
``{"ok": true, "device": {...}}``. Nothing of JAX and nothing of the JAX
package is imported.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from dataclasses import asdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FULL_RSS = 3_250_585  # 12.4 GiB of 4 KiB pages: the paper's BFS RSS
FULL_INTERVALS = 12
SWEEP_FRACS = None  # set in main(): np.round(np.arange(1.0, 0.0, -0.05), 3)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
ALU_OPS_PER_S = 67e12  # H100 SXM scalar (non-tensor-core) rate
PCIE_BYTES_PER_S = 64e9  # PCIe Gen5 x16, one direction (the host tier)
FP32_EPS = 2.0 ** -24  # unit roundoff of float32

# Tiered serving, with the settings of examples/serve_tiered.py: 4,096
# logical pages, 1,024 HBM slots, 400 sessions, batches of 16, 3 resumes a
# round, tuned every 16 rounds, popularity drift every 250 of 800 rounds.
SERVE_TOTAL_PAGES, SERVE_HBM_PAGES = 4096, 1024
SERVE_ROUNDS, SERVE_DRIFT = 800, 250
SERVE_BATCHER = dict(n_sessions=400, page_size=16, max_batch=16,
                     resumes_per_round=3.0)
# The page at full width is Qwen3-1.7B's KV (repro_torch.configs.qwen3_1_7b:
# 28 layers, 16 query heads, 8 KV heads, head_dim 128), 16 tokens a page, in
# bfloat16: 1,835,008 bytes a page, 7.52 GB of host pool, 1.88 GB of HBM. Set
# in main() from the port's config, once the package is importable.
QWEN3_1_7B_PAGE: dict = {}
QWEN3_1_7B_QUERY_HEADS = 0
# the CPU lane == CUDA lane check runs the demo's page counts at a narrow
# page: the control plane never looks at the width
NARROW_PAGE = dict(n_groups=1, page_size=16, kv_heads=1, head_dim=8)
# the micro-benchmark probe: two 1 GiB pools of 4 KiB pages, one in HBM and
# one in pinned host memory
PROBE_PAGES, PROBE_PAGE_ELEMS = 262_144, 1024
# Model serving at full width: both families, 4 requests of 2,048-token
# prompts and 32 greedy new tokens each, weights drawn from a seed on the card
MODEL_FAMILIES = ("qwen3-1.7b", "rwkv6-3b")
SERVE_BATCH, PROMPT_LEN, NEW_TOKENS = 4, 2048, 32
PROFILED_STEPS = 4  # decode steps read by the profiler; the rest are timed
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
# The forward through the kernels is held against the same forward through
# their plain versions on the card, in bfloat16, by the relative L2 error of
# the logits. The two paths round each attention / WKV output to bfloat16 at
# other points, and the random-weight models amplify such one-ulp
# differences layer by layer (at full width on an H100 80GB HBM3: 0.020 for
# Qwen3-1.7B, 0.058 for RWKV6-3B), so no fixed bound follows from the unit
# roundoff. The tolerance is the model's own bfloat16 error instead, e, the
# distance of the plain bfloat16 forward from the plain float32 forward on
# the same weights (0.019 and 0.086 there): two bfloat16 paths that each
# sit e from float32 in unrelated directions sit about sqrt(2) e apart, so
# the kernel path must sit within MODEL_PATH_FACTOR * e of the plain path.
# A wrong mask or head mapping gives an error of order 1, far past it.
MODEL_PATH_FACTOR = 2.0
# CPU lane vs CUDA lane at full width and 2 layers, in float32: other
# summation orders on the two devices (cuBLAS in full float32, TF32 off).
# On an H100 80GB HBM3 the logits (about 5.5) differ by 8e-6 (Qwen3-1.7B)
# and 3.5e-4 (RWKV6-3B), so 1e-3 on rtol and atol
LANE_LAYERS, LANE_BATCH, LANE_LEN, LANE_TOL = 2, 2, 64, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, repeats: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of one call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def batched_ms(fn, calls: int = 20) -> float:
    """Milliseconds of one call of ``fn`` on the card, by CUDA events around
    ``calls`` back-to-back calls after one warm-up call: the host's launch
    work overlaps the card's, so a call longer than its launch reads as its
    device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def profiled_ms(fn, *kernels: str, calls: int = 20):
    """Device milliseconds of one call of ``fn`` spent in kernels whose name
    holds one of ``kernels`` (none named: all the call's device work), by
    the profiler, over ``calls`` calls after one warm-up call. With kernels
    named, the total is divided by the launches of the first one that the
    trace holds (one a call): the trace can miss launches, and dividing by
    ``calls`` would then read low. A count other than ``calls`` is logged;
    with none found the result is None."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (not kernels or any(k in e.name for k in kernels))]
    us = sum(e.device_time_total for e in found)
    n = sum(kernels[0] in e.name for e in found) if kernels else calls
    if n != calls:
        log(f"   profiler: {n} launches of {kernels[0]} in the trace of {calls} calls")
    return us / 1e3 / n if n else None


def host_ms_per_call(fn, calls: int = 200) -> float:
    """Host milliseconds of one call of ``fn`` (the wrapper's own time: the
    launches queue on the card), by the host clock over ``calls`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t) * 1e3 / calls
    torch.cuda.synchronize()
    return host


def ptxas_registers(source: str) -> list:
    """Registers and spill bytes of each kernel of ``csrc/<source>.cu``, as
    ptxas reported them when this process built it (``-Xptxas -v``); empty
    when the library was already built."""
    from repro_torch.kernels import _build

    found, entry = [], None
    for line in _build.build_log.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = {"kernel": m.group(1), "registers": None, "spill_bytes": 0}
            found.append(entry)
        elif entry is not None and "spill stores" in line:
            entry["spill_bytes"] = sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif entry is not None and (m := re.search(r"Used (\d+) registers", line)):
            entry["registers"] = int(m.group(1))
    return found


# ------------------------------------------------------------ phase 2
def kernel_checks(dev) -> int:
    """victim_partition == its plain version on the card over seeded rows
    (and == the plain form of its tiled decomposition): ragged rows, rows of
    one to three of the kernel's tiles with the demand on a tile boundary,
    1,000 short rows in one launch, and the main path's shape 20 times over
    (a look-back race shows as a difference in some run); returns the
    largest absolute difference seen (must be 0)."""
    import numpy as np
    import torch

    from repro_torch.kernels.victim_partition import (
        TILE,
        victim_partition,
        victim_partition_plain,
        victim_partition_tiled_plain,
    )

    rng = np.random.default_rng(20261016)
    worst = 0
    cases = []
    for n_cols in (1, 7, 4095, 4096, 4097, 100_003):
        for density in (0.0, 0.4, 1.0):
            fast = (rng.random((5, n_cols)) < density).astype(np.int32)
            supply = fast.sum(axis=1)
            # zero demand, tight demand, over-demand, negative demand
            demand = np.array(
                [0, int(supply[1]), int(supply[2]) + 5, -3,
                 int(rng.integers(0, n_cols + 2))], dtype=np.int64,
            )
            cases.append((torch.from_numpy(fast).to(dev), demand))
    for n_cols in (TILE - 1, TILE, TILE + 1, 2 * TILE, 3 * TILE - 5, 3 * TILE):
        fast = (rng.random((4, n_cols)) < 0.5).astype(np.int32)
        cum = np.cumsum(fast, axis=1)
        # the count through the first tile, the second, one past it, all
        demand = np.array([cum[0, min(TILE, n_cols) - 1],
                           cum[1, min(2 * TILE, n_cols) - 1],
                           cum[2, min(TILE, n_cols) - 1] + 1, cum[3, -1]],
                          dtype=np.int64)
        cases.append((torch.from_numpy(fast).to(dev), demand))
    short = (rng.random((1000, 37)) < 0.5).astype(np.int32)
    cases.append((torch.from_numpy(short).to(dev), rng.integers(-2, 40, size=1000)))
    strided = torch.from_numpy((rng.random((4, 9001)) < 0.5).astype(np.int32))
    cases.append((strided.to(dev)[:, 3:8999], np.array([0, 1, 2000, 9000])))
    full = torch.from_numpy((rng.random((20, FULL_RSS)) < 0.6).astype(np.int32)).to(dev)
    full_demand = rng.integers(0, 2_500_000, size=20)
    for fast01, demand in cases:
        d = torch.from_numpy(np.asarray(demand, dtype=np.int64)).to(dev)
        got = victim_partition(fast01, d)
        torch.cuda.synchronize()
        want = victim_partition_plain(fast01, d)
        tiled = victim_partition_tiled_plain(fast01, d)
        diff = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, diff)
        check(diff == 0 and got.shape == fast01.shape and torch.equal(tiled, want),
              f"victim_partition differs from its plain version on "
              f"{tuple(fast01.shape)}: max |diff| {diff}")
    d = torch.from_numpy(full_demand).to(dev)
    want = victim_partition_plain(full, d)
    for run in range(20):
        got = victim_partition(full, d)
        diff = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, diff)
        check(diff == 0, f"victim_partition at {tuple(full.shape)}, run {run} of "
              f"20, differs from its plain version: max |diff| {diff}")
    return worst


# ------------------------------------------------------------ phase 3
def runs_plain(rs) -> list:
    out = []
    for r in rs.runs:
        res = r.result
        out.append({
            "cell": (r.scenario, r.policy, r.fm_frac, r.backend),
            "stats": res.stats,
            "interval_times": res.interval_times.tolist(),
            "total_time": res.total_time,
            "fm_sizes": res.fm_sizes.tolist(),
            "configs": [asdict(c) for c in res.configs],
            "costs": [asdict(c) for c in res.costs],
            "decisions": None if r.decisions is None else [
                {**d.__dict__, "config": asdict(d.config)} for d in r.decisions
            ],
            "watermark_log": None if r.watermark_log is None else [
                e.__dict__ for e in r.watermark_log
            ],
            "fault_events": r.fault_events,
            "arbiter_log": r.arbiter_log,
        })
    return out


def lanes_agree() -> dict:
    """The port's run on the CPU and on the card, bit for bit."""
    import numpy as np

    from repro_torch.core.perfdb import PerfDB, PerfRecord
    from repro_torch.core.telemetry import ConfigVector
    from repro_torch.sim import api
    from repro_torch.sim.workloads import thrash_trace

    tr = thrash_trace(rss_pages=3_000, n_intervals=8)
    grid = np.round(np.arange(1.0, 0.19, -0.05), 3)
    db = PerfDB()
    db.add(PerfRecord(
        config=ConfigVector(pacc_f=10_000, pacc_s=500, pm_de=20, pm_pr=20,
                            ai=6.0, rss_pages=4_000, hot_thr=4, num_threads=1),
        fm_fracs=grid, times=1.0 + np.linspace(0.0, 0.4, grid.size),
    ))
    db.build()
    shrink = thrash_trace(rss_pages=4_000, n_intervals=12, seed=5)
    out = {}
    for device in ("cpu", "cuda"):
        untuned = api.run(api.Experiment(
            scenarios=[api.Scenario(trace=tr)],
            fm_fracs=(0.8, 0.45, 0.25, 0.1), collect_configs=True,
        ), device=device)
        tuned = api.run(api.Experiment(
            scenarios=[api.Scenario(trace=shrink)], fm_fracs=(0.9,),
            policies=[
                api.PolicySpec(label="tpp+tuna", tuner=api.TunerSpec(
                    target_loss=0.25, tune_every=2, max_step_frac=0.3)),
                api.PolicySpec(label="tpp"),
            ],
        ), db=db, device=device)
        guard = api.run(api.Experiment(
            scenarios=[api.Scenario(trace=tr)],
            fm_fracs=(0.8, 0.45, 0.25, 0.1), collect_configs=True,
            policies=[api.PolicySpec(kind="thrash_guard")],
        ), device=device)
        out[device] = (runs_plain(untuned), runs_plain(tuned), runs_plain(guard))
    cpu, gpu = out["cpu"], out["cuda"]
    check(cpu[0] == gpu[0], "untuned sweep: CPU and CUDA lanes differ")
    check(cpu[1] == gpu[1], "tuned shrink: CPU and CUDA lanes differ")
    check(cpu[2] == gpu[2], "thrash_guard sweep: CPU and CUDA lanes differ")
    suppressed = sum(c["pm_admit_fail"] for r in gpu[2] for c in r["configs"])
    check(suppressed > 0, "thrash_guard sweep: the guard never engaged")
    moves = len(gpu[1][0]["watermark_log"])
    check(moves > 0, "tuned shrink: the tuner never moved the watermarks")
    demoted = sum(
        r["stats"]["pgdemote_kswapd"] + r["stats"]["pgdemote_direct"]
        for r in gpu[0]
    )
    check(demoted > 0, "untuned sweep: no demotion, the victim path was not run")
    return {"cells": len(gpu[0]) + len(gpu[1]) + len(gpu[2]),
            "watermark_moves": moves, "demotions": demoted,
            "guard_suppressed": suppressed}


# ------------------------------------------------------------ phase 4
def main_path(dev, capture: dict) -> dict:
    """The quickstart sequence at full size through the port's entry
    points. ``capture`` receives the victim kernel's inputs of the main
    path's largest call (for phase 5)."""
    import numpy as np
    import torch

    from repro_torch.core.tuner import build_database
    from repro_torch.kernels.victim_partition import victim_partition
    from repro_torch.sim import api
    from repro_torch.sim import torch_engine
    from repro_torch.sim.workloads import thrash_trace

    def recording(fast01, demand):
        if fast01.numel() >= capture.get("numel", 0):
            capture.update(numel=fast01.numel(), fast01=fast01.clone(),
                           demand=demand.clone())
        return victim_partition(fast01, demand)

    torch_engine.victim_partition = recording
    phases = {}
    t = time.perf_counter()
    trace = thrash_trace(rss_pages=FULL_RSS, n_intervals=FULL_INTERVALS)
    phases["trace_s"] = time.perf_counter() - t
    capture["trace"] = trace  # phase 11's real-size fault pass reuses it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    t = time.perf_counter()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
    ) as prof:
        sweep = api.run(api.Experiment(
            name="profile", scenarios=[api.Scenario(trace=trace)],
            fm_fracs=SWEEP_FRACS, collect_configs=True,
        ))
        torch.cuda.synchronize()
    phases["sweep_s"] = time.perf_counter() - t
    # device time: every kernel and copy the profiler saw on the card
    device_us = sum(
        e.device_time_total for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    n_int = len(trace)
    split = {
        "intervals": n_int,
        "wall_ms_per_interval": phases["sweep_s"] * 1e3 / n_int,
        "device_ms_per_interval": (device_us / 1e3 / n_int) if device_us else None,
    }
    if device_us:
        split["host_ms_per_interval"] = (
            split["wall_ms_per_interval"] - split["device_ms_per_interval"]
        )
        split["device_busy_share"] = split["device_ms_per_interval"] / split[
            "wall_ms_per_interval"
        ]

    cvs = sweep.record(fm_frac=1.0).result.configs[1:]
    configs = [c for c in cvs if c.pacc_f + c.pacc_s >= 500][:10]
    check(len(configs) > 0, "profile sweep produced no usable ConfigVector")
    t = time.perf_counter()
    db = build_database(configs)
    torch.cuda.synchronize()
    phases["build_database_s"] = time.perf_counter() - t

    t = time.perf_counter()
    tuned = api.run(api.Experiment(
        name="quickstart", scenarios=[api.Scenario(trace=trace)],
        fm_fracs=(1.0,),
        policies=[
            api.PolicySpec(label="tpp"),
            api.PolicySpec(label="tpp+tuna", tuner=api.TunerSpec(
                target_loss=0.05, tune_every=3)),
        ],
    ), db=db)
    torch.cuda.synchronize()
    phases["tuned_run_s"] = time.perf_counter() - t
    torch_engine.victim_partition = victim_partition

    # --- the outputs are what the system promises
    for rs in (sweep, tuned):
        check(rs.chunked_step_count == 0, f"{rs.name}: chunked steps ran")
        check(rs.spec["device"] == str(dev), f"{rs.name} ran on {rs.spec['device']}")
        for r in rs.runs:
            times = r.result.interval_times
            check(times.shape == (n_int,) and bool(np.all(np.isfinite(times)))
                  and bool(np.all(times > 0)),
                  f"{rs.name}/{r.policy}@{r.fm_frac}: bad interval times")
            check(all(v >= 0 for v in r.result.stats.values()),
                  f"{rs.name}/{r.policy}@{r.fm_frac}: negative counters")
    check(len(sweep.runs) == len(SWEEP_FRACS), "profile sweep lost cells")
    curve = sweep.total_times()
    check(curve[0] == curve.min(), "full fast memory is not the fastest size")
    check(len(db.records) == len(configs) and all(
        bool(np.all(np.isfinite(r.times))) for r in db.records),
        "database records are not finite")
    base = tuned.result(policy="tpp")
    tuna = tuned.result(policy="tpp+tuna")
    rec = tuned.record(policy="tpp+tuna")
    return {
        "rss_pages": trace.rss_pages,
        "intervals": n_int,
        "sizes": len(SWEEP_FRACS),
        "sweep_total_s_by_frac": dict(zip(map(float, SWEEP_FRACS),
                                          map(float, curve))),
        "db_records": len(db.records),
        "tpp_total_s": base.total_time,
        "tuna_total_s": tuna.total_time,
        "tuna_loss": (tuna.total_time - base.total_time) / base.total_time,
        "tuna_saving_mean": 1 - float(tuna.fm_sizes.mean()) / trace.rss_pages,
        "tuna_saving_max": 1 - float(tuna.fm_sizes.min()) / trace.rss_pages,
        "tuna_decisions": len(rec.decisions),
        "tuna_watermark_moves": len(rec.watermark_log),
        "chunked_step_count": sweep.chunked_step_count + tuned.chunked_step_count,
        "phases_s": phases,
        "profile_sweep_split": split,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }


# ------------------------------------------------------------ phase 5
def time_victim_partition(capture: dict) -> dict:
    import torch

    from repro_torch.kernels.victim_partition import (
        TILE,
        victim_partition,
        victim_partition_plain,
    )

    fast01, demand = capture["fast01"], capture["demand"]
    n, r = fast01.shape
    got = victim_partition(fast01, demand)
    want = victim_partition_plain(fast01, demand)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(err == 0, "victim_partition differs from its plain version on the "
          "main path's inputs")
    ms = cuda_ms(lambda: victim_partition(fast01, demand))
    device_ms = profiled_ms(lambda: victim_partition(fast01, demand),
                            "victim_partition_kernel")
    host_ms = host_ms_per_call(lambda: victim_partition(fast01, demand))
    plain_ms = cuda_ms(lambda: victim_partition_plain(fast01, demand))
    cumsum_ms = cuda_ms(lambda: torch.cumsum(fast01, dim=1, dtype=torch.int32))
    # bytes the function needs on this data: each row is read up to the
    # element where its running count reaches the demand, the mask is
    # written whole, the demand read once
    cum = torch.cumsum(fast01, dim=1, dtype=torch.int64)
    d = demand.to(torch.int64)
    need = torch.where(
        d > 0, torch.clamp((cum < d[:, None]).sum(dim=1) + 1, max=r), 0
    )
    read_bytes = int(need.sum()) * 4 + n * 4
    write_bytes = n * r * 4
    ops = 2 * int(need.sum())  # one add and one compare per element read
    bytes_ms = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU_OPS_PER_S * 1e3
    return {
        "design": f"single-pass scan, tiles of {TILE} elements, decoupled "
                  "look-back, read first, per-row reached flag",
        "blocks": n * -(-r // TILE),
        "max_abs_err": err, "ms": ms, "device_ms": device_ms, "host_ms": host_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes this mask
        "cumsum_ms": cumsum_ms,
        "shape": [n, r],
        "bytes": read_bytes + write_bytes,
        "demand": [int(x) for x in demand.tolist()],
    }


# ------------------------------------------------------------ phase 2, serving kernels
def migrate_checks(dev) -> float:
    """migrate_pages == its plain version, bit for bit: device->device,
    pinned->device and device->pinned; bf16 and f32; pages that are not a
    multiple of 16 bytes; one page and every slot; the full Qwen3-1.7B KV
    page at 1 and 17 pages; 1,000 pages in one batch (more pages than the
    kernel's persistent grid has blocks, and more than its parameter holds),
    with host and with device page ids. Returns the largest absolute
    difference (must be 0)."""
    import torch

    from repro_torch.kernels.page_migrate import migrate_pages, migrate_pages_plain

    g = torch.Generator().manual_seed(12)
    worst = 0.0

    def compare(src, dst, di, si, label, ids_on_card=False):
        nonlocal worst
        want = migrate_pages_plain(dst.clone(), src, di, si)
        for way in ("d2d", "h2d", "d2h"):
            s = src.pin_memory() if way == "h2d" else src.to(dev)
            d = dst.pin_memory() if way == "d2h" else dst.to(dev)
            ids = (di.to(dev), si.to(dev)) if ids_on_card else (di, si)
            migrate_pages(d, s, *ids)
            torch.cuda.synchronize()
            got = d.cpu()
            diff = float((got.float() - want.float()).abs().max())
            worst = max(worst, diff)
            check(torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
                  f"migrate_pages {way} {label} differs from its plain version "
                  f"(max |diff| {diff})")

    for dtype in (torch.bfloat16, torch.float32):
        for page in ((7,), (3, 5), (1029,), (28, 2, 16, 8, 16)):
            src = torch.randn((12,) + page, generator=g).to(dtype)
            dst = torch.randn((12,) + page, generator=g).to(dtype)
            for n in (1, 12):
                di = torch.randperm(12, generator=g)[:n]
                si = torch.randperm(12, generator=g)[:n]
                compare(src, dst, di, si, f"{dtype} page {page} n={n}")
    page = (QWEN3_1_7B_PAGE["n_groups"], 2, QWEN3_1_7B_PAGE["page_size"],
            QWEN3_1_7B_PAGE["kv_heads"], QWEN3_1_7B_PAGE["head_dim"])
    src = torch.randn((24,) + page, generator=g).to(torch.bfloat16)
    dst = torch.randn((24,) + page, generator=g).to(torch.bfloat16)
    for n in (1, 17):
        di, si = torch.randperm(24, generator=g)[:n], torch.randperm(24, generator=g)[:n]
        compare(src, dst, di, si, f"Qwen3-1.7B KV page n={n}")
    for width in (1024, 1029):  # 4,096-byte pages (TMA) and 4,116-byte ones
        src = torch.randn((1200, width), generator=g)
        dst = torch.randn((1200, width), generator=g)
        di = torch.randperm(1200, generator=g)[:1000]
        si = torch.randperm(1200, generator=g)[:1000]
        compare(src, dst, di, si, f"1,000 pages of {width} floats, host ids")
        compare(src, dst, di.flip(0), si, f"1,000 pages of {width} floats, ids "
                "on the card", ids_on_card=True)
    return worst


def probe_tolerance(terms, ai_iters: int, n_pages: int, sm_count: int,
                    page_elems: int = PROBE_PAGE_ELEMS):
    """The probe's float32 rounding bound against float64, per column:
    each term is ai_iters fused multiply-adds of one sign (relative error
    <= ai_iters u), and the kernel adds the terms in chains of at most
    chain_length additions (ceil(n / G) page results a block, then the G
    blocks' partial rows; relative error <= that many u of the sum of
    |terms|), u = 2**-24."""
    from repro_torch.kernels.strided_probe import chain_length

    chain = chain_length(n_pages, page_elems, sm_count)
    return (ai_iters + chain + 2) * FP32_EPS * terms


def probe_checks(dev) -> float:
    """strided_probe against its float64 plain version within the derived
    bound, with the slow pool in pinned host memory: ai_iters in {0, 1, 7,
    64} over an empty fast list, an empty slow list and mixed lists; page
    rows of 1,000 floats (TMA) and 1,001 floats (the plain-load branch); a
    pool whose base is one float past alignment (a sliced view); page
    counts one below and one above the kernel's grid; a 1-page list; and
    one 4,000-page mixed call 20 times over, bit-identical each time (a
    stale ring stage read by a wrong mbarrier phase shows as a difference).
    Returns the largest absolute error."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.strided_probe import (
        bulk_reads,
        grid_blocks,
        strided_probe,
        strided_probe_plain,
    )

    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(13)
    fast = torch.randn((512, PROBE_PAGE_ELEMS), generator=g).to(dev)
    slow = torch.randn((512, PROBE_PAGE_ELEMS), generator=g).pin_memory()
    worst = 0.0

    def case(what, fast, slow, nf, ns, ai, bulk=True):
        nonlocal worst
        width = fast.shape[1]
        fi = torch.randint(0, fast.shape[0], (nf,), generator=g)
        si = torch.randint(0, slow.shape[0], (ns,), generator=g)
        addresses = [_build.device_address("strided_probe", p) for p in (fast, slow)]
        check(bulk_reads(addresses, [fast.stride(0), slow.stride(0)], width) == bulk,
              f"strided_probe {what}: expected the "
              f"{'TMA' if bulk else 'plain-load'} branch")
        got = strided_probe(fast, slow, fi, si, ai)
        torch.cuda.synchronize()
        want = strided_probe_plain(fast, slow, fi, si, ai, dtype=torch.float64)
        terms = strided_probe_plain(fast.abs(), slow.abs(), fi, si, ai,
                                    dtype=torch.float64)
        err = (got.double() - want).abs()
        worst = max(worst, float(err.max()))
        check(got.shape == (1, width) and bool(
            (err <= probe_tolerance(terms, ai, nf + ns, sm, width)).all()),
              f"strided_probe {what} ai={ai} nf={nf} ns={ns}: error "
              f"{float(err.max())} beyond its rounding bound")
        return fi, si

    for ai in (0, 1, 7, 64):
        for nf, ns in ((40, 30), (0, 9), (9, 0), (3000, 1000)):
            case("1,024-float rows", fast, slow, nf, ns, ai)
    for width, bulk in ((1000, True), (1001, False)):
        f = torch.randn((64, width), generator=g).to(dev)
        s = torch.randn((64, width), generator=g).pin_memory()
        for ai in (1, 64):
            case(f"{width}-float rows", f, s, 400, 300, ai, bulk)
    flat = torch.randn(512 * PROBE_PAGE_ELEMS + 1, generator=g).to(dev)
    shifted = flat[1:].view(512, PROBE_PAGE_ELEMS)
    for ai in (1, 64):
        case("base one float past alignment", shifted, slow, 300, 200, ai, False)
    grid = grid_blocks(10**6, PROBE_PAGE_ELEMS, sm)
    for n in (grid - 1, grid + 1):
        case(f"{n} pages", fast, slow, n // 2, n - n // 2, 7)
    case("one fast page", fast, slow, 1, 0, 64)
    case("one slow page", fast, slow, 0, 1, 64)
    fi, si = case("4,000 pages", fast, slow, 2000, 2000, 64)
    first = strided_probe(fast, slow, fi, si, 64)
    for run in range(20):
        again = strided_probe(fast, slow, fi, si, 64)
        check(torch.equal(again, first),
              f"strided_probe 4,000 pages, run {run} of 20, differs from the first")
    return worst


def attention_checks(dev) -> float:
    """paged_decode_attention == its plain version within 2e-4 (float32)
    or 2e-2 (bfloat16): holes, partial last pages, a length past the table,
    rep in {1, 2, 4}, hd in {64, 128}, and a fully masked row (zeros); then
    sequences of 40 pages, which the kernel cuts into three or more splits,
    with lengths that end mid-page in the last split, against the plain
    version and the plain version of the kernel's split-and-merge, and
    pools that are not 16-byte aligned. Returns the largest absolute
    difference."""
    import torch

    from repro_torch.kernels.paged_attention import (
        card_pages_per_split,
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_decode_attention_split_plain,
    )

    g = torch.Generator().manual_seed(14)
    worst = 0.0
    B, KV, P, ps, ppseq = 6, 2, 40, 16, 5
    for dtype in (torch.bfloat16, torch.float32):
        for rep in (1, 2, 4):
            for hd in (64, 128):
                q = torch.randn((B, KV * rep, hd), generator=g).to(dtype).to(dev)
                k = torch.randn((P, ps, KV, hd), generator=g).to(dtype).to(dev)
                v = torch.randn((P, ps, KV, hd), generator=g).to(dtype).to(dev)
                tbl = torch.randperm(P, generator=g)[: B * ppseq].view(B, ppseq)
                tbl = tbl.to(torch.int32)
                tbl[4, 0] = -1  # a hole inside the valid range
                lens = torch.tensor([1, 35, 80, 0, 17, 99], dtype=torch.int32)
                got = paged_decode_attention(q, k, v, tbl, lens)
                torch.cuda.synchronize()
                want = paged_decode_attention_plain(q, k, v, tbl.to(dev), lens.to(dev))
                diff = float((got.float() - want.float()).abs().max())
                worst = max(worst, diff)
                tol = 2e-4 if dtype == torch.float32 else 2e-2
                check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                      f"paged_decode_attention {dtype} rep={rep} hd={hd}: "
                      f"max |diff| {diff} beyond {tol}")
                check(not bool(got[3].any()), "a fully masked row is not zeros")
    B, KV, P, ps, ppseq = 4, 8, 200, 16, 40
    for dtype in (torch.bfloat16, torch.float32):
        for rep, hd in ((2, 128), (4, 64)):
            q = torch.randn((B, KV * rep, hd), generator=g).to(dtype).to(dev)
            k = torch.randn((P, ps, KV, hd), generator=g).to(dtype).to(dev)
            v = torch.randn((P, ps, KV, hd), generator=g).to(dtype).to(dev)
            tbl = torch.randperm(P, generator=g)[: B * ppseq].view(B, ppseq)
            tbl = tbl.to(torch.int32).to(dev)
            tbl[0, 5] = -1
            lens = torch.tensor([633, 0, 250, 639], dtype=torch.int32, device=dev)
            pps = card_pages_per_split(q, k, tbl)
            check(-(-ppseq // pps) >= 3, f"40 pages cut into fewer than 3 splits of {pps}")
            got = paged_decode_attention(q, k, v, tbl, lens)
            torch.cuda.synchronize()
            tol = 2e-4 if dtype == torch.float32 else 2e-2
            for label, want in (
                ("plain", paged_decode_attention_plain(q, k, v, tbl, lens)),
                ("split plain", paged_decode_attention_split_plain(q, k, v, tbl, lens, pps)),
            ):
                diff = float((got.float() - want.float()).abs().max())
                worst = max(worst, diff)
                check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                      f"paged_decode_attention {dtype} rep={rep} hd={hd}, 40 pages in "
                      f"splits of {pps}: max |diff| {diff} from the {label} version "
                      f"beyond {tol}")
            check(not bool(got[1].any()), "a sequence of length 0 is not zeros")
        # pools one element past a 16-byte boundary: the plain-load path
        flat = torch.randn((2, P * ps * KV * 64 + 1), generator=g).to(dtype).to(dev)
        k, v = (flat[i, 1:].view(P, ps, KV, 64) for i in (0, 1))
        q = torch.randn((B, KV * 2, 64), generator=g).to(dtype).to(dev)
        got = paged_decode_attention(q, k, v, tbl, lens)
        torch.cuda.synchronize()
        want = paged_decode_attention_plain(q, k, v, tbl, lens)
        diff = float((got.float() - want.float()).abs().max())
        worst = max(worst, diff)
        tol = 2e-4 if dtype == torch.float32 else 2e-2
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"paged_decode_attention {dtype} on unaligned pools: max |diff| {diff}")
    return worst


# ------------------------------------------------------------ serving
def demo_db(total_pages: int):
    """The hand-built performance database of examples/serve_tiered.py."""
    import numpy as np

    from repro_torch.core.perfdb import PerfDB, PerfRecord
    from repro_torch.core.telemetry import ConfigVector

    grid = np.array([1.0, 0.85, 0.7, 0.55, 0.4, 0.25])
    db = PerfDB()
    for pacc in (200, 800, 2400):
        for pm in (2, 16, 64):
            loss = (pm / 32.0) * (1.0 / grid - 1.0) * 0.08
            db.add(PerfRecord(
                config=ConfigVector(pacc_f=pacc, pacc_s=pm, pm_de=pm, pm_pr=pm,
                                    ai=1e6, rss_pages=total_pages, hot_thr=2,
                                    num_threads=1),
                fm_fracs=grid, times=1.0 + loss,
            ))
    db.build()
    return db


def build_server(page: dict, device, fill):
    """The demo's server through the port's public classes; ``fill(kv)``
    writes the host pool before the run."""
    from dataclasses import replace

    from repro_torch.core.tuner import TunaTuner, TunerConfig
    from repro_torch.core.watermark import WatermarkController
    from repro_torch.serving import (
        ContinuousBatcher,
        KVPageConfig,
        TieredPagedKV,
        TieredServer,
    )
    from repro_torch.sim.costmodel import H100_HOST_TIER

    kv = TieredPagedKV(KVPageConfig(**page), total_pages=SERVE_TOTAL_PAGES,
                       hbm_capacity=SERVE_HBM_PAGES, device=device)
    fill(kv)
    tuner = TunaTuner(
        demo_db(SERVE_TOTAL_PAGES),
        WatermarkController(kv.pool, max_step_frac=0.1),
        TunerConfig(target_loss=0.05), peak_rss_pages=SERVE_HBM_PAGES,
    )
    hw = replace(H100_HOST_TIER, page_bytes=kv.cfg.bytes_per_page,
                 access_bytes=kv.cfg.bytes_per_page)
    return TieredServer(kv, ContinuousBatcher(**SERVE_BATCHER), tuner=tuner,
                        tune_every=16, hw=hw)


def serving_state(server) -> dict:
    """Everything the serving loop leaves behind, as plain data."""
    from dataclasses import asdict

    import numpy as np
    import torch

    kv = server.kv
    every = np.arange(kv.total_pages)
    return {
        "summary": server.summary(),
        "history": [asdict(h) for h in server.history],
        "decisions": [{**d.__dict__, "config": asdict(d.config)}
                      for d in server.tuner.decisions],
        "watermark_log": [e.__dict__ for e in server.tuner.controller.log],
        "hbm_slot": kv.hbm_slot.tolist(),
        "tier": np.asarray(kv.pool.tier).tolist(),
        "heat": kv.pool.heat_of(every).tolist(),
        "host": kv.host.view(torch.int16).cpu().numpy().tobytes(),
        "hbm": kv.hbm.view(torch.int16).cpu().numpy().tobytes(),
    }


def serving_lanes_agree() -> dict:
    """The serving loop on the CPU and on the card, bit for bit, at the
    demo's page counts and a narrow page, tuned, with seeded host pools."""
    import numpy as np
    import torch

    elems = (2 * NARROW_PAGE["n_groups"] * NARROW_PAGE["page_size"]
             * NARROW_PAGE["kv_heads"] * NARROW_PAGE["head_dim"])
    host = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (SERVE_TOTAL_PAGES, elems), dtype=np.float32)).to(torch.bfloat16)
    out = {}
    for device in ("cpu", "cuda"):
        server = build_server(NARROW_PAGE, device, lambda kv: kv.host.copy_(host))
        server.run(rounds=300, drift_every=100)
        torch.cuda.synchronize()
        out[device] = serving_state(server)
    cpu, gpu = out["cpu"], out["cuda"]
    for key in cpu:
        check(cpu[key] == gpu[key], f"serving: CPU and CUDA lanes differ in {key}")
    s = gpu["summary"]
    check(s["migrated_in"] > 0 and s["migrated_out"] > 0,
          "serving lanes: no page moved both ways")
    check(len(gpu["watermark_log"]) > 0, "serving lanes: the tuner never moved")
    return {"rounds": s["rounds"], "migrated_in": s["migrated_in"],
            "migrated_out": s["migrated_out"],
            "watermark_moves": len(gpu["watermark_log"])}


def fingerprints(pages, weights):
    """One int64 per page: the page's 16-bit words times seeded weights,
    summed (two pages with other contents collide with chance ~2**-31)."""
    import torch

    bits = pages.view(torch.int16).to(torch.int32)
    return (bits * weights).sum(dim=1, dtype=torch.int64)


def serving_full_width(dev, capture: dict) -> dict:
    """The demo at full width through the port's public classes: Qwen3-1.7B
    KV pages, the host pool (7.52 GB, pinned) filled from a seed on the
    card, 800 rounds, tuned. Checks that every page's content survives
    wherever it sits. ``capture`` receives the largest promotion and
    demotion batch, the last round's batch and the server."""
    import numpy as np
    import torch

    from repro_torch.serving import kv_cache
    from repro_torch.kernels.page_migrate import migrate_pages

    chunk = 64
    gen = torch.Generator(device=dev).manual_seed(16)
    elems = None
    before = None
    weights = None

    def fill(kv):
        nonlocal elems, before, weights
        elems = kv.cfg.elems_per_page
        weights = torch.randint(1, 2**15, (elems,), generator=gen, device=dev,
                                dtype=torch.int32)
        fps = []
        for a in range(0, kv.total_pages, chunk):
            pages = torch.randn((min(chunk, kv.total_pages - a), elems),
                                generator=gen, device=dev, dtype=torch.bfloat16)
            fps.append(fingerprints(pages, weights))
            kv.host[a:a + pages.shape[0]].copy_(pages)
        torch.cuda.synchronize()
        before = torch.cat(fps)

    t = time.perf_counter()
    server = build_server(QWEN3_1_7B_PAGE, None, fill)
    setup_s = time.perf_counter() - t
    kv = server.kv
    check(kv.host.is_pinned() and kv.hbm.is_cuda, "serving pools are not on the tiers")

    def recording(dst_pool, src_pool, dst_idx, src_idx):
        n = len(dst_idx)
        way = "promote" if src_pool is kv.host else "demote"
        if n > capture.get(f"{way}_n", 0):
            capture[f"{way}_n"] = n
            capture[way] = (np.array(dst_idx), np.array(src_idx))
        return migrate_pages(dst_pool, src_pool, dst_idx, src_idx)

    last = {}
    round_batch = server.batcher.round_batch

    def recording_batch():
        last["batch"] = round_batch()
        return last["batch"]

    kv_cache.migrate_pages = recording
    server.batcher.round_batch = recording_batch
    torch.cuda.synchronize()
    migrate_pages.launches = 0
    t = time.perf_counter()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
    ) as prof:
        server.run(rounds=SERVE_ROUNDS, drift_every=SERVE_DRIFT)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = migrate_pages.launches
    kv_cache.migrate_pages = migrate_pages
    server.batcher.round_batch = round_batch
    check(launches > 0, "the serving loop never launched migrate_pages")

    device_us = sum(e.device_time_total for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    traced = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "migrate_kernel" in e.name]
    migrate_us = sum(e.device_time_total for e in traced)

    # --- every page's content survived, in host memory and, for resident
    # pages, in its HBM slot
    for a in range(0, kv.total_pages, chunk):
        got = fingerprints(kv.host[a:a + chunk].to(dev), weights)
        check(torch.equal(got, before[a:a + chunk]),
              f"host pool pages {a}..{a + chunk} changed")
    resident = np.flatnonzero(kv.hbm_slot >= 0)
    for a in range(0, resident.size, chunk):
        pages = resident[a:a + chunk]
        slots = torch.as_tensor(kv.hbm_slot[pages], device=dev)
        got = fingerprints(kv.hbm[slots], weights)
        check(torch.equal(got, before[torch.as_tensor(pages, device=dev)]),
              f"HBM slots of pages {pages[:4]}... do not hold their pages")

    s = server.summary()
    check(s["rounds"] == SERVE_ROUNDS and all(
        np.isfinite(v) for v in s.values()), f"bad serving summary {s}")
    check(s["migrated_in"] > 0 and s["migrated_out"] > 0,
          "full-width serving moved no page both ways")
    page_b = kv.cfg.bytes_per_page
    moved_b = (s["migrated_in"] + s["migrated_out"]) * page_b
    capture.update(server=server, last_batch=last["batch"])
    return {
        "page_bytes": page_b,
        "host_pool_bytes": kv.host.numel() * kv.host.element_size(),
        "hbm_pool_bytes": kv.hbm.numel() * kv.hbm.element_size(),
        "setup_s": setup_s,
        "rounds": SERVE_ROUNDS,
        "wall_s": wall_s,
        "wall_ms_per_round": wall_s * 1e3 / SERVE_ROUNDS,
        "device_ms_per_round": device_us / 1e3 / SERVE_ROUNDS,
        "device_busy_share": device_us / 1e6 / wall_s,
        "migrate_kernel_ms_total": migrate_us / 1e3,
        # launches the trace holds; fewer than migrate_pages_launches means
        # the total above misses some
        "migrate_kernel_launches_traced": len(traced),
        "pages_in": s["migrated_in"], "pages_out": s["migrated_out"],
        "gb_in": s["migrated_in"] * page_b / 1e9,
        "gb_out": s["migrated_out"] * page_b / 1e9,
        "migrate_gb_per_s": moved_b / (migrate_us / 1e6) / 1e9 if migrate_us else None,
        "largest_promote_batch": capture.get("promote_n", 0),
        "largest_demote_batch": capture.get("demote_n", 0),
        "watermark_moves": len(server.tuner.controller.log),
        "migrate_pages_launches": launches,
        "summary": s,
    }


def time_migrate(dev, capture: dict) -> dict:
    """migrate_pages on the serving run's largest promotion (pinned host ->
    HBM) and demotion (HBM -> pinned host) batches and on one page each way,
    by CUDA events around one call and by the profiler's device time,
    beside the plain version, the PCIe bound and the copy engines (one
    ``copy_`` a page, a yardstick the port never calls); device -> device on
    the promotion's slots beside ``index_copy_``, both by device time, with
    the HBM bound; and the wrapper's host time a call. Run after the
    serving checks: it rewrites those pages."""
    import numpy as np
    import torch

    from repro_torch.kernels.page_migrate import migrate_pages, migrate_pages_plain

    kv = capture["server"].kv
    page_b = kv.cfg.bytes_per_page
    out = {}
    cases = []
    for way, dst_pool, src_pool in (("promote", kv.hbm, kv.host),
                                    ("demote", kv.host, kv.hbm)):
        if way in capture:
            di, si = capture[way]
            cases.append((way, dst_pool, src_pool, di, si))
            cases.append((f"{way}_1", dst_pool, src_pool, di[:1], si[:1]))
    for way, dst_pool, src_pool, di, si in cases:
        n = len(di)
        # host ids, as the serving loop passes them
        call = lambda: migrate_pages(dst_pool, src_pool, di, si)
        ms = cuda_ms(call, repeats=20)
        device_ms = profiled_ms(call, "migrate_kernel")
        plain_ms = cuda_ms(lambda: migrate_pages_plain(
            dst_pool, src_pool, torch.as_tensor(di), torch.as_tensor(si)),
            repeats=5, warmup=1)
        pairs = list(zip(di.tolist(), si.tolist()))

        def engines():
            for d, s in pairs:
                dst_pool[d].copy_(src_pool[s], non_blocking=True)

        ce_ms = cuda_ms(engines, repeats=20)
        ce_device_ms = profiled_ms(engines)
        bound = n * page_b / PCIE_BYTES_PER_S * 1e3
        out[way] = {"pages": n, "bytes": n * page_b, "ms": ms, "device_ms": device_ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "gb_per_s": n * page_b / device_ms / 1e6 if device_ms else None,
                    "copy_engine_ms": ce_ms, "copy_engine_device_ms": ce_device_ms,
                    "copy_engine_gb_per_s": n * page_b / ce_device_ms / 1e6}
    di = capture["promote"][0]
    out["host_ms"] = host_ms_per_call(
        lambda: migrate_pages(kv.hbm, kv.host, di[:1], capture["promote"][1][:1]))
    di_d = torch.as_tensor(di, device=dev)
    rows = kv.hbm[di_d].clone()
    seq = np.arange(len(di))
    d2d = lambda: migrate_pages(kv.hbm, rows, di, seq)
    index_copy = lambda: kv.hbm.index_copy_(0, di_d, rows)
    out["d2d"] = {"pages": len(di), "ms": cuda_ms(d2d, repeats=20),
                  "device_ms": profiled_ms(d2d, "migrate_kernel"),
                  "index_copy_ms": cuda_ms(index_copy, repeats=20),
                  "index_copy_device_ms": profiled_ms(index_copy),
                  "bound_ms": 2 * len(di) * page_b / HBM_BYTES_PER_S * 1e3}
    return out


def attention_on_last_batch(dev, capture: dict) -> dict:
    """paged_decode_attention over the last round's batch, straight out of
    the HBM pool: layer group g of every page viewed as K/V
    [slots, 16 tokens, 8 KV heads, 128] (this script's view of a page as
    [28 groups, K/V, 16, 8, 128]; the JAX package defines no in-page
    layout), with 16 query heads. All 28 groups are driven once with the
    launch count set to 0 before and read after; group 0 is checked against
    the plain version and the plain version of the kernel's split-and-merge,
    and timed beside the plain version, the K/V byte bound and
    scaled_dot_product_attention over pre-gathered K/V (a yardstick only)."""
    import numpy as np
    import torch

    from repro_torch.kernels.paged_attention import (
        card_pages_per_split,
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_decode_attention_split_plain,
    )

    kv = capture["server"].kv
    batch = capture["last_batch"]
    check(len(batch) > 0, "the last serving round scheduled no session")
    for s in batch:  # what the next round would do first
        kv.ensure_resident(np.asarray(s.pages))
    batch = [s for s in batch if np.all(kv.hbm_slot[s.pages] >= 0)]
    check(len(batch) > 0, "no session of the last batch is resident")
    ppseq = max(len(s.pages) for s in batch)
    tbl = np.full((len(batch), ppseq), -1, np.int32)
    for b, s in enumerate(batch):
        tbl[b, :len(s.pages)] = kv.hbm_slot[s.pages]
    lens = np.array([s.tokens for s in batch], np.int32)
    p = QWEN3_1_7B_PAGE
    view = kv.hbm.view(kv.hbm.shape[0], p["n_groups"], 2, p["page_size"],
                       p["kv_heads"], p["head_dim"])
    gen = torch.Generator(device=dev).manual_seed(17)
    q = torch.randn((len(batch), QWEN3_1_7B_QUERY_HEADS, p["head_dim"]),
                    generator=gen, device=dev, dtype=torch.bfloat16)
    tbl_d = torch.as_tensor(tbl, device=dev)
    lens_d = torch.as_tensor(lens, device=dev)
    torch.cuda.synchronize()
    paged_decode_attention.launches = 0
    outs = [paged_decode_attention(q, view[:, g, 0], view[:, g, 1], tbl_d, lens_d)
            for g in range(p["n_groups"])]
    torch.cuda.synchronize()
    launches = paged_decode_attention.launches
    check(launches == p["n_groups"], "paged_decode_attention was not driven")
    k0, v0 = view[:, 0, 0], view[:, 0, 1]
    want = paged_decode_attention_plain(q, k0, v0, tbl_d, lens_d)
    err = float((outs[0].float() - want.float()).abs().max())
    check(torch.allclose(outs[0].float(), want.float(), rtol=2e-2, atol=2e-2)
          and all(bool(torch.isfinite(o).all()) for o in outs),
          f"paged_decode_attention on the serving pool: max |diff| {err}")
    pps = card_pages_per_split(q, k0, tbl_d)
    split_want = paged_decode_attention_split_plain(q, k0, v0, tbl_d, lens_d, pps)
    split_err = float((outs[0].float() - split_want.float()).abs().max())
    check(torch.allclose(outs[0].float(), split_want.float(), rtol=2e-2, atol=2e-2),
          f"paged_decode_attention on the serving pool vs its split-and-merge "
          f"plain version: max |diff| {split_err}")
    call = lambda: paged_decode_attention(q, k0, v0, tbl_d, lens_d)
    ms = cuda_ms(call)
    # the wrapper's host time a call, and the two kernels' device time a
    # call: the CUDA-event time above holds both where the card waits for
    # the host
    host_ms = host_ms_per_call(call)
    device_ms = profiled_ms(call, "paged_split_kernel", "paged_merge_kernel")
    plain_ms = cuda_ms(lambda: paged_decode_attention_plain(q, k0, v0, tbl_d, lens_d))
    # yardstick: one fused PyTorch attention call over K/V gathered densely
    T = ppseq * p["page_size"]
    safe = tbl_d.clamp(min=0).long()
    kd = k0[safe].reshape(len(batch), T, p["kv_heads"], p["head_dim"]).transpose(1, 2)
    vd = v0[safe].reshape(len(batch), T, p["kv_heads"], p["head_dim"]).transpose(1, 2)
    mask = (torch.arange(T, device=dev)[None, :] < lens_d[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask, enable_gqa=True)

    sdpa_err = float((sdpa()[:, :, 0].float() - want.float()).abs().max())
    library_ms = cuda_ms(sdpa)
    tokens = int(lens.sum())
    kv_bytes = 2 * tokens * p["kv_heads"] * p["head_dim"] * 2
    io_bytes = 2 * q.numel() * 2 + tbl.nbytes + lens.nbytes
    bytes_ms = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * tokens * QWEN3_1_7B_QUERY_HEADS * p["head_dim"] / ALU_OPS_PER_S * 1e3
    n_splits = -(-ppseq // pps)
    return {
        "design": f"split page list ({n_splits} splits of {pps} pages), "
                  "cp.async 16 B, LSE merge",
        "launches": launches, "max_abs_err": max(err, split_err), "ms": ms,
        "device_ms": device_ms, "host_ms": host_ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "sdpa_max_abs_diff": sdpa_err,
        "split_plain_max_abs_diff": split_err,
        "gb_per_s": (kv_bytes + io_bytes) / ms / 1e6,
        "batch": len(batch), "pages_per_seq": ppseq, "tokens": tokens,
        "kv_bytes": kv_bytes, "pages_per_split": pps, "splits": n_splits,
    }


def probe_tiers(dev) -> dict:
    """strided_probe over two 1 GiB pools of 4 KiB pages, one in HBM and
    one in pinned host memory, in a seeded random page order: fast only,
    slow only and half of each, at ai_iters 1 and 64. All six are driven
    once with the launch count set to 0 before and read after, then each
    is checked against the float64 plain version and timed. The per-tier
    GB/s at ai_iters 1 is the micro-benchmark's reading of the two tiers; the
    copy engines' GB/s for one contiguous 0.5 GiB pinned block into HBM is
    printed beside it, as the tier's yardstick."""
    import torch

    from repro_torch.kernels.strided_probe import strided_probe, strided_probe_plain

    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(18)
    fast = torch.randn((PROBE_PAGES, PROBE_PAGE_ELEMS), generator=gen, device=dev)
    slow = torch.empty((PROBE_PAGES, PROBE_PAGE_ELEMS), pin_memory=True)
    for a in range(0, PROBE_PAGES, 16_384):
        n = min(16_384, PROBE_PAGES - a)
        slow[a:a + n].copy_(torch.randn((n, PROBE_PAGE_ELEMS), generator=gen,
                                        device=dev))
    order = torch.randperm(PROBE_PAGES, generator=torch.Generator().manual_seed(19))
    half = PROBE_PAGES // 2
    none = torch.empty(0, dtype=torch.int64)
    mixes = {"fast": (order, none), "slow": (none, order),
             "mixed": (order[:half], order[half:])}
    cases = [(mix, ai) for ai in (1, 64) for mix in mixes]
    idx = {mix: (fi.to(dev), si.to(dev)) for mix, (fi, si) in mixes.items()}
    torch.cuda.synchronize()
    strided_probe.launches = 0
    outs = {(mix, ai): strided_probe(fast, slow, *idx[mix], ai) for mix, ai in cases}
    torch.cuda.synchronize()
    launches = strided_probe.launches
    check(launches == len(cases), "strided_probe was not driven")
    page_b = PROBE_PAGE_ELEMS * 4
    rows = {}
    worst = 0.0
    fast_abs, slow_abs = fast.abs(), slow.abs()
    for mix, ai in cases:
        fi, si = mixes[mix]
        want = strided_probe_plain(fast, slow, fi, si, ai, dtype=torch.float64)
        terms = strided_probe_plain(fast_abs, slow_abs, fi, si, ai,
                                    dtype=torch.float64)
        err = (outs[mix, ai].double() - want).abs()
        worst = max(worst, float(err.max()))
        check(bool((err <= probe_tolerance(terms, ai, fi.numel() + si.numel(), sm)).all()),
              f"strided_probe {mix} ai={ai}: error {float(err.max())} beyond its bound")
        del want, terms
        ms = cuda_ms(lambda: strided_probe(fast, slow, *idx[mix], ai), repeats=10)
        call = lambda: strided_probe(fast, slow, *idx[mix], ai)  # noqa: E731
        device_ms = profiled_ms(call, "probe_kernel", "combine_kernel", calls=5)
        batch_ms = batched_ms(call, calls=5)
        fb, sb = fi.numel() * page_b, si.numel() * page_b
        bytes_ms = max(fb / HBM_BYTES_PER_S, sb / PCIE_BYTES_PER_S) * 1e3
        ops_ms = 2 * ai * (fi.numel() + si.numel()) * PROBE_PAGE_ELEMS / ALU_OPS_PER_S * 1e3
        rows[f"{mix}_ai{ai}"] = {
            "ms": ms, "device_ms": device_ms, "batch_ms": batch_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "gb_per_s": (fb + sb) / ms / 1e6,
            "batch_gb_per_s": (fb + sb) / batch_ms / 1e6,
            "max_abs_err": float(err.max()),
        }
    del fast_abs, slow_abs
    # the copy engines' reading of the host tier, as a yardstick: one copy_
    # of a contiguous 0.5 GiB pinned block into HBM (not the probe's function)
    block = slow[:half]
    dst = torch.empty_like(block, device=dev)
    engine_ms = cuda_ms(lambda: dst.copy_(block, non_blocking=True), repeats=5)
    engine_gb_per_s = block.numel() * 4 / engine_ms / 1e6
    del dst
    fi, si = mixes["mixed"]
    plain_ms = cuda_ms(lambda: strided_probe_plain(fast, slow, fi, si, 64),
                       repeats=3, warmup=1)
    main = rows["mixed_ai64"]
    return {
        "launches": launches, "max_abs_err": worst, "ms": main["ms"],
        "device_ms": main["device_ms"], "batch_ms": main["batch_ms"],
        "plain_ms": plain_ms, "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "hbm_gb_per_s": rows["fast_ai1"]["gb_per_s"],
        "host_gb_per_s": rows["slow_ai1"]["gb_per_s"],
        "host_batch_gb_per_s": rows["slow_ai1"]["batch_gb_per_s"],
        "copy_engine_host_gb_per_s": engine_gb_per_s,
        "copy_engine_ms_half_gib": engine_ms,
        "registers": ptxas_registers("strided_probe"),
        "cases": rows,
    }


# ------------------------------------------------------------ phase 2, model kernels
def flash_checks(dev) -> float:
    """flash_attention == its plain version within 2e-4 (float32) or 2e-2
    (bfloat16): causal and not, T > S, ragged tails, grouped heads, hd in
    {16, 32, 64, 128}, rows that see no key (S > T, zeros in both), and
    causal sequences of 1,000 and 2,047 tokens (many key tiles through the
    bf16 kernel's cp.async ring, ragged last tiles).
    Returns the largest absolute difference."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )

    g = torch.Generator().manual_seed(21)
    worst = 0.0
    cases = [  # B, S, T, H, KV, hd, causal
        (2, 128, 128, 4, 2, 64, True), (1, 100, 100, 8, 2, 128, True),
        (1, 64, 192, 8, 2, 128, False), (1, 33, 65, 2, 1, 64, True),
        (2, 48, 20, 4, 2, 16, True), (1, 70, 131, 16, 8, 128, False),
        (1, 257, 257, 16, 8, 128, True), (2, 40, 40, 4, 4, 32, True),
        (1, 1000, 1000, 16, 8, 128, True), (1, 2047, 2047, 16, 8, 128, True),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, T, H, KV, hd, causal in cases:
            q = torch.randn((B, S, H, hd), generator=g).to(dtype).to(dev)
            k = torch.randn((B, T, KV, hd), generator=g).to(dtype).to(dev)
            v = torch.randn((B, T, KV, hd), generator=g).to(dtype).to(dev)
            got = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            want = flash_attention_plain(q, k, v, causal=causal)
            diff = float((got.float() - want.float()).abs().max())
            worst = max(worst, diff)
            tol = 2e-4 if dtype == torch.float32 else 2e-2
            check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                  f"flash_attention {dtype} {(B, S, T, H, KV, hd, causal)}: "
                  f"max |diff| {diff} beyond {tol}")
            if causal and S > T:
                check(not bool(got[:, : S - T].any()), "rows with no key are not zeros")
    return worst


def wkv6_checks(dev) -> float:
    """wkv6 == its plain version: o within 3e-4 (float32 r, k, v) or 2e-2
    (bfloat16 r, k, v beside float32 w, as the model passes them), the
    float32 state within 3e-4; S not a multiple of the kernel's 32-token
    chunk, hd in {16, 32, 64, 128}, each with its columns split over more
    than one block; strong decays (w = exp(-exp(randn + 2)), many under
    1e-3); S = 1, 15, 17 and 2,048 at 40 heads of 64; and one call 10 times
    over, bit-identical each time. Returns the largest absolute
    difference."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import HEAD_DIMS, wkv6, wkv6_grid, wkv6_plain

    sm = _build.sm_count(dev.index or 0)
    g = torch.Generator().manual_seed(22)
    worst = 0.0
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # B, S, H, hd, dtype of r, k, v, decay bias
        (2, 64, 2, 32, f32, -4.0), (1, 100, 4, 64, f32, -4.0),
        (2, 32, 2, 16, f32, -4.0), (1, 17, 2, 128, f32, -4.0),
        (2, 37, 3, 64, bf16, -4.0), (1, 300, 40, 64, bf16, -4.0),
        (2, 64, 4, 64, bf16, 2.0), (1, 100, 2, 32, f32, 2.0),
        (1, 40, 2, 128, f32, 2.0), (1, 33, 2, 16, f32, 2.0),
        (2, 50, 4, 128, bf16, -4.0), (2, 45, 3, 16, bf16, -4.0),
        (1, 1, 40, 64, bf16, -4.0), (1, 15, 40, 64, bf16, -4.0),
        (1, 17, 40, 64, bf16, 2.0), (1, 2048, 40, 64, bf16, -4.0),
    ]
    split = set()

    def inputs(B, S, H, hd, dtype, bias):
        r, k, v = ((torch.randn((B, S, H, hd), generator=g) * 0.5).to(dtype).to(dev)
                   for _ in range(3))
        scale = 0.5 if bias < 0 else 1.0
        w = torch.exp(-torch.exp(torch.randn((B, S, H, hd), generator=g) * scale
                                 + bias)).to(dev)
        u = (torch.randn((H, hd), generator=g) * 0.3).to(dev)
        return r, k, v, w, u

    for B, S, H, hd, dtype, bias in cases:
        r, k, v, w, u = inputs(B, S, H, hd, dtype, bias)
        if wkv6_grid(hd, B * H, sm)[1] > 1:
            split.add(hd)
        o, st = wkv6(r, k, v, w, u)
        torch.cuda.synchronize()
        o_want, st_want = wkv6_plain(r, k, v, w, u)
        tol = 3e-4 if dtype == f32 else 2e-2
        d_o = float((o.float() - o_want.float()).abs().max()) if S else 0.0
        d_s = float((st - st_want).abs().max())
        worst = max(worst, d_o, d_s)
        check(torch.allclose(o.float(), o_want.float(), rtol=tol, atol=tol)
              and torch.allclose(st, st_want, rtol=3e-4, atol=3e-4),
              f"wkv6 {dtype} {(B, S, H, hd)} decay bias {bias}: max |diff| o "
              f"{d_o}, state {d_s}")
    check(split == set(HEAD_DIMS), f"wkv6: columns split only at hd {sorted(split)}")
    args = inputs(2, 300, 40, 64, bf16, 2.0)
    o1, st1 = wkv6(*args)
    for run in range(10):
        o, st = wkv6(*args)
        check(torch.equal(o, o1) and torch.equal(st, st1),
              f"wkv6 run {run} of 10 differs from the first")
    return worst


# ------------------------------------------------------------ phase 3, models
def model_lanes_agree(dev) -> dict:
    """Each family at full width and 2 layers, in float32, the same weights
    (drawn on the CPU from a seed) on the CPU and on the card: the forward's
    logits and a 4-token prefill's logits and decode state within
    LANE_TOL."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_decode_state, init_model, prefill

    out = {}
    for name in MODEL_FAMILIES:
        cfg = replace(get_config(name), num_layers=LANE_LAYERS,
                      param_dtype="float32", compute_dtype="float32")
        params = init_model(cfg, generator=torch.Generator().manual_seed(23), device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (LANE_BATCH, LANE_LEN),
                               generator=torch.Generator().manual_seed(24))
        lanes = {}
        for lane, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
            p = params if lane == "cpu" else _to(params, device)
            t = tokens.to(device)
            logits, _ = forward(p, cfg, t)
            state = init_decode_state(cfg, LANE_BATCH, 8, device=device)
            last, state = prefill(p, cfg, t[:, :4], state)
            lanes[lane] = (logits.cpu(), last.cpu(), {k: v.cpu() for k, v in state.items()})
            del p
        torch.cuda.synchronize()
        (lc, pc, sc), (lg, pg, sg) = lanes["cpu"], lanes["cuda"]
        diffs = {"logits": float((lc - lg).abs().max()),
                 "prefill_logits": float((pc - pg).abs().max()),
                 **{k: float((sc[k] - sg[k]).abs().max()) for k in sc}}
        ok = torch.allclose(lc, lg, rtol=LANE_TOL, atol=LANE_TOL) and torch.allclose(
            pc, pg, rtol=LANE_TOL, atol=LANE_TOL) and all(
            torch.allclose(sc[k], sg[k], rtol=LANE_TOL, atol=LANE_TOL) for k in sc)
        check(ok, f"{name}: CPU and CUDA lanes differ beyond {LANE_TOL}: {diffs}")
        out[name] = {"max_abs_diff": diffs, "logits_max_abs": float(lc.abs().max())}
        del params, lanes
    return out


def _to(params, where):
    """A copy of a parameter tree on a device or in a dtype."""
    if isinstance(params, dict):
        return {k: _to(v, where) for k, v in params.items()}
    if isinstance(params, list):
        return [_to(v, where) for v in params]
    return params.to(where)


# ------------------------------------------------------------ model serving
def _device_us(prof) -> float:
    import torch

    return sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _logit_agreement(a, b) -> dict:
    """max |a - b|, the relative L2 error of a against b and the share of
    positions whose top-1 token agrees, batch row by batch row (the full
    logits of a 4 x 2,048 prompt are 2.5 GB in bfloat16)."""
    import torch

    worst, err2, ref2, same, n = 0.0, 0.0, 0.0, 0, 0
    for i in range(a.shape[0]):
        x, y = a[i].float(), b[i].float()
        worst = max(worst, float((x - y).abs().max()))
        err2 += float(((x - y) ** 2).sum())
        ref2 += float((y ** 2).sum())
        same += int((x.argmax(-1) == y.argmax(-1)).sum())
        n += x.shape[0] * (x.shape[1] if x.dim() > 2 else 1)
        del x, y
    torch.cuda.synchronize()
    return {"max_abs_diff": worst, "rel_l2": (err2 / ref2) ** 0.5 if ref2 else 0.0,
            "top1_agree": same / n}


def serve_model(name: str, dev, capture: dict) -> dict:
    """One family at full width through repro_torch.launch.serve: 4 prompts
    of 2,048 tokens prefilled (the kernel counts set to 0 just before the
    counted call and read just after), the kernel-path forward held against
    the plain-path forward on the card, the decode state filled by the
    decode loop (``prefill``), then 32 greedy decode steps. ``capture``
    receives the first layer's kernel inputs."""
    from dataclasses import replace

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
    from repro_torch.launch.serve import make_serve_fns
    from repro_torch.models import forward, init_model, param_count, prefill

    cfg = get_config(name)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(31)
    params = init_model(cfg, generator=gen, device=None)
    fns = make_serve_fns(cfg, SERVE_BATCH, PROMPT_LEN + NEW_TOKENS)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PROMPT_LEN), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_all

    def recording(kernel, key):
        def call(*args, **kw):
            if key not in capture:
                capture[key] = ([a.clone() for a in args], kw)
            return kernel(*args, **kw)
        return call

    # 1. the prefill fn through the kernels, counted; then once under the
    # profiler (device time) and once timed (wall: the profiler slows the host)
    ops.attention = recording(flash_attention, "flash_attention")
    ops.wkv6 = recording(wkv6, "wkv6")
    flash_attention.launches = 0
    wkv6.launches = 0
    t = time.perf_counter()
    first = fns["prefill"](params, tokens)
    torch.cuda.synchronize()
    prefill_cold_s = time.perf_counter() - t
    launches = {"flash_attention": flash_attention.launches, "wkv6": wkv6.launches}
    ops.attention, ops.wkv6 = flash_attention, wkv6
    n_attn = sum(k == "attn" for k in cfg.block_pattern) * cfg.num_groups
    n_rwkv = sum(k == "rwkv" for k in cfg.block_pattern) * cfg.num_groups
    check(launches == {"flash_attention": n_attn, "wkv6": n_rwkv},
          f"{name}: prefill launched {launches}, want {n_attn} flash_attention "
          f"and {n_rwkv} wkv6")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fns["prefill"](params, tokens)
        torch.cuda.synchronize()
    prefill_device_ms = _device_us(prof) / 1e3
    traced = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(n in e.name for n in ("flash_mma_kernel", "flash_fma_kernel",
                                            "wkv6_kernel"))]
    kernel_device_ms = sum(e.device_time_total for e in traced) / 1e3
    del prof
    t = time.perf_counter()
    again = fns["prefill"](params, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    check(bool(torch.isfinite(first).all())
          and first.shape == (SERVE_BATCH, 1, cfg.vocab_size),
          f"{name}: prefill logits not finite or of the wrong shape")
    repeat_diff = float((first.float() - again.float()).abs().max())
    del again

    # 2. the same forward through the plain versions on the card, in
    # bfloat16 and, on float32 copies of the weights, in float32
    logits_k, _ = forward(params, cfg, tokens)
    ops.attention, ops.wkv6 = flash_attention_plain, wkv6_plain
    t = time.perf_counter()
    logits_p, _ = forward(params, cfg, tokens)
    torch.cuda.synchronize()
    plain_forward_s = time.perf_counter() - t
    params32 = _to(params, torch.float32)
    logits_32, _ = forward(params32, replace(cfg, param_dtype="float32",
                                             compute_dtype="float32"), tokens)
    del params32
    ops.attention, ops.wkv6 = flash_attention, wkv6
    path = _logit_agreement(logits_k, logits_p)
    kernel_vs_f32 = _logit_agreement(logits_k, logits_32)
    plain_vs_f32 = _logit_agreement(logits_p, logits_32)
    check(path["rel_l2"] <= MODEL_PATH_FACTOR * plain_vs_f32["rel_l2"],
          f"{name}: kernel path vs plain path on the card {path} beyond "
          f"{MODEL_PATH_FACTOR} x the bfloat16 plain path vs float32 {plain_vs_f32}")
    del logits_k, logits_p, logits_32

    # 3. the decode state filled by the decode loop
    state = fns["init_state"]()
    t = time.perf_counter()
    last, state = prefill(params, cfg, tokens, state)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t
    fill = _logit_agreement(last, first)
    check(bool(torch.isfinite(last).all()), f"{name}: decode-loop prefill not finite")

    # 4. 32 greedy decode steps: the first PROFILED_STEPS under the profiler
    # (device time), the rest timed (wall)
    tok = last[:, -1].argmax(-1, keepdim=True)
    new = [tok]

    def step(i):
        nonlocal tok, logits, state
        logits, state = fns["decode"](params, state, tok, PROMPT_LEN + i)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        new.append(tok)

    logits = None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILED_STEPS):
            step(i)
        torch.cuda.synchronize()
    decode_device_ms = _device_us(prof) / 1e3 / PROFILED_STEPS
    del prof
    t = time.perf_counter()
    for i in range(PROFILED_STEPS, NEW_TOKENS):
        step(i)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / (NEW_TOKENS - PROFILED_STEPS)
    out_tokens = torch.cat(new, dim=1)
    check(bool(torch.isfinite(logits).all())
          and bool(((out_tokens >= 0) & (out_tokens < cfg.vocab_size)).all()),
          f"{name}: decode gave non-finite logits or bad tokens")
    result = {
        "params": param_count(params),
        "requests": SERVE_BATCH, "prompt_len": PROMPT_LEN, "new_tokens": NEW_TOKENS,
        "init_s": init_s,
        "prefill_cold_s": prefill_cold_s,
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": SERVE_BATCH * PROMPT_LEN / prefill_s,
        "prefill_device_ms": prefill_device_ms,
        "prefill_device_busy_share": prefill_device_ms / 1e3 / prefill_s,
        "prefill_kernel_device_ms": kernel_device_ms,
        "prefill_kernel_launches_traced": len(traced),
        "prefill_repeat_max_abs_diff": repeat_diff,
        "launches": launches,
        "kernel_vs_plain_path": path,
        "kernel_path_vs_f32": kernel_vs_f32,
        "plain_path_vs_f32": plain_vs_f32,
        "plain_forward_s": plain_forward_s,
        "decode_loop_prefill_s": fill_s,
        "decode_loop_vs_forward_last_logits": fill,
        "decode_ms_per_step": decode_ms,
        "decode_device_ms_per_step": decode_device_ms,
        "decode_device_busy_share": decode_device_ms / decode_ms,
        "decode_tokens_per_s": SERVE_BATCH * 1e3 / decode_ms,
        "decode_loop_prefill_ms_per_step": fill_s * 1e3 / PROMPT_LEN,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "wall_s": time.perf_counter() - t_all,
    }
    del params, state, first, last, logits, tokens
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return result


def _visible_pairs(S: int, T: int, causal: bool) -> int:
    """(query, key) pairs a (batch, head) attends over: with right-aligned
    causal queries, query s sees min(T, max(0, s + T - S + 1)) keys."""
    if not causal:
        return S * T
    return sum(min(T, max(0, s + T - S + 1)) for s in range(S))


def time_flash(capture: dict) -> dict:
    """flash_attention on the first Qwen3-1.7B layer's prefill inputs,
    beside its plain version, its bound and scaled_dot_product_attention
    (a yardstick only; the port never calls it)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    (q, k, v), kw = capture["flash_attention"]
    causal = kw.get("causal", True)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2),
          f"flash_attention on the serving inputs: max |diff| {err}")
    del got, want
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal), repeats=20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=causal),
                       repeats=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)

    sdpa_diff = float((sdpa().transpose(1, 2).float()
                       - flash_attention_plain(q, k, v, causal=causal).float()).abs().max())
    library_ms = cuda_ms(sdpa, repeats=20)
    flops = 4 * B * H * hd * _visible_pairs(S, T, causal)
    io_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    ops_ms = flops / BF16_TENSOR_FLOPS * 1e3
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    return {
        "design": "mma.sync m16n8k16 bf16, cp.async ring" if q.dtype == torch.bfloat16
                  else "float32 FMA",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms, "sdpa_max_abs_diff": sdpa_diff,
        "shape": {"B": B, "S": S, "T": T, "H": H, "KV": KV, "hd": hd, "causal": causal},
        "gflop": flops / 1e9, "bytes": io_bytes,
        "tflop_per_s": flops / ms / 1e9,
    }


def time_wkv6(capture: dict) -> dict:
    """wkv6 on the first RWKV6-3B layer's prefill inputs, beside its plain
    version and its bound (no PyTorch call computes the recurrence)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import wkv6, wkv6_grid, wkv6_plain

    (r, k, v, w, u), _ = capture["wkv6"]
    B, S, H, hd = r.shape
    o, st = wkv6(r, k, v, w, u)
    o_want, st_want = wkv6_plain(r, k, v, w, u)
    err = max(float((o.float() - o_want.float()).abs().max()),
              float((st - st_want).abs().max()))
    check(torch.allclose(o.float(), o_want.float(), rtol=2e-2, atol=2e-2)
          and torch.allclose(st, st_want, rtol=3e-4, atol=3e-4),
          f"wkv6 on the serving inputs: max |diff| {err}")
    del o, st, o_want, st_want
    ms = cuda_ms(lambda: wkv6(r, k, v, w, u), repeats=20)
    device_ms = profiled_ms(lambda: wkv6(r, k, v, w, u), "wkv6_kernel")
    batch_ms = batched_ms(lambda: wkv6(r, k, v, w, u))
    plain_ms = cuda_ms(lambda: wkv6_plain(r, k, v, w, u), repeats=3, warmup=1)
    # a multiply and two FMAs per (token, i, j): 5 flops, float32 outside
    # the tensor cores
    flops = 5 * B * S * H * hd * hd
    io_bytes = (sum(x.numel() * x.element_size() for x in (r, k, v, w, u))
                + r.numel() * r.element_size() + B * H * hd * hd * 4)
    ops_ms = flops / ALU_OPS_PER_S * 1e3
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    return {
        "max_abs_err": err, "ms": ms, "device_ms": device_ms, "batch_ms": batch_ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "shape": {"B": B, "S": S, "H": H, "hd": hd, "rkv_dtype": str(r.dtype)},
        "gflop": flops / 1e9, "bytes": io_bytes,
        "grid": dict(zip(("columns_a_block", "column_slices"),
                         wkv6_grid(hd, B * H, _build.sm_count(r.device.index or 0)))),
        "registers": ptxas_registers("wkv6"),
    }


# ------------------------------------------------------------ phase 10
# The paper's experiment (Figs. 3-7 of the paper; benchmarks/fig3_7_tuning.py
# in the JAX package) and the database it queries (benchmarks/common.py::
# build_bench_db), rebuilt on the port's public entry points:
# repro_torch.sim.api.run, repro_torch.core.tuner.build_database and
# repro_torch.sim.workloads.WORKLOADS.
PAPER_WORKLOADS = ("bfs", "sssp", "pagerank", "xsbench", "btree")
PAPER_TAU = 0.05
# the paper's overall losses at tau = 5% and its mean fast-memory saving
PAPER_LOSS = {"bfs": 0.02, "sssp": 0.047, "pagerank": 0.046, "xsbench": 0.018,
              "btree": 0.046}
PAPER_MEAN_SAVING = 0.085
KNEE_KINDS = ("tpp", "admission", "thrash_guard")
# the database: representative vectors at DB_REP_FRACS, DB_PER_WORKLOAD
# sampled steady-state vectors from DB_PROBE_FRACS, each with DB_JITTER
# jittered copies; each record's curve over 1.0 .. 0.2 in steps of 0.04
DB_REP_FRACS = (1.0, 0.95, 0.9, 0.8)
DB_PROBE_FRACS = (1.0, 0.9, 0.75, 0.6, 0.45, 0.3)
DB_PER_WORKLOAD, DB_JITTER, DB_INTERVALS = 12, 1, 12
# one paper workload at a real size: btree_trace(levels=7) has 1,607,817
# pages of 4 KiB (6.6 GB; the paper's Btree is 10.8 GB, levels 8 would be
# 16 times larger than that)
BIG_BTREE = dict(levels=7)
BIG_BTREE_PAGES = 1_607_817


def paper_tuner():
    """The tuner of the paper's experiment (fig3_7_tuning.py's tuner_spec)."""
    from repro_torch.sim import api

    return api.TunerSpec(target_loss=PAPER_TAU, tune_every=3,
                         cooldown_windows=5, max_step_frac=0.04)


def steady_from(cvs: list, skip: int = 3, min_pacc: float = 500.0) -> list:
    """Steady-state interval vectors: the first ``skip`` and the near-empty
    intervals dropped."""
    return [c for c in cvs[skip:] if c.pacc_f + c.pacc_s >= min_pacc]


def representative_from(cvs: list, trace):
    """One vector for a run: the mean interval, AI and intensity weighted
    by accesses, the trace's RSS, the warm-page fields averaged."""
    import dataclasses

    import numpy as np

    from repro_torch.core.telemetry import ConfigVector

    arr = np.stack([c.as_array() for c in cvs])
    mean = arr.mean(axis=0)
    acc = arr[:, 0] + arr[:, 1]
    w = acc / max(acc.sum(), 1.0)
    mean[4] = float((arr[:, 4] * w).sum())  # ai
    mean[5] = trace.rss_pages
    mean[6] = cvs[0].hot_thr
    mean[7] = cvs[0].num_threads
    intensity = float(sum(c.intensity * wi for c, wi in zip(cvs, w)))
    cv = ConfigVector.from_array(mean, intensity=max(1.0, intensity))
    return dataclasses.replace(
        cv, warm_pages=float(np.mean([c.warm_pages for c in cvs])),
        warm_touches=float(np.mean([c.warm_touches for c in cvs])),
    )


def bench_db(traces: dict, device=None, per_workload: int = DB_PER_WORKLOAD,
             jitter: int = DB_JITTER, seed: int = 0):
    """The benchmark database over ``traces`` (workload name -> trace, in
    WORKLOADS order): one harvest sweep a workload over DB_REP_FRACS and
    DB_PROBE_FRACS, its representative vectors, ``per_workload`` sampled
    steady-state vectors with ``jitter`` jittered copies each, then
    ``build_database``. Returns ``(db, configs, seconds)``."""
    import dataclasses

    import numpy as np

    from repro_torch.core.telemetry import ConfigVector
    from repro_torch.core.tuner import build_database
    from repro_torch.sim import api

    rng = np.random.default_rng(seed)
    configs = []
    fracs = sorted(set(DB_REP_FRACS) | set(DB_PROBE_FRACS), reverse=True)
    seconds = {}
    t = time.perf_counter()
    for name, tr in traces.items():
        rs = api.run(api.Experiment(
            name=f"harvest[{name}]", scenarios=[api.Scenario(trace=tr, name=name)],
            fm_fracs=fracs, collect_configs=True,
        ), device=device)
        by_frac = {float(r.fm_frac): r.result.configs for r in rs.runs}
        for frac in DB_REP_FRACS:
            configs.append(representative_from(steady_from(by_frac[frac]), tr))
        pool = []
        for frac in DB_PROBE_FRACS:
            pool.extend(steady_from(by_frac[float(frac)]))
        idx = rng.choice(len(pool), size=min(per_workload, len(pool)), replace=False)
        for i in idx:
            configs.append(pool[i])
            for _ in range(jitter):
                v = pool[i].as_array().copy()
                v[:4] *= rng.uniform(0.7, 1.4, size=4)  # pacc / pm jitter
                v[4] *= rng.uniform(0.8, 1.25)  # AI jitter
                configs.append(dataclasses.replace(
                    ConfigVector.from_array(v, intensity=pool[i].intensity),
                    warm_pages=pool[i].warm_pages,
                    warm_touches=pool[i].warm_touches,
                ))
    seconds["harvest_s"] = time.perf_counter() - t
    t = time.perf_counter()
    db = build_database(configs, fm_fracs=np.round(np.arange(1.0, 0.199, -0.04), 3),
                        n_intervals=DB_INTERVALS, device=device)
    seconds["build_database_s"] = time.perf_counter() - t
    return db, configs, seconds


def fig3_7_run(trace, db, device=None):
    """TPP and TPP+Tuna at tau = 5% from full fast memory: one tuned sweep."""
    from repro_torch.sim import api

    return api.run(api.Experiment(
        name=f"fig3_7[{trace.name}:tpp]", scenarios=[api.Scenario(trace=trace)],
        fm_fracs=(1.0,),
        policies=[api.PolicySpec(kind="tpp", label="tpp"),
                  api.PolicySpec(kind="tpp", label="tuna", tuner=paper_tuner())],
    ), db=db, device=device)


def knee_run(trace, db, device=None):
    """Each migrating kind at full fast memory, and with Tuna from half."""
    from repro_torch.sim import api

    policies = []
    for kind in KNEE_KINDS:
        policies.append(api.PolicySpec(kind=kind, label=f"{kind}_full", fm_frac=1.0))
        policies.append(api.PolicySpec(kind=kind, label=f"{kind}_tuna", fm_frac=0.5,
                                       tuner=paper_tuner()))
    return api.run(api.Experiment(
        name="fig3_7_policy_cmp[thrash]", scenarios=[api.Scenario(trace=trace)],
        fm_fracs=(1.0,), policies=policies,
    ), db=db, device=device)


def summarize(base, res, rss_pages: int) -> dict:
    """fig3_7_tuning.py's summary of one tuned run against its baseline."""
    return {
        "avg_saving": 1.0 - float(res.fm_sizes.mean()) / rss_pages,
        "max_saving": 1.0 - float(res.fm_sizes.min()) / rss_pages,
        "overall_loss": (res.total_time - base.total_time) / base.total_time,
        "migrations": res.migrations,
    }


def trace_sha256(trace) -> str:
    """sha256 over the trace's concatenated int64 ``pages``, then
    ``counts``, then ``touches`` (all intervals in order), then each
    interval's ``ops`` as float64: the same digest from the JAX package's
    generator on any machine means the same trace."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for field in ("pages", "counts", "touches"):
        h.update(np.concatenate([getattr(ia, field) for ia in trace])
                 .astype(np.int64).tobytes())
    h.update(np.array([ia.ops for ia in trace], dtype=np.float64).tobytes())
    return h.hexdigest()


def profiled_split(fn, n_intervals: int, wall_s: float) -> dict:
    """``fn()`` once more under the profiler, for its device time: wall
    (``wall_s``, the same call timed without the profiler) against device
    ms an interval, and the device's busy share."""
    import torch

    t = time.perf_counter()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
    ) as prof:
        fn()
        torch.cuda.synchronize()
    profiled_s = time.perf_counter() - t
    device_us = sum(
        e.device_time_total for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    split = {
        "intervals": n_intervals,
        "wall_ms_per_interval": wall_s * 1e3 / n_intervals,
        "profiled_wall_ms_per_interval": profiled_s * 1e3 / n_intervals,
        "device_ms_per_interval": (device_us / 1e3 / n_intervals) if device_us else None,
    }
    if device_us:
        split["host_ms_per_interval"] = (
            split["wall_ms_per_interval"] - split["device_ms_per_interval"]
        )
        split["device_busy_share"] = split["device_ms_per_interval"] / split[
            "wall_ms_per_interval"
        ]
    return split


def generate_traces(jobs: dict) -> dict:
    """Each ``name -> (workload, kwargs)`` generated in its own process (the
    generators are single-threaded numpy on the host)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.sim.workloads import WORKLOADS

    workers = max(1, min(len(jobs), (os.cpu_count() or 1) - 1))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        futs = {name: ex.submit(WORKLOADS[w], **kw) for name, (w, kw) in jobs.items()}
        return {name: f.result() for name, f in futs.items()}


def paper_experiment(dev) -> dict:
    """The paper's loop on the card: the database, Figs. 3-7 at the default
    sizes with the thrash row and the knee block, the CPU lane against
    each, and TPP vs TPP+Tuna on the btree at 1,607,817 pages."""
    import numpy as np
    import torch

    from repro_torch.kernels.victim_partition import (
        victim_partition,
        victim_partition_plain,
    )
    from repro_torch.sim import torch_engine
    from repro_torch.sim.workloads import WORKLOADS

    seconds = {}
    t = time.perf_counter()
    jobs = {name: (name, {}) for name in WORKLOADS}
    jobs["btree_big"] = ("btree", BIG_BTREE)
    traces = generate_traces(jobs)
    big = traces.pop("btree_big")
    seconds["trace_generation_s"] = time.perf_counter() - t
    check(big.rss_pages == BIG_BTREE_PAGES,
          f"btree_trace({BIG_BTREE}) has {big.rss_pages} pages")

    db, configs, s = bench_db(traces)
    seconds.update(s)
    check(len(db.records) == len(configs) and all(
        bool(np.all(np.isfinite(r.times))) for r in db.records),
        "paper database: records are not finite")

    # --- Figs. 3-7 on the card, the victim kernel's launches counted
    rows = {}
    card = {}
    victim_partition.launches = 0
    t = time.perf_counter()
    for name in PAPER_WORKLOADS + ("thrash",):
        tr = traces[name]
        t1 = time.perf_counter()
        rs = fig3_7_run(tr, db)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t1
        row = {"pages": tr.rss_pages, "intervals": len(tr), "wall_s": wall_s,
               **summarize(rs.result(policy="tpp"), rs.result(policy="tuna"),
                           tr.rss_pages),
               "watermark_moves": len(rs.record(policy="tuna").watermark_log),
               "sha256": trace_sha256(tr)}
        if name == "thrash":
            row["target_miss"] = row["overall_loss"] - PAPER_TAU
        else:
            row["paper_loss"] = PAPER_LOSS[name]
        rows[name] = row
        card[name] = rs
    knee = knee_run(traces["thrash"], db)
    card["knee"] = knee
    seconds["tuned_runs_s"] = time.perf_counter() - t
    launches = victim_partition.launches
    check(launches > 0, "the paper's runs never launched victim_partition")
    # pagerank has the most intervals: its device time, by the profiler
    t = time.perf_counter()
    pr = traces["pagerank"]
    rows["pagerank"]["split"] = profiled_split(
        lambda: fig3_7_run(pr, db), len(pr), rows["pagerank"]["wall_s"])
    seconds["profiled_reruns_s"] = time.perf_counter() - t
    knee_rows = {}
    for kind in KNEE_KINDS:
        base = knee.result(policy=f"{kind}_full")
        res = knee.result(policy=f"{kind}_tuna")
        knee_rows[kind] = summarize(base, res, traces["thrash"].rss_pages)
        knee_rows[kind]["target_miss"] = knee_rows[kind]["overall_loss"] - PAPER_TAU
        knee_rows[kind]["pm_admit_fail"] = sum(
            c.pm_admit_fail for p in ("full", "tuna")
            for c in knee.result(policy=f"{kind}_{p}").configs)
    check(knee_rows["thrash_guard"]["pm_admit_fail"] > 0,
          "thrash_guard never suppressed a candidate on the card")
    for name, rs in card.items():
        check(rs.spec["device"] == str(dev), f"{rs.name} ran on {rs.spec['device']}")
        check(rs.chunked_step_count == 0, f"{rs.name}: chunked steps ran")
        for r in rs.runs:
            times = r.result.interval_times
            check(bool(np.all(np.isfinite(times))) and bool(np.all(times > 0)),
                  f"{rs.name}/{r.policy}: bad interval times")
            if r.decisions is not None:
                check(len(r.decisions) > 0, f"{rs.name}/{r.policy}: no tuner decision")

    # --- the CPU lane, bit for bit
    t = time.perf_counter()
    for name, rs in card.items():
        if name == "knee":
            cpu = knee_run(traces["thrash"], db, device="cpu")
        else:
            cpu = fig3_7_run(traces[name], db, device="cpu")
        check(runs_plain(cpu) == runs_plain(rs),
              f"{rs.name}: the CPU and CUDA lanes differ")
    seconds["cpu_reruns_s"] = time.perf_counter() - t

    # --- btree at 1,607,817 pages on the card; the victim kernel's largest
    # call held against its plain version
    capture: dict = {}

    def recording(fast01, demand):
        if fast01.numel() >= capture.get("numel", 0):
            capture.update(numel=fast01.numel(), fast01=fast01.clone(),
                           demand=demand.clone())
        return victim_partition(fast01, demand)

    victim_partition.launches = 0
    torch_engine.victim_partition = recording
    t = time.perf_counter()
    try:
        rs = fig3_7_run(big, db)
        torch.cuda.synchronize()
    finally:
        torch_engine.victim_partition = victim_partition
    seconds["big_btree_s"] = time.perf_counter() - t
    big_launches = victim_partition.launches
    t = time.perf_counter()
    split = profiled_split(lambda: fig3_7_run(big, db), len(big),
                           seconds["big_btree_s"])
    seconds["profiled_reruns_s"] += time.perf_counter() - t
    check(big_launches > 0, "the large btree never launched victim_partition")
    got = victim_partition(capture["fast01"], capture["demand"])
    want = victim_partition_plain(capture["fast01"], capture["demand"])
    big_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(big_err == 0, "victim_partition differs from its plain version on "
          "the large btree's inputs")
    for r in rs.runs:
        times = r.result.interval_times
        check(bool(np.all(np.isfinite(times))) and bool(np.all(times > 0)),
              f"{rs.name}/{r.policy}: bad interval times")
    big_row = {"pages": big.rss_pages, "intervals": len(big),
               **summarize(rs.result(policy="tpp"), rs.result(policy="tuna"),
                           big.rss_pages),
               "watermark_moves": len(rs.record(policy="tuna").watermark_log),
               "victim_partition_launches": big_launches,
               "victim_shape": list(capture["fast01"].shape),
               "sha256": trace_sha256(big), "split": split}
    savings = [rows[n]["avg_saving"] for n in PAPER_WORKLOADS]
    return {
        "db_records": len(db.records),
        "rows": rows,
        "mean_saving": float(np.mean(savings)),
        "paper_mean_saving": PAPER_MEAN_SAVING,
        "knee": knee_rows,
        "big_btree": big_row,
        "victim_partition_launches": launches,
        "max_abs_err": big_err,
        "seconds": seconds,
        # for phases 11 and 12, which reuse the database and the traces
        "db": db,
        "traces": traces,
    }


# ------------------------------------------------------------ phase 11
# The fault model and the multi-tenant fleet on the card, after the JAX
# package's benchmarks/fig_fault_resilience.py and benchmarks/fig_fleet.py
# (their metric code copied here: this script imports neither package's
# benchmarks), through repro_torch.sim.api.run, repro_torch.fleet and
# repro_torch.serving.MultiTenantKV.
FAULT_SEED = 7
# fig_fleet.py: the global budget as a fraction of the tenants' RSS, the
# intervals dropped from the loss percentiles, the arbiter, the fleet's tau
FLEET_BUDGET_FRAC = 0.7
FLEET_WARMUP = 2
TAU_FLEET = 0.2
# the fleet mixes' sizes: fig_fleet.py's defaults, and the skewed mix at
# phase 4's RSS (3,250,584 pages of 4 KiB, 13.3 GB: tenants of 1,625,292 +
# 812,646 + 812,646 pages, pages_per_session scaled by the same factor)
FLEET_SIZE = dict(ni=48, rss=12_000, pps=600, noisy_rss=8_000)
FLEET_FULL_SIZE = dict(ni=48, rss=812_646, pps=40_632, noisy_rss=8_000)
# MultiTenantKV at Qwen3-1.7B's KV page: 2,048 pinned host pages (3.76 GB),
# an HBM budget of 512 slots, each tenant's ceiling half its pages
FLEET_KV_TENANTS = {"a": 1024, "b": 512, "c": 512}
FLEET_KV_BUDGET, FLEET_KV_CEIL = 512, 0.5
FLEET_KV_ROUNDS, FLEET_KV_REBALANCE = 200, 8


def fault_levels() -> dict:
    """fig_fault_resilience.py's levels; ``None`` is the fault-free control."""
    from repro_torch.sim.faults import FaultSpec

    return {
        "none": None,
        "mild": FaultSpec(seed=FAULT_SEED, promote_fail_rate=0.05,
                          max_retries=3, telemetry_drop_rate=0.10),
        "harsh": FaultSpec(
            seed=FAULT_SEED, promote_fail_rate=0.20, max_retries=2,
            backoff_base=1, demote_fail_rate=0.10, kswapd_stall_rate=0.05,
            kswapd_stall_len=2, telemetry_drop_rate=0.15,
            telemetry_noise_rate=0.20, telemetry_noise_scale=0.5,
            db_outage_rate=0.15, db_outage_len=2, actuation_lag=1,
        ),
    }


def degraded_counts(decisions) -> dict:
    out: dict = {}
    for d in decisions or ():
        if d.degraded is not None:
            out[d.degraded] = out.get(d.degraded, 0) + 1
    return out


def fault_level_run(trace, level: str, spec, db, kinds=KNEE_KINDS,
                    tuned_start: float = 1.0, device=None):
    """fig_fault_resilience.py's experiment at one level: each kind at full
    size and tuned (tau 5%) from ``tuned_start``, one scenario."""
    from repro_torch.sim import api

    policies = []
    for kind in kinds:
        policies.append(api.PolicySpec(kind=kind, label=f"{kind}_full", fm_frac=1.0))
        policies.append(api.PolicySpec(kind=kind, label=f"{kind}_tuna",
                                       fm_frac=tuned_start, tuner=paper_tuner()))
    return api.run(api.Experiment(
        name=f"fault_resilience[{trace.name}@{level}]",
        scenarios=[api.Scenario(trace=trace, name=f"{trace.name}@{level}",
                                faults=spec)],
        fm_fracs=(1.0,), policies=policies,
    ), db=db, device=device)


def fault_rows(rs, trace, kinds=KNEE_KINDS) -> dict:
    """fig_fault_resilience.py's row per kind of one level's RunSet."""
    rows = {}
    for kind in kinds:
        base = rs.result(policy=f"{kind}_full")
        res = rs.result(policy=f"{kind}_tuna")
        rec = rs.record(policy=f"{kind}_tuna")
        loss = summarize(base, res, trace.rss_pages)["overall_loss"]
        rows[kind] = {
            "overall_loss": loss,
            "target_miss": loss - PAPER_TAU,
            "migrations": res.migrations,
            "pgpromote_fail": res.stats["pgpromote_fail"],
            "degraded": degraded_counts(rec.decisions),
            "fault_events": len(rec.fault_events or ()),
        }
    return rows


def fleet_arbiter():
    from repro_torch.fleet import ArbiterSpec

    return ArbiterSpec(every=2, hysteresis_frac=0.02)


def fleet_tuner_spec():
    from repro_torch.sim import api

    return api.TunerSpec(target_loss=TAU_FLEET, tune_every=2, k_neighbors=1,
                         cooldown_windows=3, max_step_frac=0.08)


def arrivals_kw(seed: int, ni: int, rss: int, pps: int, base_rate: float = 0.4):
    """fig_fleet.py's arrivals tenant: light load against the RSS, one
    diurnal cycle and one flash crowd a run."""
    return dict(n_intervals=ni, rss_pages=rss, pages_per_session=pps,
                base_rate=base_rate, session_mean=3.0, shared_frac=0.15,
                diurnal_period=ni, diurnal_amp=0.6, flash_crowds=1,
                flash_mult=4.0, seed=seed)


def fleet_mix_jobs(ni: int, rss: int, pps: int, noisy_rss: int) -> dict:
    """fig_fleet.py's mixes: mix -> [(tenant, workload, kwargs, ceil_frac)]."""
    return {
        "balanced": [
            ("t0", "arrivals", arrivals_kw(11, ni, rss, pps, 0.25), 1.0),
            ("t1", "arrivals", arrivals_kw(23, ni, rss, pps, 0.4), 1.0),
            ("t2", "arrivals", arrivals_kw(37, ni, rss, pps, 0.55), 1.0),
        ],
        "skewed": [
            ("big", "arrivals", arrivals_kw(41, ni, 2 * rss, pps, 0.8), 1.0),
            ("small0", "arrivals", arrivals_kw(43, ni, rss, pps), 1.0),
            ("small1", "arrivals", arrivals_kw(47, ni, rss, pps), 1.0),
        ],
        "noisy": [
            ("victim0", "arrivals", arrivals_kw(53, ni, rss, pps), 1.0),
            ("victim1", "arrivals", arrivals_kw(59, ni, rss, pps), 1.0),
            ("noisy", "thrash", dict(n_intervals=ni, rss_pages=noisy_rss), 0.4),
        ],
    }


def fleet_tenants(rows, traces=None) -> tuple:
    """TenantSpecs of one mix's job rows; ``traces`` (tenant -> trace)
    holds traces made elsewhere, else each is generated here."""
    from repro_torch.fleet import TenantSpec
    from repro_torch.sim.workloads import WORKLOADS

    return tuple(
        TenantSpec(trace=traces[name] if traces else WORKLOADS[w](**kw),
                   name=name, ceil_frac=ceil)
        for name, w, kw, ceil in rows
    )


def fleet_run(mix: str, tenants, db, policies, budget_frac=FLEET_BUDGET_FRAC,
              faults=None, device=None, name=None):
    from repro_torch.fleet import FleetScenario
    from repro_torch.sim import api

    return api.run(api.Experiment(
        name=name or f"fleet[{mix}]",
        scenarios=[FleetScenario(tenants=tenants, name=mix,
                                 budget_frac=budget_frac,
                                 arbiter=fleet_arbiter(), faults=faults)],
        fm_fracs=(1.0,), policies=policies,
    ), db=db, device=device)


def fleet_policies() -> list:
    from repro_torch.sim import api

    return [api.PolicySpec(label="static"),
            api.PolicySpec(label="fleet_tuna", tuner=fleet_tuner_spec())]


def run_mix(mix: str, tenants, db, device=None, faults=None):
    """fig_fleet.py's run_mix: the full-budget reference (shares by RSS,
    ceilings open, budget 1.0) and static + fleet_tuna. ``(ref_rs, rs)``."""
    import dataclasses

    from repro_torch.sim import api

    ref_tenants = tuple(
        dataclasses.replace(t, share=float(t.trace.rss_pages), ceil_frac=1.0)
        for t in tenants
    )
    ref_rs = fleet_run(f"{mix}_ref", ref_tenants, db,
                       [api.PolicySpec(label="static")], budget_frac=1.0,
                       device=device, name=f"fleet_ref[{mix}]")
    rs = fleet_run(mix, tenants, db, fleet_policies(), faults=faults,
                   device=device)
    return ref_rs, rs


def tenant_loss_percentiles(rec, ref_rec, warmup: int = FLEET_WARMUP) -> dict:
    """p50/p95/p99 of per-interval loss against the reference over the
    intervals where the reference spent at least 10% of its mean."""
    import numpy as np

    t = np.asarray(rec.result.interval_times[warmup:], dtype=np.float64)
    b = np.asarray(ref_rec.result.interval_times[warmup:], dtype=np.float64)
    m = b >= 0.1 * float(b.mean())
    losses = (t[m] - b[m]) / b[m]
    return {p: float(np.percentile(losses, p)) for p in (50, 95, 99)}


def fm_in_use(recs):
    import numpy as np

    return np.sum([r.result.fm_sizes for r in recs], axis=0)


def reclaimable(alloc, desired, budget: int) -> float:
    """Stranded-but-wanted pages under one allocation: ``min(stranded,
    starved)``, unassigned budget counted as stranded."""
    import numpy as np

    alloc = np.asarray(alloc, dtype=np.int64)
    desired = np.asarray(desired, dtype=np.int64)
    stranded = int(np.maximum(alloc - desired, 0).sum())
    stranded += max(0, budget - int(alloc.sum()))
    starved = int(np.maximum(desired - alloc, 0).sum())
    return float(min(stranded, starved))


def fleet_budget(tenants):
    """The mix's budget (pages) and static share split."""
    import numpy as np

    from repro_torch.fleet.runner import static_partition, tenant_bounds

    caps = np.array([int(t.trace.rss_pages) for t in tenants])
    budget = int(round(FLEET_BUDGET_FRAC * caps.sum()))
    floors, ceils = tenant_bounds(tenants, caps)
    return budget, static_partition(budget, caps, [t.share for t in tenants],
                                    floors, ceils)


def stranded_summary(rs, mix: str, tenants) -> dict:
    """Mean reclaimable stranded memory at the arbiter's steps after the
    warm-up, static split against the tuned grants, and the pages
    arbitration recovers."""
    import numpy as np

    budget, static_alloc = fleet_budget(tenants)
    rec = rs.record(scenario=f"{mix}/{tenants[0].resolved_name}",
                    policy="fleet_tuna")
    static_vals, tuned_vals = [], []
    for e in rec.arbiter_log or ():
        if int(e["interval"]) < FLEET_WARMUP:
            continue
        static_vals.append(reclaimable(static_alloc, e["desired"], budget))
        tuned_vals.append(reclaimable(e["granted"], e["desired"], budget))
    out = {
        "budget_pages": budget,
        "stranded_static": float(np.mean(static_vals)) if static_vals else 0.0,
        "stranded_tuned": float(np.mean(tuned_vals)) if tuned_vals else 0.0,
    }
    out["saved_pages"] = out["stranded_static"] - out["stranded_tuned"]
    out["saved_frac_of_budget"] = out["saved_pages"] / budget
    return out


def mode_counts(arbiter_log) -> dict:
    out: dict = {}
    for e in arbiter_log or ():
        out[e["mode"]] = out.get(e["mode"], 0) + 1
    return out


def mix_summary(mix: str, tenants, ref_rs, rs) -> dict:
    """fig_fleet.py's mix_summary: budget, mean fm in use, reclaimable
    stranded memory, loss percentiles per (tenant, policy), arbiter modes."""
    import numpy as np

    out = stranded_summary(rs, mix, tenants)
    out["tenants"] = {}
    for pol in ("static", "fleet_tuna"):
        recs = [rs.record(scenario=f"{mix}/{t.resolved_name}", policy=pol)
                for t in tenants]
        out["fm_used_static" if pol == "static" else "fm_used_tuned"] = float(
            np.mean(fm_in_use(recs)))
        for t, rec in zip(tenants, recs):
            ref_rec = ref_rs.record(scenario=f"{mix}_ref/{t.resolved_name}",
                                    policy="static")
            out["tenants"].setdefault(t.resolved_name, {})[pol] = (
                tenant_loss_percentiles(rec, ref_rec))
    tuned = [rs.record(scenario=f"{mix}/{t.resolved_name}", policy="fleet_tuna")
             for t in tenants]
    out["fm_peak_tuned"] = float(np.max(fm_in_use(tuned)))
    out["arbiter_modes"] = mode_counts(tuned[0].arbiter_log)
    return out


def isolation_delta(summary: dict, victims=("victim0", "victim1")) -> float:
    """The noisy mix's worst victim p99-loss delta, tuned - static."""
    return max(summary["tenants"][v]["fleet_tuna"][99]
               - summary["tenants"][v]["static"][99] for v in victims)


def fleet_kv_rounds(mt, rounds: int = FLEET_KV_ROUNDS,
                    every: int = FLEET_KV_REBALANCE, seed: int = 18) -> list:
    """A seeded schedule on a MultiTenantKV (the port's or the JAX
    package's): each round every tenant makes a window of its pages
    resident and touches it (the hot tenant a quarter of its pages, the
    others a 32nd), the hot tenant moving on every ``rounds // (2 *
    tenants)`` rounds; every ``every`` rounds a rebalance. Returns what each
    call returned and, after each rebalance, the grants and each tenant's
    HBM pages in use and effective fast-memory size."""
    import numpy as np

    rng = np.random.default_rng(seed)
    names = list(mt.names)
    phase = max(1, rounds // (2 * len(names)))
    log = []
    for r in range(rounds):
        hot = names[(r // phase) % len(names)]
        for name in names:
            kv = mt[name]
            n = kv.total_pages // (4 if name == hot else 32)
            pages = (int(rng.integers(0, kv.total_pages)) + np.arange(n)) % kv.total_pages
            log.append(("resident", name, kv.ensure_resident(pages)))
            kv.touch(pages)
        for name in names:
            mt[name].end_interval()
        if (r + 1) % every == 0:
            granted = mt.rebalance(t=float(r), interval=r)
            log.append(("rebalance", [int(g) for g in granted],
                        [int(mt[n].pool.fast_pages().size) for n in names],
                        [int(mt[n].pool.effective_fm_size) for n in names]))
    return log


def fleet_kv_state(mt) -> dict:
    """A MultiTenantKV's state as plain data (the port's)."""
    import numpy as np
    import torch

    out = {"events": mt.arbiter.log_dicts()}
    for name in mt.names:
        kv = mt[name]
        every = np.arange(kv.total_pages)
        out[name] = {
            "hbm_slot": kv.hbm_slot.tolist(),
            "tier": np.asarray(kv.pool.tier).tolist(),
            "heat": kv.pool.heat_of(every).tolist(),
            "stats": kv.pool.stats.snapshot(),
            "effective_fm": kv.pool.effective_fm_size,
            "host": kv.host.view(torch.int16).cpu().numpy().tobytes(),
            "hbm": kv.hbm.view(torch.int16).cpu().numpy().tobytes(),
        }
    return out


def build_fleet_kv(page: dict, device, fill=None):
    from repro_torch.serving import KVPageConfig, MultiTenantKV

    mt = MultiTenantKV(KVPageConfig(**page), tenant_pages=FLEET_KV_TENANTS,
                       hbm_budget=FLEET_KV_BUDGET, ceil_frac=FLEET_KV_CEIL,
                       seed=5, device=device)
    if fill is not None:
        for name in mt.names:
            fill(mt[name])
    return mt


def fleet_kv_phase(dev) -> dict:
    """MultiTenantKV: the control plane's CPU lane == its CUDA lane at a
    narrow page, then the schedule at Qwen3-1.7B's KV page on the card with
    ``migrate_pages`` counted and every page's content checked."""
    import numpy as np
    import torch

    from repro_torch.kernels.page_migrate import migrate_pages

    elems = (2 * NARROW_PAGE["n_groups"] * NARROW_PAGE["page_size"]
             * NARROW_PAGE["kv_heads"] * NARROW_PAGE["head_dim"])
    lanes = {}
    for device in ("cpu", "cuda"):
        rng = np.random.default_rng(17)

        def fill(kv):
            kv.host.copy_(torch.from_numpy(rng.standard_normal(
                (kv.total_pages, elems), dtype=np.float32)).to(torch.bfloat16))

        mt = build_fleet_kv(NARROW_PAGE, device, fill)
        log = fleet_kv_rounds(mt)
        torch.cuda.synchronize()
        lanes[device] = (log, fleet_kv_state(mt))
    check(lanes["cpu"][0] == lanes["cuda"][0],
          "MultiTenantKV: the CPU and CUDA lanes' call results differ")
    for key in lanes["cpu"][1]:
        check(lanes["cpu"][1][key] == lanes["cuda"][1][key],
              f"MultiTenantKV: the CPU and CUDA lanes differ in {key}")

    chunk = 64
    gen = torch.Generator(device=dev).manual_seed(19)
    weights = None
    before = {}

    def fill_full(kv):
        nonlocal weights
        elems = kv.cfg.elems_per_page
        if weights is None:
            weights = torch.randint(1, 2**15, (elems,), generator=gen, device=dev,
                                    dtype=torch.int32)
        fps = []
        for a in range(0, kv.total_pages, chunk):
            pages = torch.randn((min(chunk, kv.total_pages - a), elems),
                                generator=gen, device=dev, dtype=torch.bfloat16)
            fps.append(fingerprints(pages, weights))
            kv.host[a:a + pages.shape[0]].copy_(pages)
        before[id(kv)] = torch.cat(fps)

    t = time.perf_counter()
    mt = build_fleet_kv(QWEN3_1_7B_PAGE, None, fill_full)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    check(all(mt[n].host.is_pinned() and mt[n].hbm.is_cuda for n in mt.names),
          "MultiTenantKV pools are not on the tiers")
    migrate_pages.launches = 0
    t = time.perf_counter()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
    ) as prof:
        log = fleet_kv_rounds(mt)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = migrate_pages.launches
    check(launches > 0, "MultiTenantKV never launched migrate_pages")
    device_us = sum(e.device_time_total for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    # after each rebalance every tenant holds at most its effective size,
    # and that size is its grant to within its controller's deadband (the
    # arbiter's apply stops there, as in the JAX package), so the HBM in
    # use exceeds the budget by less than the deadbands' sum
    rebalances = [e for e in log if e[0] == "rebalance"]
    check(all(u <= e for _, _, use, eff in rebalances for u, e in zip(use, eff)),
          "MultiTenantKV: a tenant holds more HBM than its watermark allows")
    deadbands = sum(c.deadband_frac * c.pool.hw_capacity
                    for c in mt.arbiter.controllers)
    over = max(sum(use) - mt.hbm_budget for _, _, use, _ in rebalances)
    check(over < deadbands, f"MultiTenantKV: HBM in use {over} pages above the "
          f"budget after a rebalance, past the deadbands' {deadbands}")
    for name in mt.names:
        kv = mt[name]
        for a in range(0, kv.total_pages, chunk):
            got = fingerprints(kv.host[a:a + chunk].to(dev), weights)
            check(torch.equal(got, before[id(kv)][a:a + chunk]),
                  f"MultiTenantKV {name}: host pages {a}..{a + chunk} changed")
        resident = np.flatnonzero(kv.hbm_slot >= 0)
        for a in range(0, resident.size, chunk):
            pages = resident[a:a + chunk]
            slots = torch.as_tensor(kv.hbm_slot[pages], device=dev)
            got = fingerprints(kv.hbm[slots], weights)
            check(torch.equal(got, before[id(kv)][torch.as_tensor(pages, device=dev)]),
                  f"MultiTenantKV {name}: HBM slots do not hold their pages")
    stats = {n: mt[n].pool.stats.snapshot() for n in mt.names}
    moved = sum(mt[n].migrated_in + mt[n].migrated_out for n in mt.names)
    out = {
        "page_bytes": mt[mt.names[0]].cfg.bytes_per_page,
        "host_pool_bytes": sum(mt[n].host.numel() * mt[n].host.element_size()
                               for n in mt.names),
        "hbm_pool_bytes": sum(mt[n].hbm.numel() * mt[n].hbm.element_size()
                              for n in mt.names),
        "setup_s": setup_s,
        "rounds": FLEET_KV_ROUNDS,
        "wall_s": wall_s,
        "wall_ms_per_round": wall_s * 1e3 / FLEET_KV_ROUNDS,
        "device_ms_per_round": device_us / 1e3 / FLEET_KV_ROUNDS,
        "device_busy_share": device_us / 1e6 / wall_s,
        "pages_moved": moved,
        "gb_moved": moved * mt[mt.names[0]].cfg.bytes_per_page / 1e9,
        "rebalances": len(rebalances),
        "modes": mode_counts(mt.arbiter.log_dicts()),
        "final_grants": rebalances[-1][1],
        "max_hbm_in_use": max(sum(use) for _, _, use, _ in rebalances),
        "max_pages_over_budget": over,
        "rebalances_over_budget": sum(sum(use) > mt.hbm_budget
                                      for _, _, use, _ in rebalances),
        "pgpromote_fail": {n: stats[n]["pgpromote_fail"] for n in mt.names},
        "migrate_pages_launches": launches,
        "narrow_lanes_calls": len(lanes["cpu"][0]),
    }
    del mt
    return out


def real_size_run(fn, n_intervals: int) -> dict:
    """``fn()`` once under the profiler: wall and device ms an interval,
    the device's busy share, and ``victim_partition``'s launches."""
    import torch

    from repro_torch.kernels.victim_partition import victim_partition

    torch.cuda.synchronize()
    victim_partition.launches = 0
    t = time.perf_counter()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
    ) as prof:
        rs = fn()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    device_us = sum(e.device_time_total for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    split = {"intervals": n_intervals, "wall_s": wall_s,
             "wall_ms_per_interval": wall_s * 1e3 / n_intervals,
             "device_ms_per_interval": device_us / 1e3 / n_intervals,
             "device_busy_share": device_us / 1e6 / wall_s,
             "victim_partition_launches": victim_partition.launches}
    return rs, split


def check_runs(rs, dev) -> None:
    import numpy as np

    check(rs.spec["device"] == str(dev), f"{rs.name} ran on {rs.spec['device']}")
    check(rs.chunked_step_count == 0, f"{rs.name}: chunked steps ran")
    for r in rs.runs:
        times = r.result.interval_times
        check(bool(np.all(np.isfinite(times))) and bool(np.all(times >= 0)),
              f"{rs.name}/{r.scenario}/{r.policy}: bad interval times")


def faults_and_fleets(dev, db, thrash, full_thrash, phase4_split: dict) -> dict:
    """Phase 11: fault resilience (CPU == CUDA, then phase 4's trace under
    harsh faults), the three fleet mixes (CPU == CUDA, the noisy mix under
    harsh faults, then the skewed mix at phase 4's RSS on the card), and
    MultiTenantKV at Qwen3-1.7B's KV page."""
    import torch

    from repro_torch.kernels.victim_partition import victim_partition
    from repro_torch.sim import api

    seconds = {}
    out = {"seconds": seconds}
    levels = fault_levels()

    # --- (a) fig_fault_resilience at its defaults, both lanes
    t = time.perf_counter()
    victim_partition.launches = 0
    rows = {}
    by_level = {}
    for level, spec in levels.items():
        rs = by_level[level] = fault_level_run(thrash, level, spec, db)
        check_runs(rs, dev)
        cpu = fault_level_run(thrash, level, spec, db, device="cpu")
        check(runs_plain(cpu) == runs_plain(rs),
              f"faults@{level}: the CPU and CUDA lanes differ")
        rows[level] = fault_rows(rs, thrash)
        recs = [rs.record(policy=f"{k}_tuna") for k in KNEE_KINDS]
        if spec is None:
            check(all(r.fault_events is None for r in recs),
                  "faults@none logged fault events")
        else:
            check(all(r.fault_events for r in recs), f"faults@{level}: no events")
    check(all(any(d.degraded for d in by_level["harsh"].record(
        policy=f"{k}_tuna").decisions) for k in KNEE_KINDS),
        "faults@harsh: no degraded tuner decision")
    del by_level
    out["fault_rows"] = rows
    out["fault_launches"] = victim_partition.launches
    seconds["faults_s"] = time.perf_counter() - t

    # --- (a) phase 4's trace under harsh faults: the paper's 20 sizes
    # untuned with TPP+Tuna riding along in the same tuned sweep
    t = time.perf_counter()
    harsh = levels["harsh"]
    n_int = len(full_thrash)
    rs, split = real_size_run(lambda: api.run(api.Experiment(
        name="faults@harsh[full]",
        scenarios=[api.Scenario(trace=full_thrash, name="thrash_full@harsh",
                                faults=harsh)],
        fm_fracs=SWEEP_FRACS,
        policies=[api.PolicySpec(label="tpp"),
                  api.PolicySpec(label="tuna", fm_frac=1.0, tuner=paper_tuner())],
    ), db=db), n_int)
    check_runs(rs, dev)
    check(all(r.fault_events for r in rs.runs), "real-size faults: no events")
    pf = sum(r.result.stats["pgpromote_fail"] for r in rs.runs)
    check(pf > 0, "real-size faults: pgpromote_fail stayed 0")
    check(split["victim_partition_launches"] > 0,
          "real-size faults never launched victim_partition")
    tuna = rs.record(policy="tuna")
    out["fault_full"] = {
        "pages": full_thrash.rss_pages, "slices": len(rs.runs), **split,
        "phase4_wall_ms_per_interval": phase4_split["wall_ms_per_interval"],
        "phase4_device_ms_per_interval": phase4_split["device_ms_per_interval"],
        "phase4_device_busy_share": phase4_split["device_busy_share"],
        "pgpromote_fail_total": pf,
        "fault_events_total": sum(len(r.fault_events) for r in rs.runs),
        "tuna_degraded": degraded_counts(tuna.decisions),
        "tuna_watermark_moves": len(tuna.watermark_log),
    }
    del rs
    seconds["faults_full_s"] = time.perf_counter() - t

    # --- (b) fig_fleet's three mixes at their defaults, both lanes
    t = time.perf_counter()
    victim_partition.launches = 0
    mixes = {}
    for mix, jobs in fleet_mix_jobs(**FLEET_SIZE).items():
        tenants = fleet_tenants(jobs)
        ref_rs, rs = run_mix(mix, tenants, db)
        for r in (ref_rs, rs):
            check_runs(r, dev)
        cpu_ref, cpu = run_mix(mix, tenants, db, device="cpu")
        check(runs_plain(cpu_ref) == runs_plain(ref_rs)
              and runs_plain(cpu) == runs_plain(rs),
              f"fleet {mix}: the CPU and CUDA lanes differ")
        s = mix_summary(mix, tenants, ref_rs, rs)
        check(s["arbiter_modes"], f"fleet {mix}: the arbiter never stepped")
        if mix == "noisy":
            s["victim_p99_delta"] = isolation_delta(s)
            ceil_b = round(0.4 * tenants[2].trace.rss_pages)
            check(all(e["granted"][2] <= ceil_b for e in
                      rs.record(scenario="noisy/noisy", policy="fleet_tuna").arbiter_log),
                  "fleet noisy: the ceiling did not bind")
            # once more under harsh faults: it degrades and does not raise
            h = fleet_run(mix, tenants, db, fleet_policies(), faults=harsh,
                          name="fleet[noisy@harsh]")
            check_runs(h, dev)
            hc = fleet_run(mix, tenants, db, fleet_policies(), faults=harsh,
                           name="fleet[noisy@harsh]", device="cpu")
            check(runs_plain(hc) == runs_plain(h),
                  "fleet noisy@harsh: the CPU and CUDA lanes differ")
            tuned = [r for r in h.runs if r.policy == "fleet_tuna"]
            check(all(r.fault_events for r in tuned), "fleet noisy@harsh: no events")
            degraded = sum(d.degraded is not None for r in tuned for d in r.decisions)
            check(degraded > 0, "fleet noisy@harsh: no degraded decision")
            s["harsh"] = {"degraded_decisions": degraded,
                          "degraded_arbitrations": sum(
                              e["degraded"] for e in tuned[0].arbiter_log),
                          "fault_events": sum(len(r.fault_events) for r in tuned),
                          "modes": mode_counts(tuned[0].arbiter_log)}
        mixes[mix] = s
    out["fleet_mixes"] = mixes
    out["fleet_launches"] = victim_partition.launches
    seconds["fleet_mixes_s"] = time.perf_counter() - t

    # --- (b) the skewed mix at phase 4's RSS, on the card only
    t = time.perf_counter()
    jobs = fleet_mix_jobs(**FLEET_FULL_SIZE)["skewed"]
    traces = generate_traces({name: (w, kw) for name, w, kw, _ in jobs})
    tenants = fleet_tenants(jobs, traces)
    seconds["fleet_full_traces_s"] = time.perf_counter() - t
    pages = sum(t_.trace.rss_pages for t_ in tenants)
    check(pages == 3_250_584, f"the full-size fleet has {pages} pages")
    full = {"pages": pages, "tenant_pages": [t_.trace.rss_pages for t_ in tenants]}
    recs = {}
    for pol in fleet_policies():
        rs, split = real_size_run(
            lambda: fleet_run("skewed_full", tenants, db, [pol]),
            FLEET_FULL_SIZE["ni"])
        check_runs(rs, dev)
        check(split["victim_partition_launches"] > 0,
              f"the full-size fleet ({pol.label}) never launched victim_partition")
        full[pol.label] = split
        recs[pol.label] = rs
    full["fleet_tuna"]["modes"] = mode_counts(recs["fleet_tuna"].runs[0].arbiter_log)
    full.update(stranded_summary(recs["fleet_tuna"], "skewed_full", tenants))
    out["fleet_full"] = full
    del recs, traces, tenants
    seconds["fleet_full_s"] = time.perf_counter() - t

    # --- (c) MultiTenantKV
    t = time.perf_counter()
    out["fleet_kv"] = fleet_kv_phase(dev)
    torch.cuda.empty_cache()
    seconds["fleet_kv_s"] = time.perf_counter() - t
    return out


# ------------------------------------------------------------ phase 12
# The per-size engine, custom runners and the timing engine on the card:
# the JAX package's benchmarks/fig1_motivation.py (Fig. 1: TPP against
# first touch) and benchmarks/fig_model_fidelity.py (the interval cost model
# against the address-level timing engine), rebuilt on the port's public
# entry points: repro_torch.sim.api.run (the first_touch kind, pool_factory,
# runner) and repro_torch.timing (calibrate, timing_runner).
FIG1_GRID = (1.0, 0.95, 0.895, 0.8, 0.7, 0.5, 0.266)
FIG1_SCENARIOS = ("bfs", "thrash")
FIG1_PAPER = {"tpp_loss@0.895": 0.044, "ft_loss@0.895": 0.088, "tpp_loss@0.266": 0.302}
FIDELITY_FRACS = (1.0, 0.9, 0.75, 0.6, 0.45, 0.3)
FIDELITY_MAX_EVENTS = 50_000
RESIDUAL_BOUND = 0.15  # fig_model_fidelity's contract bounds
BALANCED_BOUND = 0.60
TIMING_FULL_FRAC = 0.75  # the real-size timing lane: phase 4's trace, TPP
REPLAY_PREFIX = 4_000  # events of each real-size replay in the prefix launch
REPLAY_REPEATS = 10
REPLAY_BLOCK = 128  # replays a block of csrc/timing_replay.cu (kThreads)
PLAIN_WORKERS = 6  # spawned processes running replay_ref beside the phase
F64_OPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores


def fig1_run(traces: dict, device=None):
    """fig1_motivation.py's experiment: bfs and thrash x FIG1_GRID x {tpp,
    first_touch}, one run (both kinds on the device sweep)."""
    from repro_torch.sim import api

    return api.run(api.Experiment(
        name="fig1_motivation",
        scenarios=[api.Scenario(trace=traces[n], name=n) for n in FIG1_SCENARIOS],
        fm_fracs=FIG1_GRID,
        policies=[api.PolicySpec(label="tpp"),
                  api.PolicySpec(kind="first_touch", label="first_touch")],
    ), device=device)


def fig1_rows(rs, scenarios=FIG1_SCENARIOS, grid=FIG1_GRID) -> dict:
    """fig1_motivation.py's report numbers: per scenario and size the TPP
    and first-touch losses against TPP at full size, TPP's migrations and
    failed promotions."""
    rows = {}
    for name in scenarios:
        base = rs.result(scenario=name, policy="tpp", fm_frac=1.0).total_time
        rows[name] = {}
        for f in grid:
            tpp = rs.result(scenario=name, policy="tpp", fm_frac=f)
            ft = rs.result(scenario=name, policy="first_touch", fm_frac=f)
            rows[name][f] = {
                "tpp_loss": (tpp.total_time - base) / base,
                "ft_loss": (ft.total_time - base) / base,
                "migrations": tpp.migrations,
                "pgpromote_fail": tpp.stats["pgpromote_fail"],
            }
    return rows


def fidelity_regime(counts, t_overhead: float, t_total: float) -> str:
    """fig_model_fidelity.py's interval regimes."""
    import numpy as np

    if t_total <= 0.0 or counts.size == 0:
        return "balanced"
    if t_overhead / t_total > 0.25:
        return "migration"
    c = counts.astype(np.float64)
    s1 = c.sum()
    pr = (s1 * s1) / np.square(c).sum()
    if pr < counts.size / 3.0:
        return "skewed_mlp"
    return "balanced"


def clock_pair(tr, name: str, fracs=FIDELITY_FRACS, cal=None, seed: int = 0,
               max_events: int = FIDELITY_MAX_EVENTS, device=None):
    """Both clocks on one trace (fig_model_fidelity.clock_pair): the model
    lane through the device sweep, the timing lane through
    ``timing_runner``. Returns ``(model RunSet, timing RunSet)``."""
    import functools

    from repro_torch.sim import api
    from repro_torch.sim.costmodel import OPTANE_LIKE
    from repro_torch.timing import calibrate, timing_runner

    if cal is None:
        cal = calibrate(OPTANE_LIKE, max_events=max_events, seed=seed, device=device)
    spec = api.PolicySpec(kind="tpp")
    rs_model = api.run(api.Experiment(
        name=f"fidelity_model[{name}]",
        scenarios=[api.Scenario(trace=tr, name=name, seed=seed)],
        fm_fracs=tuple(fracs), policies=[spec],
    ), device=device)
    runner = functools.partial(timing_runner, calibration=cal.to_dict(),
                               max_events=max_events, device=device)
    rs_timing = api.run(api.Experiment(
        name=f"fidelity_timing[{name}]",
        scenarios=[api.Scenario(trace=tr, name=name, seed=seed, runner=runner)],
        fm_fracs=tuple(fracs), policies=[spec],
    ), device=device)
    return rs_model, rs_timing


def divergences(tr, rs_model, rs_timing, fracs=FIDELITY_FRACS) -> dict:
    """Per-regime per-interval divergence pooled over the size vector
    (fig_model_fidelity.divergences)."""
    import numpy as np

    by_regime: dict = {}
    per_frac: dict = {}
    for f in fracs:
        model = rs_model.record(fm_frac=f).result
        payload = rs_timing.record(fm_frac=f).result
        t_model = np.asarray(model.interval_times)
        t_timing = np.asarray(payload["interval_times"])
        check(t_model.size == t_timing.size, "clock lanes saw different interval counts")
        d = (t_timing - t_model) / np.maximum(t_model, 1e-30)
        per_frac[f] = d
        for i, ia in enumerate(tr):
            info = payload["intervals"][i]
            reg = fidelity_regime(ia.counts, info["t_migrate"] + info["t_stall"],
                                  info["total"])
            by_regime.setdefault(reg, []).append(float(d[i]))
    return {"per_frac": per_frac, "by_regime": by_regime}


def fidelity_summary(rs_model, rs_timing) -> dict:
    """Total-time divergence per size (fig_model_fidelity.fidelity_summary,
    the table2 model-fidelity column)."""
    import numpy as np

    tm = rs_model.total_times()
    tt = rs_timing.total_times()
    d = (tt - tm) / np.maximum(tm, 1e-30)
    return {"per_frac": [float(x) for x in d],
            "mean_abs": float(np.mean(np.abs(d))), "max_abs": float(np.max(np.abs(d)))}


def fidelity_quick(device=None) -> dict:
    """fig_model_fidelity._quick_smoke: both clocks on small traces and the
    divergence contract (calibration residuals, finite and positive times,
    the balanced regime's bound, a bit-identical re-run). Returns the
    timing payloads and regimes, for comparing lanes."""
    import functools

    import numpy as np

    from repro_torch.sim.costmodel import OPTANE_LIKE
    from repro_torch.sim.workloads import thrash_trace, xsbench_trace
    from repro_torch.timing import calibrate

    cal = calibrate(OPTANE_LIKE, max_events=FIDELITY_MAX_EVENTS, device=device)
    for k, v in cal.residuals.items():
        check(v <= RESIDUAL_BOUND, f"calibration residual {k}={v:.3f} exceeds {RESIDUAL_BOUND}")
    small = {
        "thrash": functools.partial(thrash_trace, n_intervals=10, rss_pages=4_000),
        "xsbench": functools.partial(xsbench_trace, n_intervals=12, lookups=40_000),
    }
    fracs = (1.0, 0.7, 0.4)
    out = {}
    for name, factory in small.items():
        tr = factory()
        rs_model, rs_timing = clock_pair(tr, f"{name}_smoke", fracs=fracs, cal=cal,
                                         device=device)
        div = divergences(tr, rs_model, rs_timing, fracs=fracs)
        for f, d in div["per_frac"].items():
            check(bool(np.all(np.isfinite(d))), f"{name} fm={f}: non-finite divergence")
            t = rs_timing.record(fm_frac=f).result["interval_times"]
            check(all(x > 0 for x in t), f"{name} fm={f}: non-positive time")
        bal = div["by_regime"].get("balanced", [])
        if bal:
            check(np.median(np.abs(bal)) <= BALANCED_BOUND,
                  f"{name}: balanced-regime divergence {np.median(np.abs(bal)):.2f} "
                  f"exceeds {BALANCED_BOUND}")
        _, again = clock_pair(tr, f"{name}_smoke", fracs=fracs, cal=cal, device=device)
        for f in fracs:
            check(again.record(fm_frac=f).result["interval_times"]
                  == rs_timing.record(fm_frac=f).result["interval_times"],
                  f"{name} fm={f}: timing replay not deterministic")
        out[name] = {
            "payloads": [r.result for r in rs_timing.runs],
            "model_times": [r.result.interval_times.tolist() for r in rs_model.runs],
            "regimes": {r: [float(x) for x in ds] for r, ds in sorted(div["by_regime"].items())},
        }
    out["calibration"] = cal.to_dict()
    return out


def fidelity_run(traces: dict, cal, device=None) -> dict:
    """fig_model_fidelity.run at its defaults: every workload x
    FIDELITY_FRACS through both clocks; divergence per regime (pooled and
    per workload) and the total-time divergence per workload."""
    import numpy as np

    pooled: dict = {}
    rows = {}
    for name, tr in traces.items():
        t = time.perf_counter()
        rs_model, rs_timing = clock_pair(tr, name, cal=cal, device=device)
        wall_s = time.perf_counter() - t
        div = divergences(tr, rs_model, rs_timing)
        for f in FIDELITY_FRACS:
            check(all(x > 0 for x in rs_timing.record(fm_frac=f).result["interval_times"]),
                  f"fidelity {name} fm={f}: non-positive timing-lane time")
        for reg, ds in div["by_regime"].items():
            pooled.setdefault(reg, []).extend(ds)
        rows[name] = {
            "pages": tr.rss_pages, "intervals": len(tr), "wall_s": wall_s,
            "events": sum(iv["events"] for r in rs_timing.runs
                          for iv in r.result["intervals"]),
            **fidelity_summary(rs_model, rs_timing),
            "regimes": {r: {"n": len(ds), "mean_abs": float(np.mean(np.abs(ds))),
                            "median_d": float(np.median(ds))}
                        for r, ds in sorted(div["by_regime"].items())},
        }
    regimes = {r: {"n": len(ds), "mean_abs": float(np.mean(np.abs(ds)))}
               for r, ds in sorted(pooled.items())}
    mean = {r: v["mean_abs"] for r, v in regimes.items()}
    bal = mean.get("balanced", 0.0)
    concentrated = max(mean.get("skewed_mlp", 0.0), mean.get("migration", 0.0)) >= bal
    return {"rows": rows, "regimes": regimes, "concentrated": concentrated}


def replay_launch(replays: list):
    """The flat launch arguments of ``replays`` (one launch, in order)."""
    import torch

    sizes = [r[0].numel() for r in replays]
    dev = replays[0][0].device
    ev_off = torch.zeros(len(replays) + 1, dtype=torch.int64)
    ev_off[1:] = torch.cumsum(torch.tensor(sizes, dtype=torch.int64), dim=0)
    return (torch.cat([r[0] for r in replays]), torch.cat([r[1] for r in replays]),
            torch.cat([r[2] for r in replays]), torch.cat([r[3] for r in replays]),
            ev_off.to(dev), torch.cat([r[4] for r in replays]),
            torch.cat([r[5] for r in replays]), torch.cat([r[6] for r in replays]))


def replay_cost(args) -> dict:
    """Bytes, float64 operations and the bound of one launch of
    ``timing_replay``. Bytes: events read once (page 4, tier 1, occ 8, lat 8),
    the per-replay arrays, ``page_done`` zeroed (8 a page a replay), t_app
    written; ``ready`` is this design's scratch and not counted. Operations:
    about 6 float64 an event (2 adds, 2 subtracts, 2 maxima) at the card's
    rate, and the serial chain (windows x a dependent load + events x a
    dependent float64 add, the longest replay) with both links measured now
    by ``chain_latency_ns`` over the launch's largest ``n_pages``. The bound
    is the largest of the three; the chain counts as operations."""
    from repro_torch.kernels.timing_replay import chain_bound_ms, chain_latency_ns

    page, tier, occ, lat, ev_off, w_slots, chan, n_pages = args
    n_ev = page.numel()
    n_rep = w_slots.numel()
    sizes = (ev_off[1:] - ev_off[:-1]).cpu()
    windows = (sizes + w_slots.cpu() - 1) // w_slots.cpu()
    bytes_moved = n_ev * 21 + n_rep * (8 * 4 + 16) + n_rep * 8 + int(n_pages.sum()) * 8
    ops = 6 * n_ev
    links = chain_latency_ns(int(n_pages.max()), page.device)
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    chain_ms = chain_bound_ms(ev_off, w_slots, links)
    ops_ms = max(ops / F64_OPS_PER_S * 1e3, chain_ms)
    return {"events": n_ev, "replays": n_rep, "windows": int(windows.sum()),
            "bytes": bytes_moved, "f64_ops": ops, **links,
            "bytes_ms": bytes_ms, "chain_ms": chain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def sub_launch(args, lo: int, hi: int) -> tuple:
    """Replays ``lo:hi`` of one launch's arguments as a launch of their own:
    the replays are independent, so each keeps its result."""
    page, tier, occ, lat, ev_off, w_slots, chan, n_pages = args
    a, b = int(ev_off[lo]), int(ev_off[hi])
    return (page[a:b], tier[a:b], occ[a:b], lat[a:b], ev_off[lo:hi + 1] - a,
            w_slots[lo:hi], chan[lo:hi], n_pages[lo:hi])


def plain_replay(arrays) -> list:
    """``timing_replay`` over host copies (numpy) of one launch's arguments,
    that is its plain version ``replay_ref``; runs in a spawned process."""
    import torch

    from repro_torch.kernels.timing_replay import timing_replay

    return timing_replay(*[torch.from_numpy(a) for a in arrays]).tolist()


class PlainReplays:
    """The plain version of main-path launches of ``timing_replay``, beside
    the phase: each submitted launch is cut into chunks of replays, copied
    to the host and replayed by ``replay_ref`` in spawned processes of one
    torch thread each; :meth:`verify` holds the kernel's results against
    them bit for bit."""

    def __init__(self):
        import multiprocessing
        import os
        from concurrent.futures import ProcessPoolExecutor

        import torch

        self.ex = ProcessPoolExecutor(
            max_workers=max(1, min(PLAIN_WORKERS, (os.cpu_count() or 2) - 2)),
            mp_context=multiprocessing.get_context("spawn"),
            initializer=torch.set_num_threads, initargs=(1,))
        self.jobs = []

    def submit(self, name: str, args, got, chunk: int) -> None:
        n = got.numel()
        futs = [self.ex.submit(plain_replay, [a.cpu().numpy() for a in
                                              sub_launch(args, lo, min(n, lo + chunk))])
                for lo in range(0, n, chunk)]
        self.jobs.append((name, got.cpu().tolist(), futs))

    def verify(self) -> dict:
        out = {}
        for name, got, futs in self.jobs:
            want = [x for f in futs for x in f.result()]
            bad = [r for r, (a, b) in enumerate(zip(got, want)) if a != b]
            check(len(got) == len(want) and not bad,
                  f"timing_replay differs from replay_ref on {name}, replays {bad[:8]}: "
                  f"{[got[r] for r in bad[:8]]} vs {[want[r] for r in bad[:8]]}")
            out[name] = len(got)
        return out

    def close(self) -> None:
        self.ex.shutdown(wait=True, cancel_futures=True)


@contextlib.contextmanager
def one_cpu_thread():
    """The CPU lanes of the replay run thousands of tiny torch ops, one
    window at a time: one intra-op thread, since idle pool threads only
    spin beside them."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


class ReplayRecorder:
    """Wraps ``repro_torch.timing.engine.timing_replay``: keeps the
    arguments, result and seconds (synchronized) of every call, or with
    ``min_replays`` of the first call with more replays than that only, so
    that the card's calls can be held against the plain version."""

    def __init__(self, min_replays: int | None = None):
        from repro_torch.kernels.timing_replay import timing_replay

        self.fn = timing_replay
        self.min_replays = min_replays
        self.calls = []
        self.seconds = 0.0

    def __call__(self, *args):
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        out = self.fn(*args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        self.seconds += dt
        if self.min_replays is None or (not self.calls and out.numel() > self.min_replays):
            self.calls.append((args, out.cpu(), dt))
        return out

    def __enter__(self):
        from repro_torch.timing import engine

        engine.timing_replay = self
        return self

    def __exit__(self, *exc):
        from repro_torch.timing import engine

        engine.timing_replay = self.fn
        return False


def replay_checks(dev, card_calls: list, cpu_calls: list, plain: PlainReplays,
                  prefix) -> dict:
    """(a): ``timing_replay`` on the card == ``replay_ref`` on the CPU,
    bit for bit: every call the card lanes of (b) and (c) made against the
    CPU lanes' calls of the plain version (the same inputs, built on each
    device, must be equal too), synthetic edge cases (W = 1 chains, one
    page hammered, writes, pages twice in a window, an empty replay between
    others), the main path's launches that ``plain`` replayed beside the
    phase (a fidelity launch over several blocks, a whole real-size replay,
    the real-size prefix launch), and ``REPLAY_REPEATS`` identical launches
    of the prefix launch ``prefix`` = (arguments, result)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.timing_replay import timing_replay
    from repro_torch.sim.costmodel import OPTANE_LIKE
    from repro_torch.timing import AddressTimingEngine, TimingParams

    def cpu(x):
        return x.cpu()

    # the recorded launches: the card's inputs and results against the CPU
    # lane's (replay_ref over the streams the CPU built)
    check(len(card_calls) == len(cpu_calls), "the lanes made different numbers "
          "of timing_replay calls")
    n = 0
    err = 0.0

    def diff(a, b) -> float:
        return float((a.cpu() - b.cpu()).abs().max()) if a.numel() else 0.0

    for k, ((c_args, c_out, _), (p_args, p_out, _)) in enumerate(zip(card_calls, cpu_calls)):
        check(all(torch.equal(cpu(a), b) for a, b in zip(c_args, p_args)),
              f"timing_replay call {k}: the card built other events than the CPU")
        err = max(err, diff(c_out, p_out))
        check(torch.equal(c_out, p_out), f"timing_replay call {k}: the kernel "
              f"differs from replay_ref: {c_out.tolist()} vs {p_out.tolist()}")
        n += c_out.numel()
    # synthetic streams, built by the engine on the card
    rng = np.random.default_rng(12)
    w1 = AddressTimingEngine(dataclasses.replace(
        TimingParams.from_profile(OPTANE_LIKE, max_events=5_000), window=1.0),
        seed=3, device=dev)
    eng = AddressTimingEngine(TimingParams.from_profile(OPTANE_LIKE, max_events=20_000),
                              seed=4, device=dev)
    cases = {
        "w1_chains": (w1, dict(counts=rng.integers(1, 40, size=300), num_threads=1,
                               tiers=rng.integers(0, 2, size=300), rand_frac=0.8)),
        "one_page": (eng, dict(counts=np.array([60_000]), tiers=np.array([1]))),
        "writes": (eng, dict(counts=rng.integers(1, 200, size=2_000),
                             tiers=rng.integers(0, 2, size=2_000), rand_frac=0.6,
                             writes=rng.integers(0, 100, size=2_000), pm_pr=40, pm_de=25)),
        "dup_pages": (eng, dict(counts=np.full(3, 5_000), tiers=np.array([0, 1, 0]))),
    }
    synth = []
    for name, (e, kw) in cases.items():
        counts = np.asarray(kw.pop("counts"), dtype=np.int64)
        kw.setdefault("num_threads", 2)
        part, stream = e._prepare(index=7, pages=np.arange(counts.size), counts=counts,
                                  tiers=np.asarray(kw.pop("tiers"), dtype=np.int8),
                                  ops=0.0, **kw)
        ev, w, chan = stream
        synth.append((name, ev, w, chan))
    reps = [(ev.page, ev.tier, ev.occ, ev.lat,
             torch.tensor([w], dtype=torch.int64, device=dev),
             torch.tensor([chan], dtype=torch.float64, device=dev),
             torch.tensor([ev.n_pages], dtype=torch.int64, device=dev))
            for _, ev, w, chan in synth]
    empty = (reps[0][0][:0], reps[0][1][:0], reps[0][2][:0], reps[0][3][:0],
             reps[0][4], torch.tensor([[3e-6, 5e-6]], dtype=torch.float64, device=dev),
             reps[0][6])
    launch = replay_launch(reps[:2] + [empty] + reps[2:])
    got_t = timing_replay(*launch)
    with one_cpu_thread():
        want_t = timing_replay(*[cpu(a) for a in launch])
    err = max(err, diff(got_t, want_t))
    got, want = got_t.tolist(), want_t.tolist()
    check(got == want, f"timing_replay differs from replay_ref on the edge cases: "
          f"{got} vs {want}")
    check(got[2] == 5e-6, "an empty replay must end at its channel preload")
    check(synth[0][2] == 1, "the W = 1 case did not get one-event windows")
    # the main path's launches against the plain version beside the phase
    main_path = plain.verify()
    # the real-size prefix launch, repeated
    args, got = prefix
    for _ in range(REPLAY_REPEATS):
        check(torch.equal(timing_replay(*args), got),
              "timing_replay is not bit-identical across repeats")
    return {"recorded_replays": n, "edge_cases": [s[0] for s in synth] + ["empty"],
            "main_path_replays": main_path, "prefix_events": int(args[0].numel()),
            "repeats": REPLAY_REPEATS, "max_abs_err": err}


def timing_full(dev, trace) -> tuple:
    """(g): phase 4's trace under TPP at TIMING_FULL_FRAC through
    ``timing_runner`` on the card, every interval replayed in one launch;
    conservation checks; the host schedule's seconds against the replay's.
    Returns the row and the launch's (arguments, result)."""
    import numpy as np
    import torch

    from repro_torch.kernels.timing_replay import timing_replay
    from repro_torch.sim import api
    from repro_torch.sim.costmodel import OPTANE_LIKE
    from repro_torch.timing import absorb_llc, timing_runner

    hw = OPTANE_LIKE
    torch.cuda.synchronize()
    timing_replay.launches = 0
    t = time.perf_counter()
    with ReplayRecorder() as rec:
        payload = timing_runner(api.Scenario(trace=trace), TIMING_FULL_FRAC,
                                api.PolicySpec(kind="tpp"), None, device=dev)
    wall_s = time.perf_counter() - t
    launches = timing_replay.launches
    check(launches == 1, f"the real-size timing lane launched timing_replay "
          f"{launches} times, not once")
    args, t_app, _ = rec.calls[0]
    ivs = payload["intervals"]
    check(len(ivs) == len(trace) and len(payload["interval_times"]) == len(trace),
          "the real-size timing lane lost intervals")
    cl = max(1, hw.page_bytes // hw.access_bytes)
    page, tier, occ, lat, ev_off, w_slots, chan, n_pages = args
    off = ev_off.tolist()
    r = 0
    for i, (ia, iv) in enumerate(zip(trace, ivs)):
        lines = int(absorb_llc(np.asarray(ia.counts, dtype=np.int64), hw.llc_pages, cl).sum())
        check(iv["bytes_fast"] + iv["bytes_slow"] == lines * hw.access_bytes,
              f"interval {i}: bytes not conserved")
        check(np.isfinite(iv["total"]) and iv["total"] > 0, f"interval {i}: bad time")
        if not iv["events"]:
            continue
        s = slice(off[r], off[r + 1])
        floor = max(float(chan[r, tr]) + float(occ[s][tier[s] == tr].sum())
                    for tr in (0, 1))
        check(iv["t_app"] >= floor * (1 - 1e-9),
              f"interval {i}: t_app {iv['t_app']} below its channel occupancy {floor}")
        check(iv["t_app"] == float(t_app[r]), f"interval {i}: t_app not the kernel's")
        r += 1
    cost = replay_cost(args)
    row = {"pages": trace.rss_pages, "intervals": len(trace), "fm_frac": TIMING_FULL_FRAC,
           "wall_s": wall_s, "replay_s": rec.seconds,
           "host_schedule_and_build_s": wall_s - rec.seconds,
           "events_per_interval": [iv["events"] for iv in ivs],
           "scale_per_interval": [iv["scale"] for iv in ivs],
           "w_slots": w_slots.tolist(), "launches": launches,
           "total_time_s": payload["total_time"],
           "migrations": payload["migrations"],
           "page_done_bytes": int(n_pages.sum()) * 8, **cost}
    return row, (args, t_app)


def prefix_launch(args) -> tuple:
    """The first REPLAY_PREFIX events of every replay of one launch, each
    with its own real ``n_pages``, window and preload, launched together
    on the card: several real-size ``page_done`` rows at distinct offsets.
    Returns (arguments, result)."""
    from repro_torch.kernels.timing_replay import timing_replay

    page, tier, occ, lat, ev_off, w_slots, chan, n_pages = args
    off = ev_off.tolist()
    reps = []
    for r in range(w_slots.numel()):
        s = slice(off[r], min(off[r + 1], off[r] + REPLAY_PREFIX))
        reps.append((page[s], tier[s], occ[s], lat[s], w_slots[r:r + 1],
                     chan[r:r + 1], n_pages[r:r + 1]))
    launch = replay_launch(reps)
    return launch, timing_replay(*launch)


def fig1_full(trace) -> dict:
    """(e) at phase 4's RSS: Fig. 1's grid, TPP and first touch, one device
    pass each."""
    from repro_torch.kernels.victim_partition import victim_partition
    from repro_torch.sim import api

    victim_partition.launches = 0
    t = time.perf_counter()
    rs = api.run(api.Experiment(
        name="fig1_full", scenarios=[api.Scenario(trace=trace, name="full")],
        fm_fracs=FIG1_GRID,
        policies=[api.PolicySpec(label="tpp"),
                  api.PolicySpec(kind="first_touch", label="first_touch")],
    ))
    wall_s = time.perf_counter() - t
    rows = fig1_rows(rs, scenarios=("full",))["full"]
    return {"pages": trace.rss_pages, "intervals": len(trace), "wall_s": wall_s,
            "victim_partition_launches": victim_partition.launches,
            "rows": {str(f): v for f, v in rows.items()}}


def per_size_engine(dev, thrash) -> dict:
    """(f): a ``pool_factory`` scenario (the port's TieredPagePool through
    functools.partial) against the device sweep's records, every kind."""
    import functools

    from repro_torch.sim import api
    from repro_torch.tiering.page_pool import TieredPagePool

    fracs = (1.0, 0.5, 0.266)
    kinds = ("tpp", "admission", "thrash_guard", "first_touch")
    policies = [api.PolicySpec(kind=k, label=k) for k in kinds]
    t = time.perf_counter()
    per_size = api.run(api.Experiment(
        name="per_size", collect_configs=True, fm_fracs=fracs, policies=policies,
        scenarios=[api.Scenario(trace=thrash, name="thrash", kswapd_batch=256,
                                pool_factory=functools.partial(
                                    TieredPagePool, hotness_halflife=2.0))],
    ))
    per_size_s = time.perf_counter() - t
    sweep = api.run(api.Experiment(
        name="per_size", collect_configs=True, fm_fracs=fracs, policies=policies,
        scenarios=[api.Scenario(trace=thrash, name="thrash", kswapd_batch=256)],
    ))
    check(per_size.backends == ("simulate",) and sweep.backends == ("torch_sweep",),
          f"backends {per_size.backends} / {sweep.backends}")

    def strip(rows):
        return [{**r, "cell": r["cell"][:3]} for r in rows]

    check(strip(runs_plain(per_size)) == strip(runs_plain(sweep)),
          "the per-size engine and the device sweep differ")
    return {"cells": len(per_size.runs), "per_size_s": per_size_s,
            "migrations": {r.policy + "@" + str(r.fm_frac): r.result.migrations
                           for r in per_size.runs}}


def timing_phase(dev, traces: dict, full_trace) -> dict:
    """Phase 12: the replay kernel against its plain version, calibration
    and the fidelity quick contract (CPU == CUDA), the fidelity experiment
    and Fig. 1 at their defaults, Fig. 1 at phase 4's RSS, the per-size
    engine against the device sweep, and the timing lane at real size."""
    import torch

    from repro_torch.kernels.timing_replay import timing_replay
    from repro_torch.kernels.victim_partition import victim_partition
    from repro_torch.sim.costmodel import OPTANE_LIKE
    from repro_torch.timing import calibrate

    seconds = {}
    out = {"seconds": seconds}
    # --- (b) calibration, both lanes
    t = time.perf_counter()
    with ReplayRecorder() as cal_rec:
        cal = calibrate(OPTANE_LIKE, max_events=FIDELITY_MAX_EVENTS, device=dev)
    with ReplayRecorder() as cal_cpu_rec, one_cpu_thread():
        cal_cpu = calibrate(OPTANE_LIKE, max_events=FIDELITY_MAX_EVENTS, device="cpu")
    check(cal.to_dict() == cal_cpu.to_dict(), "calibrate: the CPU and CUDA lanes differ")
    check(all(v < RESIDUAL_BOUND for v in cal.residuals.values()),
          f"calibration residuals {cal.residuals} reach {RESIDUAL_BOUND}")
    out["calibration"] = cal.to_dict()
    seconds["calibrate_s"] = time.perf_counter() - t

    # --- (c) the fidelity quick contract, both lanes
    t = time.perf_counter()
    with ReplayRecorder() as quick_rec:
        quick = fidelity_quick(dev)
    with ReplayRecorder() as quick_cpu_rec, one_cpu_thread():
        check(fidelity_quick("cpu") == quick, "fidelity quick contract: the CPU and "
              "CUDA lanes differ")
    out["quick_regimes"] = {name: {r: len(ds) for r, ds in q["regimes"].items()}
                            for name, q in quick.items() if name != "calibration"}
    seconds["quick_s"] = time.perf_counter() - t

    plain = PlainReplays()
    try:
        # --- (d) the fidelity experiment at its defaults, on the card; its
        # first launch over more than one block of replays goes to the plain
        # version beside the phase
        t = time.perf_counter()
        victim_partition.launches = 0
        timing_replay.launches = 0
        with ReplayRecorder(min_replays=REPLAY_BLOCK) as fid_rec:
            fid = fidelity_run(traces, cal, dev)
        out["fidelity"] = fid
        out["launches_fidelity"] = victim_partition.launches
        out["launches_timing_replay"] = timing_replay.launches
        check(out["launches_timing_replay"] > 0, "the fidelity path never launched timing_replay")
        check(out["launches_fidelity"] > 0, "the fidelity model lane never launched "
              "victim_partition")
        check(len(fid_rec.calls) == 1, f"no fidelity launch spans more than {REPLAY_BLOCK} "
              "replays")
        args, got, _ = fid_rec.calls[0]
        plain.submit(f"a fidelity launch of {got.numel()} replays", args, got,
                     chunk=-(-got.numel() // PLAIN_WORKERS))
        del fid_rec
        seconds["fidelity_s"] = time.perf_counter() - t

        # --- (e) Fig. 1 at its defaults, both lanes; then at phase 4's RSS
        t = time.perf_counter()
        victim_partition.launches = 0
        fig1 = fig1_run(traces, device=dev)
        out["launches_fig1"] = victim_partition.launches
        check(out["launches_fig1"] > 0, "Fig. 1 never launched victim_partition")
        check(runs_plain(fig1_run(traces, device="cpu")) == runs_plain(fig1),
              "Fig. 1: the CPU and CUDA lanes differ")
        rows = fig1_rows(fig1)
        out["fig1"] = {n: {str(f): v for f, v in r.items()} for n, r in rows.items()}
        out["fig1_bfs_summary"] = {
            "tpp_loss@0.895": rows["bfs"][0.895]["tpp_loss"],
            "ft_loss@0.895": rows["bfs"][0.895]["ft_loss"],
            "tpp_loss@0.266": rows["bfs"][0.266]["tpp_loss"],
            "paper": FIG1_PAPER,
        }
        seconds["fig1_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["fig1_full"] = fig1_full(full_trace)
        seconds["fig1_full_s"] = time.perf_counter() - t

        # --- (f) the per-size engine through pool_factory == the device sweep
        t = time.perf_counter()
        out["per_size"] = per_size_engine(dev, traces["thrash"])
        seconds["per_size_s"] = time.perf_counter() - t

        # --- (g) the timing lane at real size; its first (whole) replay and
        # a launch of every replay's prefix go to the plain version
        t = time.perf_counter()
        out["timing_full"], (args, got) = timing_full(dev, full_trace)
        plain.submit(f"the whole first replay at {full_trace.rss_pages} pages "
                     f"({out['timing_full']['events_per_interval'][0]} events)",
                     sub_launch(args, 0, 1), got[:1], chunk=1)
        prefix = prefix_launch(args)
        plain.submit(f"the first {REPLAY_PREFIX} events of each of {got.numel()} "
                     "real-size replays, one launch", *prefix, chunk=1)
        del args, got
        seconds["timing_full_s"] = time.perf_counter() - t

        # --- (a) the replay kernel against its plain version
        t = time.perf_counter()
        out["replay_checks"] = replay_checks(dev, cal_rec.calls + quick_rec.calls,
                                             cal_cpu_rec.calls + quick_cpu_rec.calls,
                                             plain, prefix)
    finally:
        plain.close()
    # timed on the quick contract's largest launch: the kernel by CUDA events,
    # the plain version by the CPU lane's call on the same inputs (one thread)
    k = max(range(len(quick_rec.calls)), key=lambda i: quick_rec.calls[i][0][0].numel())
    args = quick_rec.calls[k][0]
    ms = cuda_ms(lambda: timing_replay(*args), repeats=10, warmup=1)
    plain_ms = quick_cpu_rec.calls[k][2] * 1e3
    out["replay_timed"] = {"ms": ms, "plain_ms": plain_ms, **replay_cost(args)}
    seconds["replay_checks_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print("chip_smoke: src/repro_torch is missing next to this script; "
              "run it from the root of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    global SWEEP_FRACS, QWEN3_1_7B_PAGE, QWEN3_1_7B_QUERY_HEADS
    SWEEP_FRACS = tuple(float(f) for f in np.round(np.arange(1.0, 0.0, -0.05), 3))
    from repro_torch.configs import get_config

    qwen3 = get_config("qwen3-1.7b")
    QWEN3_1_7B_PAGE = dict(n_groups=qwen3.num_layers, page_size=16,
                           kv_heads=qwen3.num_kv_heads, head_dim=qwen3.head_dim)
    QWEN3_1_7B_QUERY_HEADS = qwen3.num_heads
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed")
    card = smi.stdout.strip().splitlines()[0]
    log(f"== card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import _build
    from repro_torch.kernels.victim_partition import victim_partition

    t = time.perf_counter()
    libs = _build.build()
    log(f"== 1 build: {len(libs)} source(s) in {time.perf_counter() - t:.2f} s")
    for name in _build.build_log:
        for k in ptxas_registers(name):
            log(f"   {name}: {k['kernel']}: {k['registers']} registers, "
                f"{k['spill_bytes']} bytes spilled")

    t = time.perf_counter()
    worst = kernel_checks(dev)
    migrate_err = migrate_checks(dev)
    probe_err = probe_checks(dev)
    attention_err = attention_checks(dev)
    flash_err = flash_checks(dev)
    wkv6_err = wkv6_checks(dev)
    log(f"== 2 kernels == plain versions: victim_partition and migrate_pages "
        f"exact (max |diff| {worst}, {migrate_err}), strided_probe within its "
        f"float64 rounding bound (max |err| {probe_err}), "
        f"paged_decode_attention within 2e-4 f32 / 2e-2 bf16 (max |diff| "
        f"{attention_err}), flash_attention within 2e-4 f32 / 2e-2 bf16 (max "
        f"|diff| {flash_err}), wkv6 within 3e-4 f32 / 2e-2 bf16 (max |diff| "
        f"{wkv6_err}) in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    lanes = lanes_agree()
    serving_lanes = serving_lanes_agree()
    model_lanes = model_lanes_agree(dev)
    log(f"== 3 CPU lane == CUDA lane, bit for bit: sweep {lanes}, serving "
        f"{serving_lanes}; models at full width, {LANE_LAYERS} layers, float32, "
        f"within {LANE_TOL}: {json.dumps(model_lanes)} in "
        f"{time.perf_counter() - t:.2f} s")

    capture: dict = {}
    victim_partition.launches = 0
    t = time.perf_counter()
    summary = main_path(dev, capture)
    launches = victim_partition.launches
    summary["victim_partition_launches"] = launches
    check(launches > 0, "the main path never launched victim_partition")
    check(summary["chunked_step_count"] == 0, "chunked steps on the main path")
    log(f"== 4 main path at full size in {time.perf_counter() - t:.2f} s")
    log("   " + json.dumps(summary))

    vp = time_victim_partition(capture)
    log(f"== 5 victim_partition on the main path's inputs: {json.dumps(vp)}")

    serve_capture: dict = {}
    t = time.perf_counter()
    serving = serving_full_width(dev, serve_capture)
    log(f"== 6 tiered serving at full width (Qwen3-1.7B KV pages, "
        f"{SERVE_TOTAL_PAGES} pinned host pages, {SERVE_HBM_PAGES} HBM slots, "
        f"{SERVE_ROUNDS} rounds) in {time.perf_counter() - t:.2f} s; every "
        f"page's content survived")
    log("   " + json.dumps(serving))

    t = time.perf_counter()
    pa = attention_on_last_batch(dev, serve_capture)
    mig = time_migrate(dev, serve_capture)
    probe = probe_tiers(dev)
    log(f"== 7 serving kernels timed on the inputs the card sees in "
        f"{time.perf_counter() - t:.2f} s")
    log("   paged_decode_attention: " + json.dumps(pa))
    log("   migrate_pages: " + json.dumps(mig))
    log("   strided_probe: " + json.dumps(probe))
    # phase 6's pools go (their pinned blocks stay in PyTorch's host cache)
    serve_capture.clear()
    torch.cuda.empty_cache()

    model_capture: dict = {}
    served = {}
    for name in MODEL_FAMILIES:
        t = time.perf_counter()
        served[name] = serve_model(name, dev, model_capture)
        log(f"== 8 model serving at full width, {name}: {SERVE_BATCH} requests of "
            f"{PROMPT_LEN} + {NEW_TOKENS} tokens in {time.perf_counter() - t:.2f} s")
        log("   " + json.dumps(served[name]))

    t = time.perf_counter()
    fa = time_flash(model_capture)
    wk = time_wkv6(model_capture)
    del model_capture
    log(f"== 9 model kernels timed on the first layer's serving inputs in "
        f"{time.perf_counter() - t:.2f} s")
    log("   flash_attention: " + json.dumps(fa))
    log("   wkv6: " + json.dumps(wk))

    t = time.perf_counter()
    paper = paper_experiment(dev)
    paper_db, paper_traces = paper.pop("db"), paper.pop("traces")
    log(f"== 10 the paper's experiment (Figs. 3-7, tau = {PAPER_TAU}) on the "
        f"card, CPU lane == CUDA lane, in {time.perf_counter() - t:.2f} s")
    for name, row in paper["rows"].items():
        log(f"   {name}: " + json.dumps(row))
    log(f"   mean saving over the paper's five: {paper['mean_saving']:.4f} "
        f"(paper {PAPER_MEAN_SAVING})")
    for kind, row in paper["knee"].items():
        log(f"   thrash knee, {kind}: " + json.dumps(row))
    log("   btree at full size: " + json.dumps(paper["big_btree"]))
    log(f"   database: {paper['db_records']} records; victim_partition "
        f"launches {paper['victim_partition_launches']}; seconds "
        + json.dumps(paper["seconds"]))

    t = time.perf_counter()
    ff = faults_and_fleets(dev, paper_db, paper_traces["thrash"], capture["trace"],
                           summary["profile_sweep_split"])
    ff["seconds"]["phase_s"] = time.perf_counter() - t
    log(f"== 11 the fault model and the fleet on the card, CPU lane == CUDA "
        f"lane, in {ff['seconds']['phase_s']:.2f} s")
    for level, rows in ff["fault_rows"].items():
        for kind, row in rows.items():
            log(f"   faults {level}/{kind}: " + json.dumps(row))
    log("   faults harsh at full size: " + json.dumps(ff["fault_full"]))
    for mix, row in ff["fleet_mixes"].items():
        log(f"   fleet {mix}: " + json.dumps(row))
    log("   fleet skewed at full size: " + json.dumps(ff["fleet_full"]))
    log("   MultiTenantKV: " + json.dumps(ff["fleet_kv"]))
    log(f"   victim_partition launches: faults {ff['fault_launches']} + "
        f"{ff['fault_full']['victim_partition_launches']} (full size), fleets "
        f"{ff['fleet_launches']} + "
        + " + ".join(str(ff["fleet_full"][p]["victim_partition_launches"])
                     for p in ("static", "fleet_tuna"))
        + " (full size); seconds " + json.dumps(ff["seconds"]))

    t = time.perf_counter()
    tm = timing_phase(dev, paper_traces, capture.pop("trace"))
    tm["seconds"]["phase_s"] = time.perf_counter() - t
    log(f"== 12 the per-size engine, runners and the timing engine on the card, "
        f"in {tm['seconds']['phase_s']:.2f} s")
    log("   (a) timing_replay == replay_ref, bit for bit: "
        + json.dumps(tm["replay_checks"]) + "; timed: " + json.dumps(tm["replay_timed"]))
    log("   (b) calibration, CPU lane == CUDA lane: " + json.dumps(tm["calibration"]))
    log("   (c) fidelity quick contract, CPU lane == CUDA lane; regime counts "
        + json.dumps(tm["quick_regimes"]))
    for reg, row in tm["fidelity"]["regimes"].items():
        log(f"   (d) fidelity regime {reg}: " + json.dumps(row))
    for name, row in tm["fidelity"]["rows"].items():
        log(f"   (d) fidelity {name}: " + json.dumps(row))
    log(f"   (d) divergence concentrated outside the balanced regime: "
        f"{tm['fidelity']['concentrated']}")
    for name, rows in tm["fig1"].items():
        log(f"   (e) fig1 {name}, CPU lane == CUDA lane: " + json.dumps(rows))
    log("   (e) fig1 bfs summary: " + json.dumps(tm["fig1_bfs_summary"]))
    log("   (e) fig1 at full size: " + json.dumps(tm["fig1_full"]))
    log("   (f) pool_factory == device sweep: " + json.dumps(tm["per_size"]))
    log("   (g) timing lane at full size: " + json.dumps(tm["timing_full"]))
    log(f"   launches: timing_replay {tm['launches_timing_replay']} (fidelity), "
        f"victim_partition {tm['launches_fidelity']} (fidelity), "
        f"{tm['launches_fig1']} (fig1); seconds " + json.dumps(tm["seconds"]))

    promote = mig["promote"]
    kernels = [{
        "name": "victim_partition",
        "route": "cuda",
        "source": "src/repro_torch/csrc/victim_partition.cu",
        "replaces": "src/repro/kernels/demote_rank.py:71",
        "launches": launches,
        "max_abs_err": max(worst, vp["max_abs_err"], paper["max_abs_err"]),
        "ms": vp["ms"],
        "plain_ms": vp["plain_ms"],
        "bound_ms": vp["bound_ms"],
        "bound_by": vp["bound_by"],
        "library_ms": vp["library_ms"],
        "device_ms": vp["device_ms"],
        "cumsum_ms": vp["cumsum_ms"],
        "launches_paper": paper["victim_partition_launches"],
        "launches_big_btree": paper["big_btree"]["victim_partition_launches"],
        "launches_faults": ff["fault_launches"],
        "launches_faults_full": ff["fault_full"]["victim_partition_launches"],
        "launches_fleets": ff["fleet_launches"],
        "launches_fleet_full": sum(ff["fleet_full"][p]["victim_partition_launches"]
                                   for p in ("static", "fleet_tuna")),
        "launches_fig1": tm["launches_fig1"],
        "launches_fig1_full": tm["fig1_full"]["victim_partition_launches"],
        "launches_fidelity": tm["launches_fidelity"],
    }, {
        "name": "migrate_pages",
        "route": "cuda",
        "source": "src/repro_torch/csrc/page_migrate.cu",
        "replaces": "src/repro/kernels/page_migrate.py:44",
        "launches": serving["migrate_pages_launches"],
        "max_abs_err": migrate_err,
        "ms": promote["ms"],
        "plain_ms": promote["plain_ms"],
        "bound_ms": promote["bound_ms"],
        "bound_by": "bytes",
        # no single PyTorch call copies pinned host pages into device slots;
        # index_copy_ is timed device to device beside the kernel instead
        "library_ms": None,
        "pages": promote["pages"],
        "device_ms": promote["device_ms"],
        "copy_engine_ms": promote["copy_engine_ms"],
        "host_ms": mig["host_ms"],
        "d2d_device_ms": mig["d2d"]["device_ms"],
        "d2d_index_copy_device_ms": mig["d2d"]["index_copy_device_ms"],
        "d2d_bound_ms": mig["d2d"]["bound_ms"],
        "launches_fleet_kv": ff["fleet_kv"]["migrate_pages_launches"],
    }, {
        "name": "strided_probe",
        "route": "cuda",
        "source": "src/repro_torch/csrc/strided_probe.cu",
        "replaces": "src/repro/kernels/strided_probe.py:73",
        **{k: probe[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms", "device_ms",
                                 "batch_ms", "host_gb_per_s",
                                 "copy_engine_host_gb_per_s")},
        "case": "mixed, ai_iters 64",
    }, {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:113",
        **{k: pa[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by", "library_ms")},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:110",
        "launches": served["qwen3-1.7b"]["launches"]["flash_attention"],
        "max_abs_err": max(flash_err, fa["max_abs_err"]),
        **{k: fa[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }, {
        "name": "wkv6",
        "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6_chunk.py:106",
        "launches": served["rwkv6-3b"]["launches"]["wkv6"],
        "max_abs_err": max(wkv6_err, wk["max_abs_err"]),
        **{k: wk[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "device_ms", "batch_ms")},
    }, {
        "name": "timing_replay",
        "route": "cuda",
        "source": "src/repro_torch/csrc/timing_replay.cu",
        # no TPU counterpart: the JAX package's numpy replay loop
        "replaces": "src/repro/timing/engine.py:218",
        "tpu_kernel": None,
        "launches": tm["launches_timing_replay"],
        "launches_full_size": tm["timing_full"]["launches"],
        "max_abs_err": tm["replay_checks"]["max_abs_err"],
        **{k: tm["replay_timed"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "events", "replays")},
        "library_ms": None,
        "full_size_ms": tm["timing_full"]["replay_s"] * 1e3,
        "full_size_events": tm["timing_full"]["events"],
        "full_size_bound_ms": tm["timing_full"]["bound_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
