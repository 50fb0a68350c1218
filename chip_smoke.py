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
   over-demand, strided rows; device, pinned-host and mixed pools, pages
   that are not a multiple of 16 bytes), ``strided_probe`` against float64
   within its rounding bound, ``paged_decode_attention`` within a stated
   tolerance (holes, partial pages, grouped heads, a fully masked row);
3. the CPU lane == the CUDA lane, bit for bit: the sweep through ``run``
   (an untuned sweep and a tuned shrink), and the tiered serving loop at
   the demo's page counts and a narrow page (summary, history, tuner
   decisions, watermark log, slot map, tiers, heat, both pools' bits);
4. the sweep's main path at full size through the entry points a user
   calls (``repro_torch.sim.api.run``, ``build_database``), with the
   ``victim_partition`` count set to 0 just before and read just after;
5. ``victim_partition`` timed on the main path's inputs;
6. tiered serving at full width through the port's public classes
   (``repro_torch.serving``): Qwen3-1.7B KV pages, a pinned host pool and
   an HBM pool, 800 tuned rounds, with the ``migrate_pages`` count set to
   0 just before and read just after; every page's content must survive;
7. the serving kernels on the inputs the card sees: ``paged_decode_
   attention`` over the last round's batch straight out of the HBM pool
   (every layer group driven once, counted), ``migrate_pages`` on the
   run's largest promotion and demotion, ``strided_probe`` over a 1 GiB HBM
   pool and a 1 GiB pinned host pool (six cases driven once, counted);
   CUDA events, median of repeated runs, beside the plain version, the
   bound and a PyTorch yardstick where one call computes the same function.

The last three lines of standard output are the kernels' JSON line, the
card's name and power limit (``nvidia-smi``), and
``{"ok": true, "device": {...}}``. Nothing of JAX and nothing of the JAX
package is imported.
"""

from __future__ import annotations

import json
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
# The page at full width is Qwen3-1.7B's KV (src/repro/configs/qwen3_1_7b.py:
# 28 layers, 16 query heads, 8 KV heads, head_dim 128), 16 tokens a page, in
# bfloat16: 1,835,008 bytes a page, 7.52 GB of host pool, 1.88 GB of HBM.
QWEN3_1_7B_PAGE = dict(n_groups=28, page_size=16, kv_heads=8, head_dim=128)
QWEN3_1_7B_QUERY_HEADS = 16
# the CPU lane == CUDA lane check runs the demo's page counts at a narrow
# page: the control plane never looks at the width
NARROW_PAGE = dict(n_groups=1, page_size=16, kv_heads=1, head_dim=8)
# the micro-benchmark probe: two 1 GiB pools of 4 KiB pages, one in HBM and
# one in pinned host memory
PROBE_PAGES, PROBE_PAGE_ELEMS = 262_144, 1024


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


# ------------------------------------------------------------ phase 2
def kernel_checks(dev) -> int:
    """victim_partition == its plain version on the card over seeded rows;
    returns the largest absolute difference seen (must be 0)."""
    import numpy as np
    import torch

    from repro_torch.kernels.victim_partition import (
        victim_partition,
        victim_partition_plain,
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
    strided = torch.from_numpy((rng.random((4, 9001)) < 0.5).astype(np.int32))
    cases.append((strided.to(dev)[:, 3:8999], np.array([0, 1, 2000, 9000])))
    full = (rng.random((20, FULL_RSS)) < 0.6).astype(np.int32)
    cases.append(
        (torch.from_numpy(full).to(dev), rng.integers(0, 2_500_000, size=20))
    )
    for fast01, demand in cases:
        d = torch.from_numpy(np.asarray(demand, dtype=np.int64)).to(dev)
        got = victim_partition(fast01, d)
        torch.cuda.synchronize()
        want = victim_partition_plain(fast01, d)
        diff = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, diff)
        check(diff == 0 and got.shape == fast01.shape,
              f"victim_partition differs from its plain version on "
              f"{tuple(fast01.shape)}: max |diff| {diff}")
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
        out[device] = (runs_plain(untuned), runs_plain(tuned))
    cpu, gpu = out["cpu"], out["cuda"]
    check(cpu[0] == gpu[0], "untuned sweep: CPU and CUDA lanes differ")
    check(cpu[1] == gpu[1], "tuned shrink: CPU and CUDA lanes differ")
    moves = len(gpu[1][0]["watermark_log"])
    check(moves > 0, "tuned shrink: the tuner never moved the watermarks")
    demoted = sum(
        r["stats"]["pgdemote_kswapd"] + r["stats"]["pgdemote_direct"]
        for r in gpu[0]
    )
    check(demoted > 0, "untuned sweep: no demotion, the victim path was not run")
    return {"cells": len(gpu[0]) + len(gpu[1]), "watermark_moves": moves,
            "demotions": demoted}


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
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
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
    multiple of 16 bytes; one page and every slot. Returns the largest
    absolute difference (must be 0)."""
    import torch

    from repro_torch.kernels.page_migrate import migrate_pages, migrate_pages_plain

    g = torch.Generator().manual_seed(12)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for page in ((7,), (3, 5), (1029,), (28, 2, 16, 8, 16)):
            src = torch.randn((12,) + page, generator=g).to(dtype)
            dst = torch.randn((12,) + page, generator=g).to(dtype)
            for n in (1, 12):
                di = torch.randperm(12, generator=g)[:n]
                si = torch.randperm(12, generator=g)[:n]
                want = migrate_pages_plain(dst.clone(), src, di, si)
                for way in ("d2d", "h2d", "d2h"):
                    s = src.pin_memory() if way == "h2d" else src.to(dev)
                    d = dst.pin_memory() if way == "d2h" else dst.to(dev)
                    migrate_pages(d, s, di, si)
                    torch.cuda.synchronize()
                    got = d.cpu()
                    diff = float((got.float() - want.float()).abs().max())
                    worst = max(worst, diff)
                    check(torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
                          f"migrate_pages {way} {dtype} page {page} n={n} "
                          f"differs from its plain version (max |diff| {diff})")
    return worst


def probe_tolerance(terms, ai_iters: int, n_pages: int, sm_count: int):
    """The probe's float32 rounding bound against float64, per column:
    each term is ai_iters fused multiply-adds of one sign (relative error
    <= ai_iters u), and the kernel adds the terms in chains of at most
    pages_per_segment + segments additions (relative error <= that many u
    of the sum of |terms|), u = 2**-24."""
    from repro_torch.kernels.strided_probe import segments

    per_seg = segments(n_pages, PROBE_PAGE_ELEMS, sm_count) if n_pages else 1
    n_seg = -(-n_pages // per_seg) if n_pages else 0
    return (ai_iters + per_seg + n_seg + 2) * FP32_EPS * terms


def probe_checks(dev) -> float:
    """strided_probe against its float64 plain version within the derived
    bound, for ai_iters in {0, 1, 7, 64}, an empty fast list and an empty
    slow list, with the slow pool in pinned host memory. Returns the
    largest absolute error."""
    import torch

    from repro_torch.kernels.strided_probe import strided_probe, strided_probe_plain

    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(13)
    fast = torch.randn((512, PROBE_PAGE_ELEMS), generator=g).to(dev)
    slow = torch.randn((512, PROBE_PAGE_ELEMS), generator=g).pin_memory()
    worst = 0.0
    for ai in (0, 1, 7, 64):
        for nf, ns in ((40, 30), (0, 9), (9, 0), (3000, 1000)):
            fi = torch.randint(0, 512, (nf,), generator=g)
            si = torch.randint(0, 512, (ns,), generator=g)
            got = strided_probe(fast, slow, fi, si, ai)
            torch.cuda.synchronize()
            want = strided_probe_plain(fast, slow, fi, si, ai, dtype=torch.float64)
            terms = strided_probe_plain(fast.abs(), slow.abs(), fi, si, ai,
                                        dtype=torch.float64)
            err = (got.double() - want).abs()
            worst = max(worst, float(err.max()))
            check(bool((err <= probe_tolerance(terms, ai, nf + ns, sm)).all()),
                  f"strided_probe ai={ai} nf={nf} ns={ns}: error "
                  f"{float(err.max())} beyond its rounding bound")
    return worst


def attention_checks(dev) -> float:
    """paged_decode_attention == its plain version within 2e-4 (float32)
    or 2e-2 (bfloat16): holes, partial last pages, a length past the table,
    rep in {1, 2, 4}, hd in {64, 128}, and a fully masked row (zeros).
    Returns the largest absolute difference."""
    import torch

    from repro_torch.kernels.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
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
    migrate_us = sum(e.device_time_total for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "migrate_kernel" in e.name)

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
    """migrate_pages on the largest promotion (pinned host -> HBM) and
    demotion (HBM -> pinned host) batches of the serving run, beside the
    plain version and the PCIe bound; device -> device on the promotion's
    slots beside ``index_copy_``. Run after the serving checks: it rewrites
    those pages."""
    import torch

    from repro_torch.kernels.page_migrate import migrate_pages, migrate_pages_plain

    kv = capture["server"].kv
    page_b = kv.cfg.bytes_per_page
    out = {}
    for way, dst_pool, src_pool in (("promote", kv.hbm, kv.host),
                                    ("demote", kv.host, kv.hbm)):
        if way not in capture:
            continue
        di, si = (torch.as_tensor(x, device=dev) for x in capture[way])
        n = di.numel()
        ms = cuda_ms(lambda: migrate_pages(dst_pool, src_pool, di, si), repeats=20)
        plain_ms = cuda_ms(lambda: migrate_pages_plain(dst_pool, src_pool, di, si),
                           repeats=5, warmup=1)
        bound = n * page_b / PCIE_BYTES_PER_S * 1e3
        out[way] = {"pages": n, "bytes": n * page_b, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "gb_per_s": n * page_b / ms / 1e6}
    di = torch.as_tensor(capture["promote"][0], device=dev)
    rows = kv.hbm[di].clone()
    seq = torch.arange(di.numel(), device=dev)
    d2d_ms = cuda_ms(lambda: migrate_pages(kv.hbm, rows, di, seq), repeats=20)
    index_copy_ms = cuda_ms(lambda: kv.hbm.index_copy_(0, di, rows), repeats=20)
    out["d2d"] = {"pages": di.numel(), "ms": d2d_ms, "index_copy_ms": index_copy_ms,
                  "bound_ms": 2 * di.numel() * page_b / HBM_BYTES_PER_S * 1e3}
    return out


def attention_on_last_batch(dev, capture: dict) -> dict:
    """paged_decode_attention over the last round's batch, straight out of
    the HBM pool: layer group g of every page viewed as K/V
    [slots, 16 tokens, 8 KV heads, 128] (this script's view of a page as
    [28 groups, K/V, 16, 8, 128]; the JAX package defines no in-page
    layout), with 16 query heads. All 28 groups are driven once with the
    launch count set to 0 before and read after; group 0 is checked and
    timed beside the plain version, the K/V byte bound and
    scaled_dot_product_attention over pre-gathered K/V (a yardstick only)."""
    import numpy as np
    import torch

    from repro_torch.kernels.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
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
    ms = cuda_ms(lambda: paged_decode_attention(q, k0, v0, tbl_d, lens_d))
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
    return {
        "launches": launches, "max_abs_err": max(err, 0.0), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "sdpa_max_abs_diff": sdpa_err,
        "batch": len(batch), "pages_per_seq": ppseq, "tokens": tokens,
        "kv_bytes": kv_bytes,
    }


def probe_tiers(dev) -> dict:
    """strided_probe over two 1 GiB pools of 4 KiB pages, one in HBM and
    one in pinned host memory, in a seeded random page order: fast only,
    slow only and half of each, at ai_iters 1 and 64. All six are driven
    once with the launch count set to 0 before and read after, then each
    is checked against the float64 plain version and timed. The per-tier
    GB/s at ai_iters 1 is the micro-benchmark's reading of the two tiers."""
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
        fb, sb = fi.numel() * page_b, si.numel() * page_b
        bytes_ms = max(fb / HBM_BYTES_PER_S, sb / PCIE_BYTES_PER_S) * 1e3
        ops_ms = 2 * ai * (fi.numel() + si.numel()) * PROBE_PAGE_ELEMS / ALU_OPS_PER_S * 1e3
        rows[f"{mix}_ai{ai}"] = {
            "ms": ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "gb_per_s": (fb + sb) / ms / 1e6, "max_abs_err": float(err.max()),
        }
    del fast_abs, slow_abs
    fi, si = mixes["mixed"]
    plain_ms = cuda_ms(lambda: strided_probe_plain(fast, slow, fi, si, 64),
                       repeats=3, warmup=1)
    main = rows["mixed_ai64"]
    return {
        "launches": launches, "max_abs_err": worst, "ms": main["ms"],
        "plain_ms": plain_ms, "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "hbm_gb_per_s": rows["fast_ai1"]["gb_per_s"],
        "host_gb_per_s": rows["slow_ai1"]["gb_per_s"],
        "cases": rows,
    }


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
    global SWEEP_FRACS
    SWEEP_FRACS = tuple(float(f) for f in np.round(np.arange(1.0, 0.0, -0.05), 3))
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
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"   {name}: {line.strip()}")

    t = time.perf_counter()
    worst = kernel_checks(dev)
    migrate_err = migrate_checks(dev)
    probe_err = probe_checks(dev)
    attention_err = attention_checks(dev)
    log(f"== 2 kernels == plain versions: victim_partition and migrate_pages "
        f"exact (max |diff| {worst}, {migrate_err}), strided_probe within its "
        f"float64 rounding bound (max |err| {probe_err}), "
        f"paged_decode_attention within 2e-4 f32 / 2e-2 bf16 (max |diff| "
        f"{attention_err}) in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    lanes = lanes_agree()
    serving_lanes = serving_lanes_agree()
    log(f"== 3 CPU lane == CUDA lane, bit for bit: sweep {lanes}, serving "
        f"{serving_lanes} in {time.perf_counter() - t:.2f} s")

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

    promote = mig["promote"]
    kernels = [{
        "name": "victim_partition",
        "route": "cuda",
        "source": "src/repro_torch/csrc/victim_partition.cu",
        "replaces": "src/repro/kernels/demote_rank.py:71",
        "launches": launches,
        "max_abs_err": max(worst, vp["max_abs_err"]),
        "ms": vp["ms"],
        "plain_ms": vp["plain_ms"],
        "bound_ms": vp["bound_ms"],
        "bound_by": vp["bound_by"],
        "library_ms": vp["library_ms"],
        "cumsum_ms": vp["cumsum_ms"],
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
        "d2d_ms": mig["d2d"]["ms"],
        "d2d_index_copy_ms": mig["d2d"]["index_copy_ms"],
    }, {
        "name": "strided_probe",
        "route": "cuda",
        "source": "src/repro_torch/csrc/strided_probe.cu",
        "replaces": "src/repro/kernels/strided_probe.py:73",
        **{k: probe[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")},
        "case": "mixed, ai_iters 64",
    }, {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:113",
        **{k: pa[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by", "library_ms")},
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
