#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA device and
the CUDA toolkit::

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. build every CUDA source under ``src/repro_torch/csrc`` with nvcc;
2. every kernel against its plain PyTorch version on the card, exactly,
   over seeded inputs (ragged rows, zero and over-demand, strided rows,
   the main path's full shape);
3. the CPU lane == the CUDA lane, bit for bit, through the port's ``run``:
   an untuned sweep and a tuned shrink on small thrash traces;
4. the main path at full size through the entry points a user calls
   (``repro_torch.sim.api.run``, ``repro_torch.core.tuner.build_database``):
   profile sweep over 20 sizes, database build, TPP vs TPP+Tuna, with
   the kernels' launch counts set to 0 just before and read just after;
5. each kernel timed on the inputs the main path gave it (CUDA events,
   median of repeated runs) beside its plain version and its bound.

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
    log(f"== 2 kernels == plain versions, exact (max |diff| {worst}) "
        f"in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    lanes = lanes_agree()
    log(f"== 3 CPU lane == CUDA lane, bit for bit: {lanes} "
        f"in {time.perf_counter() - t:.2f} s")

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
