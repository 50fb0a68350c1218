"""One run of one cell: set-up, the measured window (traced or not), the
peak memory, the check against the reference, the metrics."""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import torch

from bench.harness import compare, spec
from bench.harness.trace import Window
from bench.reference.arch import Arch

RETAKES = 2  # traces taken again where the profiler lost the window's


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell_name: str, config: dict, mix: dict, limits: dict, metric_entries: list,
             seed: int, seconds: float, trace: bool, device, t0: float, chips: int = 1,
             fault: str | None = None, control: bool = False) -> dict:
    """The result's fields (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``breakdown`` when traced, ``checks``)."""
    ctx = SimpleNamespace(cell=cell_name, config=config, mix=mix, arch=Arch.from_config(config),
                          seed=int(seed), device=device, fault=fault, control=control,
                          mark=lambda what: log(f"{what} {time.perf_counter() - t0:.3f} s"))
    kind = spec.kind_module(mix["kind"])
    ctx.mark("imports")
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
        ctx.mark("device ready")
    state = kind.setup(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s")
    with Window(trace, device) as w:
        measured = kind.window(ctx, state, seconds, w)
    summary, traced = w.summary, measured
    for _ in range(RETAKES if trace else 0):
        if summary and summary["events"]:
            break
        log("profiler: no device event in the window's trace; tracing a short window again")
        with Window(True, device) as w2:
            traced = kind.window(ctx, state, max(2.0, seconds / 10), w2)
        summary = w2.summary
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"memory peak {peak} bytes; window {measured['window_s']:.3f} s, "
        f"{measured['attempted']} attempted")
    t_check = time.perf_counter()
    numbers = kind.check(ctx, state, measured)
    log(f"check {time.perf_counter() - t_check:.3f} s; read {numbers}")
    checks = compare.judge(numbers, limits)
    run = {"arch": ctx.arch, "mix": mix, "config": config, "setup_s": setup_s,
           "measured": measured, "traced": traced, "trace": summary}
    metrics = {}
    for m in metric_entries:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": compare.passed(checks), "attempted": measured["attempted"],
           "failed": measured["failed"], "metrics": metrics, "device": dev_info}
    if trace and summary is not None:
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        out["breakdown"] = summary["breakdown"]
    if control:
        out["sound"] = getattr(ctx, "sound", None)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return out
