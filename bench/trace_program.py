"""One run of one cell on the card with the program's own spans and
counters on, each kernel put down to its span and phase:

    python3 bench/trace_program.py --workload <cell> --seed <n> --seconds <s> [--out <file>]

from the root of a checkout. The run is the cell's (its set-up, then
``--seconds`` of its loop), each traced by
``harness.attribute.ProgramWindow``; the reference check does not run.
Standard error gets the attribution's shares of each; the last line of
standard output is a JSON object: the cell's end-to-end and per-layer
metrics as ``bench/run.py`` reads them (the window traced), the
program-span metrics (``attribute.metrics``), the idle gaps by span, the
set-up's device seconds by top-level span, each span's host seconds (the
decode cell's fill is ``rt.prefill``) and its heaviest kernels under no
program span and, for an MoE cell, each
step's host seconds, dispatch device ms and dropped share. ``--out`` writes the attribution in full
(device seconds by span and phase, by step, the heaviest kernels of
each, the set-up's kernels by span and phase)."""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench.harness import attribute, env, spec  # noqa: E402
from bench.harness.runner import log  # noqa: E402


def part_of(bench: dict, cell: str):
    """The suffix of the cell's split training rate (``moe``, ``dense``), or None."""
    for m in spec.metrics_for(bench, cell, False):
        if m["name"].startswith("train_tokens_per_s."):
            return m["name"].split(".", 1)[1]
    return None


def step_table(summary: dict, traced: dict) -> list:
    """Each training step of the window: [host s of its ``step`` span,
    ``rt.moe.dispatch`` device ms, dropped share %]."""
    prog = summary["program"]
    host = prog["host_s"].get("step", [])
    disp = prog["steps"].get("rt.moe.dispatch", {})
    calls = len(prog["counters"].get("moe.picks", []))
    n = traced["steps"]
    series = attribute.moe_series(prog["counters"], calls // n) if n and calls else []
    rows = []
    for i, h in enumerate(host):
        picks, kept, _ = series[i] if i < len(series) else (0, 0, 0)
        rows.append([h, 1e3 * disp.get(f"step {i}", 0.0),
                     100.0 * (picks - kept) / picks if picks else None])
    return rows


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    env.set_cache_dirs(spec.ROOT)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available():
        log("no result: no CUDA device")
        return 2
    device = torch.device("cuda", 0)
    log(f"card {torch.cuda.get_device_name(device)}, power limit {env.power_limit_w()} W")
    run = attribute.trace_cell(args.workload, spec.config(bench, cell["config"]),
                               spec.mix(cell["traffic"]), args.seed, args.seconds, device, T0)
    summary, measured = run["trace"], run["measured"]
    metrics = {}
    for m in spec.metrics_for(bench, args.workload, False) + spec.metrics_for(
            bench, args.workload, True):
        if m["name"] != "setup_s":
            metrics[m["name"]] = spec.metric_reader(m["name"])(run)
    metrics.update(attribute.metrics(run, part_of(bench, args.workload)))
    prog = summary["program"]
    out = {"metrics": metrics, "busy_s": summary["busy_s"], "window_s": summary["window_s"],
           "idle_gaps": summary["breakdown"]["idle_gaps"], "top": prog["top"],
           "by_span": prog["by_span"], "device": torch.cuda.get_device_name(device),
           "power_limit_w": env.power_limit_w()}
    if "steps" in measured and prog["counters"]:
        out["steps"] = step_table(summary, measured)
        for i, (host, disp, dropped) in enumerate(out["steps"]):
            log(f"step {i}: {host:.4f} s, rt.moe.dispatch {disp:.2f} device ms, "
                f"dropped {dropped}%")
    if "steps" in measured:
        four = sum(prog["top"].get(f"rt.train.{t}", 0.0)
                   for t in ("forward", "backward", "clip", "adamw"))
        out["train_spans_over_step"] = four / prog["marks"]["step"] if prog["marks"].get(
            "step") else None
    out["splits"] = {n: attribute.kernel_split(prog, n)
                     for n in ("indexing_backward", "elementwise", "gemm")}
    setup = run["setup_trace"]["program"]
    out["setup"] = {"s": run["setup_s"], "busy_s": run["setup_trace"]["busy_s"],
                    "top": setup["top"],
                    "host_s": {k: sum(v) for k, v in setup["host_s"].items()},
                    "no_span": sorted(setup["kernels"].get(attribute.NO_SPAN, {}).items(),
                                      key=lambda kv: -kv[1])[:5]}
    out["runtime_s"] = prog["runtime"]
    out["host_ms_median"] = {k: 1e3 * statistics.median(v) for k, v in prog["host_s"].items()}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(out, kernels=prog["kernels"], steps_by_span=prog["steps"],
                           counters=prog["counters"], marks=prog["marks"],
                           bench_alone=prog["bench_alone"], setup_kernels=setup["kernels"]), f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
