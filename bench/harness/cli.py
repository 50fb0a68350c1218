"""``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell on the card. The last line of standard
output is the result's JSON object; the last lines of standard error the
numbers compared, each beside its limit. Without a card (or with fewer
cards than the cell asks for), or with JAX or the JAX package loaded once
the window has closed, it exits with another code than 0 and prints no
result."""

from __future__ import annotations

import argparse
import json
import sys

from bench.harness import env, spec
from bench.harness.runner import log, run_cell


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    env.set_cache_dirs(spec.ROOT)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"no result: the cell needs {cell['chips']} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    device = torch.device("cuda", 0)
    power = env.power_limit_w()
    log(f"card {torch.cuda.get_device_name(device)}, power limit {power} W, "
        f"torch {torch.__version__}")
    result = run_cell(args.workload, spec.config(bench, cell["config"]), spec.mix(cell["traffic"]),
                      spec.limits(args.workload), spec.metrics_for(bench, args.workload,
                                                                   bool(args.trace)),
                      args.seed, args.seconds, bool(args.trace), device, t0, cell["chips"])
    result["device"]["power_limit_w"] = power
    loaded = env.forbidden_modules()
    if loaded:
        log(f"no result: modules of JAX or the JAX package loaded: {loaded}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
