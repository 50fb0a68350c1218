"""The readings that a cell's limits are set from, on the card at the
cell's own size: each seed's numbers compared, for the program (sound
runs), for the control (the reference computed in float8 e4m3 in the
program's place) and for a fault planted under the program:

    python3 bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
        [--control] [--fault half_batch|state_unchanged|token_altered]

One process a seed, as a run; each prints one JSON line of its readings."""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from bench.harness import env, faults, spec  # noqa: E402
from bench.harness.runner import run_cell  # noqa: E402


def main(argv) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=faults.NAMES, default=None)
    args = p.parse_args(argv)
    env.set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    for seed in args.seeds:
        out = run_cell(args.workload, spec.config(bench, cell["config"]), spec.mix(cell["traffic"]),
                       spec.limits(args.workload), [], seed, args.seconds, False,
                       torch.device("cuda", 0), time.perf_counter(), cell["chips"],
                       fault=args.fault, control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "fault": args.fault, "checks": out["checks"],
                          "sound": out.get("sound")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
