"""Time the timing replay of several source trees on one card, in turns.

For each TREE (the root of a checkout: ``.`` or an unpacked other commit),
in a fresh process that imports that tree's ``repro_torch`` and
``chip_smoke.py``: the real-size timing lane of ``chip_smoke.py`` phase 12
(g) (phase 4's 3,250,585-page trace under TPP at 0.75, every interval in
one ``timing_replay`` call: its ``replay_s``, then the launch timed by CUDA
events, median of FULL_REPEATS), the fidelity quick contract's largest
launch (median of QUICK_REPEATS), and the chain's links
(``chain_latency_ns`` at the real-size page count). Where the tree splits
the call into ``replay_prepass`` and ``replay_walk``, also the synthetic
CASES (seeded numpy streams of the real-size lane's shapes): the wrapper's
argument check, the pre-pass, the walker and the whole call apart (median
of CASE_REPEATS), and the walker's ns a window of the longest replay. The
trees must give the same makespans bit for bit; the script fails
otherwise.

Prints the card's name and power limit, one JSON line a tree run, and a
JSON summary last. Run on a machine with a CUDA card, from the repository
root, e.g. parent, change, change, parent:

    python3 tools/replay_ab.py PARENT . . PARENT
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

FULL_REPEATS = 3
QUICK_REPEATS = 10
CASE_REPEATS = 3
ONE_EVENT, FIRST_TOUCH = 2_294_923, 3_250_585  # the real-size lane's intervals
# name: (replay sizes, windows, pages repeat)
CASES = {
    "w1_unique": ([ONE_EVENT], [1], False),
    "w1_repeats": ([ONE_EVENT], [1], True),
    "w80_unique": ([FIRST_TOUCH], [80], False),
    "real_size_like": ([FIRST_TOUCH] + [ONE_EVENT] * 12, [80] + [1] * 12, False),
    "w17_repeats": ([62_000], [17], True),
}


def case_launch(sizes, windows, repeats: bool, seed: int = 0):
    """Flat arguments of one synthetic launch: pages a permutation (no
    writer) or drawn from a quarter as many pages (writers at every
    distance)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = sum(sizes)
    page = np.concatenate([rng.integers(0, max(1, s // 4), s) if repeats else rng.permutation(s)
                           for s in sizes]).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(sizes)])

    def dev(x):
        return torch.from_numpy(x).cuda()

    return (dev(page), dev(rng.integers(0, 2, n).astype(np.int8)), dev(rng.random(n) * 1e-8),
            dev(rng.random(n) * 3e-7), dev(off.astype(np.int64)),
            dev(np.array(windows, np.int64)), dev(rng.random((len(sizes), 2)) * 1e-6),
            dev(np.array(sizes, np.int64)))


def cases(cs, tr) -> tuple:
    """The synthetic cases' parts by CUDA events, and their makespans."""
    import torch

    rows, t_app = [], {}
    for name, (sizes, windows, repeats) in CASES.items():
        args = case_launch(sizes, windows, repeats)
        page, tier, occ, lat, ev_off, w_slots, chan, n_pages = args
        prep = tr.replay_prepass(page, tier, occ, ev_off, w_slots, n_pages)
        walk = tr.replay_walk(prep, tier, lat, ev_off, w_slots, chan)
        whole = tr.timing_replay(*args)
        if not torch.equal(walk, whole):
            raise RuntimeError(f"{name}: the walker differs from the whole call")
        row = {"case": name, "events": page.numel(), "replays": len(sizes),
               "check_ms": cs.cuda_ms(lambda: tr._check(*args), repeats=CASE_REPEATS, warmup=1),
               "prepass_ms": cs.cuda_ms(lambda: tr.replay_prepass(page, tier, occ, ev_off,
                                                                  w_slots, n_pages),
                                        repeats=CASE_REPEATS, warmup=1),
               "walk_ms": cs.cuda_ms(lambda: tr.replay_walk(prep, tier, lat, ev_off, w_slots,
                                                            chan),
                                     repeats=CASE_REPEATS, warmup=1),
               "call_ms": cs.cuda_ms(lambda: tr.timing_replay(*args), repeats=CASE_REPEATS,
                                     warmup=1),
               "windows_longest": max(-(-s // w) for s, w in zip(sizes, windows))}
        row["walk_ns_a_window"] = row["walk_ms"] * 1e6 / row["windows_longest"]
        rows.append(row)
        t_app[name] = whole.tolist()
        del args, prep
    return rows, t_app


def one(tree: str) -> dict:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.timing_replay import timing_replay
    from repro_torch.sim.costmodel import OPTANE_LIKE
    from repro_torch.sim.workloads import thrash_trace
    from repro_torch.timing import calibrate

    _build.build(["timing_replay", "victim_partition"])
    dev = torch.device("cuda")
    trace = thrash_trace(rss_pages=cs.FULL_RSS, n_intervals=cs.FULL_INTERVALS)
    row, (args, t_full) = cs.timing_full(dev, trace)
    full_ms = cs.cuda_ms(lambda: timing_replay(*args), repeats=FULL_REPEATS, warmup=1)
    del args
    cal = calibrate(OPTANE_LIKE, max_events=cs.FIDELITY_MAX_EVENTS, device=dev)
    with cs.ReplayRecorder() as rec:
        cs.fidelity_quick(dev, cal=cal, rerun=False)
    args, t_quick, _ = max(rec.calls, key=lambda c: c[0][0].numel())
    quick_ms = cs.cuda_ms(lambda: timing_replay(*args), repeats=QUICK_REPEATS, warmup=1)
    quick_events, quick_replays = args[0].numel(), int(args[5].numel())
    del args, rec
    import repro_torch.kernels.timing_replay as tr

    links = tr.chain_latency_ns(cs.FULL_RSS, dev)
    case_rows, t_cases = cases(cs, tr) if hasattr(tr, "replay_walk") else ([], None)
    return {"tree": tree, "full_replay_s": row["replay_s"], "full_ms": full_ms,
            "full_bound_ms": row["bound_ms"],
            "full_chain_ms_with_loads": row.get("chain_ms_with_loads"),
            "full_events": row["events"],
            "quick_ms": quick_ms, "quick_events": quick_events,
            "quick_replays": quick_replays, "links": links, "cases": case_rows,
            "t_app_full": t_full.tolist(), "t_app_quick": t_quick.tolist(),
            "t_app_cases": t_cases}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    runs = []
    for tree in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": ""})
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({k: v for k, v in run.items() if not k.startswith("t_app")}),
              flush=True)
        runs.append(run)
    split = [r["t_app_cases"] for r in runs if r["t_app_cases"] is not None]
    same = all(r["t_app_full"] == runs[0]["t_app_full"]
               and r["t_app_quick"] == runs[0]["t_app_quick"] for r in runs) and all(
        c == split[0] for c in split)
    print(json.dumps({"trees": sys.argv[1:], "bit_equal": same,
                      "full_ms": [r["full_ms"] for r in runs],
                      "quick_ms": [r["quick_ms"] for r in runs],
                      "window_chain_ns": [r["links"].get("window_chain_ns") for r in runs],
                      "walk_ns_a_window": [{c["case"]: c["walk_ns_a_window"] for c in r["cases"]}
                                           for r in runs]}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
