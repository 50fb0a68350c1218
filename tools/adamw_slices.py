"""Time the AdamW update at Jamba-1.5-Large's training layout with each
slice size of ``optim/adamw.py``'s ``CHUNK`` on the card.

``update_`` runs ``one()`` over each leaf in flat slices of at most
``CHUNK[device type]`` elements. This script builds Jamba-1.5-Large's lane
layout as ``chip_smoke.py``'s phase 14 trains it (2 layers, one attention
and one Mamba block, 4 experts: 4.67 B parameters), bfloat16 weights and
bfloat16 AdamW state, with random bfloat16 gradients from a seed, and
times ``update_`` at each slice size in ``SLICES``, in turns (ABBA, ROUNDS
times), by CUDA events and the host clock, with its peak memory above what
is allocated before it. Each slice size gives the same bits (every
operation of ``one()`` is elementwise); the script checks it on the first
round.

Prints the card's name and power limit, then one JSON object. Run on a
machine with a CUDA card, from the repository root:

    python3 tools/adamw_slices.py
"""

from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH = "jamba-1.5-large-398b"
LAYOUT = {"num_layers": 2, "block_pattern": ("attn", "mamba"), "n_experts": 4}
SLICES = (1 << 26, 1 << 22)
ROUNDS = 3


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_train_fns
    from repro_torch.optim.adamw import from_leaves, leaves

    A = importlib.import_module("repro_torch.optim.adamw")

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    dev = torch.device("cuda")
    cfg = replace(get_config(ARCH), **LAYOUT)
    params, state = make_train_fns(cfg, opt_state_dtype=torch.bfloat16)["init"](
        torch.Generator(device=dev).manual_seed(57))
    gen = torch.Generator(device=dev).manual_seed(59)
    grads = from_leaves(params, [
        (torch.randn(p.shape, generator=gen, device=dev) * 1e-3).to(p.dtype)
        for p in leaves(params)])
    opt = A.adamw(lr=A.cosine_schedule(3e-4, warmup=200, total=10_000),
                  state_dtype=torch.bfloat16)
    n = sum(p.numel() for p in leaves(params))
    times = {s: {"ms": [], "host_ms": [], "peak_above_bytes": []} for s in SLICES}
    saved = A.CHUNK["cuda"]
    first = {}
    with torch.no_grad():  # each update starts from these weights and state
        p0 = [p.clone() for p in leaves(params)]
        s0 = {k: [t.clone() for t in leaves(state[k])] for k in ("m", "v")}
        step0 = state["step"].clone()
    try:
        order = [s for r in range(ROUNDS) for s in (SLICES if r % 2 == 0 else SLICES[::-1])]
        for s in order:
            A.CHUNK["cuda"] = s
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            opt.update_(grads, state, params)
            end.record()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t) * 1e3
            row = times[s]
            row["ms"].append(start.elapsed_time(end))
            row["host_ms"].append(host)
            row["peak_above_bytes"].append(torch.cuda.max_memory_allocated() - base)
            if s not in first:  # held in host memory: the card has no room for two copies
                first[s] = [p.detach().cpu() for p in leaves(params)]
            with torch.no_grad():
                for p, q in zip(leaves(params), p0):
                    p.copy_(q)
                for k in ("m", "v"):
                    for a, b in zip(leaves(state[k]), s0[k]):
                        a.copy_(b)
                state["step"].copy_(step0)
    finally:
        A.CHUNK["cuda"] = saved
    same = all(torch.equal(a, b) for a, b in zip(*(first[s] for s in SLICES)))
    out = {"arch": ARCH, "layout": {k: list(v) if isinstance(v, tuple) else v
                                    for k, v in LAYOUT.items()},
           "params": n, "weights_and_state": "bfloat16", "card": card.strip(),
           "torch": torch.__version__, "bit_equal": same, "rounds": ROUNDS,
           "slices": {str(s): {**v, "median_ms": statistics.median(v["ms"]),
                               "median_host_ms": statistics.median(v["host_ms"])}
                      for s, v in times.items()}}
    print(json.dumps(out))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
