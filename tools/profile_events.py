"""Read one profile's device time both ways ``chip_smoke.py`` could: its
raw kineto events (``chip_smoke._cuda_events``) and ``prof.events()``.

``prof.events()`` first parses every event, host ops included, into a
FunctionEvent tree; ``_cuda_events`` reads the device events of the raw
results alone. The script profiles STEPS steps of a 256 x 256 float32
matmul, a scale and a relu on the card, once with the host's ops traced
and once with the card's activity alone, and for each reports both
readings' seconds, their event counts, their device µs and whether they
hold the same kernel names with the same µs each. It also times the first
two traces that ``chip_smoke.BackgroundTraces`` hands over from its
spawned processes.

Prints the card's name and power limit, then one JSON object. Run on a
machine with a CUDA card, from the repository root:

    python3 tools/profile_events.py
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

STEPS = 20_000


def readings(prof) -> dict:
    import torch

    import chip_smoke

    t = time.perf_counter()
    raw = chip_smoke._cuda_events(prof)
    raw_s = time.perf_counter() - t
    t = time.perf_counter()
    parsed = [(e.name, e.device_time_total) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    parsed_s = time.perf_counter() - t
    a, b = chip_smoke._by_name(raw), chip_smoke._by_name(parsed)
    return {"raw_s": raw_s, "parsed_s": parsed_s, "events_raw": len(raw),
            "events_parsed": len(parsed), "device_us_raw": sum(a.values()),
            "device_us_parsed": sum(b.values()),
            "same_names": collections.Counter(n for n, _ in raw)
            == collections.Counter(n for n, _ in parsed),
            "max_us_diff_by_name": max(abs(a[k] - b[k]) for k in set(a) | set(b))}


def main() -> int:
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("profile_events: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    a = torch.randn(256, 256, device="cuda")
    out = {"torch": torch.__version__, "steps": STEPS}
    activities = {"host_and_card": [torch.profiler.ProfilerActivity.CPU,
                                    torch.profiler.ProfilerActivity.CUDA],
                  "card_only": [torch.profiler.ProfilerActivity.CUDA]}
    for name, acts in activities.items():
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            x = a
            for _ in range(STEPS):
                x = torch.relu(x @ a * 0.001)
            torch.cuda.synchronize()
        out[name] = readings(prof)
    t = time.perf_counter()
    bg = chip_smoke.BackgroundTraces({"thrash": ("thrash", dict(n_intervals=3, rss_pages=2000)),
                                      "bfs": ("bfs", {})})
    got = bg.take(["thrash", "bfs"])
    out["background_traces"] = {k: [v.rss_pages, len(v)] for k, v in got.items()}
    out["background_traces_s"] = time.perf_counter() - t
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
