"""Run chosen parts of ``chip_smoke.py``'s phases 2 and 14 alone on the
card, with the checks reported instead of ending the run, and print each
part's result and seconds.

Parts, in the order given on the command line (all of them by default):

    2            phase 2's ``flash_bwd_checks``
    a            (a): ``train_run("qwen3-1.7b")`` and its ``train_grads``
    d            (d): ``resume_check`` against (a)'s losses (run ``a`` first)
    <arch>       (f): ``family_run`` then ``train_grads`` of a FAMILY_RUNS arch
    g:<arch>     ``train_grads`` alone
    e            (e): ``time_flash_bwd`` at each layout the gradient checks
                 of DeepSeekMoE-16B, ChatGLM3-6B and Qwen2-72B captured

A part that runs out of device memory is reported with the peak memory
allocated and the run goes on with the next part; nothing is retried at
another setting. Prints the card's name and power limit, the host's free
disk and memory, then one line a result. Exits 1 if any check failed or
any part raised. Run on a machine with a CUDA card, from the repository
root:

    python3 tools/phase14_parts.py 2 a d deepseek-moe-16b g:qwen2-72b e
"""

from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

NEW_ARCHS = ("deepseek-moe-16b", "chatglm3-6b", "qwen2-72b")


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv) -> int:
    import torch

    cs = load_chip_smoke()
    failed = []

    def soft(cond, msg):
        if not cond:
            failed.append(msg)
            print("CHECK FAILED:", msg, flush=True)

    cs.check = soft
    parts = argv or ["2", "a", "d", *NEW_ARCHS, "e"]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    for d in (tempfile.gettempdir(), str(ROOT)):
        print(f"disk {d}: {shutil.disk_usage(d).free} bytes free")
    print(Path("/proc/meminfo").read_text().splitlines()[:3], flush=True)
    from repro_torch.kernels import _build

    _build.build()
    out, capture, seconds = {}, {}, {}
    for part in parts:
        t = time.perf_counter()
        before = set(out)
        oom = False
        try:
            if part == "2":
                out["2 flash_bwd_checks max |diff|"] = cs.flash_bwd_checks(dev)
            elif part == "a":
                out["a"] = cs.train_run("qwen3-1.7b", dev)
                out["a grads"] = cs.train_grads("qwen3-1.7b", dev, capture)
            elif part == "d":
                out["d"] = cs.resume_check(out["a"]["losses"])
            elif part == "e":
                for name in NEW_ARCHS:
                    for (S, T, causal), args in capture.get(("flash_layouts", name), {}).items():
                        out[f"e {name} {S}x{T}"] = cs.time_flash_bwd(*args, causal)
            elif part.startswith("g:"):
                out[f"g {part[2:]}"] = cs.train_grads(part[2:], dev, capture)
            else:
                out[f"f {part}"] = cs.family_run(part, dev)
                out[f"g {part}"] = cs.train_grads(part, dev, capture)
        except torch.cuda.OutOfMemoryError:
            traceback.print_exc()
            oom = True
        except Exception:
            traceback.print_exc()
            failed.append(f"{part} raised")
        if oom:  # outside the handler, whose traceback holds the frames
            failed.append(f"{part} ran out of device memory, peak "
                          f"{torch.cuda.max_memory_allocated()} bytes")
            print(failed[-1], flush=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        seconds[part] = time.perf_counter() - t
        for k in set(out) - before:
            print(f"== {k}: " + json.dumps(out[k], default=str), flush=True)
        print(f"== {part} in {seconds[part]:.1f} s", flush=True)
    print("seconds " + json.dumps(seconds))
    print("failed " + json.dumps(failed))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
