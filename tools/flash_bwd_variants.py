"""Time the bfloat16 kernels of ``csrc/flash_attention_bwd.cu`` at other
geometries than the one the source fixes.

Each variant is compiled from a copy of the source whose constants are
changed: warps a block of the dQ kernel and of the dK dV kernel (4 or 8,
16 owned rows a warp: a dK dV block of 8 warps owns 128 keys) and rows of
the streamed tiles (64 or 128: keys in the dQ kernel, queries in the dK dV
kernel). Every variant runs at Qwen3-1.7B's first-layer training shape (B 4,
S = T 2,048, 16 query heads over 8 KV heads of 128, causal, random bf16
inputs from a seed), is checked against the committed build (each gradient
within 1e-2 of its largest value) and timed by CUDA events in turns,
beside the backward of ``scaled_dot_product_attention``. Prints the card's
name and power limit, then one JSON object.

Run on a machine with a CUDA card, from the repository root:

    python3 tools/flash_bwd_variants.py
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WARPS = (4, 8)
TILES = (64, 128)
ROUNDS = 3


def variant_source(src: str, dq_warps: int, dkdv_warps: int, tile: int) -> str:
    """The source with its geometry constants replaced."""
    for name, value in (("kDqWarps", dq_warps), ("kDkdvWarps", dkdv_warps), ("kTile", tile)):
        pattern = rf"constexpr int {name} = \d+;"
        if len(re.findall(pattern, src)) != 1:
            raise RuntimeError(f"csrc/flash_attention_bwd.cu has no single {name}")
        src = re.sub(pattern, f"constexpr int {name} = {value};", src)
    return src


def events_ms(fn, repeats: int = 10, warmup: int = 3) -> float:
    """Median milliseconds of one call of ``fn`` (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main() -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import _launch, flash_attention_bwd

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    lib = _build.load("flash_attention_bwd")
    committed = (lib.flash_attention_bwd_dq_warps(), lib.flash_attention_bwd_dkdv_warps(),
                 lib.flash_attention_bwd_tile())
    geometries = [(dq, dkdv, tile) for dq in WARPS for dkdv in WARPS for tile in TILES]
    out_dir = Path(tempfile.mkdtemp(prefix="flash_bwd_variants_"))
    procs = {}
    for geo in geometries:
        name = "dq%d_dkdv%d_tile%d" % geo
        path = out_dir / f"{name}.cu"
        path.write_text(variant_source(src, *geo))
        procs[geo] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, registers = {}, {}
    for geo, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            raise RuntimeError(f"variant {geo} did not build")
        regs, entry = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and entry and "mma_kernel" in entry and "Li128E" in entry:
                regs["dq" if "dq_mma" in entry else "dkdv"] = int(m.group(1))
        registers[geo] = regs
        libs[geo] = ctypes.PyDLL(str(out_dir / ("dq%d_dkdv%d_tile%d.so" % geo)))

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    B, S, H, KV, hd = 4, 2048, 16, 8, 128
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, S, KV, hd), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn((B, S, H, hd), generator=g, device=dev).to(torch.bfloat16)
    out, lse = _launch(q, k, v, True, with_lse=True)
    want = flash_attention_bwd(q, k, v, out, lse, do)
    scale = [float(x.float().abs().max()) for x in want]
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)

    def call(vlib, grads):
        fn = vlib.flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                                      ctypes.c_void_p]
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in grads), 1, B, S, S,
                H, KV, hd, 1, 1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    results = {}
    for geo, vlib in libs.items():
        grads = [torch.empty_like(x) for x in want]
        call(vlib, grads)
        torch.cuda.synchronize()
        err = [float((a.float() - b.float()).abs().max()) for a, b in zip(grads, want)]
        if not all(e <= 1e-2 * s for e, s in zip(err, scale)):
            raise RuntimeError(f"variant {geo} disagrees with the committed build: {err}")
        results[geo] = {"grads": grads, "ms": [], "max_abs_err": max(err)}
    order = list(libs)
    for rnd in range(ROUNDS):
        for geo in (order if rnd % 2 == 0 else order[::-1]):
            grads = results[geo]["grads"]
            results[geo]["ms"].append(events_ms(lambda: call(libs[geo], grads)))
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    sdpa_ms = events_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
    print(json.dumps({
        "shape": {"B": B, "S": S, "T": S, "H": H, "KV": KV, "hd": hd, "causal": True},
        "committed": "dq %d, dkdv %d, tile %d" % committed,
        "sdpa_backward_ms": sdpa_ms,
        "variants": [{"dq_warps": geo[0], "dkdv_warps": geo[1], "tile": geo[2],
                      "ms": r["ms"], "median_ms": sorted(r["ms"])[len(r["ms"]) // 2],
                      "max_abs_err_vs_committed": r["max_abs_err"],
                      "registers_hd128": registers[geo]}
                     for geo, r in results.items()],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
