"""Where one float32 training step of RWKV6-3B's lane layout loses agreement
between the CPU and the card, and whether the weights' draw or the device
is the cause.

``chip_smoke.py``'s phase 3 holds one float32 training step of each arch's
lane layout (full width, 2 layers; batch 2 x 64 from seed 25) on the CPU
and on the card within ``TRAIN_LANE_TOL``. For weights drawn from seeds on
the CPU's generator and on the card's, this script runs the step's loss
and gradients four ways:

* ``cpu``: the plain versions on the CPU (the lane phase 3 holds);
* ``cpu_perturbed``: the same, on weights each moved by half a float32 ulp
  (times 1 +- 2^-24, the signs from a seed): a rounding-sized change on one
  device, so its distance from ``cpu`` is the step's own conditioning;
* ``cuda_plain``: the plain versions on the card (``wkv6_plain`` in place
  of the kernel), TF32 off;
* ``cuda``: the kernels on the card, as phase 3 runs it.

Each is held against ``cpu``: the loss and the gradients' global norm
(relative), each leaf's gradient (relative L2; the largest listed), and,
layer by layer, the time mix's and channel mix's outputs and the WKV
output ``o`` with their gradients (relative L2). For ``o`` it also gives
the positions that carry most of the gradient's difference and the
smallest mean square of a (batch, position, head) row, which the group
norm after it divides by (``rsqrt(ms + 1e-6)``). It also checks that the
two generators draw the same distributions (each random leaf's mean and
its standard deviation times sqrt(fan-in)).

Prints the card's name and power limit, then one JSON object, also
written to the file ``--out`` names when given. Run on a machine with a
CUDA card, from the repository root (``--draws`` picks some of
``DRAWS``, as ``where:seed`` pairs joined by commas):

    python3 tools/lane_conditioning.py [--draws cuda:26,cpu:28] [--out FILE]
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH = "rwkv6-3b"
LAYERS, BATCH, SEQ = 2, 2, 64  # chip_smoke.py's LANE_LAYERS, LANE_BATCH, LANE_LEN
DRAWS = (("cpu", 26), ("cuda", 26), ("cpu", 27), ("cuda", 27), ("cpu", 28), ("cuda", 28))
TOP = 5


def rel(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def run_lane(cfg, master, batch, device, plain: bool) -> dict:
    """Loss, gradients and the taps of one step's loss and backward on
    ``device``; ``plain`` swaps the WKV kernel for its plain version."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
    from repro_torch.launch.train import make_train_fns
    from repro_torch.models import layers as L
    from repro_torch.optim.adamw import from_leaves, leaves

    taps = {}
    tm, cm = L.rwkv_time_mix, L.rwkv_channel_mix
    inner = wkv6_plain if plain else wkv6

    def tap(fn, key):
        def call(*args, **kw):
            out, carry = fn(*args, **kw)
            out.retain_grad()
            taps.setdefault(key, []).append(out)
            return out, carry
        return call

    params = from_leaves(master, [p.detach().to(device, copy=True).requires_grad_(True)
                                  for p in leaves(master)])
    L.rwkv_time_mix, L.rwkv_channel_mix = tap(tm, "time_mix"), tap(cm, "channel_mix")
    ops.wkv6 = tap(inner, "wkv_o")
    try:
        with torch.enable_grad():
            loss = make_train_fns(cfg, remat="none", device=device)["loss"](params, batch)
            loss.backward()
    finally:
        L.rwkv_time_mix, L.rwkv_channel_mix, ops.wkv6 = tm, cm, wkv6
    grads = [p.grad.detach().cpu() for p in leaves(params)]
    return {"loss": float(loss.detach()), "grads": grads,
            "grad_norm": math.sqrt(sum(float(g.double().square().sum()) for g in grads)),
            "taps": {k: [(t.detach().cpu(), t.grad.detach().cpu()) for t in v]
                     for k, v in taps.items()}}


def compare(lane: dict, ref: dict, names: list) -> dict:
    leaf = sorted(((rel(a, b), n) for n, a, b in zip(names, lane["grads"], ref["grads"])),
                  reverse=True)
    layers = {}
    for key, rows in ref["taps"].items():
        for i, ((x, gx), (y, gy)) in enumerate(zip(lane["taps"][key], rows)):
            row = {"forward_rel_l2": rel(x, y), "grad_rel_l2": rel(gx, gy)}
            if key == "wkv_o":  # (B, S, H, hd)
                d = (gx.double() - gy.double()).square().sum(dim=(0, 2, 3))
                share = d / d.sum().clamp_min(1e-300)
                top = share.argsort(descending=True)[:3]
                ms = y.double().square().mean(-1)  # (B, S, H)
                at = divmod(int(ms.argmin()), ms.shape[1] * ms.shape[2])
                row.update({
                    "positions_most_grad_diff": {int(s): float(share[s]) for s in top},
                    "min_row_mean_square": float(ms.min()),
                    "min_at_batch_position_head": [at[0], *divmod(at[1], ms.shape[2])],
                    "rows_below_100_eps": int((ms < 1e-4).sum()),
                    "after_position_0": _smallest_row(ms[:, 1:], 1),
                    "grad_rel_l2_without_position_0": rel(gx[:, 1:], gy[:, 1:]),
                })
            layers[f"{key}[{i}]"] = row
    return {"loss_rel": abs(lane["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_norm_rel": abs(lane["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
            "grads_rel_l2": rel(torch_cat(lane["grads"]), torch_cat(ref["grads"])),
            "worst_leaves": [[n, r] for r, n in leaf[:TOP]], "layers": layers}


def _smallest_row(ms, first: int) -> dict:
    """The smallest mean square of ``ms`` (B, S, H), its (batch, position,
    head) with positions counted from ``first``, and the rows below 100 eps."""
    b, rest = divmod(int(ms.argmin()), ms.shape[1] * ms.shape[2])
    s, h = divmod(rest, ms.shape[2])
    return {"min_row_mean_square": float(ms.min()), "at": [b, s + first, h],
            "rows_below_100_eps": int((ms < 1e-4).sum())}


def torch_cat(ts):
    import torch

    return torch.cat([t.reshape(-1) for t in ts])


def draw_stats(master, names) -> dict:
    """Each random leaf's mean and std * sqrt(fan-in) (1 for dense_init)."""
    from repro_torch.optim.adamw import leaves

    out = {}
    for n, p in zip(names, leaves(master)):
        if p.dim() == 2 and float(p.std()) > 0:
            fan_in = p.shape[1] if n.endswith("embed") else p.shape[0]
            out[n] = [float(p.double().mean()), float(p.double().std()) * math.sqrt(fan_in)]
    return out


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import init_model

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    dev = torch.device("cuda")
    cfg = replace(get_config(ARCH), num_layers=LAYERS, param_dtype="float32",
                  compute_dtype="float32")
    batch = SyntheticLMDataset(cfg.vocab_size, SEQ, BATCH, seed=25).batch_at(0)
    out = {"arch": ARCH, "layers": LAYERS, "batch": BATCH, "seq": SEQ, "card": card.strip(),
           "torch": torch.__version__, "cpu_threads": torch.get_num_threads(), "draws": {}}
    draws = DRAWS
    if "--draws" in sys.argv:
        draws = [(w, int(n)) for w, n in (d.split(":") for d in
                                          sys.argv[sys.argv.index("--draws") + 1].split(","))]
    for where, seed in draws:
        t = time.perf_counter()
        gen = torch.Generator(device=where).manual_seed(seed)
        master = _to_cpu(init_model(cfg, generator=gen, device=torch.device(where)))
        names = leaf_names(master)
        noise = torch.Generator().manual_seed(99)
        perturbed = _map(master, lambda p: p * (1 + 2.0 ** -24 * (
            torch.randint(0, 2, p.shape, generator=noise) * 2 - 1).to(p.dtype)))
        ref = run_lane(cfg, master, batch, torch.device("cpu"), plain=True)
        row = {"draw_stats": draw_stats(master, names)}
        for lane, params, device, plain in (
                ("cpu_perturbed", perturbed, torch.device("cpu"), True),
                ("cuda_plain", master, dev, True), ("cuda", master, dev, False)):
            got = run_lane(cfg, params, batch, device, plain)
            row[lane] = compare(got, ref, names)
            del got
        row["loss_cpu"], row["grad_norm_cpu"] = ref["loss"], ref["grad_norm"]
        row["s"] = time.perf_counter() - t
        out["draws"][f"{where} seed {seed}"] = row
        print(f"{where} seed {seed}: " + json.dumps(
            {k: {m: v[m] for m in ("loss_rel", "grad_norm_rel", "grads_rel_l2")}
             for k, v in row.items() if isinstance(v, dict) and "loss_rel" in v}), flush=True)
        del master, perturbed, ref
    text = json.dumps(out)
    if "--out" in sys.argv:
        Path(sys.argv[sys.argv.index("--out") + 1]).write_text(text)
    print(text)
    return 0


def leaf_names(tree, prefix="") -> list:
    """The path of every leaf, in ``adamw.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _to_cpu(tree):
    return _map(tree, lambda t: t.detach().to("cpu", copy=True))


if __name__ == "__main__":
    sys.exit(main())
