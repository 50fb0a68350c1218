"""Training: one step object (the program's ``make_train_fns(...)["step"]``
with the benchmark's weights and a zeroed optimizer state) driven from the
seed. Set-up runs the first ``checked_steps`` steps through the window's own
call and feed (they are the warm-up), and records what the reference
follows: each step's loss and gradient norm, the first gradient as the
optimizer holds it (m / (1 - b1) after one step) and each leaf's change.
The window runs further steps on new rows; ``check`` runs the reference
over the first steps once the program's state is gone.

Mix keys: ``batch``, ``seq_len``, ``remat``, ``lr``, ``warmup``,
``total_steps``, ``aux_weight_key`` (the configuration's key of the aux
loss weight), ``adamw`` (the update's constants, which the reference
uses), ``checked_steps``."""

from __future__ import annotations

import json
import math
import sys

import torch

from bench.harness import compare, faults, program, weights
from bench.harness.env import subseed
from bench.reference import model as ref_model

# leaves whose reference gradient is below this share of the median leaf's
# move by rounding alone and are left out of the change's comparison
TINY_GRAD = 1e-3


def _batches(ctx):
    """An endless feed of (tokens, labels), each row new, from the seed."""
    B, S, V = ctx.mix["batch"], ctx.mix["seq_len"], ctx.arch.vocab
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(subseed(ctx.seed, "train-batches"))
    while True:
        t = torch.randint(0, V, (B, S + 1), generator=gen, device=ctx.device)
        yield {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _delta_norms(ctx, flat) -> dict:
    """Each leaf's ||p - p0|| in float32, p0 drawn again from the seed."""
    out = {}
    for i in range(len(weights.chunks(ctx.arch))):
        for name, p0 in weights.draw_chunk(ctx.arch, ctx.seed, i, ctx.device).items():
            out[name] = float((flat[name].detach().float() - p0.float()).norm())
    for name, _, fan_in in ctx.arch.leaves():
        if fan_in is None:
            out[name] = float((flat[name].detach().float() - 1.0).norm())
    return out


def setup(ctx):
    cfg = program.model_config(ctx.config)
    fns = program.train_fns(cfg, ctx.mix, ctx.config, ctx.device)
    ctx.mark("train fns")
    flat = weights.make(ctx.arch, ctx.seed, ctx.device)
    for t in flat.values():
        t.requires_grad_(True)
    opt_dt = getattr(torch, ctx.config["program"]["opt_state_dtype"])
    m = {n: torch.zeros(t.shape, dtype=opt_dt, device=ctx.device) for n, t in flat.items()}
    v = {n: torch.zeros(t.shape, dtype=opt_dt, device=ctx.device) for n, t in flat.items()}
    st = {"params": weights.to_tree(flat),
          "opt": {"m": weights.to_tree(m), "v": weights.to_tree(v),
                  "step": torch.zeros((), dtype=torch.int32, device=ctx.device)},
          "step": faults.train_step(ctx.fault, fns["step"]), "feed": _batches(ctx)}
    ctx.mark("weights and state")
    b1 = ctx.mix["adamw"]["b1"]
    losses, norms, g1 = [], [], None
    for i in range(ctx.mix["checked_steps"]):
        st["params"], st["opt"], out = st["step"](st["params"], st["opt"], next(st["feed"]))
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
        if i == 0:
            g1 = {n: float(t.float().norm()) / (1.0 - b1) for n, t in m.items()}
        ctx.mark(f"step {i + 1}")
    st["checked"] = {"loss": losses, "grad_norm": norms, "grad_leaf": g1,
                     "update_leaf": _delta_norms(ctx, flat)}
    return st


def window(ctx, st, seconds: float, w) -> dict:
    B, S = ctx.mix["batch"], ctx.mix["seq_len"]
    steps = failed = 0
    while w.elapsed() < seconds:
        with w.span("batch build"):
            batch = next(st["feed"])
        with w.span("step"):
            st["params"], st["opt"], out = st["step"](st["params"], st["opt"], batch)
            loss = float(out["loss"])
        steps += 1
        failed += not math.isfinite(loss)
    w.sync()
    return {"steps": steps, "tokens": steps * B * S, "attempted": steps, "failed": failed,
            "window_s": w.elapsed()}


def check(ctx, st, measured) -> dict:
    """The program's first steps against the reference's (float32); with
    ``ctx.control`` the control's (the reference in float8) are returned
    and the program's kept in ``ctx.sound``."""
    prog = st.pop("checked")
    st.clear()
    compare.free(ctx.device)
    ref_model.no_tf32()
    n = ctx.mix["checked_steps"]
    feed = _batches(ctx)
    batches = [(b["tokens"], b["labels"]) for b in (next(feed) for _ in range(n))]
    aux = program.aux_weight(ctx.mix, ctx.config)
    W = weights.make(ctx.arch, ctx.seed, ctx.device)
    ref = ref_model.train(ctx.arch, W, batches, ctx.mix, aux)
    if ref.get("dropped"):
        print(f"reference step 1: picks past capacity a layer {ref['dropped']}", file=sys.stderr)
    ref["update_leaf"] = _delta_norms(ctx, W)
    ctx.sound = _numbers(prog, ref)
    _log_steps("program", prog, ref)
    if ctx.control:
        W = weights.make(ctx.arch, ctx.seed, ctx.device)
        low = ref_model.train(ctx.arch, W, batches, ctx.mix, aux, fp8=True)
        low["update_leaf"] = _delta_norms(ctx, W)
        _log_steps("control", low, ref)
    del W
    compare.free(ctx.device)
    return _numbers(low, ref) if ctx.control else ctx.sound


def _log_steps(who: str, got, ref) -> None:
    """Each step's loss and gradient-norm gaps, to standard error."""
    gaps = {k: [abs(p - r) / abs(r) for p, r in zip(got[k], ref[k])] for k in ("loss", "grad_norm")}
    print(f"steps {who}: {json.dumps(gaps)}", file=sys.stderr)


def _numbers(prog, ref) -> dict:
    """Each step's loss and global gradient norm (before the clip; and the
    first step's norm alone, ``grad_norm_1``), the first clipped gradient's
    worst leaf, and the worst moving leaf's change over the checked steps,
    each as a gap relative to the reference. A cell's limits name the
    numbers it compares."""
    med = sorted(ref["grad_leaf"].values())[len(ref["grad_leaf"]) // 2]
    moving = [k for k, g in ref["grad_leaf"].items() if g >= TINY_GRAD * med]
    print(f"update_leaf: {len(ref['grad_leaf']) - len(moving)} of {len(ref['grad_leaf'])} leaves"
          " left out (reference gradient under 1/1000 of the median leaf's)", file=sys.stderr)
    return {
        "loss": max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])),
        "grad_norm": max(abs(p - r) / r for p, r in zip(prog["grad_norm"], ref["grad_norm"])),
        "grad_norm_1": abs(prog["grad_norm"][0] - ref["grad_norm"][0]) / ref["grad_norm"][0],
        "grad_leaf": compare.leaf_gap(prog["grad_leaf"], ref["grad_leaf"]),
        "update_leaf": compare.leaf_gap(prog["update_leaf"], ref["update_leaf"], moving),
    }
