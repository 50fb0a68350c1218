"""Decoding over long cached contexts: ``batch`` sequences whose
``prompt_len``-token prompts (ids from the seed) the port's own
``models.transformer.prefill`` writes into one decode state in set-up, one
sequence a call (the whole prompt's logits of one sequence are the fill's
largest tenant); then greedy decoding through ``make_serve_fns(cfg, batch,
max_len)["decode"]``, all sequences in one step. A step's time runs from its
start until its sampled tokens are on the host. Where the cache fills
(``max_len``), the sequences start their next turn from the cached prompt.

``check`` compares, for ``checked_sequences`` sequences, one drawn from the
seed in each of as many equal groups of slots, every token served in the
first turn: the reference runs once over the
prompt and the served tokens and reads, at each served position, the gap of
the served token below its best logit, and the distance of the program's
logits from its own. With ``ctx.control`` it returns the control's numbers
(the reference in float8 in the program's place: the gap of the token it
puts first) and keeps the program's in ``ctx.sound``."""

from __future__ import annotations

import random
import time

import torch

from bench.harness import compare, faults, program, weights
from bench.harness.env import subseed
from bench.reference import model as ref_model

WARM_STEPS = 2


def checked_slots(batch: int, n: int, seed: int) -> list:
    """One slot drawn from the seed in each of ``n`` equal groups of the
    batch's slots."""
    rng, size = random.Random(subseed(seed, "checked")), batch // n
    return [g * size + rng.randrange(size) for g in range(n)]


def setup(ctx):
    mix, a = ctx.mix, ctx.arch
    B, P, L = mix["batch"], mix["prompt_len"], mix["max_len"]
    cfg = program.model_config(ctx.config)
    fns = program.serve_fns(cfg, B, L, ctx.device)
    flat = weights.make(a, ctx.seed, ctx.device)
    params = weights.to_tree(flat)
    state = fns["init_state"]()
    ctx.mark("weights and state")
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(subseed(ctx.seed, "prompts"))
    prompts = torch.randint(0, a.vocab, (B, P), generator=gen, device=ctx.device)
    checked = checked_slots(B, mix["checked_sequences"], ctx.seed)
    first = torch.empty((B, 1), dtype=torch.long, device=ctx.device)
    fill_logits = {}
    for b in range(B):
        one = {k: t[:, b:b + 1] for k, t in state.items()}
        last, _ = program.prefill_into(params, cfg, prompts[b:b + 1], one)
        first[b] = last[0, -1].argmax()
        if b in checked:
            fill_logits[b] = last[0, -1].clone()
        del last
    compare.free(ctx.device)
    ctx.mark("cache filled")
    decode = faults.decode(ctx.fault, fns["decode"])
    tok = first
    for j in range(WARM_STEPS):  # positions P.. are written again by the window
        logits, _ = decode(params, state, tok, P + j)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        tok.cpu()
    return {"params": params, "state": state, "decode": decode, "first": first,
            "prompts": prompts, "checked": checked, "fill_logits": fill_logits}


def window(ctx, st, seconds: float, w) -> dict:
    P, L = ctx.mix["prompt_len"], ctx.mix["max_len"]
    params, state, decode = st["params"], st["state"], st["decode"]
    tok, cur, turn = st["first"], P, 0
    times, contexts, served, kept = [], [], [st["first"].cpu()], []
    while w.elapsed() < seconds:
        if cur == L:
            tok, cur, turn = st["first"], P, turn + 1
        t0 = time.perf_counter()
        with w.span("decode step"):
            logits, _ = decode(params, state, tok, cur)
        with w.span("sampling"):
            tok = logits[:, -1].argmax(-1, keepdim=True)
            host = tok.cpu()
        times.append(time.perf_counter() - t0)
        contexts.append(cur)
        if turn == 0:
            served.append(host)
            kept.append(logits[st["checked"], -1])
        cur += 1
    st["served"], st["kept"] = torch.cat(served, dim=1), kept
    n = len(times)
    return {"step_s": times, "contexts": contexts, "batch": ctx.mix["batch"],
            "attempted": n, "failed": 0, "window_s": w.elapsed()}


def check(ctx, st, measured) -> dict:
    P = ctx.mix["prompt_len"]
    checked, served = st["checked"], st["served"]
    n = len(st["kept"])  # decode steps of the first turn; n + 1 tokens served
    prog = {b: torch.stack([st["fill_logits"][b]] + [k[i] for k in st["kept"]])
            for i, b in enumerate(checked)}
    seqs = {b: torch.cat([st["prompts"][b], served[b, :n].to(ctx.device)]) for b in checked}
    st.clear()
    compare.free(ctx.device)
    ref_model.no_tf32()
    W = weights.make(ctx.arch, ctx.seed, ctx.device)
    found = {"gap": [], "rel_l2": []}
    low = {"gap": [], "rel_l2": []}
    rows = torch.arange(P - 1, P + n, device=ctx.device)
    for b in checked:
        ref = ref_model.Model(ctx.arch, W).logits_at(seqs[b], rows)
        found["gap"].append(compare.gap(ref, served[b, :n + 1]))
        found["rel_l2"].append(compare.rel_l2(prog[b], ref))
        if ctx.control:
            fp8 = ref_model.Model(ctx.arch, W, fp8=True).logits_at(seqs[b], rows)
            low["gap"].append(compare.gap(ref, fp8.argmax(-1)))
            low["rel_l2"].append(compare.rel_l2(fp8, ref))
            del fp8
        del ref
    del W
    compare.free(ctx.device)
    ctx.sound = {k: max(v) for k, v in found.items()}
    return {k: max(v) for k, v in low.items()} if ctx.control else ctx.sound
