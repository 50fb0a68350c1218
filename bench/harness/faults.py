"""Faults planted under the timed path, for the checks' tests and for the
fault readings a training limit is set from (``bench/control.py --fault``):
a step that leaves its state as it was, half of the batch left out with the
mean over the rest, a token or answer altered where it is produced."""

from __future__ import annotations

import torch

NAMES = ("state_unchanged", "half_batch", "token_altered")


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def _kept(fn, state_of):
    """``fn`` with the tensors ``state_of(args)`` restored after each call."""
    def call(*args):
        saved = [t.detach().clone() for t in _tensors(state_of(args))]
        out = fn(*args)
        with torch.no_grad():
            for t, s in zip(_tensors(state_of(args)), saved):
                t.copy_(s)
        return out
    return call


def train_step(fault, step):
    if fault == "state_unchanged":
        return _kept(step, lambda args: args[0])
    if fault == "half_batch":
        def half(params, opt, batch):
            n = batch["tokens"].shape[0] // 2
            return step(params, opt, {k: t[:n] for k, t in batch.items()})
        return half
    return step


def decode(fault, fn):
    if fault == "state_unchanged":
        return _kept(fn, lambda args: args[1])
    if fault == "token_altered":
        def altered(params, state, token, cur):
            logits, state = fn(params, state, token, cur)
            return logits.roll(1, dims=-1), state
        return altered
    return fn

