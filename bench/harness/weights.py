"""Weights from the seed, made on the device in a few large calls: the
matrices of the configuration in fixed order, cut into chunks of at most
``CHUNK`` elements, each chunk one ``torch.randn`` in float32 from a
generator on the device seeded from (seed, chunk), then scaled by 1/sqrt(fan
in) and cast to the served dtype leaf by leaf. Any chunk can be drawn again
alone (the reference and the training check do)."""

from __future__ import annotations

import math

import torch

from bench.harness.env import subseed

CHUNK = 1 << 28


def chunks(arch) -> list:
    """The random leaves of ``arch`` grouped into chunks: a list of lists of
    (name, shape, fan-in)."""
    out, cur, n = [], [], 0
    for leaf in arch.leaves():
        if leaf[2] is None:
            continue
        size = math.prod(leaf[1])
        if cur and n + size > CHUNK:
            out.append(cur)
            cur, n = [], 0
        cur.append(leaf)
        n += size
    if cur:
        out.append(cur)
    return out


def draw_chunk(arch, seed: int, index: int, device, dtype=torch.bfloat16) -> dict:
    """The leaves of chunk ``index``, name -> tensor in ``dtype``."""
    group = chunks(arch)[index]
    total = sum(math.prod(s) for _, s, _ in group)
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, "weights", index))
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, fan_in in group:
        n = math.prod(shape)
        out[name] = (buf[off:off + n].view(shape) * (1.0 / math.sqrt(fan_in))).to(dtype)
        off += n
    del buf
    return out


def make(arch, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Every parameter, name -> tensor in ``dtype`` on ``device``: norm
    scales ones, the rest drawn by chunks."""
    flat = {}
    for i in range(len(chunks(arch))):
        flat.update(draw_chunk(arch, seed, i, device, dtype))
    for name, shape, fan_in in arch.leaves():
        if fan_in is None:
            flat[name] = torch.ones(shape, dtype=dtype, device=device)
    return {name: flat[name] for name, _, _ in arch.leaves()}


def to_tree(flat: dict):
    """The program's nested parameter tree (dicts, the layers a list) over
    the same tensors."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        parts = name.split(".")
        for key, nxt in zip(parts[:-1], parts[1:]):
            if key.isdigit():
                key = int(key)
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = [] if nxt.isdigit() else {}
                node = node[key]
            else:
                node = node.setdefault(key, [] if nxt.isdigit() else {})
        node[parts[-1]] = t
    return tree
