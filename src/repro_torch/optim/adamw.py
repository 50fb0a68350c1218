"""AdamW with global-norm clipping and a cosine schedule (counterpart of
:mod:`repro.optim.adamw`).

The optimizer state mirrors the parameter tree (``m``, ``v``) beside an
int32 ``step``, in float32 or, to halve its memory, bfloat16. The schedule,
the bias corrections ``1 - b ** step`` and the clip scale are computed in
float32 on the parameters' device, as the JAX functions compute them: the
same arithmetic in Python's float64 gives another learning rate.

``update`` returns new parameters and a new state and leaves its inputs
alone, like the JAX function; :func:`adamw`'s ``update_`` writes both in
place instead, for a trainer that must not hold two copies of a large model.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch


def leaves(tree) -> list:
    """The tensors of a nested dict / list tree, dict keys sorted (the
    order of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def from_leaves(tree, flat):
    """``flat`` (in :func:`leaves` order) in the structure of ``tree``."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``),
    in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, leaf by leaf."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    down to 0 at ``total``; ``lr(step)`` takes an int or a tensor and
    returns a float32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return lr


# The update runs over each leaf in flat slices of at most CHUNK[device
# type] elements: ``one()`` makes about a dozen float32 temporaries of what
# it is given, 3.2 GB each for one of Jamba-1.5-Large's (4, 8,192, 24,576)
# expert weights. On the CPU a temporary under the allocator's mmap
# threshold (32 MB) reuses memory instead of faulting in fresh pages. On
# the card more slices cost more launches: Jamba's lane layout (4.67 B
# bfloat16 weights and state) updates in 442 ms in slices of 2^26 and in
# 518 ms in slices of 2^22 (tools/adamw_slices.py on an H100 80GB HBM3 at
# 700 W). Every operation of ``one()`` is elementwise, so the slices give
# the same bits as the whole leaf.
CHUNK = {"cpu": 1 << 22, "cuda": 1 << 26}


def _slices(p, g, mo, vo):
    """(p, g, m, v) of one leaf cut into flat slices of at most
    CHUNK[device type] elements, those of p, m and v views to write the
    update through; the whole leaf where p, m or v is not contiguous."""
    chunk = CHUNK.get(p.device.type)
    if chunk is None or p.numel() <= chunk or not all(
            t.is_contiguous() for t in (p, mo, vo)):
        return [(p, g, mo, vo)]
    flat = (p.view(-1), g.reshape(-1), mo.view(-1), vo.view(-1))
    return [tuple(t[i:i + chunk] for t in flat) for i in range(0, p.numel(), chunk)]


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    update_: Callable


def adamw(
    lr: float | Callable = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float | None = 1.0,
    state_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    """``init(params)`` -> state; ``update(grads, state, params)`` ->
    (new params, new state); ``update_(grads, state, params)`` the same
    update written into ``params`` and ``state``."""
    lr_fn = lr if callable(lr) else (lambda step: torch.as_tensor(lr, dtype=torch.float32))

    def init(params):
        first = leaves(params)[0]
        return {
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device),
                          params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device),
                          params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device),
        }

    def scalars(grads, state):
        """(step, clip scale or None, bc1, bc2, lr_t), float32 on the device."""
        step = state["step"] + 1
        scale = None
        if clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        stepf = step.to(torch.float32)
        b1t = torch.tensor(b1, dtype=torch.float32, device=stepf.device)
        b2t = torch.tensor(b2, dtype=torch.float32, device=stepf.device)
        bc1 = 1.0 - b1t ** stepf
        bc2 = 1.0 - b2t ** stepf
        return step, scale, bc1, bc2, lr_fn(step).to(stepf.device)

    def one(p, g, mo, vo, scale, bc1, bc2, lr_t):
        """New (p, m, v) of one leaf, JAX's arithmetic in float32."""
        g = g.float()
        if scale is not None:
            g = g * scale
        m = (b1 * mo.float() + (1 - b1) * g).to(state_dtype)
        v = (b2 * vo.float() + (1 - b2) * g * g).to(state_dtype)
        mh = m.float() / bc1
        vh = v.float() / bc2
        u = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        return (p.float() - lr_t * u).to(p.dtype), m, v

    def update(grads, state, params):
        new_params = tree_map(lambda t: t.detach().clone(), params)
        new_state = tree_map(lambda t: t.detach().clone(), state)
        return update_(grads, new_state, new_params)

    def update_(grads, state, params):
        step, scale, bc1, bc2, lr_t = scalars(grads, state)
        with torch.no_grad():
            for leaf in zip(leaves(params), leaves(grads), leaves(state["m"]),
                            leaves(state["v"])):
                for p, g, mo, vo in _slices(*leaf):
                    np_, nm, nv = one(p, g, mo, vo, scale, bc1, bc2, lr_t)
                    p.copy_(np_)
                    mo.copy_(nm)
                    vo.copy_(nv)
            state["step"].copy_(step)
        return params, state

    return Optimizer(init=init, update=update, update_=update_)
