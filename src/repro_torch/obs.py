"""The program's own tracing: named spans on the profiler's clock, and
counters kept on the device.

Tracing is off by default, and only :func:`enable` / :func:`disable` turn
it on and off (a harness calls them around a profiled window; no
environment variable or argument does). While it is off, :func:`span`
returns one shared no-op context and nothing else runs: a bare
``record_function`` costs about 10 µs a call even with no profiler
running, the check about 0.6 µs.

* :func:`span` -- a ``torch.profiler.record_function`` range. Every name
  starts with ``rt.``, so a trace reader can tell the program's spans from
  its own. The ranges land in the same kineto trace as the kernels and the
  host's CUDA runtime calls, so each kernel can be put down to the
  innermost span that was open when it was launched.
* :func:`count` -- adds to a named counter, a value per call in call
  order (a Python int, or a device tensor kept as it is: no host sync).
  :func:`counting` says whether a caller should compute what it counts:
  tracing is on and the caller is not inside a backward pass, where
  activation checkpointing runs a forward again (``remat="full"``), so
  that each forward is counted once. It reads autograd's current graph
  task through the private ``torch._C._current_graph_task_id()`` (-1
  outside a backward); the counter test under remat "full" fails if a
  PyTorch release changes that.
* :func:`reset` empties the counters;
  :func:`counters` reads them, each a list of ints in call order (one
  sync a counter).

Spans in the model (``rt.embed``, ``rt.attn``, ``rt.mlp``, ``rt.moe.*``,
``rt.head``, ``rt.loss``; ``rt.decode.step``, ``rt.attn.decode``,
``rt.decode_attention``, ``rt.prefill``), the training step
(``rt.train.forward``, ``.backward``, ``.clip``, ``.adamw``), and the MoE
layer's counters ``moe.picks`` (tokens x top-k), ``moe.kept`` (picks
below capacity) and ``moe.slots`` (experts x groups x capacity, the slots
the experts compute over) are where the model code calls them.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


class _State:
    """The process's switch and the counters."""

    def __init__(self):
        self.on = False
        self.counts: dict = {}


_STATE = _State()


def enable() -> None:
    """Turn the spans and counters on."""
    _STATE.on = True


def disable() -> None:
    """Turn them off; the counters keep what they hold."""
    _STATE.on = False


def span(name: str):
    """A ``record_function`` range named ``name`` (``rt.`` and the layer)
    while tracing is on; the shared no-op context while it is off."""
    if not _STATE.on:
        return _OFF
    return torch.profiler.record_function(name)


def counting() -> bool:
    """Tracing is on and the caller is not inside a backward pass (where
    a checkpointed forward runs again; autograd's graph task id, private
    to torch, is -1 outside one)."""
    return _STATE.on and torch._C._current_graph_task_id() == -1


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a 0-d device tensor, kept without a
    sync) to counter ``name`` as this call's entry."""
    if _STATE.on:
        _STATE.counts.setdefault(name, []).append(
            value.detach() if isinstance(value, torch.Tensor) else int(value))


def reset() -> None:
    """Empty every counter."""
    _STATE.counts = {}


def counters() -> dict:
    """``{name: [int a call, in call order]}``; the device entries of a
    counter are read in one transfer."""
    out = {}
    for name, vals in _STATE.counts.items():
        dev = [v for v in vals if isinstance(v, torch.Tensor)]
        host = iter(torch.stack(dev).cpu().tolist()) if dev else iter(())
        out[name] = [next(host) if isinstance(v, torch.Tensor) else v for v in vals]
    return out
