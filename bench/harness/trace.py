"""The measured window, with or without ``torch.profiler``; the trace's
device events, busy time and breakdown.

The benchmark's own spans (``record_function``) go around its calls into
each layer (the kinds name them: ``step``, ``batch build``, ``decode
step``, ``sampling``); ``window`` spans the whole window. A device event is a
kernel, copy or set on the card (the profiler's raw results, as
``chip_smoke.py``'s ``_cuda_events`` reads them: asynchronous events and
the spans' own device annotations left out). The profiler can lose
launches, and now and then a whole trace: a reader counts the events it
finds against the launches it expects and says so, and a trace with no
device event is taken again by the runner."""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

WINDOW = "window"


class Window:
    """``with Window(trace, device) as w:`` around the measured loop;
    ``w.span(name)`` marks a call into a layer, ``w.elapsed()`` is the
    window's length so far by the host clock and ``w.summary`` (traced
    only) the trace's reading."""

    def __init__(self, trace: bool, device):
        self.trace, self.device = trace, device
        self.prof, self.summary = None, None
        self._outer = None
        self.span_names: set = set()

    def span(self, name: str):
        if not self.trace:
            return contextlib.nullcontext()
        self.span_names.add(name)
        return torch.profiler.record_function(name)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self.sync()
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self._outer = torch.profiler.record_function(WINDOW)
            self._outer.__enter__()
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def __exit__(self, *exc):
        self.sync()
        if self.trace:
            self._outer.__exit__(*exc)
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = summarize(self.prof, self.span_names)
            self.prof = None
        return False


def summarize(prof, span_names) -> dict:
    """``events`` (name, start ns, end ns) on the card inside the window,
    ``spans`` of the benchmark's own marks, ``busy_s`` (the union of the
    device events), ``window_s``, and the ``breakdown``."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    raw_events = list(prof.profiler.kineto_results.events())
    spans, window = [], None
    for e in raw_events:
        if e.device_type() == cpu and not e.is_async():
            if e.name() == WINDOW:
                window = (e.start_ns(), e.end_ns())
            elif e.name() in span_names:
                spans.append((e.name(), e.start_ns(), e.end_ns()))
    names: dict = {}
    events = []
    for e in raw_events:
        if (e.device_type() != cuda or e.is_async()
                or e.start_thread_id() != e.end_thread_id()):
            continue
        raw = e.name()
        if raw in span_names or raw == WINDOW:
            continue
        if raw not in names:
            names[raw] = torch._C._demangle(raw) if len(raw) > 1 else raw
        events.append((names[raw], e.start_ns(), e.end_ns()))
    if window is None:
        window = (min((s for _, s, _ in events), default=0), max((t for _, _, t in events), default=0))
    w0, w1 = window
    events = sorted(((n, max(s, w0), min(t, w1)) for n, s, t in events if t > w0 and s < w1),
                    key=lambda x: x[1])
    busy, gaps = _union(events, w0, w1)
    return {"events": events, "spans": sorted(spans, key=lambda x: x[1]),
            "busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "breakdown": {"device_ops": _top_ops(events), "idle_gaps": _gap_owners(gaps, spans)}}


def _union(events, w0, w1):
    """(ns covered by any event, the idle gaps (start, end) between them)."""
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for _, s, e in events:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            else:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((cur_e, w1))
    return busy, [g for g in gaps if g[1] > g[0]]


def _top_ops(events, n: int = 10) -> list:
    total = collections.Counter()
    for name, s, e in events:
        total[name[:120]] += (e - s) / 1e9
    return [[k, v] for k, v in total.most_common(n)]


def _gap_owners(gaps, spans, n: int = 10) -> list:
    """Idle seconds of the card by the innermost benchmark span the host
    was in at each gap's midpoint ("between spans" where none)."""
    spans = sorted(spans, key=lambda x: x[1])
    starts = [s for _, s, _ in spans]
    total = collections.Counter()
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        owner = "between spans"
        i = bisect.bisect_right(starts, mid) - 1
        for name, _, e in spans[max(0, i - 3):i + 1][::-1]:  # spans nest at most a few deep
            if e >= mid:
                owner = name
                break
        total[owner] += (g1 - g0) / 1e9
    return [[k, v] for k, v in total.most_common(n)]


def found(summary: dict, needle: str, exclude: str | None = None) -> list:
    """The device events whose name holds ``needle`` (and not ``exclude``):
    (name, seconds)."""
    return [(n, (e - s) / 1e9) for n, s, e in summary["events"]
            if needle in n and (exclude is None or exclude not in n)]
