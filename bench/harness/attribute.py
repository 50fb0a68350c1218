"""Each device event of a traced window put down to one program span and
one phase, on the trace's own clock.

The program (``repro_torch.obs``) opens ``record_function`` spans named
``rt.*`` while its tracing is on; :class:`ProgramWindow` turns it on with
the profiler. A device event's launch is the host's CUDA runtime call with
the same correlation (the profiler links both to the op that made the
call, where one did: a launch made outside every op, as ctypes makes the
flash forward's under inference mode, carries no link and is found by its
correlation alone); it ran on the kernel's thread (``start_thread_id``,
the same ids the spans carry). Then:

* **fwd** -- the innermost program span open on the launch's thread at
  the launch;
* **recompute** -- the same, where that span lies inside
  ``rt.train.backward``: a checkpointed forward run again by the backward
  (``remat="full"``), on autograd's thread;
* **bwd** -- where an autograd node's ``evaluate_function`` opened after
  that span (or with none open) holds the launch: the span of the forward
  op that built the node (the op with the node's sequence number on the
  node's forward thread; the last one started holds it), or, if none is
  found, the program span that holds the launch by time on any thread.

Every device event lands in exactly one (span, phase), or in
:data:`NO_SPAN`. ``top`` is the outermost program span holding the launch
by time on any thread (the training step's four, ``rt.decode.step``...),
``mark`` the innermost benchmark span. The program spans' own device
annotations are left out of the device events, as the benchmark's own
are, so busy time and every reader of ``trace.summarize``'s events read
as they would without program spans. Idle gaps are named by the innermost
span, program or benchmark, open on the host's main thread at the gap's
midpoint.

:func:`summarize` reads the trace once and gives ``trace.summarize``'s
fields with the attribution beside them. It stands beside
``trace.summarize`` / ``trace._gap_owners`` and ``runner.run_cell`` only
until the benchmark opens its window with :class:`ProgramWindow`; then
those two and :func:`trace_cell` (with ``bench/trace_program.py``) go.
"""

from __future__ import annotations

import bisect
import collections
import re
import statistics
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import torch

from bench.harness import spec, trace
from bench.harness.runner import RETAKES, log
from bench.harness.trace import WINDOW, Window
from bench.reference.arch import Arch

RT = "rt."
BACKWARD = "rt.train.backward"
EVALUATE = "autograd::engine::evaluate_function: "
NO_SPAN = "no span"
CUDA_CALL = re.compile(r"cu(da)?[A-Z]")  # a CUDA runtime or driver call's name


@dataclass
class Trace:
    """What attribution reads of a trace, as plain data (ns, thread ids).

    ``kernels`` (name, start, end, thread, launch ns or None), clipped to
    the window as ``trace.summarize`` clips them; ``spans`` the program's
    (name, thread, start, end); ``marks`` the benchmark's; ``evals`` the
    autograd nodes' (thread, start, end, sequence nr, forward thread);
    ``fwd_ops`` (thread, sequence nr) -> start of the last op started with
    that number; ``main`` the window's thread; ``runtime`` the host's CUDA
    runtime and driver calls (name, thread, start, end)."""

    kernels: list
    spans: list
    marks: list = field(default_factory=list)
    evals: list = field(default_factory=list)
    fwd_ops: dict = field(default_factory=dict)
    window: tuple = (0, 0)
    main: int = 0
    runtime: list = field(default_factory=list)


class _Nest:
    """Intervals (start, end, item) that nest on each key (a thread's
    ``record_function`` ranges do): the innermost one holding an instant."""

    def __init__(self, items):
        by = collections.defaultdict(list)
        for key, s, e, item in items:
            by[key].append((s, -e, item))
        self._by = {}
        for key, lst in by.items():
            lst.sort(key=lambda x: (x[0], x[1]))
            starts = [s for s, _, _ in lst]
            ends = [-ne for _, ne, _ in lst]
            parent, stack = [], []
            for i, (s, _, _) in enumerate(lst):
                while stack and ends[stack[-1]] < s:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self._by[key] = (starts, ends, parent, [it for _, _, it in lst])

    def innermost(self, key, t):
        """The innermost item on ``key`` whose interval holds ``t``, or None."""
        got = self._by.get(key)
        if got is None:
            return None
        starts, ends, parent, items = got
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ends[i] < t:
            i = parent[i]
        return items[i] if i >= 0 else None


class _Roots:
    """The outermost of intervals (start, end, item) from any thread that
    holds an instant; an interval inside an earlier one is not a root."""

    def __init__(self, items):
        roots = []
        for s, e, item in sorted(items, key=lambda x: (x[0], -x[1])):
            if not roots or s > roots[-1][1]:
                roots.append((s, e, item))
        self._starts = [r[0] for r in roots]
        self._roots = roots

    def holding(self, t):
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self._roots[i][1] >= t:
            return self._roots[i][2]
        return None


def attribute(tr: Trace) -> list:
    """One record a device event: (name, seconds, span, phase, top, mark,
    step), ``span`` :data:`NO_SPAN` where no program span takes it;
    ``mark`` the innermost benchmark span holding the launch and ``step``
    its ordinal among the window's marks of that name (None where none)."""
    spans = _Nest((t, s, e, (name, s, e)) for name, t, s, e in tr.spans)
    evals = _Nest((t, s, e, (s, seq, fwd)) for t, s, e, seq, fwd in tr.evals)
    back = _Roots((s, e, name) for name, _, s, e in tr.spans if name == BACKWARD)
    top = _Roots((s, e, name) for name, _, s, e in tr.spans)
    any_span = _Nest((None, s, e, name) for name, _, s, e in tr.spans)
    ordinal, counter = {}, collections.Counter()
    for name, _, s, e in sorted(tr.marks, key=lambda m: m[2]):
        ordinal[(name, s)] = counter[name]
        counter[name] += 1
    marks = _Nest((None, s, e, (name, s)) for name, _, s, e in tr.marks)
    out = []
    for name, s, e, tid, launch in tr.kernels:
        secs = (e - s) / 1e9
        if launch is None:
            out.append((name, secs, NO_SPAN, None, None, None, None))
            continue
        sp = spans.innermost(tid, launch)
        ev = evals.innermost(tid, launch)
        if ev is not None and (sp is None or ev[0] > sp[1]):
            phase, span = "bwd", None
            t_fwd = tr.fwd_ops.get((ev[2], ev[1]))
            if t_fwd is not None:
                got = spans.innermost(ev[2], t_fwd)
                span = got[0] if got else None
            if span is None:
                span = any_span.innermost(None, launch)
        elif sp is not None:
            span = sp[0]
            inside = back.holding(sp[1])
            phase = "recompute" if inside and span != BACKWARD else "fwd"
        else:
            span, phase = None, None
        mark = marks.innermost(None, launch)
        out.append((name, secs, span or NO_SPAN, phase, top.holding(launch),
                    mark[0] if mark else None, ordinal[mark] if mark else None))
    return out


def collect(prof, bench_names) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``; the
    device events are ``trace.summarize``'s own (the same filter and
    clip), with the program spans' device annotations (``rt.*``) left
    out."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    skip = set(bench_names) | {WINDOW}
    raw, launches, spans, marks, evals, fwd_ops, runtime = [], {}, [], [], [], {}, []
    window, main, names = None, 0, {}
    for e in prof.profiler.kineto_results.events():
        if e.is_async():
            continue
        if e.device_type() == cuda:
            name = e.name()
            if (e.start_thread_id() == e.end_thread_id() and name not in skip
                    and not name.startswith(RT)):
                if name not in names:
                    names[name] = torch._C._demangle(name) if len(name) > 1 else name
                raw.append((names[name], e.start_ns(), e.end_ns(), e.start_thread_id(),
                            e.correlation_id(), e.linked_correlation_id()))
            continue
        if e.device_type() != cpu:
            continue
        name, tid, link = e.name(), e.start_thread_id(), e.linked_correlation_id()
        if link or CUDA_CALL.match(name):  # a runtime call, inside an op or not
            launches[(e.correlation_id(), link)] = e.start_ns()
            runtime.append((name, tid, e.start_ns(), e.end_ns()))
            continue
        if name == WINDOW:
            window, main = (e.start_ns(), e.end_ns()), tid
        elif name.startswith(RT):
            spans.append((name, tid, e.start_ns(), e.end_ns()))
        elif name in bench_names:
            marks.append((name, tid, e.start_ns(), e.end_ns()))
        elif name.startswith(EVALUATE):
            evals.append((tid, e.start_ns(), e.end_ns(), e.sequence_nr(), e.fwd_thread_id()))
        elif e.sequence_nr() >= 0 and e.fwd_thread_id() == 0:
            key = (tid, e.sequence_nr())
            fwd_ops[key] = max(fwd_ops.get(key, 0), e.start_ns())
    if window is None:
        window = (min((s for _, s, *_ in raw), default=0),
                  max((t for _, _, t, *_ in raw), default=0))
    w0, w1 = window
    kernels = sorted(((n, max(s, w0), min(t, w1), tid, launches.get((corr, link)))
                      for n, s, t, tid, corr, link in raw if t > w0 and s < w1),
                     key=lambda k: k[1])
    return Trace(kernels, spans, marks, evals, fwd_ops, window, main, runtime)


def gap_owners(tr: Trace, gaps=None, n: int = 10) -> list:
    """Idle seconds of the card by the innermost span, program or
    benchmark, open on the main thread at each gap's midpoint ("between
    spans" where none); ``gaps`` the window's idle gaps, from its kernels
    where None."""
    if gaps is None:
        _, gaps = trace._union([k[:3] for k in tr.kernels], *tr.window)
    nest = _Nest((t, s, e, name) for name, t, s, e in tr.spans + tr.marks if t == tr.main)
    total = collections.Counter()
    for g0, g1 in gaps:
        total[nest.innermost(tr.main, (g0 + g1) // 2) or "between spans"] += (g1 - g0) / 1e9
    return [[k, v] for k, v in total.most_common(n)]


def runtime_by_span(tr: Trace, n: int = 12) -> list:
    """The host's heaviest runtime calls: [call, innermost span (program or
    benchmark) open on its thread, calls, seconds], by seconds."""
    nest = _Nest((t, s, e, name) for name, t, s, e in tr.spans + tr.marks)
    total = collections.defaultdict(lambda: [0, 0.0])
    for name, tid, s, e in tr.runtime:
        got = total[(name, nest.innermost(tid, s) or "between spans")]
        got[0] += 1
        got[1] += (e - s) / 1e9
    return sorted(([k[0], k[1], c, t] for k, (c, t) in total.items()), key=lambda x: -x[3])[:n]


def summarize(prof, bench_names, counters=None) -> dict:
    """``trace.summarize``'s fields from one read of the trace (the
    program spans' device annotations left out of the events, the idle
    gaps named by program spans too), and ``program``: the attribution
    (:func:`reduce`), each span's host durations in order (``host_s``,
    program and benchmark spans), the counters and the host's runtime
    calls (:func:`runtime_by_span`)."""
    tr = collect(prof, bench_names)
    events = [k[:3] for k in tr.kernels]
    busy, gaps = trace._union(events, *tr.window)
    host = collections.defaultdict(list)
    for name, _, s, e in sorted(tr.spans + tr.marks, key=lambda x: x[2]):
        host[name].append((e - s) / 1e9)
    return {"events": events,
            "spans": sorted(((n, s, e) for n, _, s, e in tr.marks), key=lambda x: x[1]),
            "busy_s": busy / 1e9, "window_s": (tr.window[1] - tr.window[0]) / 1e9,
            "breakdown": {"device_ops": trace._top_ops(events),
                          "idle_gaps": gap_owners(tr, gaps)},
            "program": dict(reduce(attribute(tr)), host_s=dict(host), counters=counters or {},
                            runtime=runtime_by_span(tr))}


def reduce(records) -> dict:
    """Device seconds by (span, phase) (``by_span``: {span: {phase: s}}),
    by top-level program span (``top``, "" where none), by benchmark mark
    (``marks``, and ``bench_alone`` where no program span holds the
    launch; "" where none), by span and the mark's ordinal (``steps``:
    {span: {"<mark> <ordinal>": s}}), by kernel in each "span phase" (``kernels``) and
    ``total_s``."""
    by_span = collections.defaultdict(lambda: collections.defaultdict(float))
    tops, marks, alone = collections.Counter(), collections.Counter(), collections.Counter()
    steps = collections.defaultdict(lambda: collections.defaultdict(float))
    kern = collections.defaultdict(collections.Counter)
    total = 0.0
    for name, secs, span, phase, top, mark, step in records:
        total += secs
        by_span[span][phase or ""] += secs
        tops[top or ""] += secs
        marks[mark or ""] += secs
        if top is None:
            alone[mark or ""] += secs
        if step is not None:
            steps[span][f"{mark} {step}"] += secs
        kern[f"{span} {phase or ''}".strip()][name] += secs
    return {"by_span": {k: dict(v) for k, v in by_span.items()}, "top": dict(tops),
            "marks": dict(marks), "bench_alone": dict(alone),
            "steps": {k: dict(v) for k, v in steps.items()},
            "kernels": {k: dict(c) for k, c in kern.items()}, "total_s": total}


def kernel_split(program: dict, needle: str) -> dict:
    """Device seconds of the kernels whose name holds ``needle``, by "span
    phase"."""
    out = {}
    for where, by_name in program["kernels"].items():
        secs = sum(v for k, v in by_name.items() if needle in k)
        if secs:
            out[where] = secs
    return out


def shares_line(program: dict) -> str:
    """The stderr line: the busy share under each top-level program span,
    under a benchmark span alone, and under no span."""
    total = program["total_s"]
    if not total:
        return "no device event"
    parts = [f"{k} {100 * v / total:.2f}%" for k, v in
             sorted(program["top"].items(), key=lambda kv: -kv[1]) if k]
    bench = sum(v for k, v in program["bench_alone"].items() if k)
    none = program["bench_alone"].get("", 0.0)
    under = 100 * (total - bench - none) / total
    return (f"program spans {under:.2f}% of {total:.3f} device s ({', '.join(parts)}); "
            f"benchmark span alone {100 * bench / total:.2f}%; no span {100 * none / total:.2f}%")


def span_ms(program: dict, names, phases=None, per: int = 1):
    """Device ms of ``names`` (in ``phases``, all where None) over ``per``
    steps; None where no kernel lands there."""
    got = [s for n in names for ph, s in program["by_span"].get(n, {}).items()
           if phases is None or ph in phases]
    if not got or per <= 0:
        return None
    return 1e3 * sum(got) / per


def moe_series(counters: dict, layers: int) -> list:
    """Each step's (picks, kept, slots) summed over its ``layers`` MoE
    layer calls, from the counters' entries in call order."""
    picks, kept, slots = (counters.get(k, []) for k in ("moe.picks", "moe.kept", "moe.slots"))
    return [(sum(picks[i:i + layers]), sum(kept[i:i + layers]), sum(slots[i:i + layers]))
            for i in range(0, len(picks) - layers + 1, layers)]


def metrics(run: dict, part: str) -> dict:
    """The program-span metrics of a traced run (``run["trace"]`` from
    :func:`summarize`, ``run["traced"]`` the kind's window); ``part`` the
    training cell's suffix (``moe``, ``dense``), None for decode."""
    prog, m = run["trace"]["program"], run["traced"]
    out = {}
    if "steps" in m:
        n = m["steps"]
        out[f"adamw_ms.{part}"] = span_ms(prog, ("rt.train.clip", "rt.train.adamw"), per=n)
        out[f"loss_head_ms.{part}"] = span_ms(prog, ("rt.head", "rt.loss"), ("fwd", "bwd"), n)
        if "rt.moe.dispatch" in prog["by_span"]:
            out["moe_dispatch_ms"] = span_ms(prog, ("rt.moe.dispatch",), per=n)
            out["moe_combine_ms"] = span_ms(prog, ("rt.moe.combine",), per=n)
        calls = len(prog["counters"].get("moe.picks", []))
        series = moe_series(prog["counters"], calls // n) if n and calls else []
        picks, kept, slots = (sum(x) for x in zip(*series)) if series else (0, 0, 0)
        if picks:
            out["moe_slot_use"] = 100.0 * kept / slots
            out["moe_dropped_share"] = 100.0 * (picks - kept) / picks
    else:
        n = len(m["step_s"])
        out["decode_attention_ms"] = span_ms(prog, ("rt.decode_attention",), per=n)
        host = prog["host_s"].get("rt.decode.step")
        out["decode_host_ms"] = 1e3 * statistics.median(host) if host else None
    return {k: v for k, v in out.items() if v is not None}


class ProgramWindow(Window):
    """``Window`` that, when traced, turns the program's spans and counters
    on with the profiler (``obs.reset()`` at the start, the counters read
    after the final sync), summarizes with :func:`summarize` and prints
    :func:`shares_line` after ``label``."""

    def __init__(self, trace: bool, device, label: str = "window"):
        super().__init__(trace, device)
        self.label = label

    def __enter__(self):
        if self.trace:
            from repro_torch import obs

            obs.reset()
            obs.enable()
        return super().__enter__()

    def __exit__(self, *exc):
        if not self.trace:
            return super().__exit__(*exc)
        from repro_torch import obs

        self.sync()
        obs.disable()
        self._outer.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self.prof, self.span_names, obs.counters())
            log(f"{self.label} attribution: {shares_line(self.summary['program'])}")
        self.prof = None
        return False


def trace_cell(cell: str, config: dict, mix: dict, seed: int, seconds: float, device,
               t0: float | None = None) -> dict:
    """One run of a cell's set-up and window, each under
    :class:`ProgramWindow` (no reference check): the ``run`` a metric
    reader reads, its ``trace`` the window's :func:`summarize` (a short
    window traced again where the profiler lost every device event, as
    ``runner.run_cell`` does) and ``setup_trace`` the set-up's (the decode
    cell's fill is ``rt.prefill``)."""
    t0 = time.perf_counter() if t0 is None else t0
    ctx = SimpleNamespace(cell=cell, config=config, mix=mix, arch=Arch.from_config(config),
                          seed=int(seed), device=device, fault=None, control=False,
                          mark=lambda what: log(f"{what} {time.perf_counter() - t0:.3f} s"))
    kind = spec.kind_module(mix["kind"])
    with ProgramWindow(True, device, "set-up") as sw:
        state = kind.setup(ctx)
    setup_s = time.perf_counter() - t0
    with ProgramWindow(True, device) as w:
        measured = kind.window(ctx, state, seconds, w)
    summary, traced = w.summary, measured
    for _ in range(RETAKES):
        if summary and summary["events"]:
            break
        log("profiler: no device event in the window's trace; tracing a short window again")
        with ProgramWindow(True, device) as w2:
            traced = kind.window(ctx, state, max(2.0, seconds / 10), w2)
        summary = w2.summary
    return {"arch": ctx.arch, "mix": mix, "config": config, "setup_s": setup_s,
            "measured": measured, "traced": traced, "trace": summary,
            "setup_trace": sw.summary}
