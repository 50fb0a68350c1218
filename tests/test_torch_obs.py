"""The port's own tracing (``repro_torch.obs``) on the CPU: off, it costs a
flag check (one shared no-op context, no autograd node, the same aten ops);
on, its spans nest as the model's layers do and the MoE counters count each
forward once under remat."""

import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.launch.train import make_train_fns
from repro_torch.launch.serve import make_serve_fns

F32 = dict(param_dtype="float32", compute_dtype="float32")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def tracing_off():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def cfg(arch):
    return get_config(arch).scaled(**F32)


def train_step(arch, remat="full"):
    """A fresh (step, params, opt, batch) of a tiny ``arch``, seeded."""
    fns = make_train_fns(cfg(arch), lr=1e-3, total_steps=10, warmup=1, remat=remat, device=CPU)
    params, opt = fns["init"](torch.Generator().manual_seed(0))
    tok = torch.randint(0, 256, (2, 13), generator=torch.Generator().manual_seed(1))
    return fns["step"], params, opt, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "aten":
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def graph_nodes(t) -> collections.Counter:
    seen, out, todo = set(), collections.Counter(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        out[type(fn).__name__] += 1
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return out


def test_off_span_is_one_shared_no_op():
    a, b = obs.span("rt.attn"), obs.span("rt.train.adamw")
    assert a is b
    with a as got:
        assert got is None
    obs.enable()
    assert obs.span("rt.attn") is not a
    assert isinstance(obs.span("rt.attn"), torch.profiler.record_function)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_no_node_of_obs_in_the_graph(arch):
    c = cfg(arch)
    step, params, opt, batch = train_step(arch)
    from repro_torch.models import forward

    def nodes():
        logits, aux = forward(params, c, batch["tokens"], remat="full")
        return graph_nodes(logits.sum() + aux)

    off = nodes()
    obs.enable()
    on = nodes()
    assert on == off
    assert not [n for n in off if "obs" in n.lower() or "span" in n.lower()]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_the_step_dispatches_the_same_aten_ops_on_and_off(arch):
    logs = {}
    for on in (False, True):
        step, params, opt, batch = train_step(arch)
        (obs.enable if on else obs.disable)()
        with OpLog() as log:
            step(params, opt, batch)
        logs[on] = log.ops
    obs.disable()
    calls = len(obs.counters().get("moe.kept", []))
    # the counters' own ops: one reduction of the kept picks and its detach
    # a MoE layer's forward (not its recompute)
    extra = collections.Counter({"aten.sum.default": calls, "aten.detach.default": calls})
    assert logs[True] - logs[False] == +extra
    assert not logs[False] - logs[True]
    assert calls == (cfg(arch).num_layers if arch.startswith("deepseek") else 0)


def test_off_counts_nothing_and_reset_zeroes():
    step, params, opt, batch = train_step("deepseek-moe-16b")
    step(params, opt, batch)
    assert obs.counters() == {}
    obs.enable()
    step(params, opt, batch)
    got = obs.counters()
    assert set(got) == {"moe.picks", "moe.kept", "moe.slots"}
    assert all(len(v) == cfg("deepseek-moe-16b").num_layers for v in got.values())
    obs.reset()
    assert obs.counters() == {}


def spans_of(prof):
    """(name, thread, start, end) of each ``rt.`` range on the host."""
    return [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("rt.") and e.device_type() == torch.autograd.DeviceType.CPU]


def parents(spans) -> dict:
    """Each span name's set of innermost enclosing span names (None: top)."""
    out = collections.defaultdict(set)
    for name, tid, s, e in spans:
        holders = [(s2, n2) for n2, t2, s2, e2 in spans
                   if t2 == tid and s2 <= s and e <= e2 and (s2, e2) != (s, e)]
        out[name].add(max(holders)[1] if holders else None)
    return dict(out)


FWD = {"rt.train.forward", "rt.train.backward"}  # a layer's forward, or its recompute
TRAIN = {
    "rt.train.forward": {None}, "rt.train.backward": {None}, "rt.train.clip": {None},
    "rt.train.adamw": {None}, "rt.embed": {"rt.train.forward"},
    "rt.head": {"rt.train.forward"}, "rt.loss": {"rt.train.forward"}, "rt.attn": FWD,
}
MOE = dict(TRAIN, **{f"rt.moe.{p}": FWD for p in ("route", "dispatch", "experts", "combine",
                                                   "shared")}, **{"rt.mlp": {"rt.moe.shared"}})
DENSE = dict(TRAIN, **{"rt.mlp": FWD})
SERVE = {"rt.prefill": {None}, "rt.decode.step": {None},
         "rt.embed": {"rt.prefill", "rt.decode.step"}, "rt.attn": {"rt.prefill"},
         "rt.attn.decode": {"rt.decode.step"}, "rt.decode_attention": {"rt.attn.decode"},
         "rt.mlp": {"rt.prefill", "rt.decode.step"}, "rt.head": {"rt.prefill", "rt.decode.step"}}


@pytest.mark.parametrize("arch,want", [("deepseek-moe-16b", MOE), ("qwen3-1.7b", DENSE)])
def test_training_spans_nest_as_the_layers_do(arch, want):
    step, params, opt, batch = train_step(arch)
    obs.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(params, opt, batch)
    got = parents(spans_of(prof))
    assert got == want
    names = [n for n, *_ in spans_of(prof)]
    assert names.count("rt.train.clip") == 2  # the norm reported, and the clip's
    layers = cfg(arch).num_layers
    assert names.count("rt.attn") == 2 * layers  # forward, and its recompute
    assert set(names) == set(want)


def test_serving_spans_nest_as_the_layers_do():
    c = cfg("qwen3-1.7b")
    fns = make_serve_fns(c, 2, 16, device=CPU)
    from repro_torch.models import init_model

    params = init_model(c, generator=torch.Generator().manual_seed(0), device=CPU)
    state = fns["init_state"]()
    tok = torch.randint(0, 256, (2, 6), generator=torch.Generator().manual_seed(1))
    obs.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        from repro_torch.models.transformer import prefill

        prefill(params, c, tok, state)
        fns["decode"](params, state, tok[:, -1:], 6)
    assert parents(spans_of(prof)) == SERVE
