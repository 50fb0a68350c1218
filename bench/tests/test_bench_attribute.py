"""Each kernel put down to one program span and phase, on made-up traces:
the launch's thread, the recompute, the backward through the autograd
node's forward op, launches outside every span, the program spans' device
annotations left out of the readings, and idle gaps named by program
spans."""

from types import SimpleNamespace

import pytest
import torch

from bench.harness import attribute, spec, trace
from bench.harness.attribute import NO_SPAN, Trace
from bench.reference.arch import Arch
from bench.tests import tiny

MAIN, BWD, OTHER = 1, 2, 3
SPANS = [("rt.train.forward", MAIN, 200, 3000), ("rt.moe.dispatch", MAIN, 1000, 2000),
         ("rt.other", OTHER, 1400, 1600), ("rt.train.backward", MAIN, 3100, 7000),
         ("rt.moe.dispatch", BWD, 4000, 4500), ("rt.train.adamw", MAIN, 7100, 8000)]
MARKS = [("step", MAIN, 100, 9000)]
# autograd's node of the dispatch (sequence nr 5, built on the main thread),
# evaluated on autograd's thread; the recompute runs inside it
EVALS = [(BWD, 3500, 6000, 5, MAIN)]
FWD_OPS = {(MAIN, 5): 1500, (MAIN, 6): 2500}


def made_up(kernels) -> Trace:
    return Trace(kernels=kernels, spans=SPANS, marks=MARKS, evals=EVALS, fwd_ops=FWD_OPS,
                 window=(0, 10_000), main=MAIN)


def one(launch, tid):
    (got,) = attribute.attribute(made_up([("k", launch + 10, launch + 20, tid, launch)]))
    return got


def test_a_kernel_goes_to_the_innermost_span_on_its_launchs_thread():
    name, secs, span, phase, top, mark, step = one(1500, MAIN)
    assert (span, phase, top, mark, step) == ("rt.moe.dispatch", "fwd", "rt.train.forward",
                                              "step", 0)
    assert secs == pytest.approx(10e-9)
    assert one(1500, OTHER)[2:4] == ("rt.other", "fwd")
    assert one(2500, MAIN)[2:4] == ("rt.train.forward", "fwd")


def test_a_forward_span_inside_the_backward_is_the_recompute():
    assert one(4200, BWD)[2:5] == ("rt.moe.dispatch", "recompute", "rt.train.backward")


def test_a_backward_kernel_goes_to_its_forward_ops_span():
    assert one(5000, BWD)[2:5] == ("rt.moe.dispatch", "bwd", "rt.train.backward")
    assert one(3600, BWD)[2:4] == ("rt.moe.dispatch", "bwd")


def test_a_backward_kernel_without_its_forward_op_goes_to_the_span_by_time():
    tr = made_up([("k", 5010, 5020, BWD, 5000)])
    tr.fwd_ops = {}
    assert attribute.attribute(tr)[0][2:4] == ("rt.train.backward", "bwd")


def test_a_launch_outside_every_span_is_no_span():
    assert one(9500, MAIN)[2:] == (NO_SPAN, None, None, None, None)
    assert one(8500, MAIN)[2:] == (NO_SPAN, None, None, "step", 0)
    (got,) = attribute.attribute(made_up([("k", 10, 20, MAIN, None)]))
    assert got[2] == NO_SPAN


def test_the_reduction_and_its_line():
    recs = attribute.attribute(made_up([("a", 1510, 1610, MAIN, 1500),
                                        ("b", 4210, 4310, BWD, 4200),
                                        ("c", 5010, 5210, BWD, 5000),
                                        ("d", 8510, 8610, MAIN, 8500),
                                        ("e", 9510, 9610, MAIN, 9500)]))
    prog = attribute.reduce(recs)
    assert prog["by_span"]["rt.moe.dispatch"] == pytest.approx(
        {"fwd": 100e-9, "recompute": 100e-9, "bwd": 200e-9})
    assert prog["top"] == pytest.approx({"rt.train.forward": 100e-9,
                                         "rt.train.backward": 300e-9, "": 200e-9})
    assert prog["bench_alone"] == pytest.approx({"step": 100e-9, "": 100e-9})
    assert prog["marks"] == pytest.approx({"step": 500e-9, "": 100e-9})
    assert attribute.kernel_split(prog, "b") == pytest.approx({"rt.moe.dispatch recompute":
                                                                100e-9})
    assert prog["steps"]["rt.moe.dispatch"] == pytest.approx({"step 0": 400e-9})
    line = attribute.shares_line(prog)
    assert "program spans 66.67%" in line and "no span 16.67%" in line
    assert "benchmark span alone 16.67%" in line
    assert attribute.shares_line(attribute.reduce([])) == "no device event"


def test_idle_gaps_are_named_by_the_innermost_program_span():
    kernels = [("k", 1100, 1200, MAIN, 1100), ("k", 1300, 7150, MAIN, 1250),
               ("k", 7250, 8600, MAIN, 7200), ("k", 8800, 9100, MAIN, 8700),
               ("k", 9300, 10_000, MAIN, 9200)]
    owners = dict(attribute.gap_owners(made_up(kernels)))
    # (0, 1100) mid 550 in forward; (1200, 1300) mid 1250 in dispatch on the
    # main thread (rt.other on another thread does not name it); (7150,
    # 7250) in adamw; (8600, 8800) in the step alone; (9100, 9300) in none
    assert owners == pytest.approx({"rt.train.forward": 1100e-9, "rt.moe.dispatch": 100e-9,
                                    "rt.train.adamw": 100e-9, "step": 200e-9,
                                    "between spans": 200e-9})


class Ev:
    """A kineto event as ``trace.summarize`` and ``attribute.collect`` read it."""

    def __init__(self, name, cuda, s, e, tid=MAIN, corr=0, link=0, seq=-1, fwd=0):
        self._v = (name, cuda, s, e, tid, corr, link, seq, fwd)

    def name(self):
        return self._v[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[1] else torch.autograd.DeviceType.CPU

    def is_async(self):
        return False

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    end_thread_id = start_thread_id

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def sequence_nr(self):
        return self._v[7]

    def fwd_thread_id(self):
        return self._v[8]


def prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


DEVICE = [("k1", 100, 200), ("k2", 150, 300), ("flash_bwd_dq", 400, 500),
          ("flash_bwd_dkdv", 500, 700), ("flash_mma_kernel", 800, 900)]
BENCH = [Ev("window", False, 0, 1000), Ev("step", False, 10, 990)]
PROGRAM = [Ev("rt.attn", False, 20, 320, corr=7), Ev("rt.attn", True, 100, 700),
           Ev("rt.train.backward", False, 330, 980, corr=8),
           Ev("rt.train.backward", True, 20, 990)]


def kernels():
    out = []
    for i, (n, s, e) in enumerate(DEVICE):
        out += [Ev(n, True, s, e, corr=100 + i, link=7 if i < 2 else 8),
                Ev("cudaLaunchKernel", False, s - 50, s - 40, corr=100 + i,
                   link=7 if i < 2 else 8)]
    return out


def test_program_annotations_leave_the_readings_as_they_were():
    without = trace.summarize(prof(BENCH + kernels()), {"step"})
    with_rt = attribute.summarize(prof(BENCH + PROGRAM + kernels()), {"step"})
    # the unchanged summary would count the annotations as busy time
    assert trace.summarize(prof(BENCH + PROGRAM + kernels()), {"step"})["busy_s"] > \
        without["busy_s"]
    assert with_rt["events"] == without["events"]
    assert with_rt["busy_s"] == without["busy_s"] and with_rt["window_s"] == without["window_s"]
    assert with_rt["spans"] == without["spans"]
    assert with_rt["breakdown"]["device_ops"] == without["breakdown"]["device_ops"]
    arch = Arch.from_config(tiny.config("qwen3-1.7b"))
    names = [m["name"] for m in spec.load()["per_layer"]
             if m["name"].startswith("idle_share") or m["name"] == "flash_bwd_roofline"]
    assert "flash_bwd_roofline" in names and len(names) == 4
    for name in names:
        def read(s):
            return spec.metric_reader(name)({"arch": arch, "mix": {"batch": 4, "seq_len": 16},
                                             "trace": s, "traced": {"steps": 1}})
        assert read(with_rt) == read(without) is not None
    prog = with_rt["program"]
    assert prog["by_span"].keys() == {"rt.attn", "rt.train.backward"}
    assert prog["by_span"]["rt.attn"] == pytest.approx({"fwd": 250e-9})
    assert prog["by_span"]["rt.train.backward"] == pytest.approx({"fwd": 400e-9})
    assert prog["host_s"]["rt.attn"] == [300e-9]
    assert prog["runtime"] == [["cudaLaunchKernel", "rt.train.backward", 3, pytest.approx(30e-9)],
                               ["cudaLaunchKernel", "rt.attn", 2, pytest.approx(20e-9)]]


def test_a_launch_made_outside_every_op_goes_to_its_span_by_correlation():
    # a ctypes launch (no aten op around it): runtime call and kernel share
    # the correlation and carry no link; an op's own correlation id that
    # happens to be the same number names no launch
    events = BENCH + [Ev("rt.attn", False, 20, 320), Ev("cudaLaunchKernel", False, 50, 60, corr=9),
                      Ev("aten::empty", False, 12, 15, corr=9),
                      Ev("flash_mma_kernel", True, 100, 300, corr=9)]
    prog = attribute.summarize(prof(events), {"step"})["program"]
    assert prog["by_span"] == {"rt.attn": {"fwd": pytest.approx(200e-9)}}
    assert prog["runtime"] == [["cudaLaunchKernel", "rt.attn", 1, pytest.approx(10e-9)]]


@pytest.mark.parametrize("part", ["moe", "dense"])
def test_metrics_read_nothing_where_no_kernel_landed(part):
    prog = attribute.reduce(attribute.attribute(made_up([("k", 1510, 1610, MAIN, 1500)])))
    prog.update(host_s={}, counters={})
    run = {"trace": {"program": prog}, "traced": {"steps": 2}}
    got = attribute.metrics(run, part)
    assert got == {"moe_dispatch_ms": pytest.approx(1e3 * 100e-9 / 2)}
    assert attribute.metrics({"trace": {"program": prog}, "traced": {"step_s": [0.1]}},
                             None) == {}
