"""The trace's reductions and the per-layer readers on a made-up trace."""

import pytest

from bench.counts import flops
from bench.harness import spec, trace
from bench.reference.arch import Arch
from bench.tests import tiny

EVENTS = [("k1", 100, 200), ("k2", 150, 300), ("flash_bwd_dq", 400, 500),
          ("flash_bwd_dkdv", 500, 700), ("flash_mma_kernel", 800, 900)]
SPANS = [("step", 0, 340), ("batch build", 360, 390), ("step", 395, 1000)]


def summary():
    busy, gaps = trace._union(EVENTS, 0, 1000)
    return {"events": EVENTS, "spans": SPANS, "busy_s": busy / 1e9, "window_s": 1000 / 1e9,
            "breakdown": {"device_ops": trace._top_ops(EVENTS),
                          "idle_gaps": trace._gap_owners(gaps, SPANS)}}


def test_union_and_gaps():
    busy, gaps = trace._union(EVENTS, 0, 1000)
    assert busy == 200 + 300 + 100
    assert gaps == [(0, 100), (300, 400), (700, 800), (900, 1000)]
    owners = dict(trace._gap_owners(gaps, SPANS))
    assert owners == {"step": pytest.approx((100 + 100 + 100) / 1e9),
                      "between spans": pytest.approx(100 / 1e9)}
    assert trace._top_ops(EVENTS)[0] == ["flash_bwd_dkdv", 200 / 1e9]


def test_found_picks_by_name():
    s = summary()
    assert [n for n, _ in trace.found(s, "flash_bwd")] == ["flash_bwd_dq", "flash_bwd_dkdv"]
    assert [n for n, _ in trace.found(s, "flash_", exclude="flash_bwd")] == ["flash_mma_kernel"]


@pytest.mark.parametrize("name", [m["name"] for m in spec.load()["per_layer"]
                                  if m["name"].startswith("idle_share")])
def test_idle_share(name):
    run = {"trace": summary()}
    assert spec.metric_reader(name)(run) == pytest.approx(40.0)
    assert spec.metric_reader(name)({"trace": None}) is None


def test_rooflines_from_the_trace():
    arch = Arch.from_config(tiny.config("qwen3-1.7b"))
    mix = {"batch": 4, "seq_len": 16}
    run = {"arch": arch, "mix": mix, "trace": summary(), "traced": {"steps": 1}}
    bwd = spec.metric_reader("flash_bwd_roofline")(run)
    bound = flops.flash_bwd_bound_s(4, 16, arch.heads, arch.kv_heads, arch.hd)
    assert bwd == pytest.approx(100 * bound / 300e-9)
    run["trace"] = dict(summary(), events=[e for e in EVENTS if "flash" not in e[0]])
    assert spec.metric_reader("flash_bwd_roofline")(run) is None


@pytest.mark.parametrize("name,base", [("train_tokens_per_s.moe", "train_tokens_per_s"),
                                       ("idle_share.train.dense", "idle_share"),
                                       ("decode_mfu", "decode_mfu")])
def test_a_split_metric_is_read_by_its_base_file(name, base):
    assert spec.metric_reader(name).__code__.co_filename.endswith(f"metrics/{base}.py")


def test_a_metric_without_a_reader_is_an_error():
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric.moe")


def test_mfu_readers():
    arch = Arch.from_config(spec.config(spec.load(), "qwen3-1.7b"))
    run = {"arch": arch, "mix": {"batch": 4, "seq_len": 4096},
           "traced": {"steps": 10, "window_s": 11.31}}
    mfu = spec.metric_reader("train_mfu")(run)
    assert mfu == pytest.approx(100 * 10 * flops.train_step_flops(arch, 4, 4096) / (11.31 * 989e12))
    run["traced"] = {"step_s": [0.3365] * 4, "contexts": [31744, 31745, 31746, 31747], "batch": 16}
    dec = spec.metric_reader("decode_mfu")(run)
    assert 5.0 < dec < 6.0
