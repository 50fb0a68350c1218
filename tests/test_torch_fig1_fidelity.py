"""``chip_smoke.py``'s phase 12 copies of the JAX package's benchmarks,
on the CPU: its copy of ``benchmarks/fig1_motivation.py`` (TPP against first
touch over Fig. 1's grid) and of ``benchmarks/fig_model_fidelity.py`` (the
interval cost model against the timing engine, the quick contract and the
per-regime divergences), at quick sizes.

The smoke is imported by path and run with the card's default device
patched to the CPU; the benchmarks run as the JAX package runs them, with
their trace cache and RunSet cache in a temporary directory. Exact: the
port's rows, payloads and divergences equal the benchmarks' to the bit.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.sim.costmodel import OPTANE_LIKE as REF_OPTANE
from repro.sim.workloads import WORKLOADS as REF_WORKLOADS
from repro.timing import calibrate as ref_calibrate
from repro_torch.sim import api, torch_engine
from repro_torch.sim.costmodel import OPTANE_LIKE
from repro_torch.timing import calibrate
from repro_torch.timing import engine as timing_engine

from _torch_port import to_port

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from benchmarks import fig1_motivation as bench_fig1  # noqa: E402
from benchmarks import fig_model_fidelity as bench_fid  # noqa: E402

# quick sizes of Fig. 1's two scenarios and two fidelity workloads
FIG1_TRACES = {
    "bfs": dict(n=60_000, n_sources=4),
    "thrash": dict(rss_pages=3_000, n_intervals=16),
}
FID_TRACES = {
    "thrash": dict(rss_pages=2_000, n_intervals=6),
    "pagerank": dict(n=30_000, iters=3),
}
FID_FRACS = (1.0, 0.6, 0.3)
# the serial chain's links, which only the card can time (replay_cost)
LINKS = {"load_ns": 500.0, "f64_add_ns": 5.0, "window_chain_ns": 30.0, "shfl_step_ns": 20.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run thousands of tiny torch ops (the replay's windows):
    one intra-op thread, since idle pool threads only spin beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def on_cpu(monkeypatch):
    """The card's default device is the CPU (``device=None`` callers)."""
    cpu = torch.device("cpu")
    for mod in (api, torch_engine, timing_engine):
        monkeypatch.setattr(mod, "resolve_device", lambda device=None: cpu)


def _traces(spec):
    out = {}
    for name, kw in spec.items():
        ref = REF_WORKLOADS[name](**kw)
        out[name] = (ref, to_port(ref))
    return out


@pytest.fixture(scope="module")
def fig1_traces():
    return _traces(FIG1_TRACES)


@pytest.fixture(scope="module")
def fid_traces():
    return _traces(FID_TRACES)


def test_fig1_rows_match_the_benchmark(smoke, fig1_traces, tmp_path, monkeypatch):
    monkeypatch.setattr(bench_fig1, "CACHE", tmp_path)
    monkeypatch.setattr(bench_fig1, "get_trace", lambda n: fig1_traces[n][0])
    lines = {}
    bench_fig1.run(lambda name, us, derived: lines.__setitem__(name, derived))
    rs = smoke.fig1_run({n: t[1] for n, t in fig1_traces.items()}, device="cpu")
    rows = smoke.fig1_rows(rs)
    for name in smoke.FIG1_SCENARIOS:
        for f in smoke.FIG1_GRID:
            r = rows[name][f]
            assert lines[f"fig1/{name}_fm_{int(f*1000)}"] == (
                f"tpp_loss={r['tpp_loss']*100:.2f}%;ft_loss={r['ft_loss']*100:.2f}%"
                f";migr={r['migrations']};fail={r['pgpromote_fail']}")
    assert lines["fig1/summary"].startswith(
        f"loss@89.5={rows['bfs'][0.895]['tpp_loss']*100:.2f}% (paper 4.4%);"
        f" loss@26.6={rows['bfs'][0.266]['tpp_loss']*100:.2f}% (paper 30.2%)")
    # first touch never migrates; at full size it is TPP
    assert rows["thrash"][1.0]["ft_loss"] == 0.0
    assert any(rows["thrash"][f]["ft_loss"] > 0 for f in smoke.FIG1_GRID)


def test_fig1_first_touch_runs_on_the_device_step(smoke, fig1_traces):
    rs = smoke.fig1_run({n: t[1] for n, t in fig1_traces.items()}, device="cpu")
    assert rs.backends == ("torch_sweep",)
    assert all(r.result.migrations == 0 for r in rs.runs if r.policy == "first_touch")


@pytest.mark.parametrize("name", list(FID_TRACES))
def test_fidelity_clock_pair_matches_the_benchmark(smoke, fid_traces, name, on_cpu):
    ref_tr, tr = fid_traces[name]
    ref_cal = ref_calibrate(REF_OPTANE)
    cal = calibrate(OPTANE_LIKE, device="cpu")
    assert cal.to_dict() == ref_cal.to_dict()
    ref_model, ref_timing = bench_fid.clock_pair(ref_tr, name, fracs=FID_FRACS, cal=ref_cal)
    model, timing = smoke.clock_pair(tr, name, fracs=FID_FRACS, cal=cal, device="cpu")
    assert [r.result.interval_times.tolist() for r in model.runs] == [
        r.result.interval_times.tolist() for r in ref_model.runs]
    assert [r.result for r in timing.runs] == [r.result for r in ref_timing.runs]
    want = bench_fid.divergences(ref_tr, ref_model, ref_timing, fracs=FID_FRACS)
    got = smoke.divergences(tr, model, timing, fracs=FID_FRACS)
    assert got["by_regime"] == want["by_regime"]
    assert {f: d.tolist() for f, d in got["per_frac"].items()} == {
        f: d.tolist() for f, d in want["per_frac"].items()}
    summary = smoke.fidelity_summary(model, timing)
    tm, tt = ref_model.total_times(), ref_timing.total_times()
    d = (tt - tm) / np.maximum(tm, 1e-30)
    assert summary["per_frac"] == d.tolist()
    assert summary["mean_abs"] == float(np.mean(np.abs(d)))
    assert summary["max_abs"] == float(np.max(np.abs(d)))


def test_fidelity_regime_is_the_benchmarks(smoke):
    rng = np.random.default_rng(0)
    for _ in range(20):
        counts = rng.integers(1, 100, size=int(rng.integers(0, 50)))
        counts[: int(rng.integers(0, 5))] *= 50
        args = (counts, float(rng.uniform(0, 1)), float(rng.uniform(0, 2)))
        assert smoke.fidelity_regime(*args) == bench_fid._regime(*args)


def test_fidelity_quick_contract_matches_the_benchmark(smoke, on_cpu, monkeypatch, capsys):
    """The smoke's copy of the quick contract passes on the CPU lane, and its
    timing payloads equal the JAX package's clock_pair on the same traces."""
    bench_fid._quick_smoke()
    assert "fidelity-smoke ok." in capsys.readouterr().out
    fails = []
    monkeypatch.setattr(smoke, "check", lambda c, msg: c or fails.append(msg))
    quick = smoke.fidelity_quick("cpu")
    assert fails == []
    ref_cal = ref_calibrate(REF_OPTANE, max_events=bench_fid.MAX_EVENTS)
    assert quick["calibration"] == ref_cal.to_dict()
    ref_tr = REF_WORKLOADS["thrash"](n_intervals=10, rss_pages=4_000)
    _, ref_timing = bench_fid.clock_pair(ref_tr, "thrash_smoke", fracs=(1.0, 0.7, 0.4),
                                         cal=ref_cal)
    assert quick["thrash"]["payloads"] == [r.result for r in ref_timing.runs]


def test_fidelity_run_reports_every_workload(smoke, fid_traces, on_cpu):
    cal = calibrate(OPTANE_LIKE, device="cpu")
    out = smoke.fidelity_run({n: t[1] for n, t in fid_traces.items()}, cal, device="cpu")
    assert set(out["rows"]) == set(FID_TRACES)
    for row in out["rows"].values():
        assert len(row["per_frac"]) == len(smoke.FIDELITY_FRACS)
        assert row["max_abs"] >= row["mean_abs"] >= 0.0
        assert row["events"] > 0
    assert sum(r["n"] for r in out["regimes"].values()) == len(smoke.FIDELITY_FRACS) * sum(
        len(t[1]) for t in fid_traces.values())


def test_timing_lane_real_size_checks_run_on_a_small_trace(smoke, on_cpu, monkeypatch):
    """Phase 12 (g) on a small trace: conservation and the channel floor hold
    and every interval is replayed; the prefix launch takes each replay's
    first REPLAY_PREFIX events. Only the launch count (the CPU path
    launches nothing) cannot pass here; the chain's links and the pre-pass
    and walker timed apart, which only the card can measure, are fixed."""
    import repro_torch.kernels.timing_replay as kernel

    fails = []
    monkeypatch.setattr(smoke, "check", lambda c, msg: c or fails.append(msg))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(kernel, "chain_latency_ns", lambda n, dev: LINKS)
    monkeypatch.setattr(smoke, "replay_split", lambda args, repeats: {"walk_ms": 1.0})
    from repro_torch.sim.workloads import thrash_trace

    tr = thrash_trace(rss_pages=6_000, n_intervals=4)
    row, (args, t_app) = smoke.timing_full(torch.device("cpu"), tr)
    assert fails == ["the real-size timing lane launched timing_replay 0 times, not once"]
    assert row["intervals"] == len(tr) and row["replays"] == len(tr) == t_app.numel()
    assert row["chain_ms"] > 0 and row["bound_ms"] >= row["chain_ms"]
    assert row["chain_ms_with_loads"] > row["chain_ms"] and row["walk_ms"] == 1.0
    launch, got = smoke.prefix_launch(args)
    sizes = [min(smoke.REPLAY_PREFIX, e) for e in row["events_per_interval"] if e]
    assert launch[4].tolist() == np.concatenate([[0], np.cumsum(sizes)]).tolist()
    assert torch.equal(launch[7], args[7]) and got.numel() == len(sizes)
    first = smoke.sub_launch(args, 0, 1)
    assert smoke.plain_replay([a.numpy() for a in first]) == t_app[:1].tolist()


def test_per_size_engine_check_passes_on_the_cpu(smoke, fig1_traces, on_cpu,
                                                 monkeypatch):
    fails = []
    monkeypatch.setattr(smoke, "check", lambda c, msg: c or fails.append(msg))
    out = smoke.per_size_engine(torch.device("cpu"), fig1_traces["thrash"][1])
    assert fails == []
    assert out["cells"] == 12


def test_fig1_full_uses_one_pass_per_kind(smoke, on_cpu):
    from repro_torch.sim.workloads import thrash_trace

    out = smoke.fig1_full(thrash_trace(rss_pages=5_000, n_intervals=3))
    assert set(out["rows"]) == {str(f) for f in smoke.FIG1_GRID}
    assert out["rows"]["1.0"]["tpp_loss"] == 0.0 == out["rows"]["1.0"]["ft_loss"]


def test_replay_cost_counts_the_stream(smoke, monkeypatch):
    """Bytes (events, per-replay arrays, t_app) and the bound: the longest
    replay's chain at the links measured on the card (fixed here), each
    window one window chain plus its t - dm and shuffle steps, past the bytes' time,
    so counted as operations; the old load-based chain beside it."""
    import repro_torch.kernels.timing_replay as kernel

    monkeypatch.setattr(kernel, "chain_latency_ns", lambda n, dev: LINKS)
    page = torch.zeros(10, dtype=torch.int32)
    args = (page, torch.zeros(10, dtype=torch.int8), torch.zeros(10, dtype=torch.float64),
            torch.zeros(10, dtype=torch.float64), torch.tensor([0, 4, 10]),
            torch.tensor([2, 3]), torch.zeros(2, 2, dtype=torch.float64),
            torch.tensor([5, 5]))
    cost = smoke.replay_cost(args)
    assert (cost["events"], cost["replays"], cost["windows"]) == (10, 2, 4)
    assert cost["bytes"] == 10 * 21 + 2 * 48 + 2 * 8
    # two windows of 2 events (t - dm and one shuffle step each), two of 3
    # (t - dm and two steps each)
    wide = LINKS["window_chain_ns"] + LINKS["f64_add_ns"]
    chain = max(2 * (wide + LINKS["shfl_step_ns"]), 2 * (wide + 2 * LINKS["shfl_step_ns"])) / 1e6
    assert cost["chain_ms"] == pytest.approx(chain) == cost["bound_ms"]
    assert cost["bound_by"] == "operations"
    with_loads = max(2 * LINKS["load_ns"] + 4 * LINKS["f64_add_ns"],
                     2 * LINKS["load_ns"] + 6 * LINKS["f64_add_ns"]) / 1e6
    assert cost["chain_ms_with_loads"] == pytest.approx(with_loads)

