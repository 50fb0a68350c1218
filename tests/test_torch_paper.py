"""The paper's experiment through the port == the JAX package's, exactly,
on the CPU.

``chip_smoke.py`` rebuilds the JAX package's benchmark database
(``benchmarks/common.py::build_bench_db``) and Figs. 3-7
(``benchmarks/fig3_7_tuning.py``) on the port's entry points, and drives
them on the card. Here its builder and its runs are imported, run with the
device patched to the CPU on reduced traces of the seven workloads, and
held field by field against the benchmark code of the JAX package (its
trace cache and RunSet cache sent to a temporary directory): the database
records, TPP vs TPP+Tuna at tau = 5% on the five paper workloads, the
thrash knee block over ``tpp``, ``admission`` and ``thrash_guard``, and the
``thrash_guard`` kind untuned over several sizes.
"""

import importlib.util
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.sim import api as ref_api
from repro.sim import workloads as ref_workloads
from repro_torch.sim import api, torch_engine

from _torch_port import (
    assert_sim_equal,
    decision_dicts,
    event_dicts,
    pressure_trace,
    to_port,
)

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from benchmarks import common as bench_common  # noqa: E402
from benchmarks import fig3_7_tuning as bench_fig  # noqa: E402

PAPER = ("bfs", "sssp", "pagerank", "xsbench", "btree")
# reduced arguments: about 6 s for all seven, every harvest size with
# steady-state intervals, and the tuner moving the watermarks on each
# paper workload
REDUCED = {
    "bfs": dict(n=200_000, n_sources=8),
    "sssp": dict(n=100_000, n_sources=3),
    "pagerank": dict(n=100_000, iters=4),
    "xsbench": dict(n_intervals=30, lookups=40_000),
    "btree": dict(levels=6, n_intervals=60, queries=40_000, phase_every=20),
    "thrash": dict(rss_pages=3_000, n_intervals=20),
    "arrivals": dict(n_intervals=24, rss_pages=6_000),
}
PER_WORKLOAD = 2


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _load_chip_smoke()


@pytest.fixture(scope="module")
def traces():
    """name -> (the JAX package's trace, the same trace in the port)."""
    out = {}
    for name, kw in REDUCED.items():
        ref = ref_workloads.WORKLOADS[name](**kw)
        out[name] = (ref, to_port(ref))
    return out


@pytest.fixture(scope="module")
def dbs(smoke, traces, tmp_path_factory):
    """The benchmark database of both packages over the reduced traces:
    ``build_bench_db`` of the JAX package, and ``chip_smoke.bench_db`` as
    the smoke calls it, on the card's default device patched to the CPU."""
    cpu = torch.device("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_common, "CACHE", tmp_path_factory.mktemp("bench_cache"))
        mp.setattr(bench_common, "WORKLOADS",
                   {n: (lambda t=t: t[0]) for n, t in traces.items()})
        ref_db = bench_common.build_bench_db(per_workload=PER_WORKLOAD)
        mp.setattr(api, "resolve_device", lambda device=None: cpu)
        mp.setattr(torch_engine, "resolve_device", lambda device=None: cpu)
        port_db, configs, _ = smoke.bench_db(
            {n: t[1] for n, t in traces.items()}, per_workload=PER_WORKLOAD
        )
    assert len(configs) == len(port_db.records)
    return ref_db, port_db


@pytest.fixture
def bench_cache(tmp_path, monkeypatch):
    """The JAX benchmark's RunSet cache in a temporary directory."""
    monkeypatch.setattr(bench_fig, "CACHE", tmp_path)
    return tmp_path


def _records(db):
    return [(asdict(r.config), r.fm_fracs.tolist(), r.times.tolist())
            for r in db.records]


def _assert_records_equal(port, ref):
    assert (port.scenario, port.fm_frac) == (ref.scenario, ref.fm_frac)
    assert_sim_equal(port.result, ref.result)
    assert decision_dicts(port.decisions) == decision_dicts(ref.decisions)
    assert event_dicts(port.watermark_log) == event_dicts(ref.watermark_log)


def test_bench_db_matches_reference(dbs):
    ref_db, port_db = dbs
    assert len(port_db.records) == len(REDUCED) * (4 + 2 * PER_WORKLOAD)
    assert _records(port_db) == _records(ref_db)
    assert all(np.all(np.isfinite(r.times)) for r in port_db.records)


@pytest.mark.parametrize("name", PAPER)
def test_paper_workload_tuned_matches_reference(name, smoke, traces, dbs, bench_cache):
    ref_tr, port_tr = traces[name]
    ref_db, port_db = dbs
    base, (res,) = bench_fig.run_tuned_slices(ref_tr, ref_db, [(bench_fig.TARGET_LOSS, None)])
    rs = smoke.fig3_7_run(port_tr, port_db, device="cpu")
    assert rs.backends == ("torch_tuned_sweep",) and rs.chunked_step_count == 0
    for label, want in (("tpp", base), ("tuna", res)):
        got = rs.record(policy=label)
        assert_sim_equal(got.result, want)
    tuna = rs.record(policy="tuna")
    assert len(tuna.decisions) > 0 and len(tuna.watermark_log) > 0
    summary = smoke.summarize(rs.result(policy="tpp"), tuna.result, port_tr.rss_pages)
    want = bench_fig.summarize(base, res, ref_tr)
    assert (summary["avg_saving"], summary["max_saving"], summary["overall_loss"]) == want
    assert summary["migrations"] == res.migrations
    # the tuner's decisions and the watermark moves, beside the reference's
    # run of the same specs
    ref_rs = ref_api.run(ref_api.Experiment(
        scenarios=[ref_api.Scenario(trace=ref_tr)], fm_fracs=(1.0,),
        policies=[ref_api.PolicySpec(kind="tpp", label="tpp"),
                  ref_api.PolicySpec(kind="tpp", label="tuna",
                                     tuner=bench_fig.tuner_spec())],
    ), db=ref_db)
    for got, ref in zip(rs.runs, ref_rs.runs):
        assert got.policy == ref.policy
        _assert_records_equal(got, ref)


def test_thrash_knee_matches_reference(smoke, traces, dbs):
    ref_tr, port_tr = traces["thrash"]
    ref_db, port_db = dbs
    assert smoke.KNEE_KINDS == bench_common.policy_kinds(tunable=True)
    policies = []
    for kind in smoke.KNEE_KINDS:
        policies.append(ref_api.PolicySpec(kind=kind, label=f"{kind}_full", fm_frac=1.0))
        policies.append(ref_api.PolicySpec(kind=kind, label=f"{kind}_tuna", fm_frac=0.5,
                                           tuner=bench_fig.tuner_spec()))
    ref_rs = ref_api.run(ref_api.Experiment(
        scenarios=[ref_api.Scenario(trace=ref_tr)], fm_fracs=(1.0,), policies=policies,
    ), db=ref_db)
    rs = smoke.knee_run(port_tr, port_db, device="cpu")
    assert [r.policy for r in rs.runs] == [r.policy for r in ref_rs.runs]
    for got, ref in zip(rs.runs, ref_rs.runs):
        _assert_records_equal(got, ref)
    suppressed = {
        kind: sum(c.pm_admit_fail for p in ("full", "tuna")
                  for c in rs.result(policy=f"{kind}_{p}").configs)
        for kind in smoke.KNEE_KINDS
    }
    assert suppressed["thrash_guard"] > 0 and suppressed["tpp"] == 0


@pytest.mark.parametrize("reuse_window", [1, 2])
def test_thrash_guard_untuned_matches_reference(reuse_window):
    ref_tr = pressure_trace(3, rss=3_000, n_intervals=14)
    fracs = (0.9, 0.6, 0.4, 0.2)
    spec = dict(kind="thrash_guard", params=dict(reuse_window=reuse_window))
    ref_rs = ref_api.run(ref_api.Experiment(
        scenarios=[ref_api.Scenario(trace=ref_tr)], fm_fracs=fracs,
        policies=[ref_api.PolicySpec(**spec)], collect_configs=True))
    rs = api.run(api.Experiment(
        scenarios=[api.Scenario(trace=to_port(ref_tr))], fm_fracs=fracs,
        policies=[api.PolicySpec(**spec)], collect_configs=True), device="cpu")
    assert rs.backends == ("torch_sweep",) and ref_rs.backends == ("sweep",)
    for got, ref in zip(rs.runs, ref_rs.runs):
        assert got.policy == ref.policy
        _assert_records_equal(got, ref)
    assert sum(c.pm_admit_fail for r in rs.runs for c in r.result.configs) > 0


@pytest.mark.parametrize(
    "params",
    [dict(reuse_window=0), dict(churn_frac=1.5), dict(backoff_intervals=0)],
)
def test_thrash_guard_rejects_what_the_reference_rejects(params):
    with pytest.raises(ValueError):
        ref_api.PolicySpec(kind="thrash_guard", params=params).build_policy()
    with pytest.raises(ValueError):
        api.PolicySpec(kind="thrash_guard", params=params).build_policy()
