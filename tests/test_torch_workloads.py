"""The port's workload generators and harness persistence == the JAX
package's, exactly, on the CPU.

Each of the seven generators of ``repro_torch.sim.workloads.WORKLOADS``
against ``repro.sim.workloads.WORKLOADS`` for the same seed (the defaults,
or reduced arguments where generation takes more than a few seconds), the
store channel, ``save_trace`` / ``load_trace`` and ``PerfDB.save`` /
``load`` across the two packages, ``PerfRecord.min_fm_within``, and a
workload name as a ``Scenario``'s trace.
"""

from dataclasses import asdict

import numpy as np
import pytest

from repro.core import perfdb as ref_perfdb
from repro.core import trace as ref_trace
from repro.core.telemetry import ConfigVector as RefConfigVector
from repro.sim import api as ref_api
from repro.sim import workloads as ref_workloads
from repro_torch.core import perfdb
from repro_torch.core import trace as port_trace
from repro_torch.core.telemetry import ConfigVector
from repro_torch.sim import api
from repro_torch.sim import workloads

from _torch_port import assert_sim_equal

# sssp and xsbench take 10-15 s at their defaults: fewer sources / intervals
GENERATOR_ARGS = {
    "bfs": {},
    "sssp": dict(n=100_000, n_sources=3),
    "pagerank": {},
    "xsbench": dict(n_intervals=20),
    "btree": {},
    "thrash": {},
    "arrivals": {},
}


def assert_traces_equal(a, b):
    assert (a.name, a.rss_pages, a.num_threads) == (b.name, b.rss_pages, b.num_threads)
    if a.slow_pages is None:
        assert b.slow_pages is None
    else:
        assert np.array_equal(a.slow_pages, b.slow_pages)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("pages", "counts", "touches"):
            u, v = getattr(x, f), getattr(y, f)
            assert u.dtype == v.dtype == np.int64 and np.array_equal(u, v)
        assert (x.writes is None) == (y.writes is None)
        if x.writes is not None:
            assert np.array_equal(x.writes, y.writes)
        assert x.ops == y.ops and x.rand_frac == y.rand_frac


def test_registry_has_the_same_names_in_the_same_order():
    assert list(workloads.WORKLOADS) == list(ref_workloads.WORKLOADS)
    assert workloads.__all__ == ref_workloads.__all__


@pytest.mark.parametrize("name", list(GENERATOR_ARGS))
def test_generator_matches_reference(name):
    kw = GENERATOR_ARGS[name]
    assert_traces_equal(
        workloads.WORKLOADS[name](**kw), ref_workloads.WORKLOADS[name](**kw)
    )


@pytest.mark.parametrize(
    "name,kw",
    [("bfs", dict(n=60_000, n_sources=8, write_frac=0.25)),
     ("thrash", dict(rss_pages=2_000, n_intervals=6, write_frac=0.5))],
)
def test_store_channel_matches_reference(name, kw):
    port = workloads.WORKLOADS[name](**kw)
    assert_traces_equal(port, ref_workloads.WORKLOADS[name](**kw))
    assert any(ia.writes is not None and ia.writes.sum() > 0 for ia in port)
    # write_frac=0 leaves the trace as it was before the store channel
    quiet = workloads.WORKLOADS[name](**{**kw, "write_frac": 0.0})
    assert all(ia.writes is None for ia in quiet)


def test_helpers_match_reference():
    from repro.sim.workloads import arrivals as ref_arrivals
    from repro.sim.workloads import base as ref_base
    from repro_torch.sim.workloads import arrivals, base

    for s in (0.9, 1.25):
        assert np.array_equal(
            base.zipf_weights(1_000, s, np.random.default_rng(3)),
            ref_base.zipf_weights(1_000, s, np.random.default_rng(3)),
        )
    for a, b in zip(base.power_law_graph(5_000, 8, 1.0, 9),
                    ref_base.power_law_graph(5_000, 8, 1.0, 9)):
        assert np.array_equal(a, b)
    rates = arrivals.modulated_rates(60, seed=4)
    assert np.array_equal(rates, ref_arrivals.modulated_rates(60, seed=4))
    assert np.array_equal(arrivals.open_arrivals(rates, seed=5),
                          ref_arrivals.open_arrivals(rates, seed=5))
    assert np.array_equal(
        arrivals.session_lengths(50, 4.0, 1.6, np.random.default_rng(6)),
        ref_arrivals.session_lengths(50, 4.0, 1.6, np.random.default_rng(6)),
    )
    closed = dict(n_intervals=20, rss_pages=4_000, mode="closed")
    assert_traces_equal(arrivals.arrivals_trace(**closed),
                        ref_arrivals.arrivals_trace(**closed))


def _trace_with_everything(pkg):
    """A trace of ``pkg`` with slow pages, writes in some intervals and an
    empty interval."""
    rng = np.random.default_rng(11)
    tr = pkg.Trace(name="mixed", rss_pages=500, num_threads=3,
                   slow_pages=np.arange(100, 200, dtype=np.int64))
    for i in range(5):
        pages = np.unique(rng.integers(0, 500, size=60 * (i % 3)))
        counts = rng.integers(1, 9, size=pages.size)
        writes = rng.integers(0, counts + 1) if i % 2 else None
        tr.append(pkg.IntervalAccess(pages=pages, counts=counts, ops=7.5 * i,
                                     rand_frac=0.25 * (i % 4),
                                     touches=np.maximum(1, counts // 2),
                                     writes=writes))
    return tr


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_saved_traces_load_in_either_package(writer, tmp_path):
    port, ref = _trace_with_everything(port_trace), _trace_with_everything(ref_trace)
    assert_traces_equal(port, ref)
    path = tmp_path / "t.npz"
    (port_trace.save_trace(port, path) if writer == "port"
     else ref_trace.save_trace(ref, path))
    for loaded in (port_trace.load_trace(path), ref_trace.load_trace(path)):
        assert_traces_equal(loaded, ref)
    assert port_trace.load_trace(path).total_accesses == ref.total_accesses
    assert port_trace.load_trace(path).mean_ai == ref.mean_ai


def test_trace_validation_matches_reference():
    pages, counts = np.arange(4), np.array([2, 2, 2, 2])
    for bad in (np.array([0, 1, 2]), np.array([0, 3, 0, 0]), np.array([-1, 0, 0, 0])):
        with pytest.raises(ValueError):
            ref_trace.IntervalAccess(pages=pages, counts=counts, ops=0.0, writes=bad)
        with pytest.raises(ValueError):
            port_trace.IntervalAccess(pages=pages, counts=counts, ops=0.0, writes=bad)


def _db_pair(n=12):
    """The same records in both packages: seeded configs, rising curves."""
    rng = np.random.default_rng(21)
    grid = np.round(np.arange(1.0, 0.19, -0.08), 3)
    ref, port = ref_perfdb.PerfDB(), perfdb.PerfDB()
    for _ in range(n):
        cfg = dict(pacc_f=float(rng.uniform(1e3, 1e5)),
                   pacc_s=float(rng.uniform(0, 1e4)),
                   pm_de=float(rng.uniform(0, 500)), pm_pr=float(rng.uniform(0, 500)),
                   ai=float(rng.uniform(1, 40)), rss_pages=float(rng.integers(1e3, 1e5)),
                   hot_thr=4.0, num_threads=float(rng.integers(1, 25)),
                   intensity=float(rng.uniform(1, 8)),
                   warm_pages=float(rng.uniform(0, 100)),
                   pm_admit_fail=float(rng.integers(0, 5)))
        times = 1.0 + np.cumsum(rng.uniform(0, 0.1, size=grid.size))
        times[0] = 1.0
        ref.add(ref_perfdb.PerfRecord(RefConfigVector(**cfg), grid, times))
        port.add(perfdb.PerfRecord(ConfigVector(**cfg), grid, times))
    ref.build()
    port.build()
    return ref, port


def _records(db):
    return [(asdict(r.config), r.fm_fracs.tolist(), r.times.tolist()) for r in db.records]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_saved_databases_load_in_either_package(writer, tmp_path):
    ref, port = _db_pair()
    path = tmp_path / "sub" / "perfdb"
    (port if writer == "port" else ref).save(path)
    queries = [
        RefConfigVector(**asdict(r.config)) for r in ref.records[:6]
    ] + [RefConfigVector(pacc_f=5e4, pacc_s=2e3, pm_de=50, pm_pr=60, ai=12.0,
                         rss_pages=3e4, hot_thr=4, num_threads=8)]
    for loaded in (perfdb.PerfDB.load(path), ref_perfdb.PerfDB.load(path)):
        assert _records(loaded) == _records(ref)
        for q in queries:
            qq = ConfigVector(**asdict(q)) if isinstance(loaded, perfdb.PerfDB) else q
            got = [asdict(r.config) for r in loaded.query(qq, k=3)]
            assert got == [asdict(r.config) for r in ref.query(q, k=3)]


@pytest.mark.parametrize("target", [-0.01, 0.0, 0.02, 0.05, 0.3, 10.0])
def test_min_fm_within_matches_reference(target):
    ref, port = _db_pair(6)
    for r, p in zip(ref.records, port.records):
        assert p.min_fm_within(target) == r.min_fm_within(target)
    flat = np.ones(5)
    fr = np.array([1.0, 0.8, 0.6, 0.4, 0.2])
    assert (perfdb.PerfRecord(ConfigVector(**asdict(ref.records[0].config)), fr, flat)
            .min_fm_within(target)
            == ref_perfdb.PerfRecord(ref.records[0].config, fr, flat).min_fm_within(target))


def test_workload_name_as_scenario_trace():
    exp = dict(fm_fracs=(1.0, 0.5), collect_configs=True)
    by_name = api.run(api.Experiment(scenarios=[api.Scenario(trace="thrash")], **exp),
                      device="cpu")
    by_trace = api.run(api.Experiment(
        scenarios=[api.Scenario(trace=workloads.thrash_trace(), name="thrash")], **exp),
        device="cpu")
    ref = ref_api.run(ref_api.Experiment(
        scenarios=[ref_api.Scenario(trace="thrash")], **exp))
    # the spec echo names the workload, as the JAX package's does
    assert by_name.spec["scenarios"][0]["trace"] == "thrash"
    assert by_name.spec["scenarios"] == ref.spec["scenarios"]
    for a, b, r in zip(by_name.runs, by_trace.runs, ref.runs):
        assert a.scenario == b.scenario == r.scenario == "thrash"
        assert_sim_equal(a.result, b.result)
        assert_sim_equal(a.result, r.result)
    with pytest.raises(KeyError):
        api.run(api.Experiment(scenarios=[api.Scenario(trace="nope")]), device="cpu")
    with pytest.raises(KeyError):
        ref_api.run(ref_api.Experiment(scenarios=[ref_api.Scenario(trace="nope")]))
