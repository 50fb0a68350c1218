"""The port's experiment API == the JAX package's, exactly, on the CPU.

The quickstart loop at a small size: profile a trace with an untuned sweep,
build the performance database from its ConfigVectors, then run TPP alone
and TPP+Tuna, through ``repro_torch.sim.api.run(device="cpu")`` and the JAX
package's ``repro.sim.api.run`` (its numpy sweeps). Also the port's own
copies of the workload generator, the micro-benchmark generator and the
cost model against the originals, and the device rules of the entry
points.
"""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.core.microbench import generate_microbench as ref_microbench
from repro.core.perfdb import PerfDB as RefPerfDB
from repro.core.perfdb import PerfRecord as RefPerfRecord
from repro.core.telemetry import ConfigVector as RefConfigVector
from repro.core.tuner import build_database as ref_build_database
from repro.sim import api as ref_api
from repro.sim import costmodel as ref_cost
from repro.sim.workloads import thrash_trace as ref_thrash_trace
from repro_torch import convert
from repro_torch.core.microbench import generate_microbench
from repro_torch.core.tuner import build_database
from repro_torch.device import resolve_device
from repro_torch.sim import api
from repro_torch.sim import costmodel
from repro_torch.sim.workloads import thrash_trace

from _torch_port import (
    assert_sim_equal,
    decision_dicts,
    event_dicts,
    pressure_trace,
    to_port,
)

BACKENDS = {"sweep": "torch_sweep", "tuned_sweep": "torch_tuned_sweep"}
DB_FRACS = np.round(np.arange(1.0, 0.28, -0.06), 3)


def _assert_runsets_equal(port_rs, ref_rs):
    assert len(port_rs.runs) == len(ref_rs.runs)
    assert port_rs.chunked_step_count == ref_rs.chunked_step_count == 0
    for p, r in zip(port_rs.runs, ref_rs.runs):
        assert (p.scenario, p.policy, p.fm_frac) == (r.scenario, r.policy, r.fm_frac)
        assert p.backend == BACKENDS[r.backend]
        assert_sim_equal(p.result, r.result)
        assert decision_dicts(p.decisions) == decision_dicts(r.decisions)
        assert event_dicts(p.watermark_log) == event_dicts(r.watermark_log)


@pytest.fixture(scope="module")
def quickstart():
    """Both packages' profile run, database and TPP vs TPP+Tuna run on one
    thrash trace (the ``chip_smoke.py`` sequence at a CPU-test size)."""
    tr = ref_thrash_trace(n_intervals=12, rss_pages=2_000)
    port_tr = to_port(tr)
    fracs = (1.0, 0.9, 0.6, 0.35)
    ref_prof = ref_api.run(
        ref_api.Experiment(
            scenarios=[ref_api.Scenario(trace=tr)], fm_fracs=fracs,
            collect_configs=True, name="profile",
        )
    )
    port_prof = api.run(
        api.Experiment(
            scenarios=[api.Scenario(trace=port_tr)], fm_fracs=fracs,
            collect_configs=True, name="profile",
        ),
        device="cpu",
    )
    # the database describes the application at full fast memory
    ref_cvs = ref_prof.record(fm_frac=1.0).result.configs[1:4]
    port_cvs = port_prof.record(fm_frac=1.0).result.configs[1:4]
    kw = dict(fm_fracs=DB_FRACS, n_intervals=8, max_rss_pages=4_000)
    ref_db = ref_build_database(ref_cvs, **kw)
    port_db = build_database(port_cvs, device="cpu", **kw)

    def tuned(mod, trace, db, **run_kw):
        return mod.run(
            mod.Experiment(
                name="quickstart",
                scenarios=[mod.Scenario(trace=trace)],
                fm_fracs=(1.0,),
                policies=[
                    mod.PolicySpec(label="tpp"),
                    mod.PolicySpec(
                        label="tpp+tuna",
                        tuner=mod.TunerSpec(target_loss=0.05, tune_every=3),
                    ),
                ],
            ),
            db=db,
            **run_kw,
        )

    return {
        "profile": (port_prof, ref_prof),
        "db": (port_db, ref_db),
        "tuned": (
            tuned(api, port_tr, port_db, device="cpu"),
            tuned(ref_api, tr, ref_db),
        ),
    }


def test_untuned_run_equals_reference(quickstart):
    _assert_runsets_equal(*quickstart["profile"])


def test_build_database_equals_reference(quickstart):
    port_db, ref_db = quickstart["db"]
    assert len(port_db.records) == len(ref_db.records) == 3
    for p, r in zip(port_db.records, ref_db.records):
        assert asdict(p.config) == asdict(r.config)
        assert np.array_equal(p.fm_fracs, r.fm_fracs)
        assert np.array_equal(p.times, r.times)


def test_tuned_run_equals_reference(quickstart):
    port_rs, ref_rs = quickstart["tuned"]
    _assert_runsets_equal(port_rs, ref_rs)
    assert port_rs.backends == ("torch_tuned_sweep",)
    # the closed loop really actuates: the tuner moves the watermarks
    assert len(port_rs.record(policy="tpp+tuna").watermark_log) > 0


def test_admission_params_and_fast_only_equal_reference():
    tr = pressure_trace(3, rss=2_000, n_intervals=5)

    def exp(mod):
        return mod.Experiment(
            scenarios=[mod.Scenario(trace=tr if mod is ref_api else to_port(tr),
                                    fast_only_at_full=True, kswapd_batch=64)],
            fm_fracs=(1.0, 0.5, 0.2),
            policies=[mod.PolicySpec(kind="admission",
                                     params={"admit_margin": 0.5})],
            collect_configs=True,
        )

    _assert_runsets_equal(api.run(exp(api), device="cpu"), ref_api.run(exp(ref_api)))


def test_thrash_trace_equals_reference():
    ref = convert.trace_dict(ref_thrash_trace(n_intervals=4, rss_pages=1_500))
    port = convert.trace_dict(thrash_trace(n_intervals=4, rss_pages=1_500))
    assert port.keys() == ref.keys()
    for k in ("name", "rss_pages", "num_threads", "slow_pages"):
        assert port[k] == ref[k]
    assert len(port["intervals"]) == len(ref["intervals"]) == 5
    for p, r in zip(port["intervals"], ref["intervals"]):
        for k in ("pages", "counts", "touches"):
            assert np.array_equal(p[k], r[k])
        assert (p["ops"], p["rand_frac"]) == (r["ops"], r["rand_frac"])


def test_generate_microbench_equals_reference():
    cfg = dict(pacc_f=30_000, pacc_s=1_500, pm_de=40, pm_pr=40, ai=8.0,
               rss_pages=6_000, hot_thr=4, num_threads=2, intensity=1.5,
               warm_pages=300.0, warm_touches=600.0)
    ref = convert.trace_dict(ref_microbench(RefConfigVector(**cfg), n_intervals=6))
    port = convert.trace_dict(
        generate_microbench(convert.config_from_dict(cfg), n_intervals=6)
    )
    assert np.array_equal(port["slow_pages"], ref["slow_pages"])
    assert (port["rss_pages"], port["num_threads"]) == (ref["rss_pages"], ref["num_threads"])
    for p, r in zip(port["intervals"], ref["intervals"], strict=True):
        for k in ("pages", "counts", "touches"):
            assert np.array_equal(p[k], r[k])
        assert (p["ops"], p["rand_frac"]) == (r["ops"], r["rand_frac"])


def test_costmodel_equals_reference():
    assert asdict(costmodel.OPTANE_LIKE) == asdict(ref_cost.OPTANE_LIKE)
    rng = np.random.default_rng(4)
    for _ in range(20):
        counts = rng.integers(1, 200, size=int(rng.integers(0, 3_000)))
        assert np.array_equal(
            costmodel.absorb_cache(counts, 1024), ref_cost.absorb_cache(counts, 1024)
        )
        assert costmodel.effective_mlp(counts, 10.0, 8) == ref_cost.effective_mlp(
            counts, 10.0, 8
        )
        args = dict(
            pacc_f=int(rng.integers(0, 10**6)), pacc_s=int(rng.integers(0, 10**6)),
            ops=float(rng.random() * 1e7), pm_pr=int(rng.integers(0, 5_000)),
            pm_de=int(rng.integers(0, 5_000)), pm_fail=int(rng.integers(0, 500)),
            direct_reclaimed=int(rng.integers(0, 500)),
            mlp_eff=float(rng.uniform(1, 80)), num_threads=8,
            rand_frac=float(rng.random()),
        )
        p = costmodel.interval_time(costmodel.OPTANE_LIKE, **args)
        r = ref_cost.interval_time(ref_cost.OPTANE_LIKE, **args)
        assert asdict(p) == asdict(r) and p.total == r.total


def test_perfdb_queries_equal_reference():
    """The HNSW index and its brute-force oracle pick the same records, in
    the same order, as the JAX package's on a few hundred records."""
    rng = np.random.default_rng(9)
    grid = np.round(np.arange(1.0, 0.19, -0.1), 3)
    records = []
    for _ in range(300):
        cfg = dict(
            pacc_f=float(rng.integers(1e3, 1e6)), pacc_s=float(rng.integers(0, 1e5)),
            pm_de=float(rng.integers(0, 5e3)), pm_pr=float(rng.integers(0, 5e3)),
            ai=float(rng.uniform(0.5, 20)), rss_pages=float(rng.integers(1e3, 1e6)),
            hot_thr=4.0, num_threads=float(rng.integers(1, 16)),
        )
        records.append({"config": cfg, "fm_fracs": grid,
                        "times": 1.0 + np.sort(rng.random(grid.size))})
    port = convert.perfdb_from_records(records)
    ref = RefPerfDB()
    for r in records:
        ref.add(RefPerfRecord(config=RefConfigVector(**r["config"]),
                              fm_fracs=r["fm_fracs"], times=r["times"]))
    ref.build()
    for _ in range(40):
        q = {k: v * float(rng.uniform(0.8, 1.25)) for k, v in
             records[int(rng.integers(0, 300))]["config"].items()}
        for k in (1, 3):
            assert [asdict(r.config) for r in port.query(convert.config_from_dict(q), k=k)] == [
                asdict(r.config) for r in ref.query(RefConfigVector(**q), k=k)
            ]
            assert [asdict(r.config) for r in port.query_brute(convert.config_from_dict(q), k=k)] == [
                asdict(r.config) for r in ref.query_brute(RefConfigVector(**q), k=k)
            ]


def test_tuner_config_converts():
    cfg = {"target_loss": 0.1, "k_neighbors": 2, "feedback": False}
    assert asdict(convert.tuner_config_from_dict(cfg))["k_neighbors"] == 2


def test_asking_for_the_card_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    tr = to_port(pressure_trace(0, rss=500, n_intervals=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.run(api.Experiment(scenarios=[api.Scenario(trace=tr)]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_database([convert.config_from_dict(
            dict(pacc_f=1e4, pacc_s=5e2, pm_de=20, pm_pr=20, ai=6.0,
                 rss_pages=4e3, hot_thr=4, num_threads=1))])
    assert resolve_device("cpu") == torch.device("cpu")


def _fixed_runner(scenario, fm_frac, spec, db):
    """A custom runner: a payload of the interval-times protocol."""
    return {"total_time": 3.0 * fm_frac, "interval_times": [fm_frac, 2.0 * fm_frac],
            "policy": spec.name}


def _pool_factory(mod):
    return mod.TieredPagePool


@pytest.mark.parametrize("scenario_kw", [{"runner": _fixed_runner},
                                         {"pool_factory": _pool_factory}])
def test_later_slice_scenarios_raise(scenario_kw):
    """The scenarios the port refused until the per-size engine and custom
    runners were ported: they now run, equal to the JAX package's run
    (backends ``custom`` and ``simulate``)."""
    from repro.tiering import page_pool as ref_page_pool
    from repro_torch.tiering import page_pool

    ref_tr = pressure_trace(0, rss=500, n_intervals=4)
    kw, ref_kw = dict(scenario_kw), dict(scenario_kw)
    if "pool_factory" in kw:
        kw["pool_factory"] = _pool_factory(page_pool)
        ref_kw["pool_factory"] = _pool_factory(ref_page_pool)
    port = api.run(api.Experiment(
        scenarios=[api.Scenario(trace=to_port(ref_tr), name="s", **kw)],
        fm_fracs=(1.0, 0.4)), device="cpu")
    ref = ref_api.run(ref_api.Experiment(
        scenarios=[ref_api.Scenario(trace=ref_tr, name="s", **ref_kw)],
        fm_fracs=(1.0, 0.4)))
    assert port.backends == ref.backends
    assert port.backends == (("custom",) if "runner" in kw else ("simulate",))
    for p, r in zip(port.runs, ref.runs):
        assert (p.scenario, p.policy, p.fm_frac) == (r.scenario, r.policy, r.fm_frac)
        if "runner" in kw:
            assert p.result == r.result
        else:
            assert_sim_equal(p.result, r.result)
    assert port.total_times().tolist() == ref.total_times().tolist()


def test_fault_scenarios_run():
    # fault injection came with the fault model's slice: a scenario with a
    # FaultSpec runs (tests/test_torch_faults.py holds it to the reference)
    from repro_torch.sim.faults import FaultSpec

    tr = to_port(pressure_trace(0, rss=500, n_intervals=4))
    rs = api.run(api.Experiment(
        scenarios=[api.Scenario(trace=tr, faults=FaultSpec(
            seed=1, promote_fail_rate=0.5, max_retries=0))],
        fm_fracs=(0.3,)), device="cpu")
    assert rs.record().fault_events
    assert rs.record().result.stats["pgpromote_fail"] > 0


def test_later_slice_policy_kinds_raise():
    """first_touch, a kind the port refused until the per-size engine came, runs on
    the device step equal to the JAX package's per-size engine; an unknown
    kind still raises."""
    ref_tr = pressure_trace(0, rss=500, n_intervals=4)

    def exp(mod, tr):
        return mod.Experiment(scenarios=[mod.Scenario(trace=tr)], fm_fracs=(1.0, 0.3),
                              policies=[mod.PolicySpec(kind="first_touch")])
    port = api.run(exp(api, to_port(ref_tr)), device="cpu")
    ref = ref_api.run(exp(ref_api, ref_tr))
    assert (port.backends, ref.backends) == (("torch_sweep",), ("simulate",))
    for p, r in zip(port.runs, ref.runs):
        assert_sim_equal(p.result, r.result)
    with pytest.raises(ValueError, match="unknown policy kind"):
        api.PolicySpec(kind="nope")
