"""The port's RunSet JSON, result cache and process fan-out against the JAX
package, on the CPU.

The JAX package's ``tests/test_api.py`` cases replayed against
``repro_torch.sim.api.run(device="cpu")`` at small sizes: lossless JSON
round trips, provenance, the schema check, custom payloads, v4 with its
v1-v3 reads; documents crossing between the packages both ways; the
result cache (hits, misses, partial and pool-factory identities, the
refusal of unidentifiable arguments, corrupt entries healed); the fan-out
under fork and spawn equal to serial runs bit for bit, specs refused
upfront, failures and hangs in workers raised by name; and
``build_database(workers=2)`` equal to ``workers=1``. Every fan-out call
has a ``scenario_timeout``, so a hang fails instead of stalling the suite.
"""

import functools
import json
import os
import time

import numpy as np
import pytest

from repro.core.tuner import build_database as ref_build_database
from repro.sim import api as ref_api
from repro_torch import convert
from repro_torch.core.telemetry import ConfigVector
from repro_torch.core.trace import IntervalAccess, Trace
from repro_torch.core.tuner import build_database
from repro_torch.sim import api
from repro_torch.tiering.page_pool import TieredPagePool

from _torch_port import (
    assert_sim_equal,
    decision_dicts,
    event_dicts,
    pressure_trace,
    synthetic_db_pair,
    to_port,
)

BACKENDS = {"sweep": "torch_sweep", "tuned_sweep": "torch_tuned_sweep",
            "simulate": "simulate", "custom": "custom", "fleet": "fleet"}
TIMEOUT = 120.0  # seconds a fanned-out scenario may take before the test fails
TUNER = dict(target_loss=0.05, tune_every=2, max_step_frac=0.08)


def random_trace(seed, rss=2_000, n_intervals=6):
    """The JAX test's random trace, built with the port's classes."""
    rng = np.random.default_rng(seed)
    tr = Trace(name=f"rand{seed}", rss_pages=rss)
    for _ in range(n_intervals):
        k = int(rng.integers(150, 800))
        pages = rng.choice(rss, size=k, replace=False)
        tr.append(IntervalAccess(pages=pages, counts=rng.integers(1, 9, size=k),
                                 ops=1000.0))
    return tr


def _const_payload_runner(sc, f, spec, db):
    return {"p99": 1.25, "n": 3, "knob": sc.params.get("knob")}


def _raising_trace():
    raise RuntimeError("trace factory failed on purpose")


def _hanging_trace():
    time.sleep(3600)


def _assert_runs_equal(a_rs, b_rs, backends=None):
    assert len(a_rs.runs) == len(b_rs.runs)
    for a, b in zip(a_rs.runs, b_rs.runs):
        assert (a.scenario, a.policy, a.fm_frac) == (b.scenario, b.policy, b.fm_frac)
        if backends is None:
            assert a.backend == b.backend
        else:
            assert a.backend == backends[b.backend]
        if isinstance(b.result, dict):
            assert a.result == b.result
        else:
            assert_sim_equal(a.result, b.result)
            assert a.result.interval_times.dtype == b.result.interval_times.dtype
        assert decision_dicts(a.decisions) == decision_dicts(b.decisions)
        assert event_dicts(a.watermark_log) == event_dicts(b.watermark_log)
        assert a.fault_events == b.fault_events
        assert a.arbiter_log == b.arbiter_log


def _mixed_experiment(mod, trace):
    """Untuned and tuned sweep specs, a per-size scenario and a custom
    runner: every result kind a document carries."""
    return mod.Experiment(
        name="roundtrip",
        scenarios=[mod.Scenario(trace=trace),
                   mod.Scenario(trace=trace, name="per_size",
                                pool_factory=_pool(mod)),
                   mod.Scenario(name="svc", runner=_const_payload_runner,
                                params={"knob": 7})],
        fm_fracs=(1.0, 0.5),
        policies=[mod.PolicySpec(label="base"),
                  mod.PolicySpec(label="tuned", fm_frac=1.0,
                                 tuner=mod.TunerSpec(**TUNER))],
        collect_configs=True,
    )


def _pool(mod):
    if mod is api:
        return TieredPagePool
    from repro.tiering.page_pool import TieredPagePool as RefPool

    return RefPool


@pytest.fixture(scope="module")
def mixed():
    """The same mixed experiment through both packages: (port, JAX)."""
    tr = pressure_trace(20, rss=1_500, n_intervals=10)
    ref_db, port_db = synthetic_db_pair()
    port = api.run(_mixed_experiment(api, to_port(tr)), db=port_db, device="cpu")
    ref = ref_api.run(_mixed_experiment(ref_api, tr), db=ref_db)
    return port, ref


# ------------------------------------------------------------------ JSON
def test_runs_equal_the_reference(mixed):
    port, ref = mixed
    # the untuned spec rides the tuned spec's sweep (one policy group)
    assert port.backends == ("custom", "simulate", "torch_tuned_sweep")
    _assert_runs_equal(port, ref, backends=BACKENDS)


def test_round_trip_is_lossless(mixed):
    rs, _ = mixed
    text = rs.to_json()
    back = api.RunSet.from_json(text)
    assert (back.name, back.spec, back.chunked_step_count, back.backends) == (
        rs.name, rs.spec, rs.chunked_step_count, rs.backends)
    _assert_runs_equal(back, rs)
    # a second round trip is byte-identical (fixed point)
    assert api.RunSet.from_json(back.to_json()).to_json() == text
    assert back.fanout is None


def test_provenance_fields(mixed):
    rs, ref = mixed
    assert rs.spec["name"] == "roundtrip"
    assert rs.spec["fm_fracs"] == [1.0, 0.5]
    assert rs.spec["scenarios"][0]["seed"] == 0
    assert rs.spec["scenarios"][2]["params"] == {"knob": 7}
    assert rs.spec["policies"][1]["tuner"]["target_loss"] == 0.05
    assert rs.spec["db_records"] == 1
    assert rs.spec["device"] == "cpu"
    assert rs.chunked_step_count == 0
    # the spec echo is the JAX package's, plus the device; the pool
    # factories name each package's own class
    mine = {k: v for k, v in rs.spec.items() if k != "device"}
    theirs = json.loads(json.dumps(ref.spec))
    for sc in (mine["scenarios"][1], theirs["scenarios"][1]):
        assert sc.pop("pool_factory").endswith(".TieredPagePool")
    assert json.loads(json.dumps(mine)) == theirs


def test_schema_version_checked(mixed):
    d = json.loads(mixed[0].to_json())
    assert d["schema"] == api.RUNSET_SCHEMA == "tuna-runset-v4"
    d["schema"] = "bogus"
    with pytest.raises(ValueError, match="schema"):
        api.RunSet.from_json(json.dumps(d))


def test_custom_payload_round_trip():
    rs = api.run(api.Experiment(scenarios=[api.Scenario(
        name="svc", runner=_const_payload_runner)]), device="cpu")
    back = api.RunSet.from_json(rs.to_json())
    assert back.result(scenario="svc") == {"p99": 1.25, "n": 3, "knob": None}
    assert back.results() == rs.results()


def _older_documents(text):
    """The JAX test's v3, v2 and v1 documents derived from a v4 one."""
    d = json.loads(text)
    for r in d["runs"]:
        r.pop("arbiter_log")
    d["schema"] = "tuna-runset-v3"
    yield "v3", json.dumps(d)
    for r in d["runs"]:
        r.pop("fault_events")
    for sc in d["spec"]["scenarios"]:
        sc.pop("faults", None)
    d["schema"] = "tuna-runset-v2"
    yield "v2", json.dumps(d)
    for p in d["spec"]["policies"]:
        p.pop("params")
    d["schema"] = "tuna-runset-v1"
    yield "v1", json.dumps(d)


def test_schema_v4_with_v1_v2_v3_compat(mixed):
    rs, _ = mixed
    for version, text in _older_documents(rs.to_json()):
        back = api.RunSet.from_json(text)
        assert all(r.arbiter_log is None for r in back.runs), version
        for a, b in zip(back.runs, rs.runs):
            if isinstance(b.result, dict):
                assert a.result == b.result
            else:
                assert_sim_equal(a.result, b.result)
            assert decision_dicts(a.decisions) == decision_dicts(b.decisions)


def test_port_document_reads_in_the_jax_package(mixed):
    port, ref = mixed
    back = ref_api.RunSet.from_json(port.to_json())
    assert back.spec == port.spec
    _assert_runs_equal(back, ref, backends=BACKENDS)
    assert ref_api.RunSet.from_json(back.to_json()).to_json() == port.to_json()


def test_jax_documents_read_in_the_port(mixed):
    port, ref = mixed
    text = ref.to_json()
    back = api.RunSet.from_json(text)
    assert back.spec == json.loads(text)["spec"]
    _assert_runs_equal(port, back, backends=BACKENDS)
    for version, old in _older_documents(text):
        back = api.RunSet.from_json(old)
        assert [r.backend for r in back.runs] == [r.backend for r in ref.runs], version
        for a, b in zip(port.runs, back.runs):
            if isinstance(b.result, dict):
                assert a.result == b.result
            else:
                assert_sim_equal(a.result, b.result)


def test_fault_and_fleet_documents_cross_both_ways():
    """A fault-injected scenario (fault events, degraded decisions) and a
    fleet (the arbiter's log) through both packages' documents."""
    from repro.fleet import FleetScenario as RefFleet
    from repro.fleet import TenantSpec as RefTenant
    from repro.sim.faults import FaultSpec as RefFaultSpec
    from repro_torch.fleet import FleetScenario, TenantSpec
    from repro_torch.sim.faults import FaultSpec

    a, b = pressure_trace(31, rss=800, n_intervals=8), pressure_trace(32, rss=600,
                                                                      n_intervals=8)
    ref_db, port_db = synthetic_db_pair()
    fault = dict(seed=3, promote_fail_rate=0.3, max_retries=1, telemetry_drop_rate=0.3, db_outage_rate=0.3)

    def exp(mod, fleet_cls, tenant_cls, fault_cls, ta, tb):
        return mod.Experiment(
            name="faults_fleet",
            scenarios=[mod.Scenario(trace=ta, name="faulty", faults=fault_cls(**fault)),
                       fleet_cls(tenants=[tenant_cls(trace=ta, name="a"),
                                          tenant_cls(trace=tb, name="b")],
                                 name="fleet", budget_frac=0.6)],
            fm_fracs=(1.0,),
            policies=[mod.PolicySpec(label="tuned", tuner=mod.TunerSpec(**TUNER))])

    port = api.run(exp(api, FleetScenario, TenantSpec, FaultSpec, to_port(a), to_port(b)),
                   db=port_db, device="cpu")
    ref = ref_api.run(exp(ref_api, RefFleet, RefTenant, RefFaultSpec, a, b), db=ref_db)
    assert any(r.fault_events for r in port.runs)
    assert any(r.arbiter_log for r in port.runs)
    _assert_runs_equal(port, ref, backends=BACKENDS)
    _assert_runs_equal(api.RunSet.from_json(ref.to_json()), ref)
    _assert_runs_equal(ref_api.RunSet.from_json(port.to_json()), ref, backends=BACKENDS)
    mine = {k: v for k, v in port.spec.items() if k != "device"}
    assert json.loads(json.dumps(mine)) == json.loads(json.dumps(ref.spec))


# ----------------------------------------------------------------- cache
class TestResultCache:
    def _exp(self, fracs=(0.6, 0.3)):
        return api.Experiment(name="cached",
                              scenarios=[api.Scenario(trace=random_trace(60, n_intervals=5))],
                              fm_fracs=fracs, collect_configs=True)

    def test_second_run_is_served_from_cache(self, tmp_path, monkeypatch):
        rs1 = api.run(self._exp(), cache_dir=tmp_path, device="cpu")
        files = sorted(tmp_path.glob("runset_*.json"))
        assert len(files) == 1
        # prove the second call reads the file, not the engine: mutate it,
        # and make any execution fail
        files[0].write_text(files[0].read_text().replace('"cached"', '"tampered"', 1))

        def no_run(*a, **kw):
            raise AssertionError("a cache hit executed a scenario")

        monkeypatch.setattr(api, "_run_scenario", no_run)
        rs2 = api.run(self._exp(), cache_dir=tmp_path, device="cpu")
        assert rs2.name == "tampered"
        for a, b in zip(rs1.runs, rs2.runs):
            assert_sim_equal(a.result, b.result)

    def test_spec_change_misses(self, tmp_path):
        api.run(self._exp(), cache_dir=tmp_path, device="cpu")
        api.run(self._exp(fracs=(0.5,)), cache_dir=tmp_path, device="cpu")
        assert len(list(tmp_path.glob("runset_*.json"))) == 2

    def test_device_is_cache_neutral(self, tmp_path):
        rs = api.run(self._exp(), cache_dir=tmp_path, device="cpu")
        spec = dict(rs.spec)
        path = api._cache_path(tmp_path, rs.name, spec)
        assert path.exists()
        assert api._cache_path(tmp_path, rs.name, {**spec, "device": "cuda:0"}) == path
        assert api._cache_path(tmp_path, rs.name, {**spec, "db_records": 3}) != path

    def test_partial_factory_bound_args_are_cache_identity(self, tmp_path):
        def exp(n):
            return api.Experiment(name="partial", scenarios=[api.Scenario(
                trace=functools.partial(random_trace, 61, n_intervals=n), name="p")],
                fm_fracs=(0.5,))

        rs4 = api.run(exp(4), cache_dir=tmp_path, device="cpu")
        rs6 = api.run(exp(6), cache_dir=tmp_path, device="cpu")
        assert len(list(tmp_path.glob("runset_*.json"))) == 2
        assert len(rs4.result().interval_times) == 4
        assert len(rs6.result().interval_times) == 6

    def test_pool_factory_bound_args_are_cache_identity(self, tmp_path):
        tr = random_trace(62, n_intervals=4)

        def exp(halflife):
            return api.Experiment(name="pf", scenarios=[api.Scenario(
                trace=tr, pool_factory=functools.partial(
                    TieredPagePool, hotness_halflife=halflife))], fm_fracs=(0.4,))

        a = api.run(exp(2.0), cache_dir=tmp_path, device="cpu")
        b = api.run(exp(8.0), cache_dir=tmp_path, device="cpu")
        assert len(list(tmp_path.glob("runset_*.json"))) == 2
        assert a.spec != b.spec
        assert a.backends == ("simulate",)

    def test_ndarray_bound_args_hash_full_contents(self):
        x = np.arange(5000)
        y = x.copy()
        y[2500] += 1  # an interior element repr() would elide
        assert api._arg_ref(x) != api._arg_ref(y)
        assert api._arg_ref(x) == api._arg_ref(x.copy())

        class Blob:
            pass

        ref = api._arg_ref(Blob())
        assert "0x" not in str(ref)
        assert ref == api._arg_ref(Blob())
        # the two packages give an argument the same identity
        assert api._arg_ref(x) == ref_api._arg_ref(x)

    def test_refuses_to_cache_unidentifiable_factory_args(self, tmp_path):
        class Cfg:
            pass

        exp = api.Experiment(name="unid", scenarios=[api.Scenario(
            trace=functools.partial(random_trace, 63, rss=Cfg()))], fm_fracs=(0.5,))
        with pytest.raises(ValueError, match="stable identity"):
            api.run(exp, cache_dir=tmp_path, device="cpu")
        assert not list(tmp_path.glob("runset_*.json"))

    def test_cache_round_trip_is_lossless(self, tmp_path):
        rs1 = api.run(self._exp(), cache_dir=tmp_path, device="cpu")
        rs2 = api.run(self._exp(), cache_dir=tmp_path, device="cpu")
        assert rs2.to_json() == rs1.to_json()
        assert rs1.to_json() == api.run(self._exp(), device="cpu").to_json()

    def test_corrupted_entry_recomputes_and_heals(self, tmp_path):
        rs1 = api.run(self._exp(), cache_dir=tmp_path, device="cpu")
        (f,) = tmp_path.glob("runset_*.json")
        f.write_text(rs1.to_json()[: len(rs1.to_json()) // 2])  # truncated
        rs2 = api.run(self._exp(), cache_dir=tmp_path, device="cpu")
        assert rs2.to_json() == rs1.to_json()
        assert api.RunSet.from_json(f.read_text()).to_json() == rs1.to_json()
        assert not list(tmp_path.glob("*.tmp*"))


# --------------------------------------------------------------- fan-out
def _fanout_exp(n=3, n_intervals=5):
    return api.Experiment(
        name="fan",
        scenarios=[api.Scenario(trace=random_trace(s, n_intervals=n_intervals))
                   for s in range(8, 8 + n)],
        fm_fracs=(0.8, 0.4),
        policies=[api.PolicySpec(label="tpp"),
                  api.PolicySpec(label="adm", kind="admission"),
                  api.PolicySpec(label="tuned", fm_frac=1.0, tuner=api.TunerSpec(**TUNER))],
        collect_configs=True,
    )


@pytest.mark.parametrize("method", ["fork", "spawn"])
def test_fanout_matches_serial(method):
    _, port_db = synthetic_db_pair()
    exp = _fanout_exp()
    serial = api.run(exp, db=port_db, parallelism=1, device="cpu")
    fanned = api.run(exp, db=port_db, parallelism=2, mp_start_method=method,
                     scenario_timeout=TIMEOUT, device="cpu")
    _assert_runs_equal(fanned, serial)
    assert fanned.to_json() == serial.to_json()
    assert serial.fanout is None
    assert [w["scenario"] for w in fanned.fanout] == [s.resolved_name for s in exp.scenarios]
    pids = {w["pid"] for w in fanned.fanout}
    assert os.getpid() not in pids and 1 <= len(pids) <= 2
    assert all(w["peak_hbm_bytes"] is None for w in fanned.fanout)
    assert all(w["launches"] == {} for w in fanned.fanout)  # the CPU launches nothing


def test_start_method_resolution(monkeypatch):
    avail = ["fork", "spawn", "forkserver"]
    assert api._resolve_start_method(None, False, avail) == "fork"
    assert api._resolve_start_method(None, True, avail) == "spawn"
    assert api._resolve_start_method("spawn", False, avail) == "spawn"
    assert api._resolve_start_method("forkserver", True, avail) == "forkserver"
    with pytest.raises(ValueError, match="cannot serve a CUDA run"):
        api._resolve_start_method("fork", True, avail)
    assert api._resolve_start_method(None, False, ["spawn"]) is None
    assert api._resolve_start_method(None, True, ["fork"]) is None
    with pytest.raises(ValueError, match="not available"):
        api._resolve_start_method("forkserver", False, ["fork", "spawn"])
    # a parent with CUDA already initialised spawns even for a CPU run
    import torch

    seen = []

    def fake_fanout(jobs, parallelism, timeout, start_method=None):
        seen.append((start_method, {job[5] for job in jobs}))
        return None  # then serial

    monkeypatch.setattr(api, "_fanout", fake_fanout)
    exp = _fanout_exp(n=2, n_intervals=2)
    exp.policies = [api.PolicySpec()]
    api.run(exp, parallelism=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    api.run(exp, parallelism=2, device="cpu")
    assert seen == [("fork", {"cpu"}), ("spawn", {"cpu"})]


def test_fanout_rejects_unpicklable_spec_upfront():
    exp = api.Experiment(
        scenarios=[
            # tuna: ignore[TUNA008] the lint's target, used here to prove the
            # runtime guard catches what slips past it
            api.Scenario(name="s0", trace=lambda: random_trace(1, n_intervals=3)),
            api.Scenario(trace=random_trace(2, n_intervals=3))],
        fm_fracs=(0.5,))
    with pytest.raises(api.ScenarioExecutionError, match=r"'s0'.*trace"):
        api.run(exp, parallelism=2, scenario_timeout=TIMEOUT, device="cpu")
    # serial execution never pickles, so the same spec is allowed
    assert len(api.run(exp, parallelism=1, device="cpu").runs) == 2


@pytest.mark.parametrize("method", ["fork", "spawn"])
def test_worker_failure_names_the_scenario(method):
    exp = api.Experiment(
        scenarios=[api.Scenario(trace=random_trace(3, n_intervals=3)),
                   api.Scenario(name="broken", trace=_raising_trace)],
        fm_fracs=(0.5,))
    with pytest.raises(api.ScenarioExecutionError,
                       match=r"'broken' failed in a fan-out worker.*on purpose") as err:
        api.run(exp, parallelism=2, mp_start_method=method, scenario_timeout=TIMEOUT,
                device="cpu")
    assert isinstance(err.value.__cause__, RuntimeError)


def test_hung_worker_raises_after_the_timeout():
    import multiprocessing

    exp = api.Experiment(
        scenarios=[api.Scenario(trace=random_trace(4, n_intervals=3)),
                   api.Scenario(name="hung", trace=_hanging_trace)],
        fm_fracs=(0.5,))
    t = time.perf_counter()
    with pytest.raises(api.ScenarioExecutionError, match=r"'hung' did not finish"):
        api.run(exp, parallelism=2, mp_start_method="fork", scenario_timeout=10.0,
                device="cpu")
    assert time.perf_counter() - t < 60.0
    # the hung worker was ended, not left behind
    deadline = time.perf_counter() + 30.0
    while multiprocessing.active_children() and time.perf_counter() < deadline:
        time.sleep(0.1)
    assert not multiprocessing.active_children()


def _db_configs(n=3):
    return [dict(pacc_f=20_000 + 1_000 * i, pacc_s=1_000, pm_de=30, pm_pr=30, ai=8.0,
                 rss_pages=6_000, hot_thr=4, num_threads=1) for i in range(n)]


def test_build_database_workers_match_serial_and_reference():
    fracs = np.array([1.0, 0.6, 0.3])
    cvs = [convert.config_from_dict(c) for c in _db_configs()]
    kw = dict(fm_fracs=fracs, n_intervals=5, max_rss_pages=3_000, device="cpu")
    db1 = build_database(cvs, workers=1, **kw)
    db2 = build_database(cvs, workers=2, **kw)
    from repro.core.telemetry import ConfigVector as RefConfigVector

    ref = ref_build_database([RefConfigVector(**c) for c in _db_configs()], fm_fracs=fracs,
                             n_intervals=5, max_rss_pages=3_000, workers=1)
    assert len(db1.records) == len(db2.records) == len(ref.records) == 3
    for r1, r2, rr in zip(db1.records, db2.records, ref.records):
        assert np.array_equal(r1.times, r2.times)
        assert np.array_equal(r1.times, rr.times)
        assert r1.config == r2.config


def _linear_microbench(trace, fm_frac):
    return float(trace.rss_pages) * (2.0 - fm_frac) + len(trace)


def test_build_database_injected_backend_runs_per_size_like_the_reference():
    fracs = np.array([1.0, 0.5])
    cvs = [convert.config_from_dict(c) for c in _db_configs(2)]
    from repro.core.telemetry import ConfigVector as RefConfigVector

    db = build_database(cvs, _linear_microbench, fracs, n_intervals=3, max_rss_pages=2_000)
    ref = ref_build_database([RefConfigVector(**c) for c in _db_configs(2)],
                             _linear_microbench, fracs, n_intervals=3, max_rss_pages=2_000)
    for a, b in zip(db.records, ref.records):
        assert np.array_equal(a.times, b.times)
    # the full size runs the fast-only variant of the scaled trace
    from repro_torch.core.tuner import _microbench_trace

    tr = _microbench_trace(cvs[0], 3, 2_000)
    assert db.records[0].times[0] == _linear_microbench(tr.fast_only(), 1.0)
    assert db.records[0].times[1] == _linear_microbench(tr, 0.5)
    assert isinstance(db.records[0].config, ConfigVector)
