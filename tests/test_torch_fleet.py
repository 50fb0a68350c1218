"""The port's fleet layer (tenants as slices of the device step, the budget
arbiter, ``MultiTenantKV``) on the CPU == the JAX package's ``repro.fleet``
and ``repro.serving.MultiTenantKV``, bit for bit.

The pure pieces (the trace merge, the static split, water-filling, the
k-NN loss curve) are held against the reference on seeded inputs; fleet
runs go through both packages' ``run`` with the same tenant traces and
database, and every tenant record (stats, interval times, ConfigVectors,
fm sizes, tuner decisions, watermark logs, fault events) and the arbiter's
log must be equal with no tolerance. ``chip_smoke.py``'s phase 11 copies of
``benchmarks/fig_fleet.py`` (the mixes, ``run_mix``, ``mix_summary``) and
its ``MultiTenantKV`` schedule are imported by path and held against the
benchmark and the reference at the quick size.
"""

import importlib.util
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.perfdb import PerfRecord as RefPerfRecord
from repro.core.telemetry import ConfigVector as RefConfigVector
from repro.fleet import ArbiterSpec as RefArbiterSpec
from repro.fleet import FleetScenario as RefFleetScenario
from repro.fleet import TenantSpec as RefTenantSpec
from repro.fleet import merge_tenant_traces as ref_merge_tenant_traces
from repro.fleet import water_fill as ref_water_fill
from repro.fleet.arbiter import _mean_loss_curve as ref_mean_loss_curve
from repro.fleet.runner import static_partition as ref_static_partition
from repro.sim import api as ref_api
from repro.sim.faults import FaultSpec as RefFaultSpec
from repro_torch import convert
from repro_torch.core.perfdb import PerfRecord
from repro_torch.fleet import (
    ArbiterSpec,
    FleetScenario,
    TenantSpec,
    merge_tenant_traces,
    water_fill,
)
from repro_torch.fleet.arbiter import _mean_loss_curve
from repro_torch.fleet.runner import static_partition
from repro_torch.serving import MultiTenantKV
from repro_torch.sim import api
from repro_torch.sim.faults import FaultSpec

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
from benchmarks import fig_fleet as bench_fleet  # noqa: E402

QUICK = dict(ni=18, rss=3_000, pps=150, noisy_rss=2_000)  # fig_fleet --quick
HARSH = dict(seed=7, promote_fail_rate=0.20, max_retries=2, backoff_base=1,
             demote_fail_rate=0.10, kswapd_stall_rate=0.05, kswapd_stall_len=2,
             telemetry_drop_rate=0.15, telemetry_noise_rate=0.20,
             telemetry_noise_scale=0.5, db_outage_rate=0.15, db_outage_len=2,
             actuation_lag=1)
TUNER = dict(target_loss=0.1, tune_every=2, k_neighbors=1, cooldown_windows=2,
             max_step_frac=0.1)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _load_chip_smoke()


@pytest.fixture(scope="module")
def quick_mixes():
    """fig_fleet's quick mixes (the JAX package's tenants)."""
    return bench_fleet.fleet_mixes(quick=True)


@pytest.fixture(scope="module")
def dbs(quick_mixes):
    """fig_fleet's probe-built smoke database, and the same records in the
    port."""
    ref = bench_fleet._quick_db(quick_mixes["balanced"])
    port = convert.perfdb_from_records([
        {"config": asdict(r.config), "fm_fracs": r.fm_fracs, "times": r.times}
        for r in ref.records
    ])
    return ref, port


def _assert_records_equal(port_rs, ref_rs):
    assert len(port_rs.runs) == len(ref_rs.runs)
    assert port_rs.chunked_step_count == ref_rs.chunked_step_count == 0
    for p, r in zip(port_rs.runs, ref_rs.runs):
        assert (p.scenario, p.policy, p.fm_frac, p.backend) == (
            r.scenario, r.policy, r.fm_frac, r.backend)
        assert_sim_equal(p.result, r.result)
        assert decision_dicts(p.decisions) == decision_dicts(r.decisions)
        assert event_dicts(p.watermark_log) == event_dicts(r.watermark_log)
        assert p.fault_events == r.fault_events
        assert p.arbiter_log == r.arbiter_log


def _fleet_pair(dbs, tenants, budget_frac=0.5, faults=None, every=2, fm_fracs=(1.0,)):
    """One fleet experiment (static + tuned) through both packages; tenants
    are ``(name, JAX trace, ceil_frac)``."""
    ref_db, port_db = dbs
    pols = lambda mod: [mod.PolicySpec(label="static"),
                        mod.PolicySpec(label="tuna", tuner=mod.TunerSpec(**TUNER))]
    ref = ref_api.run(ref_api.Experiment(
        name="fleet",
        scenarios=[RefFleetScenario(
            tenants=tuple(RefTenantSpec(trace=tr, name=n, ceil_frac=c)
                          for n, tr, c in tenants),
            budget_frac=budget_frac, arbiter=RefArbiterSpec(every=every),
            faults=None if faults is None else RefFaultSpec(**faults))],
        fm_fracs=fm_fracs, policies=pols(ref_api)), db=ref_db)
    port = api.run(api.Experiment(
        name="fleet",
        scenarios=[FleetScenario(
            tenants=tuple(TenantSpec(trace=to_port(tr), name=n, ceil_frac=c)
                          for n, tr, c in tenants),
            budget_frac=budget_frac, arbiter=ArbiterSpec(every=every),
            faults=None if faults is None else FaultSpec(**faults))],
        fm_fracs=fm_fracs, policies=pols(api)), db=port_db, device="cpu")
    return ref, port


# ----------------------------------------------------------- pure pieces
def test_merge_tenant_traces_equals_reference():
    a = pressure_trace(1, rss=2_000, n_intervals=10)
    b = pressure_trace(2, rss=1_000, n_intervals=6)
    c = pressure_trace(3, rss=1_500, n_intervals=8)
    c.slow_pages = np.arange(0, 1_500, 7)
    c.num_threads = 4
    ref, ref_owner, ref_caps = ref_merge_tenant_traces([a, b, c], name="m")
    port, owner, caps = merge_tenant_traces([to_port(t) for t in (a, b, c)], name="m")
    assert np.array_equal(owner, ref_owner) and np.array_equal(caps, ref_caps)
    d, ref_d = convert.trace_dict(port), convert.trace_dict(ref)
    assert (d["name"], d["rss_pages"], d["num_threads"]) == (
        ref_d["name"], ref_d["rss_pages"], ref_d["num_threads"])
    assert np.array_equal(d["slow_pages"], ref_d["slow_pages"])
    assert len(d["intervals"]) == len(ref_d["intervals"]) == 10
    for x, y in zip(d["intervals"], ref_d["intervals"]):
        for k in ("pages", "counts", "touches"):
            assert np.array_equal(x[k], y[k])
        assert (x["ops"], x["rand_frac"]) == (y["ops"], y["rand_frac"])


@pytest.mark.parametrize("seed", range(6))
def test_static_partition_equals_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    caps = rng.integers(500, 5_000, size=n)
    shares = [None if rng.random() < 0.4 else float(rng.uniform(0.2, 3.0))
              for _ in range(n)]
    floors = np.maximum(1, (caps * rng.uniform(0.01, 0.2, size=n)).astype(np.int64))
    ceils = np.maximum(floors, (caps * rng.uniform(0.3, 1.0, size=n)).astype(np.int64))
    budget = int(rng.integers(100, int(caps.sum())))
    got = static_partition(budget, caps, shares, floors, ceils)
    want = ref_static_partition(budget, caps, shares, floors, ceils)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _curve(rng, fracs):
    loss = np.sort(rng.uniform(0.0, 1.0, size=fracs.size))
    loss[0] = 0.0
    return fracs, loss


@pytest.mark.parametrize("seed", range(10))
def test_water_fill_equals_reference(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 6))
    caps = rng.integers(500, 3_000, size=n)
    floors = np.maximum(1, (0.05 * caps).astype(np.int64))
    ceils = (caps * rng.choice([1.0, 0.6, 0.3], size=n)).astype(np.int64)
    desired = rng.integers(0, caps + 1)
    budget = int(rng.integers(int(floors.sum()) // 2, int(caps.sum())))
    fracs = np.round(np.arange(1.0, 0.19, -0.1), 3)
    curves = None if seed % 5 == 0 else [
        None if rng.random() < 0.3 else _curve(rng, fracs) for _ in range(n)
    ]
    got, mode = water_fill(desired, floors, ceils, caps, budget, curves)
    want, ref_mode = ref_water_fill(desired, floors, ceils, caps, budget, curves)
    assert mode == ref_mode and np.array_equal(got, want)


def test_mean_loss_curve_equals_reference():
    rng = np.random.default_rng(4)
    grid = np.round(np.arange(1.0, 0.19, -0.1), 3)
    other = np.round(np.arange(1.0, 0.19, -0.05), 3)  # interpolated onto grid
    ref_recs, recs = [], []
    for fr in (grid, other, grid):
        cfg = dict(pacc_f=float(rng.uniform(1e3, 1e4)), pacc_s=500.0, pm_de=20.0,
                   pm_pr=20.0, ai=6.0, rss_pages=4_000.0, hot_thr=4, num_threads=1)
        times = 1.0 + np.sort(rng.uniform(0, 0.5, size=fr.size))
        ref_recs.append(RefPerfRecord(config=RefConfigVector(**cfg), fm_fracs=fr,
                                      times=times))
        recs.append(PerfRecord(config=convert.config_from_dict(cfg), fm_fracs=fr,
                               times=times))
    (g1, l1), (g2, l2) = _mean_loss_curve(recs), ref_mean_loss_curve(ref_recs)
    assert np.array_equal(g1, g2) and np.array_equal(l1, l2)
    assert _mean_loss_curve([]) is None


def test_arbiter_spec_converts():
    spec = RefArbiterSpec(every=3, hysteresis_frac=0.05, k_neighbors=2)
    assert asdict(convert.arbiter_spec_from_dict(asdict(spec))) == asdict(spec)
    with pytest.raises(ValueError, match="every"):
        ArbiterSpec(every=0)


# ------------------------------------------------------------ fleet runs
def test_one_tenant_fleet_equals_the_plain_tuned_sweep(dbs):
    tr = pressure_trace(7, rss=3_000, n_intervals=10)
    ref, port = _fleet_pair(dbs, [("solo", tr, 1.0)], budget_frac=1.0)
    _assert_records_equal(port, ref)
    fleet = port.record(scenario="fleet/solo", policy="tuna")
    assert fleet.backend == "fleet" and fleet.arbiter_log
    assert all(e["mode"] == "within_budget" for e in fleet.arbiter_log)
    plain = api.run(api.Experiment(
        name="plain", scenarios=[api.Scenario(trace=to_port(tr))],
        fm_fracs=(1.0,), policies=[api.PolicySpec(
            label="tuna", tuner=api.TunerSpec(**TUNER))],
    ), db=dbs[1], device="cpu").record()
    assert plain.result.stats == fleet.result.stats
    assert np.array_equal(plain.result.interval_times, fleet.result.interval_times)
    assert np.array_equal(plain.result.fm_sizes, fleet.result.fm_sizes)
    assert [asdict(c) for c in plain.result.configs] == [
        asdict(c) for c in fleet.result.configs]
    assert decision_dicts(plain.decisions) == decision_dicts(fleet.decisions)


@pytest.mark.parametrize("budget_frac", [0.5, 0.3])
def test_two_tenants_equal_reference(dbs, budget_frac):
    ref, port = _fleet_pair(dbs, [
        ("a", pressure_trace(11, rss=3_000, n_intervals=10), 1.0),
        ("b", pressure_trace(13, rss=2_000, n_intervals=8), 1.0),
    ], budget_frac=budget_frac, fm_fracs=(1.0, 0.8))
    _assert_records_equal(port, ref)
    modes = {e["mode"] for r in port.runs if r.arbiter_log for e in r.arbiter_log}
    assert modes - {"within_budget"}, "the arbiter never divided the budget"


def test_ceiling_binds(dbs):
    ref, port = _fleet_pair(dbs, [
        ("a", pressure_trace(11, rss=3_000, n_intervals=10), 1.0),
        ("b", pressure_trace(13, rss=3_000, n_intervals=10), 0.3),
    ])
    _assert_records_equal(port, ref)
    ceil_b = round(0.3 * 3_000)
    for pol in ("static", "tuna"):
        assert port.record(scenario="fleet/b", policy=pol).result.fm_sizes.max() <= ceil_b
    log = port.record(scenario="fleet/b", policy="tuna").arbiter_log
    assert log and all(e["granted"][1] <= ceil_b for e in log)


def test_faulted_fleet_degrades_and_equals_reference(dbs):
    faults = dict(seed=5, db_outage_rate=0.7, db_outage_len=3,
                  telemetry_drop_rate=0.4, promote_fail_rate=0.3)
    ref, port = _fleet_pair(dbs, [
        ("a", pressure_trace(11, rss=3_000, n_intervals=10), 1.0),
        ("b", pressure_trace(13, rss=3_000, n_intervals=10), 1.0),
    ], faults=faults)
    _assert_records_equal(port, ref)
    rec = port.record(scenario="fleet/a", policy="tuna")
    assert rec.fault_events and any(d.degraded is not None for d in rec.decisions)


# --------------------------------------------- fig_fleet.py's quick mixes
@pytest.mark.parametrize("mix", ["balanced", "skewed", "noisy"])
def test_fig_fleet_quick_mix_equals_the_benchmark(smoke, quick_mixes, dbs, mix):
    tenants = quick_mixes[mix]
    port_tenants = smoke.fleet_tenants(smoke.fleet_mix_jobs(**QUICK)[mix])
    for t, p in zip(tenants, port_tenants):
        assert t.resolved_name == p.resolved_name and t.ceil_frac == p.ceil_frac
        a, b = convert.trace_dict(t.trace), convert.trace_dict(p.trace)
        assert all(np.array_equal(x[k], y[k]) for x, y in zip(
            a["intervals"], b["intervals"]) for k in ("pages", "counts", "touches"))
    ref_rs, rs = bench_fleet.run_mix(mix, tenants, dbs[0])
    port_ref, port_rs = smoke.run_mix(mix, port_tenants, dbs[1], device="cpu")
    _assert_records_equal(port_ref, ref_rs)
    _assert_records_equal(port_rs, rs)
    want = bench_fleet.mix_summary(mix, tenants, ref_rs, rs)
    got = smoke.mix_summary(mix, port_tenants, port_ref, port_rs)
    assert got == want
    assert got["saved_pages"] > 0  # fig_fleet --quick's claim
    if mix == "noisy":
        assert smoke.isolation_delta(got) == bench_fleet.isolation_delta(want)


def test_noisy_mix_under_harsh_faults(smoke, quick_mixes, dbs):
    tenants = quick_mixes["noisy"]
    ref = ref_api.run(ref_api.Experiment(
        name="fleet[noisy@harsh]",
        scenarios=[RefFleetScenario(
            tenants=tenants, name="noisy", budget_frac=bench_fleet.BUDGET_FRAC,
            arbiter=bench_fleet.ARBITER, faults=RefFaultSpec(**HARSH))],
        fm_fracs=(1.0,), policies=[
            ref_api.PolicySpec(label="static"),
            ref_api.PolicySpec(label="fleet_tuna",
                               tuner=bench_fleet.fleet_tuner_spec())],
    ), db=dbs[0])
    port_tenants = smoke.fleet_tenants(smoke.fleet_mix_jobs(**QUICK)["noisy"])
    port = smoke.fleet_run("noisy", port_tenants, dbs[1], smoke.fleet_policies(),
                           faults=smoke.fault_levels()["harsh"],
                           name="fleet[noisy@harsh]", device="cpu")
    _assert_records_equal(port, ref)
    tuned = [r for r in port.runs if r.policy == "fleet_tuna"]
    assert all(r.fault_events for r in tuned)
    assert any(d.degraded is not None for r in tuned for d in r.decisions)


def test_chip_smoke_copies_the_benchmark_constants(smoke):
    assert smoke.FLEET_BUDGET_FRAC == bench_fleet.BUDGET_FRAC
    assert smoke.FLEET_WARMUP == bench_fleet.WARMUP
    assert smoke.TAU_FLEET == bench_fleet.TAU_FLEET
    assert asdict(smoke.fleet_arbiter()) == asdict(bench_fleet.ARBITER)
    assert asdict(smoke.fleet_tuner_spec()) == asdict(bench_fleet.fleet_tuner_spec())
    assert smoke.FLEET_FULL_SIZE["rss"] * 2 + smoke.FLEET_FULL_SIZE["rss"] * 2 \
        == 3_250_584
    scale = smoke.FLEET_FULL_SIZE["rss"] / smoke.FLEET_SIZE["rss"]
    assert round(smoke.FLEET_SIZE["pps"] * scale) == smoke.FLEET_FULL_SIZE["pps"]


# ------------------------------------------------------------ MultiTenantKV
def _kv_pair(page, tenants, budget, ceil_frac, seed):
    import jax.numpy as jnp

    from repro.serving import MultiTenantKV as RefMultiTenantKV
    from repro.serving.kv_cache import KVPageConfig as RefPageConfig

    ref = RefMultiTenantKV(RefPageConfig(**page), tenant_pages=tenants,
                           hbm_budget=budget, ceil_frac=ceil_frac, seed=5)
    port = MultiTenantKV(convert.kv_page_config_from_dict(page),
                         tenant_pages=tenants, hbm_budget=budget,
                         ceil_frac=ceil_frac, seed=5, device="cpu")
    rng = np.random.default_rng(seed)
    for name in ref.names:
        host = np.asarray(rng.normal(size=ref[name].host.shape), dtype=jnp.bfloat16)
        ref[name].host[:] = host
        port[name].host.copy_(convert.pool_from_numpy(host))
    return ref, port


def _assert_kv_equal(port, ref):
    assert port.names == ref.names
    assert port.arbiter.log_dicts() == ref.arbiter.log_dicts()
    for name in ref.names:
        a, b = ref[name], port[name]
        every = np.arange(a.total_pages)
        assert np.array_equal(a.hbm_slot, b.hbm_slot)
        assert np.array_equal(np.asarray(a.pool.tier), np.asarray(b.pool.tier))
        assert np.array_equal(a.pool.heat_of(every), b.pool.heat_of(every))
        assert a.pool.stats.snapshot() == b.pool.stats.snapshot()
        assert a.pool.effective_fm_size == b.pool.effective_fm_size
        assert np.array_equal(np.asarray(a.host).view(np.uint16),
                              convert.pool_bits(b.host))
        assert np.array_equal(np.asarray(a.hbm).view(np.uint16),
                              convert.pool_bits(b.hbm))


def test_multi_tenant_kv_schedule_equals_reference(smoke):
    # chip_smoke's phase 11 schedule and tenants, at a narrow page
    ref, port = _kv_pair(smoke.NARROW_PAGE, smoke.FLEET_KV_TENANTS,
                         smoke.FLEET_KV_BUDGET, smoke.FLEET_KV_CEIL, seed=17)
    _assert_kv_equal(port, ref)  # the static split, applied at construction
    # 72 of the 200 rounds (the reference's copies recompile for each batch
    # shape): the hot set visits every tenant, both arbiter modes occur
    want = smoke.fleet_kv_rounds(ref, rounds=72)
    got = smoke.fleet_kv_rounds(port, rounds=72)
    assert got == want
    _assert_kv_equal(port, ref)
    rebalances = [e for e in got if e[0] == "rebalance"]
    modes = {e["mode"] for e in port.arbiter.log_dicts()}
    assert len(rebalances) == 72 // smoke.FLEET_KV_REBALANCE
    assert {"proportional", "hysteresis_hold"} <= modes
    # every tenant holds at most its watermark; grants are met to within
    # the controllers' deadband (the HBM in use may pass the budget by less)
    assert all(u <= e for _, _, use, eff in rebalances for u, e in zip(use, eff))
    deadbands = sum(c.deadband_frac * c.pool.hw_capacity
                    for c in port.arbiter.controllers)
    assert max(sum(use) for _, _, use, _ in rebalances) - port.hbm_budget < deadbands
    assert sum(port[n].migrated_in for n in port.names) > 0
    assert sum(port[n].migrated_out for n in port.names) > 0


def test_multi_tenant_kv_rebalance_follows_demand():
    page = dict(n_groups=2, page_size=4, kv_heads=2, head_dim=8)
    ref, port = _kv_pair(page, {"a": 128, "b": 128}, 96, 1.0, seed=3)
    for mt in (ref, port):
        mt["a"].ensure_resident(np.arange(90))
        mt["b"].ensure_resident(np.arange(8))
    want = ref.rebalance(t=1.0, interval=1)
    got = port.rebalance(t=1.0, interval=1)
    assert np.array_equal(got, want)
    _assert_kv_equal(port, ref)
    assert got[0] > got[1] and got.sum() <= port.hbm_budget
    assert port.hbm_in_use() <= port.hbm_budget and port.stranded_pages() >= 0


def test_fleets_on_the_card_without_a_gpu_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = to_port(pressure_trace(0, rss=500, n_intervals=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.run(api.Experiment(scenarios=[FleetScenario(
            tenants=(TenantSpec(trace=tr, name="a"),))]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiTenantKV(convert.kv_page_config_from_dict(
            dict(n_groups=1, page_size=4, kv_heads=1, head_dim=8)),
            tenant_pages={"a": 8}, hbm_budget=4)
