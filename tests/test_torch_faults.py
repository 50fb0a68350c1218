"""The port's fault model on the device step (CPU lane) == the JAX
package's on its numpy sweep, bit for bit.

Each run goes through both packages' ``run`` with the same trace, the same
seeded :class:`FaultSpec` and the same database; stats, interval times,
ConfigVectors, costs, fm sizes, tuner decisions (``degraded`` included),
watermark logs and the injected-fault event logs must be equal with no
tolerance: every fault decision is a hash of (seed, interval, page), and
everything downstream is integer or float64 host arithmetic.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.sim import api as ref_api
from repro.sim.faults import FaultSpec as RefFaultSpec
from repro.sim.faults import _u01 as ref_u01
from repro.sim.workloads import thrash_trace as ref_thrash_trace
from repro_torch.sim import api, torch_engine
from repro_torch.sim.faults import FaultInjector, FaultSpec, _u01

from _torch_port import (
    assert_sim_equal,
    decision_dicts,
    event_dicts,
    pressure_trace,
    synthetic_db_pair,
    to_port,
)

BACKENDS = {"sweep": "torch_sweep", "tuned_sweep": "torch_tuned_sweep"}
TUNER = dict(target_loss=0.05, tune_every=2, max_step_frac=0.08)

# each channel alone, at rates that fire within a 10-interval run
CHANNELS = {
    "promote": dict(promote_fail_rate=0.3, max_retries=1, backoff_base=1),
    "promote_long_backoff": dict(promote_fail_rate=0.5, max_retries=3,
                                 backoff_base=2),
    "demote": dict(demote_fail_rate=0.3),
    "kswapd_stall": dict(kswapd_stall_rate=0.2, kswapd_stall_len=2),
    "telemetry_drop": dict(telemetry_drop_rate=0.4),
    "telemetry_noise": dict(telemetry_noise_rate=0.5, telemetry_noise_scale=0.5),
    "db_outage": dict(db_outage_rate=0.5, db_outage_len=3),
    "actuation_lag": dict(actuation_lag=2),
}

# fig_fault_resilience.py's levels (FAULT_SEED 7)
LEVELS = {
    "mild": dict(seed=7, promote_fail_rate=0.05, max_retries=3,
                 telemetry_drop_rate=0.10),
    "harsh": dict(seed=7, promote_fail_rate=0.20, max_retries=2,
                  backoff_base=1, demote_fail_rate=0.10,
                  kswapd_stall_rate=0.05, kswapd_stall_len=2,
                  telemetry_drop_rate=0.15, telemetry_noise_rate=0.20,
                  telemetry_noise_scale=0.5, db_outage_rate=0.15,
                  db_outage_len=2, actuation_lag=1),
}


@pytest.fixture(scope="module")
def dbs():
    return synthetic_db_pair()


def _run_both(trace, spec, dbs, policies, fm_fracs=(1.0,), kswapd_batch=None):
    """The same experiment through both packages; ``policies`` are kwargs
    of a PolicySpec (``tuner`` as TunerSpec kwargs)."""
    ref_db, port_db = dbs

    def specs(mod):
        return [
            mod.PolicySpec(**{
                **p, "tuner": None if p.get("tuner") is None
                else mod.TunerSpec(**p["tuner"]),
            })
            for p in policies
        ]

    ref = ref_api.run(ref_api.Experiment(
        name="faults",
        scenarios=[ref_api.Scenario(
            trace=trace, name="sc", kswapd_batch=kswapd_batch,
            faults=None if spec is None else RefFaultSpec(**spec),
        )],
        fm_fracs=fm_fracs, policies=specs(ref_api), collect_configs=True,
    ), db=ref_db)
    port = api.run(api.Experiment(
        name="faults",
        scenarios=[api.Scenario(
            trace=to_port(trace), name="sc", kswapd_batch=kswapd_batch,
            faults=None if spec is None else FaultSpec(**spec),
        )],
        fm_fracs=fm_fracs, policies=specs(api), collect_configs=True,
    ), db=port_db, device="cpu")
    return ref, port


def _assert_equal(ref, port):
    assert len(port.runs) == len(ref.runs)
    assert port.chunked_step_count == ref.chunked_step_count == 0
    for p, r in zip(port.runs, ref.runs):
        assert (p.scenario, p.policy, p.fm_frac) == (r.scenario, r.policy, r.fm_frac)
        assert p.backend == BACKENDS[r.backend]
        assert_sim_equal(p.result, r.result)
        assert decision_dicts(p.decisions) == decision_dicts(r.decisions)
        assert event_dicts(p.watermark_log) == event_dicts(r.watermark_log)
        assert p.fault_events == r.fault_events


def _kinds_policies(kinds, tuned_start=0.5):
    out = []
    for kind in kinds:
        out.append(dict(kind=kind, label=f"{kind}_full", fm_frac=1.0))
        out.append(dict(kind=kind, label=f"{kind}_tuna", fm_frac=tuned_start,
                        tuner=TUNER))
    return out


def test_fault_spec_round_trips_and_validates():
    for spec in (dict(), *CHANNELS.values(), *LEVELS.values()):
        ref = RefFaultSpec(**spec)
        port = FaultSpec.from_dict(ref.to_dict())
        assert port.to_dict() == ref.to_dict()
        assert port == FaultSpec(**spec)
    with pytest.raises(ValueError, match="promote_fail_rate"):
        FaultSpec(promote_fail_rate=1.5)
    with pytest.raises(ValueError, match="max_retries"):
        FaultSpec(max_retries=-1)
    with pytest.raises(ValueError, match="noise_scale"):
        FaultSpec(telemetry_noise_scale=-0.1)


def test_hash_equals_the_reference():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**63 - 1, size=10_000, dtype=np.int64)
    for seed, salt in ((0, 1), (7, 3), (2**40 + 5, 7)):
        assert np.array_equal(_u01(keys, seed, salt), ref_u01(keys, seed, salt))


@pytest.mark.parametrize("tuned", [False, True], ids=["untuned", "tuned"])
@pytest.mark.parametrize("channel", sorted(CHANNELS))
def test_each_channel_alone(dbs, channel, tuned):
    tr = pressure_trace(1, rss=1_500, n_intervals=10)
    spec = dict(seed=3, **CHANNELS[channel])
    if tuned:
        ref, port = _run_both(tr, spec, dbs, _kinds_policies(["tpp"]))
    else:
        ref, port = _run_both(tr, spec, dbs, [dict(kind="tpp")],
                              fm_fracs=(0.8, 0.45, 0.2))
    _assert_equal(ref, port)
    if tuned or channel in ("promote", "promote_long_backoff", "demote",
                            "kswapd_stall"):
        assert any(r.fault_events for r in port.runs), "the channel never fired"


@pytest.mark.parametrize("kind", ["tpp", "admission", "thrash_guard"])
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_levels_untuned_and_tuned(dbs, level, kind):
    tr = ref_thrash_trace(n_intervals=12, rss_pages=2_000)
    ref, port = _run_both(tr, LEVELS[level], dbs, _kinds_policies([kind]))
    _assert_equal(ref, port)
    tuna = port.record(policy=f"{kind}_tuna")
    assert tuna.fault_events
    if level == "harsh":
        assert any(d.degraded is not None for d in tuna.decisions)


def test_harsh_pressure_sweep_surfaces_pgpromote_fail(dbs):
    tr = pressure_trace(4, rss=2_000, n_intervals=10)
    # backoff_base 3: a page that failed once sits out the next two
    # intervals, long enough to be withheld while it is hot again
    spec = dict(LEVELS["harsh"], promote_fail_rate=0.6, max_retries=1,
                backoff_base=3)
    ref, port = _run_both(tr, spec, dbs, [dict(kind="tpp")],
                          fm_fracs=(0.9, 0.5, 0.25))
    _assert_equal(ref, port)
    assert all(r.result.stats["pgpromote_fail"] > 0 for r in port.runs)
    kinds = {e["kind"] for r in port.runs for e in r.fault_events}
    assert {"promote_fail_exhausted", "promote_fail_transient",
            "promote_backoff_withheld"} <= kinds


def test_zero_rate_spec_equals_no_faults(dbs):
    tr = pressure_trace(2, rss=1_500, n_intervals=8)
    pols = _kinds_policies(["tpp", "thrash_guard"])
    ref0, port0 = _run_both(tr, dict(seed=9), dbs, pols)
    _assert_equal(ref0, port0)
    _, none = _run_both(tr, None, dbs, pols)
    for a, b in zip(port0.runs, none.runs):
        assert_sim_equal(a.result, b.result)
        assert decision_dicts(a.decisions) == decision_dicts(b.decisions)
        assert a.fault_events == [] and b.fault_events is None


@pytest.mark.parametrize("promote_batch", [1, 40])
def test_promote_batch_cuts_after_the_filter(dbs, promote_batch):
    # the filter runs on every admitted candidate, the cut on the survivors:
    # a cut before the filter would change the draws and the retry state
    tr = pressure_trace(5, rss=1_500, n_intervals=10)
    spec = dict(seed=11, promote_fail_rate=0.4, max_retries=2)
    pols = [dict(kind=k, label=k, params={"promote_batch": promote_batch})
            for k in ("tpp", "admission", "thrash_guard")]
    ref, port = _run_both(tr, spec, dbs, pols, fm_fracs=(0.7, 0.3))
    _assert_equal(ref, port)
    assert all(r.result.stats["pgpromote_success"] > 0 for r in port.runs)


def test_thrash_regime_resolver_sees_the_faulted_kswapd_budget(dbs, monkeypatch):
    # a starved kswapd puts reclaim demand into the same step's promotions:
    # the host resolver replays the schedule with the interval's effective
    # (stalled or shed) budget
    calls = []
    real = torch_engine._resolve_step_victims

    def counting(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(torch_engine, "_resolve_step_victims", counting)
    tr = pressure_trace(0, rss=2_000, n_intervals=10)
    spec = dict(seed=2, demote_fail_rate=0.5, kswapd_stall_rate=0.3,
                kswapd_stall_len=2, promote_fail_rate=0.2)
    ref, port = _run_both(tr, spec, dbs, [dict(kind="tpp")],
                          fm_fracs=(0.6, 0.3, 0.12), kswapd_batch=24)
    _assert_equal(ref, port)
    assert calls, "the thrash resolver never ran"
    kinds = {e["kind"] for r in port.runs for e in r.fault_events}
    assert {"kswapd_stall", "demote_fail"} <= kinds


def test_fast_only_at_full_keeps_one_injector_per_group(dbs):
    tr = pressure_trace(6, rss=1_200, n_intervals=8)
    ref_db, port_db = dbs
    spec = LEVELS["harsh"]
    pols = lambda mod: [mod.PolicySpec(label="t"), mod.PolicySpec(
        label="tuna", tuner=mod.TunerSpec(**TUNER))]
    ref = ref_api.run(ref_api.Experiment(
        scenarios=[ref_api.Scenario(trace=tr, fast_only_at_full=True,
                                    faults=RefFaultSpec(**spec))],
        fm_fracs=(1.0, 0.5), policies=pols(ref_api)), db=ref_db)
    port = api.run(api.Experiment(
        scenarios=[api.Scenario(trace=to_port(tr), fast_only_at_full=True,
                                faults=FaultSpec(**spec))],
        fm_fracs=(1.0, 0.5), policies=pols(api)), db=port_db, device="cpu")
    _assert_equal(ref, port)


def test_identical_seed_identical_event_log(dbs):
    tr = pressure_trace(3, rss=1_500, n_intervals=10)
    _, a = _run_both(tr, LEVELS["harsh"], dbs, _kinds_policies(["tpp"]))
    _, b = _run_both(tr, LEVELS["harsh"], dbs, _kinds_policies(["tpp"]))
    assert [r.fault_events for r in a.runs] == [r.fault_events for r in b.runs]
    _, c = _run_both(tr, dict(LEVELS["harsh"], seed=8), dbs,
                     _kinds_policies(["tpp"]))
    assert [r.fault_events for r in a.runs] != [r.fault_events for r in c.runs]


def test_injector_and_policy_must_agree():
    tr = to_port(pressure_trace(0, rss=500, n_intervals=2))
    from repro_torch.tiering.policy import TPPPolicy

    pol = TPPPolicy()
    pol.fault_injector = FaultInjector(FaultSpec(promote_fail_rate=0.1))
    with pytest.raises(ValueError, match="fault_injector"):
        torch_engine._require_torch_runnable(tr, pol, None)
    torch_engine._require_torch_runnable(tr, pol, pol.fault_injector)
    with pytest.raises(TypeError, match="FaultSpec"):
        api.run(api.Experiment(scenarios=[api.Scenario(
            trace=tr, faults=dataclasses.asdict(FaultSpec()))]), device="cpu")


def test_faults_on_the_card_without_a_gpu_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = to_port(pressure_trace(0, rss=500, n_intervals=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.run(api.Experiment(scenarios=[api.Scenario(
            trace=tr, faults=FaultSpec(**LEVELS["harsh"]))]))


# --------------------------- chip_smoke.py's copy of fig_fault_resilience.py
def _load_chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from benchmarks import common, fig3_7_tuning, fig_fault_resilience

    return common, fig3_7_tuning, fig_fault_resilience


@pytest.mark.parametrize("level", ["none", "mild", "harsh"])
def test_chip_smoke_fault_levels_equal_the_benchmark(dbs, bench, level):
    common, fig, fault_fig = bench
    smoke = _load_chip_smoke()
    ref_spec = fault_fig.fault_levels()[level]
    spec = smoke.fault_levels()[level]
    assert (None if spec is None else spec.to_dict()) == (
        None if ref_spec is None else ref_spec.to_dict())
    kinds = common.policy_kinds(tunable=True)
    assert kinds == smoke.KNEE_KINDS
    assert dataclasses.asdict(smoke.paper_tuner()) == dataclasses.asdict(fig.tuner_spec())
    tr = ref_thrash_trace(n_intervals=14, rss_pages=2_000)
    ref = fault_fig._level_experiment(tr, level, ref_spec, kinds, dbs[0],
                                      tuned_start=0.5)
    port = smoke.fault_level_run(to_port(tr), level, spec, dbs[1],
                                 tuned_start=0.5, device="cpu")
    _assert_equal(ref, port)
    rows = smoke.fault_rows(port, to_port(tr), kinds)
    for kind in kinds:
        base = ref.result(policy=f"{kind}_full")
        res = ref.result(policy=f"{kind}_tuna")
        rec = ref.record(policy=f"{kind}_tuna")
        loss = fig.summarize(base, res, tr)[2]
        assert rows[kind] == {
            "overall_loss": loss,
            "target_miss": loss - fig.TARGET_LOSS,
            "migrations": res.migrations,
            "pgpromote_fail": res.stats["pgpromote_fail"],
            "degraded": fault_fig._degraded_counts(rec.decisions),
            "fault_events": fault_fig._fault_event_count(rec),
        }
