"""The port's per-size engine (``repro_torch.sim.engine._simulate``), the
``pool_factory`` and ``runner`` scenarios of its ``run`` and the
``first_touch`` kind of the device step, against the JAX package, bit for
bit on the CPU.

``_simulate`` runs the host pool and the policies' host ``step``: with the
port's ``TieredPagePool`` (the bulk step, thrash regime included) and with
the JAX package's frozen ``ReferencePagePool`` as ``pool_factory`` (the
chunked loop), under a ``FaultSpec`` (the host promotion filter) and with a
Tuna tuner. Stats, interval times, ConfigVectors, costs, fm sizes, tuner
decisions, watermark logs and fault events must be equal with no
tolerance: the pool is numpy copied line for line and everything downstream
is integer or float64 host arithmetic.
"""

import functools
import warnings

import numpy as np
import pytest

from repro.core.microbench import MicrobenchSpec as RefMicrobenchSpec
from repro.core.microbench import generate_from_spec as ref_generate_from_spec
from repro.sim import api as ref_api
from repro.sim.engine import _simulate as ref_simulate
from repro.sim.faults import FaultSpec as RefFaultSpec
from repro.tiering import policy as ref_policy
from repro.tiering.page_pool import TieredPagePool as RefTieredPagePool
from repro.tiering.reference_pool import ReferencePagePool
from repro_torch.sim import api
from repro_torch.sim.engine import _simulate
from repro_torch.sim.faults import FaultSpec
from repro_torch.tiering import policy
from repro_torch.tiering.page_pool import TieredPagePool

from _torch_port import (
    assert_sim_equal,
    decision_dicts,
    event_dicts,
    pressure_trace,
    synthetic_db_pair,
    to_port,
)

KINDS = ("tpp", "admission", "thrash_guard", "first_touch")
FRACS = (1.0, 0.6, 0.35, 0.15)
HARSH = dict(seed=7, promote_fail_rate=0.2, max_retries=2, backoff_base=1,
             demote_fail_rate=0.1, kswapd_stall_rate=0.05, kswapd_stall_len=2,
             telemetry_drop_rate=0.15, telemetry_noise_rate=0.2,
             telemetry_noise_scale=0.5, db_outage_rate=0.15, db_outage_len=2,
             actuation_lag=1)


@pytest.fixture(scope="module")
def press():
    ref = pressure_trace(3, rss=2_500, n_intervals=10)
    return ref, to_port(ref)


@pytest.fixture(scope="module")
def microbench():
    """A trace with a slow-bound array (``slow_pages``) and warm pages."""
    spec = RefMicrobenchSpec(np_fast=900, np_slow=500, pm_pr=120, pm_de=100,
                             rss_pages=2_400, hot_thr=4, ai=4.0, num_threads=2,
                             tail_pages=150, tail_touches=2)
    ref = ref_generate_from_spec(spec, n_intervals=8, warmup_intervals=2)
    return ref, to_port(ref)


def _pools(which):
    """(the JAX package's pool factory, the port's)"""
    return {"port": (RefTieredPagePool, TieredPagePool),
            "reference": (ReferencePagePool, ReferencePagePool)}[which]


@pytest.mark.parametrize("pool", ["port", "reference"])
@pytest.mark.parametrize("kind", KINDS)
def test_simulate_matches_reference(press, kind, pool):
    ref_tr, tr = press
    ref_pool, port_pool = _pools(pool)
    chunked = 0
    for f in FRACS:
        want = ref_simulate(ref_tr, f, ref_policy.POLICIES[kind](),
                            pool_factory=ref_pool)
        pol = policy.POLICIES[kind]()
        got = _simulate(tr, f, pol, pool_factory=port_pool)
        assert_sim_equal(got, want)
        chunked += pol.chunked_steps
    # the bulk step covers every regime; the reference pool runs chunked
    assert (chunked == 0) if (pool == "port" or kind == "first_touch") else chunked > 0


@pytest.mark.parametrize("kind", KINDS)
def test_simulate_with_slow_pages_matches_reference(microbench, kind):
    ref_tr, tr = microbench
    for f in (1.0, 0.5, 0.3):
        want = ref_simulate(ref_tr, f, ref_policy.POLICIES[kind](hot_thr=4))
        got = _simulate(tr, f, policy.POLICIES[kind](hot_thr=4))
        assert_sim_equal(got, want)


@pytest.mark.parametrize("pool", ["port", "reference"])
@pytest.mark.parametrize("kind", ["tpp", "thrash_guard", "first_touch"])
def test_simulate_under_faults_matches_reference(press, kind, pool):
    ref_tr, tr = press
    ref_pool, port_pool = _pools(pool)
    for f in (0.6, 0.2):
        ref_pol = ref_policy.POLICIES[kind]()
        want = ref_simulate(ref_tr, f, ref_pol, pool_factory=ref_pool,
                            faults=RefFaultSpec(**HARSH))
        pol = policy.POLICIES[kind]()
        got = _simulate(tr, f, pol, pool_factory=port_pool, faults=FaultSpec(**HARSH))
        assert_sim_equal(got, want)
        assert pol.fault_injector.all_events() == ref_pol.fault_injector.all_events()
        if kind == "tpp":
            assert got.stats["pgpromote_fail"] > 0


@pytest.mark.parametrize("faults", [None, HARSH])
@pytest.mark.parametrize("kind", ["tpp", "admission", "thrash_guard"])
def test_simulate_with_a_tuner_matches_reference(press, kind, faults):
    ref_tr, tr = press
    ref_db, port_db = synthetic_db_pair()
    ref_tuner = ref_api.TunerSpec(target_loss=0.25, tune_every=2,
                                  max_step_frac=0.3).build(ref_db)
    tuner = api.TunerSpec(target_loss=0.25, tune_every=2,
                          max_step_frac=0.3).build(port_db)
    want = ref_simulate(ref_tr, 0.9, ref_policy.POLICIES[kind](), tuner=ref_tuner,
                        tune_every=2,
                        faults=None if faults is None else RefFaultSpec(**faults))
    pol = policy.POLICIES[kind]()
    got = _simulate(tr, 0.9, pol, tuner=tuner, tune_every=2,
                    faults=None if faults is None else FaultSpec(**faults))
    assert_sim_equal(got, want)
    assert decision_dicts(tuner.decisions) == decision_dicts(ref_tuner.decisions)
    assert event_dicts(tuner.controller.log) == event_dicts(ref_tuner.controller.log)
    if faults is None:
        assert len(tuner.controller.log) > 0
    else:  # harsh faults: outages and dropped telemetry hold the tuner
        assert any(e["kind"] == "db_outage" for e in pol.fault_injector.all_events())


@pytest.mark.parametrize("pool", ["port", "reference"])
def test_chunked_steps_per_policy(press, pool):
    """The per-instance chunked-loop counter equals the JAX package's: the
    port's pool takes the bulk step (no chunked loop), ``ReferencePagePool``
    has no bulk step and counts every non-empty step."""
    ref_tr, tr = press
    ref_pool, port_pool = _pools(pool)
    ref_pol, pol = ref_policy.TPPPolicy(), policy.TPPPolicy()
    ref_simulate(ref_tr, 0.3, ref_pol, pool_factory=ref_pool)
    _simulate(tr, 0.3, pol, pool_factory=port_pool)
    assert pol.chunked_steps == ref_pol.chunked_steps
    assert (pol.chunked_steps > 0) == (pool == "reference")


def _records(rs):
    out = []
    for r in rs.runs:
        res = r.result
        out.append(((r.scenario, r.policy, r.fm_frac), res.stats,
                    res.interval_times.tolist(), res.fm_sizes.tolist(),
                    [c.__dict__ for c in res.configs], [c.__dict__ for c in res.costs],
                    decision_dicts(r.decisions), event_dicts(r.watermark_log),
                    r.fault_events))
    return out


def _experiments(ref_tr, tr, pool_factory, faults=None, tuned=False, **sc):
    """The same experiment for both packages: every kind, a tuned spec when
    ``tuned``."""
    dbs = synthetic_db_pair()

    def make(mod, trace, db, spec_faults):
        pols = [mod.PolicySpec(kind=k, label=k) for k in KINDS]
        if tuned:
            pols.append(mod.PolicySpec(label="tuna", fm_frac=0.9, tuner=mod.TunerSpec(
                target_loss=0.25, tune_every=2, max_step_frac=0.3)))
        return mod.Experiment(
            scenarios=[mod.Scenario(trace=trace, name="press", faults=spec_faults,
                                    pool_factory=pool_factory, **sc)],
            fm_fracs=(1.0, 0.5, 0.2), policies=pols, collect_configs=True,
        ), db

    ref_exp, ref_db = make(ref_api, ref_tr, dbs[0],
                           None if faults is None else RefFaultSpec(**faults))
    exp, db = make(api, tr, dbs[1], None if faults is None else FaultSpec(**faults))
    return (ref_exp, ref_db), (exp, db)


@pytest.mark.parametrize("faults", [None, HARSH])
@pytest.mark.parametrize("factory", ["port", "reference"])
def test_run_with_pool_factory_matches_reference(press, factory, faults):
    ref_tr, tr = press
    ref_pool, port_pool = _pools(factory)
    (ref_exp, ref_db), _ = _experiments(ref_tr, tr, ref_pool, faults, tuned=True,
                                        kswapd_batch=200)
    _, (exp, db) = _experiments(ref_tr, tr, port_pool, faults, tuned=True,
                                kswapd_batch=200)
    want = ref_api.run(ref_exp, db=ref_db)
    got = api.run(exp, db=db, device="cpu")
    assert got.backends == want.backends == ("simulate",)
    assert _records(got) == _records(want)


def test_run_first_touch_on_the_device_step_matches_reference(press, microbench):
    """first_touch is a kind of the device sweep in the port; the JAX
    package runs it per size (``backend="simulate"``)."""
    for ref_tr, tr in (press, microbench):
        for faults in (None, HARSH):
            def exp(mod, trace, fs):
                return mod.Experiment(
                    scenarios=[mod.Scenario(trace=trace, name="t", faults=fs)],
                    fm_fracs=(1.0, 0.7, 0.4, 0.1), collect_configs=True,
                    policies=[mod.PolicySpec(kind="first_touch", label="ft")])
            want = ref_api.run(exp(ref_api, ref_tr,
                                   None if faults is None else RefFaultSpec(**faults)))
            got = api.run(exp(api, tr, None if faults is None else FaultSpec(**faults)),
                          device="cpu")
            assert want.backends == ("simulate",)
            assert got.backends == ("torch_sweep",)
            assert _records(got) == _records(want)


def test_run_with_a_runner_matches_reference(press):
    ref_tr, tr = press
    seen = []

    def make_runner(tag):
        def runner(scenario, fm_frac, spec, db):
            seen.append((tag, scenario.resolved_name, fm_frac, spec.name, db))
            return {"total_time": fm_frac * 2.0, "interval_times": [fm_frac, fm_frac],
                    "kind": spec.kind}
        return runner

    def exp(mod, tag):
        return mod.Experiment(
            scenarios=[mod.Scenario(name="r", runner=make_runner(tag))],
            fm_fracs=(1.0, 0.5),
            policies=[mod.PolicySpec(kind="tpp", label="a"),
                      mod.PolicySpec(kind="first_touch", label="b", fm_frac=0.3)])
    want = ref_api.run(exp(ref_api, "ref"), db="DB")
    got = api.run(exp(api, "port"), db="DB", device="cpu")
    assert got.backends == want.backends == ("custom",)
    assert [(r.scenario, r.policy, r.fm_frac, r.result) for r in got.runs] == [
        (r.scenario, r.policy, r.fm_frac, r.result) for r in want.runs]
    assert [s[1:] for s in seen if s[0] == "port"] == [
        s[1:] for s in seen if s[0] == "ref"]
    assert got.total_times().tolist() == want.total_times().tolist()


def test_the_per_size_engine_equals_the_device_sweep(press):
    """A pool_factory scenario and the device step give the same records
    (what chip_smoke.py's phase 12 (f) checks on the card)."""
    _, tr = press

    def exp(pool_factory):
        return api.Experiment(
            scenarios=[api.Scenario(trace=tr, name="p", kswapd_batch=150,
                                    pool_factory=pool_factory)],
            fm_fracs=(1.0, 0.45, 0.2), collect_configs=True,
            policies=[api.PolicySpec(kind=k, label=k) for k in KINDS])
    per_size = api.run(exp(functools.partial(TieredPagePool, hotness_halflife=2.0)),
                       device="cpu")
    sweep = api.run(exp(None), device="cpu")
    assert per_size.backends == ("simulate",) and sweep.backends == ("torch_sweep",)
    assert _records(per_size) == _records(sweep)


def test_first_touch_never_migrates_or_reclaims(press):
    _, tr = press
    res = _simulate(tr, 0.1, policy.FirstTouchPolicy())
    st = res.stats
    assert st["pgpromote_success"] == st["pgdemote_kswapd"] == st["pgdemote_direct"] == 0
    assert st["alloc_slow"] > 0
    with pytest.raises(ValueError, match="not tunable"):
        api.PolicySpec(kind="first_touch", tuner=api.TunerSpec())


def test_host_promotion_filter_matches_reference():
    """The host FaultInjector.filter_promotions against the JAX package's,
    over a pool's trajectory of candidate vectors."""
    from repro.sim.faults import FaultInjector as RefInjector
    from repro_torch.sim.faults import FaultInjector

    spec = dict(seed=3, promote_fail_rate=0.4, max_retries=2, backoff_base=2)
    ref_inj, inj = RefInjector(RefFaultSpec(**spec)), FaultInjector(FaultSpec(**spec))
    ref_pool = ReferencePagePool(num_pages=300, hw_capacity=300)
    pool = TieredPagePool(num_pages=300, hw_capacity=300)
    rng = np.random.default_rng(0)
    for t in range(12):
        ref_inj.begin_interval(ref_pool)
        inj.begin_interval(pool)
        cand = rng.choice(300, size=80, replace=False)
        a, na = ref_inj.filter_promotions(ref_pool, cand)
        b, nb = inj.filter_promotions(pool, cand)
        assert a.tolist() == b.tolist() and na == nb
    assert inj.all_events() == ref_inj.all_events()
    assert pool.stats.pgpromote_fail == ref_pool.stats.pgpromote_fail > 0


def test_bulk_step_matches_the_chunked_loop_on_the_port_pool(press):
    """The port's bulk step and its chunked loop (forced by a pool without
    ``_try_bulk_step``) commit the same schedule."""
    _, tr = press

    class ChunkedPool(TieredPagePool):
        _try_bulk_step = None

    for f in (0.6, 0.25):
        bulk = _simulate(tr, f, policy.TPPPolicy())
        pol = policy.TPPPolicy()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            chunked = _simulate(tr, f, pol, pool_factory=ChunkedPool)
        assert pol.chunked_steps > 0
        assert_sim_equal(bulk, chunked)
