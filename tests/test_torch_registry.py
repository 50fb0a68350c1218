"""The port's policy registry and plug-in routing against the JAX package.

The JAX package's registry cases (``tests/test_api.py``'s
``TestPolicyRegistry``) replayed against ``repro_torch``, on the CPU: a
registered ``TPPPolicy`` subclass that overrides ``_admit`` or
``_note_step`` runs on the per-size engine (``backend="simulate"``),
because the device step replicates only the four built-in kinds, and
gives the JAX package's stats exactly; the device step refuses such a
class; a subclass that overrides nothing stays on the device step.
"""

import functools

import numpy as np
import pytest

from repro.sim import api as ref_api
from repro.sim.engine import _simulate as ref_simulate
from repro.tiering import policy as ref_policy
from repro.tiering.page_pool import TieredPagePool as RefTieredPagePool
from repro_torch.fleet import FleetScenario, TenantSpec
from repro_torch.sim import api
from repro_torch.sim import sweep
from repro_torch.sim.torch_engine import _sweep_run_torch
from repro_torch.sim.costmodel import OPTANE_LIKE
from repro_torch.tiering import policy

from _torch_port import (
    assert_sim_equal,
    decision_dicts,
    event_dicts,
    pressure_trace,
    synthetic_db_pair,
    to_port,
)


def _lukewarm(base, kind_name):
    """The JAX test's LukewarmPolicy on ``base``: promotes only every other
    interval of each pool (stateless across pools)."""

    class LukewarmPolicy(base):
        kind = kind_name

        def __init__(self, hot_thr=4, skip_odd=True):
            super().__init__(hot_thr=hot_thr)
            self.skip_odd = bool(skip_odd)
            self._i = {}

        def _admit(self, pool, cand):
            i = self._i.get(id(pool), 0)
            self._i[id(pool)] = i + 1
            if self.skip_odd and i % 2 == 1:
                return cand[:0], int(cand.size)
            return cand, 0

    return LukewarmPolicy


def _reject_all(base, kind_name):
    class RejectAllPolicy(base):
        kind = kind_name

        def _admit(self, pool, cand):
            return cand[:0], int(cand.size)

    return RejectAllPolicy


def _note_counter(base, kind_name):
    """Overrides only the post-step hook (an observer with per-pool state)."""

    class NoteCounterPolicy(base):
        kind = kind_name

        def __init__(self, hot_thr=4):
            super().__init__(hot_thr=hot_thr)
            self.promoted = {}

        def _note_step(self, pool, admitted, out):
            self.promoted[id(pool)] = self.promoted.get(id(pool), 0) + out.pm_pr

    return NoteCounterPolicy


class PlainTPP(policy.TPPPolicy):
    """A subclass that overrides nothing: the device step runs it as TPP."""

    kind = "port_plain_tpp"


class TPPWithAdmitMargin(policy.TPPPolicy):
    """Carries an ``admit_margin`` attribute but TPP's own hooks: the device
    step must run it as TPP, not as the admission kind."""

    kind = "port_tpp_margin"
    admit_margin = 50.0


class HotSortedOverride(policy.TPPPolicy):
    """Promotes at most one candidate an interval, by the schedule step."""

    kind = "port_hot_sorted"

    def step_hot_sorted(self, pool, cand, assume_unique=False):
        return super().step_hot_sorted(pool, cand[:1], assume_unique)


class OptedOut(policy.TPPPolicy):
    kind = "port_opted_out"
    batchable = False


@pytest.fixture
def registered():
    """Register (port class, JAX class) pairs under their kinds for one
    test; the registries are global, so every kind is removed after."""
    kinds = []

    def add(port_cls, ref_cls=None):
        policy.register_policy(port_cls)
        kinds.append((policy.POLICIES, port_cls.kind))
        if ref_cls is not None:
            ref_policy.register_policy(ref_cls)
            kinds.append((ref_policy.POLICIES, ref_cls.kind))
        return port_cls.kind, (ref_cls.kind if ref_cls is not None else None)

    yield add
    for registry, kind in kinds:
        registry.pop(kind, None)


def _both(port_kind, ref_kind, tr, fracs=(0.5,), params=None, name="plugin",
          db_pair=None, tuner=False, kswapd_batch=None):
    """The same experiment through the port (CPU) and the JAX package."""
    params = params or {}

    def exp(mod, kind, trace):
        spec = mod.PolicySpec(kind=kind, params=params, label="plug")
        if tuner:
            spec = mod.PolicySpec(kind=kind, params=params, label="plug",
                                  tuner=mod.TunerSpec(target_loss=0.05, tune_every=2,
                                                      max_step_frac=0.08))
        return mod.Experiment(name=name, scenarios=[mod.Scenario(
            trace=trace, kswapd_batch=kswapd_batch)], fm_fracs=fracs, policies=[spec],
            collect_configs=True)

    ref_db, port_db = db_pair if db_pair is not None else (None, None)
    port = api.run(exp(api, port_kind, to_port(tr)), db=port_db, device="cpu")
    ref = ref_api.run(exp(ref_api, ref_kind, tr), db=ref_db)
    return port, ref


def _assert_records_equal(port, ref):
    assert len(port.runs) == len(ref.runs)
    for p, r in zip(port.runs, ref.runs):
        assert (p.scenario, p.policy, p.fm_frac) == (r.scenario, r.policy, r.fm_frac)
        assert_sim_equal(p.result, r.result)
        assert decision_dicts(p.decisions) == decision_dicts(r.decisions)
        assert event_dicts(p.watermark_log) == event_dicts(r.watermark_log)


def test_builtin_kinds_register_through_the_decorator():
    assert {k: policy.device_kind(c) for k, c in policy.POLICIES.items()
            if k in ("tpp", "admission", "thrash_guard", "first_touch")} == {
        "tpp": "tpp", "admission": "admission", "thrash_guard": "thrash_guard",
        "first_touch": "first_touch"}
    assert policy.resolve_policy("admission") is policy.AdmissionTPPPolicy
    with pytest.raises(ValueError, match="registered kinds:.*admission.*tpp"):
        policy.resolve_policy("numa")


def test_registry_rejects_duplicates_and_anonymous():
    with pytest.raises(ValueError, match="already registered"):

        @policy.register_policy
        class Impostor(policy.TPPPolicy):
            kind = "tpp"

    with pytest.raises(ValueError, match="kind"):

        @policy.register_policy
        class Nameless(policy.TPPPolicy):
            kind = ""

    # re-registering the same class is a no-op
    assert policy.register_policy(policy.TPPPolicy) is policy.TPPPolicy


@pytest.mark.parametrize("cls,kind", [
    (PlainTPP, "tpp"),
    (TPPWithAdmitMargin, "tpp"),
    (type("Adm2", (policy.AdmissionTPPPolicy,), {"kind": "adm2"}), "admission"),
    (type("Guard2", (policy.ThrashGuardPolicy,), {"kind": "guard2"}), "thrash_guard"),
    (type("Touch2", (policy.FirstTouchPolicy,), {"kind": "touch2"}), "first_touch"),
    (_lukewarm(policy.TPPPolicy, "lw"), None),
    (_reject_all(policy.AdmissionTPPPolicy, "ra"), None),
    (_note_counter(policy.ThrashGuardPolicy, "nc"), None),
    (HotSortedOverride, None),
    (OptedOut, None),
])
def test_device_kind_is_by_function_identity(cls, kind):
    assert policy.device_kind(cls) == kind


def test_third_party_registration_round_trips(registered):
    """The JAX test's LukewarmPolicy: per-size engine on the port, the JAX
    package's stats, params echoed through JSON, and a fresh worker's
    registry refilled from the job's classes."""
    port_cls = _lukewarm(policy.TPPPolicy, "port_lukewarm")
    port_kind, ref_kind = registered(port_cls, _lukewarm(ref_policy.TPPPolicy,
                                                         "xpkg_lukewarm"))
    tr = pressure_trace(40, rss=1_500, n_intervals=6)
    port, ref = _both(port_kind, ref_kind, tr, params={"skip_odd": True},
                      name="third_party")
    assert port.backends == ("simulate",)
    assert ref.backends == ("sweep",)
    _assert_records_equal(port, ref)
    assert sum(c.pm_admit_fail for c in port.result().configs) > 0
    assert port.spec["policies"][0]["params"] == {"skip_odd": True}
    back = api.RunSet.from_json(port.to_json())
    assert back.spec == port.spec
    assert back.result().stats == port.result().stats

    spec = api.PolicySpec(kind=port_kind)
    policy.POLICIES.pop(port_kind)  # a fresh worker's registry
    records, chunked = api._run_scenario(
        api.Scenario(trace=to_port(tr)), (0.5,), (spec,), None, True,
        device="cpu", policy_classes=(port_cls,),
    )
    assert policy.resolve_policy(port_kind) is port_cls
    assert records[0].result.stats == port.result().stats
    assert records[0].backend == "simulate"


@pytest.mark.parametrize("fracs", [(0.5,), (1.0, 0.6, 0.3)])
def test_reject_all_subclass_promotes_nothing(registered, fracs):
    """The fault itself: an ``_admit`` that rejects every candidate promoted
    as much as TPP on the device sweep; now it promotes 0 pages, as the JAX
    package does."""
    port_kind, ref_kind = registered(_reject_all(policy.TPPPolicy, "port_reject_all"),
                                     _reject_all(ref_policy.TPPPolicy, "xpkg_reject_all"))
    tr = pressure_trace(3, rss=2_000, n_intervals=6)
    port, ref = _both(port_kind, ref_kind, tr, fracs=fracs, kswapd_batch=16)
    assert port.backends == ("simulate",)
    _assert_records_equal(port, ref)
    for rec in port.runs:
        assert rec.result.stats["pgpromote_success"] == 0
        if rec.fm_frac < 1.0:  # at full size nothing is slow: no candidate
            assert sum(c.pm_admit_fail for c in rec.result.configs) > 0
    tpp = api.run(api.Experiment(scenarios=[api.Scenario(trace=to_port(tr), kswapd_batch=16)],
                                 fm_fracs=fracs), device="cpu")
    assert tpp.backends == ("torch_sweep",)
    assert any(r.result.stats["pgpromote_success"] > 0 for r in tpp.runs)


@pytest.mark.parametrize("make", [_lukewarm, _reject_all, _note_counter])
def test_device_step_refuses_a_hooking_class(make):
    pol = make(policy.TPPPolicy, "unregistered")()
    tr = to_port(pressure_trace(0, rss=500, n_intervals=2))
    with pytest.raises(ValueError, match="not one the device step replicates"):
        _sweep_run_torch(tr, np.array([0.5]), pol, OPTANE_LIKE, None, 0, False,
                         device="cpu")
    with pytest.raises(ValueError, match="not one the device step replicates"):
        sweep._sweep_fm_fracs(tr, (0.5,), policy=pol, device="cpu")


@pytest.mark.parametrize("cls", [PlainTPP, TPPWithAdmitMargin])
def test_subclass_overriding_nothing_rides_the_device_step(registered, cls):
    kind, _ = registered(cls)
    tr = to_port(pressure_trace(5, rss=2_000, n_intervals=6))

    def exp(k):
        return api.Experiment(scenarios=[api.Scenario(trace=tr, kswapd_batch=16)],
                              fm_fracs=(1.0, 0.5, 0.25),
                              policies=[api.PolicySpec(kind=k, label="p")],
                              collect_configs=True)

    sub = api.run(exp(kind), device="cpu")
    tpp = api.run(exp("tpp"), device="cpu")
    assert sub.backends == tpp.backends == ("torch_sweep",)
    for a, b in zip(sub.runs, tpp.runs):
        assert_sim_equal(a.result, b.result)


def test_opted_out_subclass_runs_per_size_like_tpp(registered):
    kind, _ = registered(OptedOut)
    ref_tr = pressure_trace(6, rss=1_500, n_intervals=5)
    rs = api.run(api.Experiment(scenarios=[api.Scenario(trace=to_port(ref_tr))],
                                fm_fracs=(0.4,), policies=[api.PolicySpec(kind=kind)],
                                collect_configs=True), device="cpu")
    assert rs.backends == ("simulate",)
    want = ref_simulate(ref_tr, fm_frac=0.4, policy=ref_policy.TPPPolicy())
    assert_sim_equal(rs.result(), want)


def test_note_step_hook_on_the_tuned_path_equals_reference(registered):
    """A ``_note_step``-only plug-in with a tuner in the loop: per-size
    engine with the tuner on the port, the JAX package's tuned sweep, the
    same decisions and watermark log."""
    port_kind, ref_kind = registered(_note_counter(policy.TPPPolicy, "port_note"),
                                     _note_counter(ref_policy.TPPPolicy, "xpkg_note"))
    tr = pressure_trace(7, rss=2_000, n_intervals=12)
    port, ref = _both(port_kind, ref_kind, tr, fracs=(1.0,), tuner=True,
                      db_pair=synthetic_db_pair())
    assert port.backends == ("simulate",)
    assert ref.backends == ("tuned_sweep",)
    _assert_records_equal(port, ref)
    assert port.record().decisions


def test_mixed_specs_route_per_spec(registered):
    """One experiment, a plug-in beside built-ins: each spec on its own
    backend, records in spec order, each equal to its own run."""
    port_kind, ref_kind = registered(_lukewarm(policy.TPPPolicy, "port_mixed"),
                                     _lukewarm(ref_policy.TPPPolicy, "xpkg_mixed"))
    tr = pressure_trace(8, rss=1_500, n_intervals=5)

    def exp(mod, kind, trace):
        return mod.Experiment(scenarios=[mod.Scenario(trace=trace)], fm_fracs=(0.6, 0.3),
                              policies=[mod.PolicySpec(label="tpp"),
                                        mod.PolicySpec(kind=kind, label="plug"),
                                        mod.PolicySpec(kind="admission", label="adm")],
                              collect_configs=True)

    port = api.run(exp(api, port_kind, to_port(tr)), device="cpu")
    ref = ref_api.run(exp(ref_api, ref_kind, tr))
    assert [r.backend for r in port.runs] == ["torch_sweep"] * 2 + ["simulate"] * 2 + [
        "torch_sweep"] * 2
    assert port.backends == ("simulate", "torch_sweep")
    _assert_records_equal(port, ref)


@pytest.mark.parametrize("kind,cls,params", [
    ("admission", ref_policy.AdmissionTPPPolicy, {"admit_margin": 1.5}),
    ("thrash_guard", ref_policy.ThrashGuardPolicy, {"reuse_window": 3}),
])
def test_new_kinds_ride_the_sweep(kind, cls, params):
    tr = pressure_trace(1, rss=2_000, n_intervals=8)
    rs = api.run(api.Experiment(
        scenarios=[api.Scenario(trace=to_port(tr), kswapd_batch=16)],
        fm_fracs=(0.6, 0.25), policies=[api.PolicySpec(kind=kind, params=params)],
        collect_configs=True), device="cpu")
    assert rs.backends == ("torch_sweep",)
    assert rs.chunked_step_count == 0
    for f in (0.6, 0.25):
        want = ref_simulate(tr, fm_frac=f, policy=cls(**params),
                            pool_factory=functools.partial(RefTieredPagePool,
                                                           kswapd_batch=16))
        assert_sim_equal(rs.record(fm_frac=f).result, want)


def test_params_reach_the_constructor_and_labels_differ():
    spec = api.PolicySpec(kind="admission", params={"admit_margin": 3.5})
    pol = spec.build_policy()
    assert isinstance(pol, policy.AdmissionTPPPolicy)
    assert pol.admit_margin == 3.5
    assert api.PolicySpec(kind="tpp").build_policy().hot_thr == 4
    a = api.PolicySpec(kind="admission", params={"admit_margin": 1.5})
    b = api.PolicySpec(kind="admission", params={"admit_margin": 3.0})
    assert a.name != b.name
    rs = api.run(api.Experiment(scenarios=[api.Scenario(
        trace=to_port(pressure_trace(42, rss=800, n_intervals=4)))],
        fm_fracs=(0.4,), policies=[a, b]), device="cpu")
    assert [r.policy for r in rs.runs] == [a.name, b.name]
    with pytest.raises(ValueError, match="tunable=False"):
        api.PolicySpec(kind="first_touch", tuner=api.TunerSpec())
    with pytest.raises(ValueError, match="admit_margn.*accepts.*admit_margin"):
        api.PolicySpec(kind="admission", params={"admit_margn": 2.0})


def test_admit_fail_flows_into_config_vectors():
    tr = to_port(pressure_trace(2, rss=2_000, n_intervals=8))
    rs = api.run(api.Experiment(
        scenarios=[api.Scenario(trace=tr, kswapd_batch=16)], fm_fracs=(0.3,),
        policies=[api.PolicySpec(label="tpp"),
                  api.PolicySpec(kind="admission", label="admission")],
        collect_configs=True), device="cpu")
    assert sum(c.pm_admit_fail for c in rs.result(policy="admission").configs) > 0
    assert all(c.pm_admit_fail == 0.0 for c in rs.result(policy="tpp").configs)


def test_fleet_refuses_a_policy_the_device_step_does_not_replicate(registered):
    kind, _ = registered(_reject_all(policy.TPPPolicy, "port_fleet_reject"))
    tr = to_port(pressure_trace(0, rss=500, n_intervals=2))
    fleet = FleetScenario(tenants=[TenantSpec(trace=tr, name="a")], name="f")
    with pytest.raises(ValueError, match="not kinds it replicates"):
        api.run(api.Experiment(scenarios=[fleet], policies=[api.PolicySpec(kind=kind)]),
                device="cpu")
