"""The port's device sweep step on the CPU == the JAX package's numpy sweep
== its frozen ``ReferencePagePool``, bit for bit.

The five regimes the JAX lane was held to (thrash pressure, starved
kswapd, watermarks near capacity, the admission backend, a tuned shrink),
now run through ``repro_torch.sim.sweep`` with ``device="cpu"``: counters,
interval times, ConfigVectors, costs, fm sizes, tuner decisions and
watermark logs are compared exactly (tolerance 0: every quantity is an
integer or float64 host arithmetic on identical integers).
"""

import functools

import numpy as np
import pytest

from repro.core.tuner import TunaTuner, TunerConfig
from repro.core.watermark import WatermarkController
from repro.sim.engine import simulate
from repro.sim.sweep import TunedSlice as RefTunedSlice
from repro.sim.sweep import _sweep_fm_fracs as ref_sweep_fm_fracs
from repro.sim.sweep import _sweep_tuned as ref_sweep_tuned
from repro.tiering import policy as ref_policy
from repro.tiering.reference_pool import ReferencePagePool
from repro_torch.core.tuner import TunaTuner as PortTunaTuner
from repro_torch.core.tuner import TunerConfig as PortTunerConfig
from repro_torch.core.watermark import WatermarkController as PortController
from repro_torch.kernels.victim_partition import victim_partition
from repro_torch.sim import sweep as port_sweep
from repro_torch.sim import torch_engine
from repro_torch.sim.faults import FaultInjector, FaultSpec
from repro_torch.sim.torch_engine import _require_torch_runnable
from repro_torch.tiering import policy as port_policy

from _torch_port import (
    assert_sim_equal,
    decision_dicts,
    event_dicts,
    plain,
    pressure_trace,
    synthetic_db_pair,
    to_port,
)

# (trace seed, rss, intervals, fm fractions, hw capacity, kswapd batch,
#  admission margin) — the regimes of the JAX lane's equivalence tests
REGIMES = {
    "thrash_pressure_0": (0, 3_000, 8, [0.8, 0.45, 0.25, 0.1], None, None, None),
    "thrash_pressure_2": (2, 3_000, 8, [0.8, 0.45, 0.25, 0.1], None, None, None),
    "kswapd_starved_1": (7, 3_000, 6, [0.6, 0.3, 0.12], None, 1, None),
    "kswapd_starved_96": (7, 3_000, 6, [0.6, 0.3, 0.12], None, 96, None),
    "near_capacity": (11, 4_000, 8, [1.0, 0.97, 0.55, 0.2], 2_000, 32, None),
    "admission": (3, 3_000, 6, [0.6, 0.25], None, None, 0.5),
}


def _policies(margin):
    if margin is None:
        return ref_policy.TPPPolicy(hot_thr=4), port_policy.TPPPolicy(hot_thr=4)
    return (
        ref_policy.AdmissionTPPPolicy(hot_thr=4, admit_margin=margin),
        port_policy.AdmissionTPPPolicy(hot_thr=4, admit_margin=margin),
    )


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_sweep_three_lanes(regime):
    seed, rss, n, fracs, cap, kswapd, margin = REGIMES[regime]
    tr = pressure_trace(seed, rss=rss, n_intervals=n)
    fracs = np.asarray(fracs, dtype=np.float64)
    ref_pol, port_pol = _policies(margin)
    port = port_sweep._sweep_fm_fracs(
        to_port(tr), fracs, hw_capacity_pages=cap, kswapd_batch=kswapd,
        collect_configs=True, policy=port_pol, device="cpu",
    )
    assert port_pol.chunked_steps == 0
    base = ref_sweep_fm_fracs(
        tr, fracs, hw_capacity_pages=cap, kswapd_batch=kswapd,
        collect_configs=True, policy=ref_pol, engine="numpy",
    )
    for i, f in enumerate(fracs):
        assert port.stats[i] == base.stats[i], f
        assert np.array_equal(port.interval_times[i], base.interval_times[i]), f
        assert plain(port.configs[i]) == plain(base.configs[i]), f
        assert plain(port.costs[i]) == plain(base.costs[i]), f
        ref = simulate(
            tr, fm_frac=float(f), hw_capacity_pages=cap,
            policy=_policies(margin)[0],
            pool_factory=functools.partial(ReferencePagePool, kswapd_batch=kswapd),
        )
        assert port.stats[i] == ref.stats, f
        assert np.array_equal(port.interval_times[i], ref.interval_times), f
        assert plain(port.configs[i]) == plain(ref.configs), f


def test_sweep_reaches_the_thrash_regime(monkeypatch):
    """The pressure traces drive reclaim demand into the same step's
    promotions, so the host thrash resolver runs (the three-lane tests
    cover its results)."""
    calls = []
    real = torch_engine._resolve_step_victims
    monkeypatch.setattr(
        torch_engine, "_resolve_step_victims",
        lambda *a: calls.append(1) or real(*a),
    )
    tr = to_port(pressure_trace(0, rss=3_000, n_intervals=8))
    res = port_sweep._sweep_fm_fracs(tr, [0.25], device="cpu")
    assert res.stats[0]["pgdemote_kswapd"] + res.stats[0]["pgdemote_direct"] > 0
    assert calls


def test_tuned_shrink_three_lanes():
    tr = pressure_trace(5, rss=4_000, n_intervals=12)
    ref_db, port_db = synthetic_db_pair()
    specs = [(0.25, 2), (None, None)]

    def ref_tuners():
        return [
            TunaTuner(ref_db, WatermarkController(max_step_frac=0.3),
                      TunerConfig(target_loss=tau, cooldown_windows=3))
            if tau else None
            for tau, _ in specs
        ]

    port_tuners = [
        PortTunaTuner(port_db, PortController(max_step_frac=0.3),
                      PortTunerConfig(target_loss=tau, cooldown_windows=3))
        if tau else None
        for tau, _ in specs
    ]
    pol = port_policy.TPPPolicy(hot_thr=4)
    port = port_sweep._sweep_tuned(
        to_port(tr),
        [port_sweep.TunedSlice(0.9, t, te) for t, (_, te) in zip(port_tuners, specs)],
        policy=pol, device="cpu",
    )
    assert pol.chunked_steps == 0
    sweep_tuners = ref_tuners()
    base = ref_sweep_tuned(
        tr, [RefTunedSlice(0.9, t, te) for t, (_, te) in zip(sweep_tuners, specs)],
        policy=ref_policy.TPPPolicy(hot_thr=4), engine="numpy",
    )
    sim_tuners = ref_tuners()
    refs = [
        simulate(tr, fm_frac=0.9, tuner=t, tune_every=te,
                 pool_factory=ReferencePagePool)
        for t, (_, te) in zip(sim_tuners, specs)
    ]
    moved = 0
    for i in range(len(specs)):
        mine = port_tuners[i]
        for other, theirs in ((base[i], sweep_tuners[i]), (refs[i], sim_tuners[i])):
            assert_sim_equal(port[i], other)
            assert (mine is None) == (theirs is None)
            if mine is not None:
                assert decision_dicts(mine.decisions) == decision_dicts(theirs.decisions)
                assert event_dicts(mine.controller.log) == event_dicts(theirs.controller.log)
        if mine is not None:
            moved += len(mine.controller.log)
    assert moved > 0  # the tuner must actually shrink the fast tier


def test_cpu_lane_never_counts_kernel_launches():
    before = victim_partition.launches
    tr = to_port(pressure_trace(0, rss=1_000, n_intervals=3))
    port_sweep._sweep_fm_fracs(tr, [0.3], device="cpu")
    assert victim_partition.launches == before


def test_eligibility_refuses_duplicates_and_faults():
    # faults run since the fault model's slice; what is refused is a faults
    # argument that is not a FaultInjector, or one the policy does not share
    tr = to_port(pressure_trace(0, rss=1_000, n_intervals=2))
    pol = port_policy.TPPPolicy()
    with pytest.raises(TypeError, match="FaultInjector"):
        _require_torch_runnable(tr, pol, faults=object())
    inj = FaultInjector(FaultSpec(promote_fail_rate=0.1))
    _require_torch_runnable(tr, pol, faults=inj)
    pol.fault_injector = FaultInjector(FaultSpec(promote_fail_rate=0.1))
    with pytest.raises(ValueError, match="fault_injector"):
        _require_torch_runnable(tr, pol, faults=inj)
    pol.fault_injector = inj
    _require_torch_runnable(tr, pol, faults=inj)
    pol.fault_injector = None
    ia = tr.intervals[0]
    ia.pages = np.concatenate([ia.pages, ia.pages[:1]])
    ia.counts = np.concatenate([ia.counts, ia.counts[:1]])
    ia.touches = ia.counts
    with pytest.raises(ValueError, match="unique page ids"):
        _require_torch_runnable(tr, pol, faults=None)
