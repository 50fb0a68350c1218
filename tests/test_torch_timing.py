"""The port's timing engine (``repro_torch.timing``) against the JAX
package's ``repro.timing``, on the CPU.

The 18 cases of ``tests/test_timing.py`` run against the port, each also
holding the port's result equal to the JAX package's on the same inputs
(bit for bit: the event streams are built in torch with the JAX package's
float operations, and the replay is ``replay_ref``, the numpy loop line by
line). The pinned ``tests/data/timing_golden.json`` is matched exactly.
Besides them: ``replay_ref`` and ``AddressTimingEngine.replay_interval``
against the JAX engine on seeded intervals, a page twice in one window and
one-event windows among them.
"""

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.sim.api import Experiment as RefExperiment
from repro.sim.api import PolicySpec as RefPolicySpec
from repro.sim.api import Scenario as RefScenario
from repro.sim.api import run as ref_run
from repro.sim.costmodel import OPTANE_LIKE as REF_OPTANE
from repro.sim.workloads import WORKLOADS as REF_WORKLOADS
from repro.timing import AddressTimingEngine as RefEngine
from repro.timing import TimingParams as RefParams
from repro.timing import calibrate as ref_calibrate
from repro.timing import timing_runner as ref_timing_runner
from repro_torch.kernels.timing_replay import (
    chain_bound_ms,
    chain_latency_ns,
    chain_ms_with_loads,
    replay_ref,
    timing_replay,
)
from repro_torch.sim import api
from repro_torch.sim.costmodel import OPTANE_LIKE
from repro_torch.sim.workloads import WORKLOADS
from repro_torch.timing import (
    AddressTimingEngine,
    TimingParams,
    calibrate,
    timing_runner,
)

GOLDEN = Path(__file__).parent / "data" / "timing_golden.json"
runner = functools.partial(timing_runner, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run thousands of tiny torch ops (the replay's windows):
    one intra-op thread, since idle pool threads only spin beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(seed=0, max_events=20_000, **hw):
    """(port engine, JAX engine) over the same profile overrides."""
    port = AddressTimingEngine(TimingParams.from_profile(
        dataclasses.replace(OPTANE_LIKE, **hw), max_events=max_events),
        seed=seed, device="cpu")
    ref = RefEngine(RefParams.from_profile(
        dataclasses.replace(REF_OPTANE, **hw), max_events=max_events), seed=seed)
    return port, ref


def _replay(engines, counts, tiers, **kw):
    """Replay on both engines; the two TimedIntervals must be equal. Returns
    the port's."""
    counts = np.asarray(counts, dtype=np.int64)
    kw.setdefault("pages", np.arange(counts.size, dtype=np.int64))
    kw.setdefault("ops", 0.0)
    index = kw.pop("index", 0)
    tiers = np.asarray(tiers, dtype=np.int8)
    port, ref = engines
    got = port.replay_interval(index=index, counts=counts, tiers=tiers, **kw)
    want = ref.replay_interval(index=index, counts=counts, tiers=tiers, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    return got


def _thrash_factory():
    return functools.partial(WORKLOADS["thrash"], n_intervals=8, rss_pages=4_000)


def _ref_thrash_factory():
    return functools.partial(REF_WORKLOADS["thrash"], n_intervals=8, rss_pages=4_000)


class TestEngineProperties:
    def test_access_conservation(self):
        eng = _engines(llc_pages=0)
        rng = np.random.default_rng(3)
        counts = rng.integers(1, 200, size=500)
        tiers = rng.integers(0, 2, size=500)
        ti = _replay(eng, counts, tiers, rand_frac=0.7)
        ab = OPTANE_LIKE.access_bytes
        assert ti.bytes_fast + ti.bytes_slow == counts.sum() * ab
        assert ti.bytes_fast == counts[tiers == 0].sum() * ab

    def test_llc_absorption_only_removes_traffic(self):
        counts = np.full(2000, 300, dtype=np.int64)
        tiers = np.zeros(2000, dtype=np.int8)
        a = _replay(_engines(llc_pages=0), counts, tiers)
        b = _replay(_engines(), counts, tiers)
        assert b.bytes_fast < a.bytes_fast
        assert b.t_app < a.t_app

    def test_monotone_in_lat_slow(self):
        rng = np.random.default_rng(5)
        counts = rng.integers(1, 50, size=800)
        tiers = rng.integers(0, 2, size=800)
        base = _replay(_engines(), counts, tiers).total
        worse = _engines(lat_slow=OPTANE_LIKE.lat_slow * 4,
                         lat_slow_write=OPTANE_LIKE.lat_slow_write * 4)
        assert _replay(worse, counts, tiers).total >= base

    def test_monotone_in_bw_slow(self):
        rng = np.random.default_rng(6)
        counts = rng.integers(1, 50, size=800)
        tiers = rng.integers(0, 2, size=800)
        base = _replay(_engines(), counts, tiers, rand_frac=0.2).total
        worse = _engines(bw_slow=OPTANE_LIKE.bw_slow / 4,
                         bw_slow_write=OPTANE_LIKE.bw_slow_write / 4)
        assert _replay(worse, counts, tiers, rand_frac=0.2).total >= base

    def test_all_fast_not_slower_than_all_slow(self):
        rng = np.random.default_rng(7)
        counts = rng.integers(1, 80, size=600)
        eng = _engines()
        fast = _replay(eng, counts, np.zeros(600, np.int8)).total
        slow = _replay(eng, counts, np.ones(600, np.int8)).total
        assert fast <= slow

    def test_writes_cost_more_on_the_slow_tier(self):
        counts = np.full(400, 40, dtype=np.int64)
        tiers = np.ones(400, dtype=np.int8)
        eng = _engines()
        rd = _replay(eng, counts, tiers).total
        wr = _replay(eng, counts, tiers, writes=counts.copy()).total
        assert wr > rd

    def test_seeded_determinism(self):
        rng = np.random.default_rng(8)
        counts = rng.integers(1, 60, size=700)
        tiers = rng.integers(0, 2, size=700)
        a = _replay(_engines(seed=42), counts, tiers, index=3)
        b = _replay(_engines(seed=42), counts, tiers, index=3)
        assert a == b
        c = _replay(_engines(seed=43), counts, tiers, index=3)
        assert c.bytes_fast == a.bytes_fast

    @settings(max_examples=25, deadline=None)
    @given(
        st.integers(min_value=1, max_value=400),
        st.integers(min_value=0, max_value=2**31 - 1),
        st.floats(min_value=0.0, max_value=1.0),
    )
    def test_property_conservation_and_dominance(self, n, seed, rand_frac):
        eng = _engines(llc_pages=0, max_events=2_000)
        rng = np.random.default_rng(seed)
        counts = rng.integers(1, 300, size=n)
        writes = rng.integers(0, counts + 1)
        fast = _replay(eng, counts, np.zeros(n, np.int8), rand_frac=rand_frac,
                       writes=writes)
        slow = _replay(eng, counts, np.ones(n, np.int8), rand_frac=rand_frac,
                       writes=writes)
        ab = OPTANE_LIKE.access_bytes
        assert fast.bytes_fast == counts.sum() * ab
        assert slow.bytes_slow == counts.sum() * ab
        assert fast.total <= slow.total
        assert fast.total > 0.0


class TestCalibration:
    def test_calibration_is_deterministic_and_tight(self):
        a = calibrate(OPTANE_LIKE, device="cpu")
        b = calibrate(OPTANE_LIKE, device="cpu")
        assert a == b
        assert a.to_dict() == ref_calibrate(REF_OPTANE).to_dict()
        for s in (a.lat_scale_fast, a.lat_scale_slow,
                  a.bw_scale_fast, a.bw_scale_slow):
            assert 0.5 < s < 2.0
        assert all(r <= 0.15 for r in a.residuals.values())

    def test_calibration_roundtrip(self):
        a = calibrate(OPTANE_LIKE, device="cpu")
        b = type(a).from_dict(json.loads(json.dumps(a.to_dict())))
        assert b.lat_scale_slow == a.lat_scale_slow
        assert b.residuals == a.residuals


@pytest.fixture(scope="module")
def payload():
    return runner(api.Scenario(trace=_thrash_factory(), seed=0), 0.5,
                  api.PolicySpec(kind="tpp"), None)


@pytest.fixture(scope="module")
def ref_payload():
    return ref_timing_runner(RefScenario(trace=_ref_thrash_factory(), seed=0), 0.5,
                             RefPolicySpec(kind="tpp"), None)


class TestRunner:
    def test_payload_shape(self, payload, ref_payload):
        assert payload == ref_payload
        assert payload["protocol"] == "interval-times/v1"
        assert payload["total_time"] == pytest.approx(sum(payload["interval_times"]))
        assert len(payload["interval_times"]) == len(payload["intervals"])
        json.dumps(payload)

    def test_schedule_parity_with_interval_engine(self, payload):
        rs = api.run(api.Experiment(
            scenarios=[api.Scenario(trace=_thrash_factory(), seed=0)],
            fm_fracs=(0.5,), policies=[api.PolicySpec(kind="tpp")],
        ), device="cpu")
        stats = rs.record().result.stats
        assert payload["stats"] == stats
        assert payload["migrations"]["promoted"] == payload["translation"]["promoted"]
        assert 0 < payload["migrations"]["promoted"] <= stats["pgpromote_success"]

    def test_runner_rejects_tuners_and_faults(self):
        from repro_torch.sim.faults import FaultSpec

        sc = api.Scenario(trace=_thrash_factory(), seed=0)
        with pytest.raises(ValueError, match="untuned"):
            runner(sc, 0.5, api.PolicySpec(kind="tpp", tuner=api.TunerSpec()), None)
        faulty = api.Scenario(trace=_thrash_factory(), seed=0,
                              faults=FaultSpec(seed=1, promote_fail_rate=0.1))
        with pytest.raises(ValueError, match="fault"):
            runner(faulty, 0.5, api.PolicySpec(kind="tpp"), None)

    def test_determinism_across_runs(self):
        # the JAX package checks its process fan-out here; the port has none
        # yet, so two serial runs must match each other and the reference
        exp = dict(fm_fracs=(0.6,))
        scen = [api.Scenario(trace=_thrash_factory(), name=f"t{i}", seed=0,
                             runner=runner) for i in range(2)]
        a = api.run(api.Experiment(scenarios=scen, **exp), device="cpu")
        b = api.run(api.Experiment(scenarios=scen, **exp), device="cpu")
        ref = ref_run(RefExperiment(
            scenarios=[RefScenario(trace=_ref_thrash_factory(), name="t0", seed=0,
                                   runner=ref_timing_runner)], **exp))
        want = ref.record(scenario="t0").result["interval_times"]
        for i in range(2):
            got = a.record(scenario=f"t{i}").result["interval_times"]
            assert got == b.record(scenario=f"t{i}").result["interval_times"] == want


class TestPayloadProtocol:
    def test_total_times_accepts_timing_payloads(self):
        rs = api.run(api.Experiment(
            scenarios=[api.Scenario(trace=_thrash_factory(), seed=0, runner=runner)],
            fm_fracs=(1.0, 0.5), policies=[api.PolicySpec(kind="tpp")],
        ), device="cpu")
        times = rs.total_times()
        assert rs.backends == ("custom",)
        assert times.shape == (2,)
        assert np.all(times > 0)
        assert times[1] >= times[0]
        ref = ref_run(RefExperiment(
            scenarios=[RefScenario(trace=_ref_thrash_factory(), seed=0,
                                   runner=ref_timing_runner)],
            fm_fracs=(1.0, 0.5), policies=[RefPolicySpec(kind="tpp")]))
        assert times.tolist() == ref.total_times().tolist()

    def test_total_times_interval_sum_fallback(self):
        def fixed(scenario, f, spec, db):
            return {"interval_times": [1.0, 2.0, 3.5]}

        rs = api.run(api.Experiment(
            scenarios=[api.Scenario(trace=_thrash_factory(), runner=fixed)],
            fm_fracs=(0.5,)), device="cpu")
        assert rs.total_times() == pytest.approx([6.5])

    def test_total_times_still_rejects_undeclared_payloads(self):
        def knob(scenario, f, spec, db):
            return {"knob": 7}

        rs = api.run(api.Experiment(
            scenarios=[api.Scenario(trace=_thrash_factory(), runner=knob)],
            fm_fracs=(0.5,)), device="cpu")
        with pytest.raises(TypeError, match="backend='custom'"):
            rs.total_times()


class TestGolden:
    def test_small_trace_golden(self, payload):
        """The pinned replay of a small thrash trace, matched exactly."""
        want = json.loads(GOLDEN.read_text())
        assert payload["migrations"] == want["migrations"]
        assert payload["translation"] == want["translation"]
        assert payload["interval_times"] == want["interval_times"]


# ---------------------------------------------------------- the replay itself
def _ref_streams(ref, index, counts, tiers, writes=None, rand_frac=1.0):
    counts = np.asarray(counts, dtype=np.int64)
    writes = np.zeros_like(counts) if writes is None else np.asarray(writes, np.int64)
    return ref._build_events(index, counts, np.asarray(tiers, np.int8), writes, rand_frac)


@pytest.mark.parametrize("case", ["random", "one_page", "dup_in_window", "w1", "writes"])
def test_replay_ref_and_streams_match_reference(case):
    rng = np.random.default_rng(21)
    threads, window, n = 4, None, 400
    counts = rng.integers(1, 60, size=n)
    tiers = rng.integers(0, 2, size=n)
    writes = None
    if case == "one_page":
        counts, tiers = np.array([9_000]), np.array([1])
    elif case == "dup_in_window":
        # three hot pages: each window holds several events of one page
        counts, tiers, threads = np.array([4_000, 3_000, 5]), np.array([0, 1, 1]), 8
    elif case == "w1":
        window, threads = 1.0, 1
    elif case == "writes":
        writes = rng.integers(0, counts + 1)
    port, ref = _engines(seed=5, max_events=3_000)
    if window is not None:
        port.params = dataclasses.replace(port.params, window=window)
        ref.params = dataclasses.replace(ref.params, window=window)
    ev = _ref_streams(ref, 2, counts, tiers, writes, rand_frac=0.8)
    mine = port._build_events(2, np.asarray(counts, np.int64), np.asarray(tiers, np.int8),
                              np.zeros(len(counts), np.int64) if writes is None
                              else np.asarray(writes, np.int64), 0.8)
    assert mine.page.tolist() == ev["page"].tolist()
    assert mine.tier.tolist() == ev["tier"].tolist()
    assert mine.occ.tolist() == ev["occ"].tolist()
    assert mine.lat.tolist() == ev["lat"].tolist()
    assert mine.scale == ev["scale"]
    w = max(1, int(round(ref.params.window * threads / ev["scale"])))
    if case == "w1":
        assert w == 1
    if case == "dup_in_window":
        first = ev["page"][:w]
        assert np.unique(first).size < first.size
    chan = np.array(ref.params.migration_channel_seconds(30, 12))
    want = ref._replay(ev, chan, threads)
    got = replay_ref(mine.page, mine.tier, mine.occ, mine.lat, w,
                     torch.tensor(chan), mine.n_pages)
    assert got == want
    # the batched CPU path of the wrapper: two replays and an empty one
    off = torch.tensor([0, mine.page.numel(), mine.page.numel(), 2 * mine.page.numel()])
    t_app = timing_replay(
        torch.cat([mine.page, mine.page]), torch.cat([mine.tier, mine.tier]),
        torch.cat([mine.occ, mine.occ]), torch.cat([mine.lat, mine.lat]), off,
        torch.tensor([w, w, w]), torch.tensor(np.array([chan, [1e-6, 2e-6], chan])),
        torch.tensor([mine.n_pages] * 3))
    assert t_app.tolist() == [want, 2e-6, want]
    assert timing_replay.launches == 0  # the CPU path launches nothing


@pytest.mark.parametrize("index", [0, 5])
def test_replay_interval_matches_reference_on_trace_intervals(index):
    """A thrash interval with its migrations preloading the channels."""
    ref_tr = REF_WORKLOADS["thrash"](n_intervals=8, rss_pages=4_000)
    ia = list(ref_tr)[index]
    rng = np.random.default_rng(index)
    tiers = rng.integers(0, 2, size=ia.pages.size)
    eng = _engines(seed=9)
    _replay(eng, ia.counts, tiers, pages=ia.pages, ops=ia.ops, index=index,
            num_threads=ref_tr.num_threads, rand_frac=ia.rand_frac,
            writes=ia.writes, pm_pr=100, pm_de=80, pm_fail=3, direct_reclaimed=7)


def test_batched_entry_equals_one_by_one():
    port, _ = _engines(seed=2)
    rng = np.random.default_rng(4)
    jobs = [dict(index=i, pages=np.arange(50), counts=rng.integers(0, 30, size=50) * (i != 1),
                 tiers=rng.integers(0, 2, size=50), ops=1e4, num_threads=2)
            for i in range(4)]
    batched = port.replay_intervals(jobs)
    assert batched[1].events == 0 and batched[1].t_app == 0.0
    assert batched == [port.replay_interval(**j) for j in jobs]


def test_timing_runner_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing_runner(api.Scenario(trace=_thrash_factory()), 0.5,
                      api.PolicySpec(kind="tpp"), None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate(OPTANE_LIKE)


def test_timing_replay_refuses_mismatched_arguments():
    page = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be a contiguous"):
        timing_replay(page, torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.float64),
                      torch.zeros(4, dtype=torch.float64), torch.tensor([0, 4]),
                      torch.tensor([1]), torch.zeros(1, 2, dtype=torch.float64),
                      torch.tensor([1]))
    with pytest.raises(ValueError, match="same R replays"):
        timing_replay(page, torch.zeros(4, dtype=torch.int8), torch.zeros(4, dtype=torch.float64),
                      torch.zeros(4, dtype=torch.float64), torch.tensor([0, 4]),
                      torch.tensor([1, 1]), torch.zeros(1, 2, dtype=torch.float64),
                      torch.tensor([1]))


def _two_replays():
    """Two replays of 3 and 2 events over 4 and 2 pages, as flat arguments."""
    return [torch.tensor([0, 3, 1, 1, 0], dtype=torch.int32),
            torch.tensor([0, 1, 1, 0, 1], dtype=torch.int8),
            torch.full((5,), 1e-6, dtype=torch.float64),
            torch.full((5,), 2e-6, dtype=torch.float64),
            torch.tensor([0, 3, 5]), torch.tensor([2, 1]),
            torch.zeros(2, 2, dtype=torch.float64), torch.tensor([4, 2])]


@pytest.mark.parametrize("fault", ["offset_start", "offset_end", "offset_falls",
                                   "page_above", "page_negative"])
def test_timing_replay_refuses_bad_offsets_and_pages(fault):
    """The kernels index by page and event unchecked, so the wrapper
    refuses offsets that do not partition the events and pages outside
    their replay's ``n_pages``, on either device, before any launch."""
    args = _two_replays()
    assert timing_replay(*args).tolist() == [
        replay_ref(args[0][:3], args[1][:3], args[2][:3], args[3][:3], 2, args[6][0], 4),
        replay_ref(args[0][3:], args[1][3:], args[2][3:], args[3][3:], 1, args[6][1], 2)]
    if fault == "offset_start":
        args[4] = torch.tensor([1, 3, 5])
    elif fault == "offset_end":
        args[4] = torch.tensor([0, 3, 4])
    elif fault == "offset_falls":
        args[4] = torch.tensor([0, 6, 5])
    elif fault == "page_above":
        args[0][4] = 2  # replay 1 has 2 pages
    else:
        args[0][1] = -1
    with pytest.raises(ValueError, match="n_pages"):
        timing_replay(*args)


LINKS = {"load_ns": 100.0, "f64_add_ns": 4.0, "window_chain_ns": 20.0, "shfl_step_ns": 7.0}


@pytest.mark.parametrize("ev_off, w_slots, bound_ns, with_loads_ns", [
    # replay 0: 3 windows of 3 (t - dm and 2 shuffle steps each) and one of
    # 1, 10 events; replay 1: none; replay 2: 7 one-event windows
    ([0, 10, 10, 17], [3, 2, 1], 7 * 20.0, 7 * 100.0 + 7 * 4.0),
    ([0, 10], [3], 3 * (20.0 + 4.0 + 2 * 7.0) + 20.0, 4 * 100.0 + 10 * 4.0),
    # windows of 80 and their last 20: 5 shuffle steps each (32 lanes)
    ([0, 180], [80], 3 * (20.0 + 4.0 + 5 * 7.0), 3 * 100.0 + 180 * 4.0),
    # two windows of 32, of 33 and of 31 (5 shuffle steps each), three of
    # 2 (one step each), one of 17 (5)
    ([0, 64, 130, 192, 198, 215], [32, 33, 31, 2, 17],
     2 * (20.0 + 4.0 + 5 * 7.0), 2 * 100.0 + 66 * 4.0),
    ([0, 6], [2], 3 * (20.0 + 4.0 + 7.0), 3 * 100.0 + 6 * 4.0),
    ([0, 0], [5], 0.0, 0.0),
])
def test_chain_bound_counts_windows_and_events(ev_off, w_slots, bound_ns, with_loads_ns):
    """The serial-chain bound of a launch: the longest replay's windows,
    each one window chain, a wider one also its t - dm and ceil(log2(lanes))
    shuffle steps; beside it
    the old load-based chain, windows x the dependent load + events x the
    dependent float64 add."""
    ev_off, w_slots = torch.tensor(ev_off), torch.tensor(w_slots)
    assert chain_bound_ms(ev_off, w_slots, LINKS) == pytest.approx(bound_ns / 1e6, rel=1e-12)
    assert chain_ms_with_loads(ev_off, w_slots, LINKS) == pytest.approx(
        with_loads_ns / 1e6, rel=1e-12)


def test_chain_latency_needs_the_card():
    with pytest.raises(ValueError, match="measures the card"):
        chain_latency_ns(100, "cpu")
