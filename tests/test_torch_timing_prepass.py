"""The replay's decomposition on the CPU: the pre-pass's plain versions
(``writer_index_ref``, ``window_prefix_ref``) against brute-force numpy
scans, and a plain walker over their outputs (this file's, the walker of
``csrc/timing_replay.cu`` event by event) against the JAX package's
``AddressTimingEngine._replay`` bit for bit.

Seeded streams with windows of 1, 2, 31, 32, 33, 80 and 1,000 events,
pages repeated within a window and in the window before, both tiers,
random occupancies and latencies, and empty replays.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.sim.costmodel import OPTANE_LIKE as REF_OPTANE
from repro.timing import AddressTimingEngine as RefEngine
from repro.timing import TimingParams as RefParams
from repro_torch.kernels.timing_replay import (
    replay_prepass,
    replay_ref,
    timing_replay,
    window_prefix_ref,
    writer_index_ref,
)

WINDOWS = (1, 2, 31, 32, 33, 80, 1_000)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stream(rng, n, n_pages, occ_scale=1e-6):
    """n events over n_pages pages (few pages: repeats in and across
    windows), both tiers, random float64 occupancies and latencies."""
    return dict(
        page=rng.integers(0, n_pages, size=n).astype(np.int32),
        tier=rng.integers(0, 2, size=n).astype(np.int8),
        occ=rng.random(n) * occ_scale,
        lat=rng.random(n) * 2e-6,
        n_pages=n_pages,
        chan=rng.random(2) * 1e-5,
    )


def _launch(streams, windows):
    """Flat arguments of one launch over ``streams`` (dicts of numpy arrays)."""
    sizes = [s["page"].size for s in streams]
    cat = {k: torch.from_numpy(np.concatenate([s[k] for s in streams]))
           for k in ("page", "tier", "occ", "lat")}
    return (cat["page"], cat["tier"], cat["occ"], cat["lat"],
            torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)),
            torch.tensor(windows, dtype=torch.int64),
            torch.tensor(np.array([s["chan"] for s in streams]), dtype=torch.float64),
            torch.tensor([s["n_pages"] for s in streams], dtype=torch.int64))


def _streams(seed, w):
    """Replays with window w: one of 5 windows' worth over few pages, one
    hammering 3 pages, one empty; and a one-event-window replay beside."""
    rng = np.random.default_rng(seed)
    n = 5 * w + 7
    streams = [_stream(rng, n, max(2, n // 3)), _stream(rng, n, 3),
               _stream(rng, 0, 4), _stream(rng, 200, 40)]
    return streams, [w, w, w, 1]


def _writer_brute(page, ev_off, w_slots):
    """Each event's writer by a scan: the last event of its page among the
    replay's earlier windows."""
    out = np.full(page.size, -1, dtype=np.int32)
    for r, w in enumerate(w_slots):
        e0, e1 = ev_off[r], ev_off[r + 1]
        last = {}
        for k in range(e0, e1, w):
            win = range(k, min(k + w, e1))
            for j in win:
                out[j] = last.get(int(page[j]), -1)
            for j in win:
                last[int(page[j])] = j
    return out


def _prefix_brute(tier, occ, ev_off, w_slots):
    c, d, dm = (np.empty_like(occ) for _ in range(3))
    for r, w in enumerate(w_slots):
        e0, e1 = ev_off[r], ev_off[r + 1]
        for k in range(e0, e1, w):
            sl = np.arange(k, min(k + w, e1))
            for tr in (0, 1):
                idx = sl[tier[sl] == tr]
                if idx.size:
                    c[idx] = np.cumsum(occ[idx])
                    d[idx] = c[idx] - occ[idx]
                    dm[idx] = np.minimum.accumulate(d[idx])
    return c, d, dm


def walk_plain(prep, tier, lat, ev_off, w_slots, chan):
    """The walker's arithmetic in numpy, event by event: ``done`` per event,
    an event's writer term ``done[writer] - d`` (0.0 - d without a
    writer), each tier's running max of it in the window, then ``finish =
    max(t_open - dm, max(term, chan)) + c`` and ``done = finish + lat``.
    Returns (t_app per replay, done)."""
    writer, c, d, dm = (x.numpy() for x in prep)
    tier, lat, chan = tier.numpy(), lat.numpy(), chan.numpy()
    done = np.zeros(tier.size)
    t_app = []
    for r, w in enumerate(w_slots.tolist()):
        e0, e1 = int(ev_off[r]), int(ev_off[r + 1])
        ch = [float(chan[r, 0]), float(chan[r, 1])]
        end, t = max(ch), 0.0
        for k in range(e0, e1, w):
            q = [-np.inf, -np.inf]
            last = [None, None]
            lo, hi = np.inf, -np.inf
            for j in range(k, min(k + w, e1)):
                tr = int(tier[j])
                pd = done[writer[j]] if writer[j] >= 0 else 0.0
                q[tr] = max(q[tr], pd - d[j])
                f = max(t - dm[j], max(q[tr], ch[tr])) + c[j]
                done[j] = f + lat[j]
                last[tr] = f
                lo, hi = min(lo, done[j]), max(hi, done[j])
            ch = [ch[i] if last[i] is None else last[i] for i in (0, 1)]
            t, end = lo, max(end, hi)
        t_app.append(max(end, max(ch)))
    return t_app, done


def _ref_replay(args, r):
    """The JAX package's AddressTimingEngine._replay on replay r."""
    page, tier, occ, lat, ev_off, w_slots, chan, n_pages = args
    s = slice(int(ev_off[r]), int(ev_off[r + 1]))
    eng = RefEngine(dataclasses.replace(RefParams.from_profile(REF_OPTANE),
                                        window=float(w_slots[r])))
    ev = {"page": page[s].numpy().astype(np.int64), "tier": tier[s].numpy(),
          "occ": occ[s].numpy(), "lat": lat[s].numpy(), "scale": 1.0,
          "n_pages": int(n_pages[r])}
    return eng._replay(ev, chan[r].numpy(), threads=1)


@pytest.mark.parametrize("w", WINDOWS)
@pytest.mark.parametrize("seed", [0, 1])
def test_writer_index_matches_a_scan(w, seed):
    streams, windows = _streams(seed, w)
    page, _, _, _, ev_off, w_slots, _, n_pages = _launch(streams, windows)
    got = writer_index_ref(page, ev_off, w_slots, n_pages)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _writer_brute(
        page.numpy(), ev_off.tolist(), w_slots.tolist()))


@pytest.mark.parametrize("w", WINDOWS)
def test_window_prefix_matches_numpy_cumsum(w):
    streams, windows = _streams(2, w)
    _, tier, occ, _, ev_off, w_slots, _, _ = _launch(streams, windows)
    got = window_prefix_ref(tier, occ, ev_off, w_slots)
    want = _prefix_brute(tier.numpy(), occ.numpy(), ev_off.tolist(), w_slots.tolist())
    for g, x in zip(got, want):
        assert g.tolist() == x.tolist()  # bit for bit


@pytest.mark.parametrize("w", WINDOWS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walker_over_the_prepass_equals_the_jax_replay(w, seed):
    streams, windows = _streams(10 + seed, w)
    args = _launch(streams, windows)
    page, tier, occ, lat, ev_off, w_slots, chan, n_pages = args
    prep = replay_prepass(page, tier, occ, ev_off, w_slots, n_pages)
    got, _ = walk_plain(prep, tier, lat, ev_off, w_slots, chan)
    want = [_ref_replay(args, r) for r in range(w_slots.numel())]
    assert got == want  # bit for bit
    assert got == timing_replay(*args).tolist()
    assert got[2] == max(streams[2]["chan"])  # the empty replay ends at its preload


def _engine_stream(case):
    """The port's engine's event stream for one interval (equal to the JAX
    package's, as tests/test_torch_timing.py holds): one-event chains,
    writes, or three pages hammered; as a dict of numpy arrays and its
    window."""
    from repro_torch.sim.costmodel import OPTANE_LIKE
    from repro_torch.timing import AddressTimingEngine, TimingParams

    rng = np.random.default_rng(50)
    params = TimingParams.from_profile(OPTANE_LIKE, max_events=20_000)
    kw = {
        "w1_chains": dict(counts=rng.integers(1, 40, size=300), tiers=rng.integers(0, 2, size=300),
                          rand_frac=0.8, num_threads=1),
        "writes": dict(counts=rng.integers(1, 200, size=2_000),
                       tiers=rng.integers(0, 2, size=2_000), rand_frac=0.6,
                       writes=rng.integers(0, 100, size=2_000), pm_pr=40, pm_de=25),
        "dup_pages": dict(counts=np.full(3, 5_000), tiers=np.array([0, 1, 0])),
    }[case]
    if case == "w1_chains":
        params = dataclasses.replace(params, window=1.0)
    counts = np.asarray(kw.pop("counts"), dtype=np.int64)
    kw.setdefault("num_threads", 2)
    _, (ev, w, chan) = AddressTimingEngine(params, seed=3, device="cpu")._prepare(
        index=7, pages=np.arange(counts.size), counts=counts,
        tiers=np.asarray(kw.pop("tiers"), dtype=np.int8), ops=0.0, **kw)
    return dict(page=ev.page.numpy(), tier=ev.tier.numpy(), occ=ev.occ.numpy(),
                lat=ev.lat.numpy(), n_pages=ev.n_pages, chan=np.asarray(chan)), w


@pytest.mark.parametrize("case", ["w1_chains", "writes", "dup_pages"])
def test_walker_over_the_prepass_equals_the_jax_replay_on_engine_streams(case):
    """The engine's own streams, read and write occupancies and latencies
    among them: the plain walker over the pre-pass equals the JAX
    package's replay bit for bit."""
    stream, w = _engine_stream(case)
    assert (w == 1) == (case == "w1_chains")
    args = _launch([stream], [w])
    page, tier, occ, lat, ev_off, w_slots, chan, n_pages = args
    if case == "writes":  # the slow tier's write latency beside the reads'
        assert len(set(lat.tolist())) == 3
    prep = replay_prepass(page, tier, occ, ev_off, w_slots, n_pages)
    got, _ = walk_plain(prep, tier, lat, ev_off, w_slots, chan)
    assert got == [_ref_replay(args, 0)]


@pytest.mark.parametrize("seed", range(4))
def test_one_event_windows_never_read_a_done_above_t_open(seed):
    """With one-event windows ``done`` never decreases (occ, lat >= 0), so
    a page's last done is never above the window's open time: the page
    loads never decide a value there."""
    rng = np.random.default_rng(40 + seed)
    streams = [_stream(rng, 3_000, n_pages) for n_pages in (1, 7, 500, 5_000)]
    args = _launch(streams, [1] * len(streams))
    page, tier, occ, lat, ev_off, w_slots, chan, n_pages = args
    prep = replay_prepass(page, tier, occ, ev_off, w_slots, n_pages)
    got, done = walk_plain(prep, tier, lat, ev_off, w_slots, chan)
    writer = prep[0].numpy()
    for r in range(len(streams)):
        e0, e1 = int(ev_off[r]), int(ev_off[r + 1])
        j = np.arange(e0 + 1, e1)
        has = writer[j] >= 0
        assert has.any()
        assert np.all(done[writer[j][has]] <= done[j - 1][has])  # t_open = done[j - 1]
        assert np.all(np.diff(done[e0:e1]) >= 0)
    assert got == [_ref_replay(args, r) for r in range(len(streams))]


def test_replay_prepass_on_the_cpu_is_the_plain_versions():
    streams, windows = _streams(5, 33)
    page, tier, occ, _, ev_off, w_slots, _, n_pages = _launch(streams, windows)
    writer, c, d, dm = replay_prepass(page, tier, occ, ev_off, w_slots, n_pages)
    assert torch.equal(writer, writer_index_ref(page, ev_off, w_slots, n_pages))
    for a, b in zip((c, d, dm), window_prefix_ref(tier, occ, ev_off, w_slots)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("w, dist, near", [
    (1, 1, True), (1, 40, True), (1, 64, True), (1, 95, False), (1, 96, False),
    (1, 200, False), (80, 60, True), (80, 160, False), (2, 2, True), (2, 4, True),
    (2, 66, False),
])
def test_near_writers_follow_the_chunk_layout(smoke, w, dist, near):
    """One page written every ``dist`` events of windows of ``w`` (the
    page alone otherwise unique): ``chip_smoke.near_writers`` counts its
    writer near when it lies in the event's chunk of 32 or one of the two
    chunks before (chunks of a window, or of the replay where windows are
    one event)."""
    n = 400
    page = np.arange(n, dtype=np.int32) + 1
    page[::dist] = 0
    ev_off = torch.tensor([0, n])
    w_slots = torch.tensor([w])
    writer = writer_index_ref(torch.from_numpy(page), ev_off, w_slots, torch.tensor([n + 1]))
    got = smoke.near_writers(writer, ev_off, w_slots)
    j = 3 * dist if 3 * dist < n else dist  # an event with a writer dist before it
    assert int(writer[j]) == j - dist
    assert bool(got[j]) == near
    assert not got[page != 0].any()


@pytest.mark.parametrize("occ", [0.0, -0.0, 5e-324, 1e-9, 3.5e-7, 1e300])
def test_one_event_windows_have_a_zero_prefix_min(occ):
    """In a one-event window the pre-pass gives ``d = dm = +0.0`` bit for
    bit for every finite ``occ`` (``c = -0.0 + occ = occ``, ``occ - occ``
    is +0.0), so the walker's fast chain may drop ``t - dm``; a window of
    two does not."""
    tier = torch.tensor([0, 1, 1, 0], dtype=torch.int8)
    occ_t = torch.tensor([occ, occ, 2e-9, occ], dtype=torch.float64)
    ev_off = torch.tensor([0, 2, 4])
    c, d, dm = window_prefix_ref(tier, occ_t, ev_off, torch.tensor([1, 2]))
    zero = torch.tensor(0.0, dtype=torch.float64).view(torch.int64)
    assert c[:2].tolist() == occ_t[:2].tolist()
    assert (d[:2].view(torch.int64) == zero).all() and (dm[:2].view(torch.int64) == zero).all()
    assert float(d[3]) == 0.0 and float(c[3]) == occ  # the second window's tiers differ
    assert float(d[2]) == 0.0


def test_replay_ref_is_unchanged_against_the_jax_replay():
    streams, windows = _streams(7, 31)
    args = _launch(streams, windows)
    page, tier, occ, lat, ev_off, w_slots, chan, n_pages = args
    for r in range(w_slots.numel()):
        s = slice(int(ev_off[r]), int(ev_off[r + 1]))
        assert replay_ref(page[s], tier[s], occ[s], lat[s], int(w_slots[r]), chan[r],
                          int(n_pages[r])) == _ref_replay(args, r)
