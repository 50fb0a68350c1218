"""The timing engine's event replay, many intervals in one call.

:class:`repro_torch.timing.engine.AddressTimingEngine` expands each
interval into an ordered stream of memory events (page, tier, channel
occupancy, latency) and replays it against two tier channels in windows of
``w_slots`` events (the bounded in-flight window). Within a window every
event becomes ready at ``max(page_done[page], t_open)``; per tier, events
serialize through the channel by the single-server queue identity
(``c += occ``; ``base = max(base, ready - (c - occ))``;
``finish = max(base, chan) + c``; ``done = finish + lat``); the channel
moves to the tier's last finish, ``page_done`` takes each event's ``done``
in event order (the last write to a page wins), the next window opens at
the window's earliest ``done``, and the interval's makespan is the latest
``done`` or channel. The replays of different intervals are independent:
each starts from its own channel preload and a zeroed ``page_done``.

:func:`timing_replay` is the entry point. On CPU tensors it takes
:func:`replay_ref` per replay, the JAX package's numpy loop
(``repro/timing/engine.py``, ``AddressTimingEngine._replay``) line by line
in plain PyTorch. On CUDA tensors it runs the hand-written Hopper kernels
of ``csrc/timing_replay.cu``: :func:`replay_prepass`, parallel over every
event, then :func:`replay_walk`, one warp a replay. There is no fallback
from one to the other. This kernel has no TPU counterpart: the JAX package
runs the replay in numpy on the host.

The decomposition rests on monotone rounding: ``fl(max(a, b) - d) ==
max(fl(a - d), fl(b - d))``, so with ``d = c - occ`` a window's ``base`` is
``max(t_open - min(d), max(page_done - d))``, every max exact and in any
order. The pre-pass builds what does not depend on the chain: each event's
writer (:func:`writer_index_ref`: the last event of its replay and page in
an earlier window, whose ``done`` is the ``page_done`` it reads) and each
window's per-tier prefix sums (:func:`window_prefix_ref`: ``c`` added in
event order, ``d = c - occ`` and ``dm``, the prefix min of ``d``). The
walker then keeps ``done`` per event and runs only the float64 chain
through ``t_open`` and the channels.

Bound: that chain. :func:`chain_latency_ns` measures its links on the
card, among them one one-event window of the walker's fast chain
(``window_chain_ns``: two adds and a max; ``dm`` is +0.0 in a one-event
window, so ``t - dm`` is ``t``, and the channels' terms are formed beside
the chain) and one shuffle step (``shfl_step_ns``);
:func:`chain_bound_ms` charges each window one window chain, and a wider
window also its ``t - dm`` and ``log2`` of its lanes in shuffle steps.
:func:`chain_ms_with_loads` is the old count, a dependent ``page_done``
load a window, which the page ids, being inputs, do not force. The
kernels add and subtract with ``__dadd_rn`` / ``__dsub_rn`` (never
contracted) and take maxima as numpy does, so they equal
:func:`replay_ref` bit for bit. The times are in ``PERF.md``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

FAST = 0
SLOW = 1


def replay_ref(page, tier, occ, lat, w_slots: int, chan, n_pages: int) -> float:
    """One replay in plain PyTorch: ``AddressTimingEngine._replay`` of the
    JAX package, line by line. ``page`` (indices into the interval's
    ``n_pages`` pages), ``tier`` (0 fast, 1 slow), ``occ`` and ``lat``
    (float64) are the ordered event stream; ``chan`` the two channels'
    preload (float64). Returns the makespan ``t_app``."""
    page = page.to(torch.int64)
    page_done = torch.zeros(int(n_pages), dtype=torch.float64, device=page.device)
    t_open = 0.0
    chan = chan.to(torch.float64).clone()
    end = float(chan.max())
    for k in range(0, page.numel(), w_slots):
        sl = slice(k, k + w_slots)
        pg = page[sl]
        ready = torch.clamp(page_done[pg], min=t_open)
        done = torch.empty(pg.numel(), dtype=torch.float64, device=page.device)
        for tr in (FAST, SLOW):
            m = tier[sl] == tr
            if not bool(m.any()):
                continue
            srv = occ[sl][m]
            c = torch.cumsum(srv, dim=0)
            base = torch.cummax(ready[m] - (c - srv), dim=0).values
            finish = torch.clamp(base, min=chan[tr]) + c
            done[m] = finish + lat[sl][m]
            chan[tr] = finish[-1]
        # numpy's fancy assignment: the last write to a page wins
        later = torch.triu(pg[:, None] == pg[None, :], diagonal=1).any(dim=1)
        page_done[pg[~later]] = done[~later]
        t_open = float(done.min())
        end = max(end, float(done.max()))
    return max(end, float(chan.max()))


@functools.lru_cache(maxsize=None)
def _probe_launcher():
    return _build.function("timing_replay", "timing_chain_probe_launch", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
        ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p,
    ])


# the chain probe's modes (csrc/timing_replay.cu) and their step counts
_PROBES = (("load_ns", 0, 20_000), ("f64_add_ns", 1, 1_000_000),
           ("window_chain_ns", 2, 1_000_000), ("shfl_step_ns", 3, 200_000))
_TIER_BITS = 0x5A3C96E1F00FD2B7  # the window probe's tiers, one bit a step


def chain_latency_ns(n_pages: int, device=None) -> dict:
    """The links of the replay's serial chain on the card, in ns: one
    dependent load through a random cycle over ``n_pages`` 8-byte entries
    (the size of one replay's ``page_done``), one dependent float64 add,
    one one-event window of the walker's fast chain (``window_chain_ns``:
    ``t + c``, the max with a term formed beside the chain, ``+ lat``, as
    ``csrc/timing_replay.cu`` runs it) and one warp
    shuffle-and-min step (``shfl_step_ns``). Each is timed by CUDA events
    at ``steps`` and ``2 * steps`` links and the difference divided by
    ``steps``, so the launch cancels out. CUDA only: the bound is a
    property of the card."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"chain_latency_ns measures the card, not {dev}")
    n = max(1, int(n_pages))
    g = torch.Generator(device=dev).manual_seed(0)
    perm = torch.randperm(n, device=dev, generator=g)
    nxt = torch.empty(n, dtype=torch.int64, device=dev)
    nxt[perm] = torch.roll(perm, -1)
    out = torch.zeros(4, dtype=torch.float64, device=dev)
    launch = _probe_launcher()

    def ms(steps: int, mode: int) -> float:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            rc = launch(nxt.data_ptr(), steps, mode, 1.0, _TIER_BITS, out.data_ptr(),
                        stream.cuda_stream)
            stop.record(stream)
            stop.synchronize()
        if rc != 0:
            raise RuntimeError(f"chain probe launch failed: CUDA error {rc}")
        return start.elapsed_time(stop)

    links = {}
    for key, mode, steps in _PROBES:
        out.zero_()
        ms(steps, mode)  # warm-up
        links[key] = max(0.0, (ms(2 * steps, mode) - ms(steps, mode)) * 1e6 / steps)
    return links


# shuffle steps of a window's min over n lanes, n = 0..32: ceil(log2(n))
_SHUFFLE_STEPS = torch.tensor([0] + [(n - 1).bit_length() for n in range(1, 33)])


def chain_bound_ms(ev_off, w_slots, links: dict) -> float:
    """The serial-chain bound of one launch: the longest replay's windows,
    each charged ``links["window_chain_ns"]``; a window of more than one
    event also its ``t - dm`` (``links["f64_add_ns"]``) and ``ceil(log2(
    lanes))`` x ``links["shfl_step_ns"]`` for its earliest done over
    ``min(events, 32)`` lanes. Replays run side by side, one warp each."""
    sizes = (ev_off[1:] - ev_off[:-1]).cpu().to(torch.int64)
    w = w_slots.cpu().to(torch.int64)
    full, rem = sizes // w, sizes % w

    def window_ns(n):
        wide = links["f64_add_ns"] + _SHUFFLE_STEPS[n.clamp(0, 32)] * links["shfl_step_ns"]
        return links["window_chain_ns"] + (n > 1) * wide

    chain_ns = full * window_ns(w) + (rem > 0) * window_ns(rem)
    return float(chain_ns.max()) / 1e6 if chain_ns.numel() else 0.0


def chain_ms_with_loads(ev_off, w_slots, links: dict) -> float:
    """The old load-based chain of one launch, printed beside the bound:
    the longest replay's windows x ``links["load_ns"]`` + events x
    ``links["f64_add_ns"]``."""
    sizes = (ev_off[1:] - ev_off[:-1]).cpu().double()
    windows = torch.ceil(sizes / w_slots.cpu().double())
    chain_ns = windows * links["load_ns"] + sizes * links["f64_add_ns"]
    return float(chain_ns.max()) / 1e6 if chain_ns.numel() else 0.0


def writer_index_ref(page, ev_off, w_slots, n_pages) -> torch.Tensor:
    """Each event's writer (int32 ``[N]``): the last event of the same
    replay and page in an earlier window, or -1. A window reads
    ``page_done`` as it stood at its start, and the last write in a window
    wins, so that event's ``done`` is what the event reads. Plain PyTorch:
    a stable sort by (replay, page), then the entry before each run of one
    key and one window."""
    n = page.numel()
    sizes = ev_off[1:] - ev_off[:-1]
    rep = torch.repeat_interleave(torch.arange(sizes.numel(), device=page.device), sizes,
                                  output_size=n)
    pd_off = torch.cumsum(n_pages, dim=0) - n_pages
    key = pd_off[rep] + page.to(torch.int64)
    idx = torch.arange(n, device=page.device)
    e0, w = ev_off[:-1][rep], w_slots[rep]
    win = e0 + (idx - e0) // w * w
    skey, order = torch.sort(key, stable=True)
    swin = win[order]
    start = torch.ones(n, dtype=torch.bool, device=page.device)
    start[1:] = (skey[1:] != skey[:-1]) | (swin[1:] != swin[:-1])
    before = torch.cummax(torch.where(start, idx, 0), dim=0).values - 1
    prev = before.clamp(min=0)
    has = (before >= 0) & (skey[prev] == skey)
    writer = torch.empty(n, dtype=torch.int32, device=page.device)
    writer[order] = torch.where(has, order[prev], -1).to(torch.int32)
    return writer


def window_prefix_ref(tier, occ, ev_off, w_slots) -> tuple:
    """Each event's window-local, per-tier prefix sums ``(c, d, dm)``
    (float64 ``[N]``): ``c`` the inclusive sum of its tier's ``occ`` in the
    window, added in event order as ``np.cumsum`` adds; ``d = c - occ``;
    ``dm`` the prefix min of ``d``. Plain PyTorch, one replay at a time: a
    row a window, the other tier's entries adding 0.0."""
    c, d, dm = (torch.empty_like(occ) for _ in range(3))
    off = ev_off.tolist()
    for r, w in enumerate(w_slots.tolist()):
        e0, e1 = off[r], off[r + 1]
        n = e1 - e0
        if n == 0:
            continue
        w = min(w, n)
        pad = -n % w
        o = torch.nn.functional.pad(occ[e0:e1], (0, pad)).view(-1, w)
        t = torch.nn.functional.pad(tier[e0:e1], (0, pad), value=-1).view(-1, w)
        for tr in (FAST, SLOW):
            m = t == tr
            ct = torch.cumsum(torch.where(m, o, 0.0), dim=1)
            dt = ct - o
            dmt = torch.cummin(torch.where(m, dt, torch.inf), dim=1).values
            sel = m.reshape(-1)[:n]
            for out, val in ((c, ct), (d, dt), (dm, dmt)):
                seg = out[e0:e1]
                seg[sel] = val.reshape(-1)[:n][sel]
    return c, d, dm


@functools.lru_cache(maxsize=None)
def _launchers():
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    return (
        _build.function("timing_replay", "timing_replay_keys_launch",
                        [p, p, p, ll, ll, p, p]),
        _build.function("timing_replay", "timing_replay_prepass_launch",
                        [p, p, p, p, p, p, p, ll, ll, ll, p, p, p, p, p]),
        _build.function("timing_replay", "timing_replay_walk_launch",
                        [p, p, p, p, p, p, p, p, p, p, p, ll, p]),
    )


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"timing_replay {what} launch failed: CUDA error {rc}")


def _check(page, tier, occ, lat, ev_off, w_slots, chan, n_pages) -> int:
    n_rep = int(w_slots.numel())
    dev = page.device
    for name, t, dtype in (("page", page, torch.int32), ("tier", tier, torch.int8),
                           ("occ", occ, torch.float64), ("lat", lat, torch.float64),
                           ("ev_off", ev_off, torch.int64),
                           ("w_slots", w_slots, torch.int64),
                           ("chan", chan, torch.float64),
                           ("n_pages", n_pages, torch.int64)):
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(
                f"timing_replay: {name} must be a contiguous {dtype} tensor on "
                f"{dev}, got {t.dtype} on {t.device}"
            )
    n_ev = page.numel()
    if not (tier.numel() == occ.numel() == lat.numel() == n_ev):
        raise ValueError("timing_replay: page, tier, occ and lat must align")
    if ev_off.shape != (n_rep + 1,) or chan.shape != (n_rep, 2) or n_pages.shape != (n_rep,):
        raise ValueError(
            "timing_replay: ev_off [R+1], w_slots [R], chan [R, 2] and "
            "n_pages [R] must describe the same R replays"
        )
    # the kernels index by page and event unchecked: hold every page below
    # its replay's n_pages, and the offsets to a partition of the events
    sizes = ev_off[1:] - ev_off[:-1]
    bad = (ev_off[0] != 0) | (ev_off[-1] != n_ev) | (sizes < 0).any()
    if n_ev and not bool(bad):
        lim = torch.repeat_interleave(n_pages.to(torch.int32), sizes, output_size=n_ev)
        bad = ((page < 0) | (page >= lim)).any()
    if bool(bad):
        raise ValueError(
            "timing_replay: ev_off must rise from 0 to the event count and "
            "every page must lie below its replay's n_pages"
        )
    return n_rep


def replay_prepass(page, tier, occ, ev_off, w_slots, n_pages) -> tuple:
    """The pre-pass over every event of every replay: ``(writer, c, d,
    dm)`` as :func:`writer_index_ref` and :func:`window_prefix_ref` define
    them. On CPU tensors those plain versions; on CUDA tensors a key
    kernel, a stable sort of the keys by ``torch.sort`` (index building),
    then one kernel for the writers and one thread a window for the prefix
    sums. Arguments as :func:`timing_replay` takes them, checked by it."""
    if page.device.type == "cpu":
        return (writer_index_ref(page, ev_off, w_slots, n_pages),
                *window_prefix_ref(tier, occ, ev_off, w_slots))
    if page.device.type != "cuda":
        raise ValueError(f"timing_replay runs on cuda or cpu, not {page.device}")
    n_rep, n_ev = w_slots.numel(), page.numel()
    if n_ev >= 2**31:
        raise ValueError("timing_replay: the card's writer index takes under 2**31 events")
    dev = page.device
    pd_off = torch.zeros(n_rep + 1, dtype=torch.int64, device=dev)
    torch.cumsum(n_pages, dim=0, out=pd_off[1:])
    win_off = torch.zeros_like(pd_off)
    torch.cumsum(-(-(ev_off[1:] - ev_off[:-1]) // w_slots), dim=0, out=win_off[1:])
    n_win = int(win_off[-1])
    key = torch.empty(n_ev, dtype=torch.int64, device=dev)
    writer = torch.empty(n_ev, dtype=torch.int32, device=dev)
    c, d, dm = (torch.empty(n_ev, dtype=torch.float64, device=dev) for _ in range(3))
    keys, prepass, _ = _launchers()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(keys(page.data_ptr(), ev_off.data_ptr(), pd_off.data_ptr(), n_rep, n_ev,
                       key.data_ptr(), stream), "key")
        skey, order = torch.sort(key, stable=True)
        _raise_on(prepass(skey.data_ptr(), order.data_ptr(), tier.data_ptr(),
                          occ.data_ptr(), ev_off.data_ptr(), w_slots.data_ptr(),
                          win_off.data_ptr(), n_rep, n_ev, n_win, writer.data_ptr(),
                          c.data_ptr(), d.data_ptr(), dm.data_ptr(), stream), "pre-pass")
    return writer, c, d, dm


def replay_walk(prep, tier, lat, ev_off, w_slots, chan) -> torch.Tensor:
    """The walker on the card: one warp a replay over the pre-pass's
    ``prep = (writer, c, d, dm)``, ``done`` kept per event in a scratch the
    wrapper allocates. Returns ``t_app`` (float64 ``[R]``). CUDA only: the
    CPU takes :func:`replay_ref`."""
    if tier.device.type != "cuda":
        raise ValueError(f"replay_walk runs on the card, not {tier.device}")
    n_rep = w_slots.numel()
    writer, c, d, dm = prep
    done = torch.empty(tier.numel(), dtype=torch.float64, device=tier.device)
    t_app = torch.empty(n_rep, dtype=torch.float64, device=tier.device)
    with torch.cuda.device(tier.device):
        stream = torch.cuda.current_stream(tier.device).cuda_stream
        _raise_on(_launchers()[2](
            tier.data_ptr(), lat.data_ptr(), writer.data_ptr(), c.data_ptr(), d.data_ptr(),
            dm.data_ptr(), ev_off.data_ptr(), w_slots.data_ptr(), chan.data_ptr(),
            done.data_ptr(), t_app.data_ptr(), n_rep, stream), "walker")
    return t_app


def timing_replay(page, tier, occ, lat, ev_off, w_slots, chan, n_pages) -> torch.Tensor:
    """Makespan ``t_app`` (float64 ``[R]``) of ``R`` independent replays.

    Replay ``r`` owns events ``ev_off[r]:ev_off[r + 1]`` of the flat
    streams ``page`` (int32, indices below ``n_pages[r]``), ``tier`` (int8,
    0 fast / 1 slow), ``occ`` and ``lat`` (float64), windows of
    ``w_slots[r]`` events (>= 1) and the channel preload ``chan[r]``
    (float64, fast then slow). Exact on both devices.

    ``timing_replay.launches`` counts the calls that launched the CUDA
    kernels (pre-pass and walker), one a call; the CPU path never adds to
    it.
    """
    n_rep = _check(page, tier, occ, lat, ev_off, w_slots, chan, n_pages)
    if page.device.type == "cpu":
        off = ev_off.tolist()
        return torch.tensor(
            [replay_ref(page[off[r]:off[r + 1]], tier[off[r]:off[r + 1]],
                        occ[off[r]:off[r + 1]], lat[off[r]:off[r + 1]],
                        int(w_slots[r]), chan[r], int(n_pages[r]))
             for r in range(n_rep)],
            dtype=torch.float64,
        )
    if page.device.type != "cuda":
        raise ValueError(f"timing_replay runs on cuda or cpu, not {page.device}")
    if bool((w_slots < 1).any()):
        raise ValueError("timing_replay: w_slots must be >= 1")
    if n_rep == 0:
        return torch.empty(0, dtype=torch.float64, device=page.device)
    prep = replay_prepass(page, tier, occ, ev_off, w_slots, n_pages)
    t_app = replay_walk(prep, tier, lat, ev_off, w_slots, chan)
    timing_replay.launches += 1
    return t_app


timing_replay.launches = 0
