"""The timing engine's event replay, many intervals in one launch.

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

:func:`timing_replay` is the entry point. On CUDA tensors it launches the
hand-written Hopper kernel ``csrc/timing_replay.cu``, one thread a replay;
on CPU tensors it takes :func:`replay_ref` per replay, the JAX package's
numpy loop (``repro/timing/engine.py``, ``AddressTimingEngine._replay``)
line by line in plain PyTorch. There is no fallback from one to the other.
This kernel has no TPU counterpart: the JAX package runs the replay in
numpy on the host, and it is the same function on this card.

Bound: the serial chain, not bytes. A replay is one dependent sequence:
a window's recurrence waits for its pages' ``page_done`` loads, the next
window's loads issue only after it, and every event adds at least one
dependent float64 step (the window's running minimum). So one replay takes
at least windows x one dependent load + events x one dependent float64
add, whatever the card's rates; :func:`chain_latency_ns` measures both
links on the card, the load over a buffer of the replay's ``n_pages``
entries (``page_done`` at 3.25 M pages is 26 MB a replay). Its bytes (21
an event read, ``page_done`` zeroed, 8 a replay written) are far below
what the chain allows. The kernel adds and subtracts with ``__dadd_rn`` /
``__dsub_rn`` (never contracted) and takes maxima as numpy does, so it
equals :func:`replay_ref` bit for bit. The times are in ``PERF.md``.
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
        ctypes.c_void_p, ctypes.c_void_p,
    ])


def chain_latency_ns(n_pages: int, device=None) -> dict:
    """The links of the replay's serial chain on the card, in ns: one
    dependent load through a random cycle over ``n_pages`` 8-byte entries
    (the size of one replay's ``page_done``) and one dependent float64 add.
    Each is timed by CUDA events at ``steps`` and ``2 * steps`` links
    (20,000 loads, 1,000,000 adds), and the difference divided by
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
    out = torch.zeros(1, dtype=torch.float64, device=dev)
    launch = _probe_launcher()

    def ms(steps: int, adds: int) -> float:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            rc = launch(nxt.data_ptr(), steps, adds, 1.0, out.data_ptr(), stream.cuda_stream)
            stop.record(stream)
            stop.synchronize()
        if rc != 0:
            raise RuntimeError(f"chain probe launch failed: CUDA error {rc}")
        return start.elapsed_time(stop)

    links = {}
    for key, steps, adds in (("load_ns", 20_000, 0), ("f64_add_ns", 1_000_000, 1)):
        ms(steps, adds)  # warm-up
        links[key] = max(0.0, (ms(2 * steps, adds) - ms(steps, adds)) * 1e6 / steps)
    return links


def chain_bound_ms(ev_off, w_slots, links: dict) -> float:
    """The serial-chain bound of one launch: the longest replay's windows
    x ``links["load_ns"]`` + events x ``links["f64_add_ns"]`` (replays run
    side by side, one thread each)."""
    sizes = (ev_off[1:] - ev_off[:-1]).cpu().double()
    windows = torch.ceil(sizes / w_slots.cpu().double())
    chain_ns = windows * links["load_ns"] + sizes * links["f64_add_ns"]
    return float(chain_ns.max()) / 1e6 if chain_ns.numel() else 0.0


@functools.lru_cache(maxsize=None)
def _launcher():
    return _build.function("timing_replay", "timing_replay_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p,
    ])


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
    # the kernel indexes page_done[page] unchecked: hold every page below
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


def timing_replay(page, tier, occ, lat, ev_off, w_slots, chan, n_pages) -> torch.Tensor:
    """Makespan ``t_app`` (float64 ``[R]``) of ``R`` independent replays.

    Replay ``r`` owns events ``ev_off[r]:ev_off[r + 1]`` of the flat
    streams ``page`` (int32, indices below ``n_pages[r]``), ``tier`` (int8,
    0 fast / 1 slow), ``occ`` and ``lat`` (float64), windows of
    ``w_slots[r]`` events (>= 1) and the channel preload ``chan[r]``
    (float64, fast then slow). Exact on both devices.

    ``timing_replay.launches`` counts the CUDA kernel's launches; the CPU
    path never adds to it.
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
    t_app = torch.empty(n_rep, dtype=torch.float64, device=page.device)
    if n_rep == 0:
        return t_app
    # per-replay scratch, zeroed page_done and one window of ready times
    pd_off = torch.zeros(n_rep + 1, dtype=torch.int64, device=page.device)
    torch.cumsum(n_pages, dim=0, out=pd_off[1:])
    rd_off = torch.zeros_like(pd_off)
    torch.cumsum(torch.minimum(w_slots, ev_off[1:] - ev_off[:-1]), dim=0,
                 out=rd_off[1:])
    page_done = torch.zeros(int(pd_off[-1]), dtype=torch.float64, device=page.device)
    ready = torch.empty(int(rd_off[-1]), dtype=torch.float64, device=page.device)
    with torch.cuda.device(page.device):
        stream = torch.cuda.current_stream(page.device).cuda_stream
        rc = _launcher()(
            page.data_ptr(), tier.data_ptr(), occ.data_ptr(), lat.data_ptr(),
            ev_off.data_ptr(), w_slots.data_ptr(), chan.data_ptr(),
            pd_off.data_ptr(), page_done.data_ptr(), rd_off.data_ptr(),
            ready.data_ptr(), t_app.data_ptr(), n_rep, stream,
        )
    if rc != 0:
        raise RuntimeError(f"timing_replay kernel launch failed: CUDA error {rc}")
    timing_replay.launches += 1
    return t_app


timing_replay.launches = 0
