"""Shared helpers of the ``test_torch_*`` files: inputs made once with numpy
and handed to both packages, and field-by-field comparison of their
results (the two packages' dataclasses are distinct types, so results are
compared as plain data)."""

from dataclasses import asdict

import numpy as np

from repro.core.perfdb import PerfDB, PerfRecord
from repro.core.telemetry import ConfigVector
from repro.core.trace import IntervalAccess, Trace
from repro_torch import convert


def pressure_trace(seed, rss=6_000, n_intervals=12):
    """Rotating hot window over most of the RSS: candidate counts far beyond
    any mid-curve headroom, so reclaim demand digs into the same step's
    promotions (the thrash regime)."""
    rng = np.random.default_rng(seed)
    tr = Trace(name=f"press{seed}", rss_pages=rss)
    hot_n = int(rss * rng.uniform(0.5, 0.8))
    stride = max(1, int(hot_n * rng.uniform(0.15, 0.45)))
    for i in range(n_intervals):
        hot = (np.arange(hot_n) + i * stride) % rss
        extra = rng.choice(rss, size=rss // 10, replace=False)
        pages = np.unique(np.concatenate([hot, extra]))
        counts = rng.integers(4, 9, size=pages.size)  # nearly all hot
        tr.append(IntervalAccess(pages=pages, counts=counts, ops=1000.0))
    return tr


def to_port(trace):
    """The JAX package's trace as the port's, through plain data."""
    return convert.trace_from_dict(convert.trace_dict(trace))


SYNTH_CONFIG = dict(
    pacc_f=10_000, pacc_s=500, pm_de=20, pm_pr=20, ai=6.0,
    rss_pages=4_000, hot_thr=4, num_threads=1,
)


def synthetic_db_pair(max_loss=0.4):
    """One-record databases (reference, port) with a loss curve growing
    linearly as fm shrinks, so the tuner actually moves the watermarks."""
    grid = np.round(np.arange(1.0, 0.19, -0.05), 3)
    times = 1.0 + np.linspace(0.0, max_loss, grid.size)
    ref = PerfDB()
    ref.add(PerfRecord(config=ConfigVector(**SYNTH_CONFIG), fm_fracs=grid,
                       times=times))
    ref.build()
    port = convert.perfdb_from_records(
        [{"config": SYNTH_CONFIG, "fm_fracs": grid, "times": times}]
    )
    return ref, port


def plain(objs):
    return None if objs is None else [asdict(o) for o in objs]


def decision_dicts(decisions):
    """A TunerDecision list as plain data (None stays None)."""
    if decisions is None:
        return None
    return [
        {**d.__dict__, "config": None if d.config is None else asdict(d.config)}
        for d in decisions
    ]


def event_dicts(log):
    """A WatermarkEvent list as plain data (None stays None)."""
    return None if log is None else [e.__dict__ for e in log]


def assert_sim_equal(a, b):
    """Two SimResult-shaped results, field by field, exactly."""
    assert a.name == b.name
    assert a.stats == b.stats
    assert np.array_equal(a.interval_times, b.interval_times)
    assert a.total_time == b.total_time
    assert np.array_equal(a.fm_sizes, b.fm_sizes)
    assert plain(a.configs) == plain(b.configs)
    assert plain(a.costs) == plain(b.costs)
