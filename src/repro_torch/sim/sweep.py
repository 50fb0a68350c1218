"""Batched fast-memory-size sweeps on the card (counterpart of
:mod:`repro.sim.sweep`).

:func:`_sweep_fm_fracs` runs one trace once across a whole vector of
fast-memory sizes; :func:`_sweep_tuned` does the same with a Tuna tuner in
the loop of any slice (the TPP+Tuna closed loop), a slice without a tuner
being a plain fixed-size run. Both execute on
:func:`repro_torch.sim.torch_engine._sweep_run_torch`, on ``device``
(``None`` = the card). The planner in :mod:`repro_torch.sim.api` is their
caller: users describe runs as an :class:`~repro_torch.sim.api.Experiment`
and call :func:`repro_torch.sim.api.run`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.trace import Trace
from repro_torch.sim.costmodel import HardwareProfile, OPTANE_LIKE
from repro_torch.sim.torch_engine import _sweep_run_torch
from repro_torch.tiering.policy import TPPPolicy


@dataclass
class SimResult:
    """One size's run: the shape the JAX package's engine returns."""

    name: str
    total_time: float
    interval_times: np.ndarray
    configs: list  # ConfigVector per interval
    fm_sizes: np.ndarray  # effective fm size (pages) per interval
    stats: dict  # final pool counters
    costs: list = field(default_factory=list)  # IntervalCosts per interval


@dataclass
class SweepResult:
    """Per-size outcome of one batched sweep."""

    name: str
    fm_fracs: np.ndarray  # [n_sizes]
    interval_times: np.ndarray  # [n_sizes, n_intervals]
    stats: list  # final pool counter snapshot per size
    configs: list | None = None  # per size: ConfigVector per interval
    costs: list | None = None  # per size: IntervalCosts per interval


@dataclass
class TunedSlice:
    """One slice of a tuned sweep: a starting fast-memory fraction plus an
    optional tuner (with its unbound watermark controller), stepped every
    ``tune_every`` intervals. ``tuner=None`` is a plain fixed-size run."""

    fm_frac: float = 1.0
    tuner: object | None = None  # TunaTuner
    tune_every: int | None = None


def _sweep_fm_fracs(
    trace: Trace,
    fm_fracs,
    hot_thr: int = 4,
    hw: HardwareProfile = OPTANE_LIKE,
    hw_capacity_pages: int | None = None,
    seed: int = 0,
    collect_configs: bool = False,
    kswapd_batch: int | None = None,
    policy=None,
    device=None,
) -> SweepResult:
    """Run ``trace`` once, concurrently at every fraction in ``fm_fracs``.

    Bit-exact against the JAX package's ``_sweep_fm_fracs(engine="numpy")``
    on the same trace. ``kswapd_batch`` overrides every slice's
    background-reclaim budget; ``policy`` (default ``TPPPolicy(hot_thr)``)
    wins over ``hot_thr``.
    """
    fm_fracs = np.asarray(fm_fracs, dtype=np.float64)
    if fm_fracs.size == 0:
        raise ValueError("a sweep needs at least one fm fraction")
    if policy is None:
        policy = TPPPolicy(hot_thr=hot_thr)
    times, pools, configs_out, _, costs = _sweep_run_torch(
        trace, fm_fracs, policy, hw, hw_capacity_pages, seed,
        collect_configs, kswapd_batch=kswapd_batch, device=device,
    )
    return SweepResult(
        name=trace.name,
        fm_fracs=fm_fracs,
        interval_times=times,
        stats=[pool.stats.snapshot() for pool in pools],
        configs=configs_out,
        costs=costs,
    )


def _sweep_tuned(
    trace: Trace,
    slices,
    hot_thr: int = 4,
    hw: HardwareProfile = OPTANE_LIKE,
    hw_capacity_pages: int | None = None,
    seed: int = 0,
    kswapd_batch: int | None = None,
    policy=None,
    device=None,
) -> list:
    """Run ``trace`` once across a vector of :class:`TunedSlice` settings.

    Returns one :class:`SimResult` per slice, in order, bit-exact against
    the JAX package's ``_sweep_tuned(engine="numpy")``: counters, interval
    times, config vectors, fm sizes, and (on the tuners themselves) the
    decision lists and watermark event logs.
    """
    if not slices:
        raise ValueError("a tuned sweep needs at least one slice")
    if policy is None:
        policy = TPPPolicy(hot_thr=hot_thr)
    fm_fracs = np.asarray([sl.fm_frac for sl in slices], dtype=np.float64)
    times, pools, configs_out, fm_sizes, costs = _sweep_run_torch(
        trace, fm_fracs, policy, hw, hw_capacity_pages, seed,
        collect_configs=True,
        tuners=[sl.tuner for sl in slices],
        tune_everys=[sl.tune_every for sl in slices],
        kswapd_batch=kswapd_batch, device=device,
    )
    return [
        SimResult(
            name=trace.name,
            total_time=float(np.sum(times[s])),
            interval_times=times[s].copy(),
            configs=configs_out[s],
            fm_sizes=fm_sizes[s].copy(),
            stats=pools[s].stats.snapshot(),
            costs=costs[s],
        )
        for s in range(len(slices))
    ]
