"""The port's experiment API: describe runs as data, execute them on the card.

Counterpart of :mod:`repro.sim.api` for the batched sweep backends:

* :class:`Scenario`: what to run (a trace, a workload name of
  :data:`repro_torch.sim.workloads.WORKLOADS`, or a zero-argument callable
  returning a trace; the hardware profile and fast-tier capacity; pool
  overrides; ``fast_only_at_full`` for the micro-benchmark's NP_slow = 0
  baseline at full size; ``faults``, a :class:`~repro_torch.sim.faults.
  FaultSpec` that turns on the seeded fault model);
* :class:`repro_torch.fleet.FleetScenario`: N tenants sharing one
  fast-memory budget, each tenant one slice of the device step, with a
  fleet-level Tuna arbiter (``backend="fleet"``, one :class:`RunRecord`
  per tenant named ``"{fleet}/{tenant}"``);
* :class:`PolicySpec`: how pages are managed (a ``kind`` from
  :data:`repro_torch.tiering.policy.POLICIES` with its ``params``, plus an
  optional :class:`TunerSpec` that puts a Tuna tuner in the loop);
* :class:`Experiment`: scenarios x fm-size vector x policy specs;
* :func:`run`: executes an experiment on ``device`` (``None`` = the card)
  and returns a :class:`RunSet`.

The planner executes every spec as a batched sweep on the device step
(:mod:`repro_torch.sim.torch_engine`):

==========================  ==================================================
spec shape                  backend
==========================  ==================================================
untuned spec                one :func:`~repro_torch.sim.sweep._sweep_fm_fracs`
                            pass over the spec's size vector
                            (``backend="torch_sweep"``)
any tuner in the loop       one :func:`~repro_torch.sim.sweep._sweep_tuned`
                            pass per (kind, hot_thr, params) group; the
                            group's untuned specs ride along as plain slices
                            (``backend="torch_tuned_sweep"``)
==========================  ==================================================

Results are bit-exact against the JAX package's ``run`` on its numpy sweep
(``backend="sweep"`` / ``"tuned_sweep"`` / ``"fleet"``), fault events
(``RunRecord.fault_events``) and the fleet arbiter's log
(``RunRecord.arbiter_log``) included. What the JAX package's planner also
does waits for a later slice of the port, and raises
:class:`NotImplementedError` here: custom runners, custom pool factories
(the per-size engine) and non-batchable policy kinds. RunSet JSON, the
result cache and process fan-out wait too.
"""

from __future__ import annotations

import inspect
import json
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.trace import Trace
from repro_torch.core.tuner import TunaTuner, TunerConfig
from repro_torch.core.watermark import WatermarkController
from repro_torch.device import resolve_device
from repro_torch.sim.costmodel import HardwareProfile, OPTANE_LIKE
from repro_torch.sim.faults import FaultInjector, FaultSpec
from repro_torch.sim.sweep import SimResult, TunedSlice, _sweep_fm_fracs, _sweep_tuned
from repro_torch.tiering.policy import resolve_policy

__all__ = [
    "Experiment",
    "PolicySpec",
    "RunRecord",
    "RunSet",
    "Scenario",
    "TunerSpec",
    "run",
]

_LATER = (
    "a later slice of the port (the per-size engine, custom runners and "
    "timing in run)"
)


@dataclass(frozen=True)
class TunerSpec:
    """Declarative Tuna tuner: everything needed to construct a
    :class:`~repro_torch.core.tuner.TunaTuner` and its unbound
    :class:`~repro_torch.core.watermark.WatermarkController` inside the run
    (the performance database is passed to :func:`run`)."""

    target_loss: float = 0.05
    tune_every: int = 3  # profiling intervals per tuning step
    k_neighbors: int = 3
    cooldown_windows: int = 3
    min_fm_frac: float = 0.05
    feedback: bool = True
    feedback_margin: float = 1.0
    tuning_interval_s: float = 2.5
    # watermark-controller actuation limits
    max_step_frac: float = 0.10
    deadband_frac: float = 0.005
    db_retry_limit: int = 3
    shrink_confirm: bool = False

    def build(self, db) -> TunaTuner:
        """Construct the live tuner (controller unbound; the sweep binds it
        to its slice pool)."""
        if db is None:
            raise ValueError(
                "PolicySpec has a TunerSpec but run() was given no "
                "performance database (db=None)"
            )
        return TunaTuner(
            db,
            WatermarkController(
                max_step_frac=self.max_step_frac,
                deadband_frac=self.deadband_frac,
            ),
            TunerConfig(
                target_loss=self.target_loss,
                tuning_interval_s=self.tuning_interval_s,
                k_neighbors=self.k_neighbors,
                min_fm_frac=self.min_fm_frac,
                feedback=self.feedback,
                feedback_margin=self.feedback_margin,
                cooldown_windows=self.cooldown_windows,
                db_retry_limit=self.db_retry_limit,
                shrink_confirm=self.shrink_confirm,
            ),
        )


@dataclass(frozen=True)
class PolicySpec:
    """One page-management variant of an experiment.

    ``kind`` names a class of :data:`repro_torch.tiering.policy.POLICIES`
    (``"tpp"``, ``"admission"``, ``"thrash_guard"``); ``params`` is passed
    to its constructor. ``tuner`` puts a Tuna tuner in the loop.
    ``fm_frac`` overrides the experiment's size vector for this spec.
    Labels are the JAX package's.
    """

    kind: str = "tpp"
    hot_thr: int = 4
    tuner: TunerSpec | None = None
    fm_frac: float | None = None
    label: str | None = None
    params: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        cls = resolve_policy(self.kind)
        if self.tuner is not None and not cls.tunable:
            raise ValueError(f"policy kind {self.kind!r} is not tunable")
        if "hot_thr" in self.params:
            raise ValueError(
                "pass hot_thr via the PolicySpec.hot_thr field, not params"
            )
        accepted = set(inspect.signature(cls.__init__).parameters) - {"self"}
        unknown = sorted(set(self.params) - accepted)
        if unknown:
            raise ValueError(
                f"policy kind {self.kind!r} does not accept params {unknown}; "
                f"{cls.__qualname__} accepts {sorted(accepted - {'hot_thr'})}"
            )

    @property
    def name(self) -> str:
        if self.label is not None:
            return self.label
        base = self.kind
        if self.params:
            kv = ",".join(f"{k}={v!r}" for k, v in sorted(self.params.items()))
            base = f"{self.kind}({kv})"
        if self.tuner is not None:
            return (
                f"{base}+tuna(tau={self.tuner.target_loss:g},"
                f"every={self.tuner.tune_every})"
            )
        return base

    @property
    def policy_cls(self):
        return resolve_policy(self.kind)

    def build_policy(self):
        return self.policy_cls(hot_thr=self.hot_thr, **self.params)


@dataclass
class Scenario:
    """What to run: a trace, a workload name of
    :data:`repro_torch.sim.workloads.WORKLOADS` (generated at its defaults),
    or a zero-argument callable returning a trace; hardware, capacity and
    pool overrides.

    ``fast_only_at_full`` runs full-size slices (``fm_frac >= 1``) on
    ``trace.fast_only()``, the micro-benchmark's NP_slow = 0 baseline the
    database build needs. ``faults`` turns on the seeded fault model (one
    :class:`~repro_torch.sim.faults.FaultInjector` per constructed policy,
    identical schedules). ``runner`` and ``pool_factory`` exist so that a
    scenario of the JAX package's shape is refused by name: they wait for
    a later slice.
    """

    trace: Trace | str | Callable[[], Trace] | None = None
    name: str | None = None
    hw: HardwareProfile = OPTANE_LIKE
    hw_capacity_pages: int | None = None
    seed: int = 0
    kswapd_batch: int | None = None
    fast_only_at_full: bool = False
    faults: FaultSpec | None = None
    runner: Callable | None = None
    pool_factory: Callable | None = None

    @property
    def resolved_name(self) -> str:
        if self.name is not None:
            return self.name
        if isinstance(self.trace, Trace):
            return self.trace.name
        if isinstance(self.trace, str):
            return self.trace
        if self.trace is not None:
            f = getattr(self.trace, "func", self.trace)
            return getattr(f, "__name__", "scenario")
        return "scenario"


@dataclass
class Experiment:
    """Scenarios x fm-size vector x policy variants. ``collect_configs``
    asks the untuned sweeps for per-interval ConfigVectors (tuned sweeps
    always collect them)."""

    scenarios: Sequence[Scenario]
    fm_fracs: Sequence[float] = (1.0,)
    policies: Sequence[PolicySpec] = (PolicySpec(),)
    collect_configs: bool = False
    name: str = "experiment"


@dataclass
class RunRecord:
    """One (scenario, policy, fm size) cell of a :class:`RunSet`."""

    scenario: str
    policy: str
    fm_frac: float
    backend: str  # "torch_sweep" | "torch_tuned_sweep" | "fleet"
    result: SimResult
    decisions: list | None = None  # TunerDecision list (tuned specs)
    watermark_log: list | None = None  # WatermarkEvent list (tuned specs)
    fault_events: list | None = None  # injected-fault log (fault runs)
    # fleet runs only: the arbiter's allocation events as plain dicts
    # (shared across the fleet's tenant records)
    arbiter_log: list | None = None


@dataclass
class RunSet:
    """Result of :func:`run`: per-cell records plus provenance (spec echo,
    backends used, the device, ``chunked_step_count``)."""

    name: str
    spec: dict
    runs: list
    chunked_step_count: int = 0
    backends: tuple = ()

    def select(
        self,
        scenario: str | None = None,
        policy: str | None = None,
        fm_frac: float | None = None,
    ) -> list:
        out = []
        for r in self.runs:
            if scenario is not None and r.scenario != scenario:
                continue
            if policy is not None and r.policy != policy:
                continue
            if fm_frac is not None and abs(r.fm_frac - fm_frac) > 1e-12:
                continue
            out.append(r)
        return out

    def record(self, **kw) -> RunRecord:
        recs = self.select(**kw)
        if len(recs) != 1:
            raise KeyError(
                f"RunSet.record({kw}) matched {len(recs)} runs, expected 1"
            )
        return recs[0]

    def result(self, **kw) -> SimResult:
        return self.record(**kw).result

    def total_times(
        self, scenario: str | None = None, policy: str | None = None
    ) -> np.ndarray:
        """Total execution time of every matching run, in ``runs`` order."""
        return np.array([r.result.total_time for r in self.select(scenario, policy)])


def _resolve_trace(scenario: Scenario) -> Trace:
    """The scenario's trace; an unknown workload name raises ``KeyError``."""
    tr = scenario.trace
    if isinstance(tr, Trace):
        return tr
    if isinstance(tr, str):
        from repro_torch.sim.workloads import WORKLOADS

        return WORKLOADS[tr]()
    return tr()


def _spec_fracs(spec: PolicySpec, fm_fracs: tuple) -> tuple:
    return (float(spec.fm_frac),) if spec.fm_frac is not None else fm_fracs


def _effective_fm(cap: int, frac: float) -> int:
    # Watermarks.for_size clamping: what effective_fm_size reports all run
    return int(max(1, min(cap, int(round(frac * cap)))))


def _run_scenario(scenario, fm_fracs, policies, db, collect_configs, device):
    """Every (policy, size) cell of one scenario, in (policy-major, size)
    order, plus the sweeps' chunked-loop count."""
    if getattr(scenario, "is_fleet", False):
        from repro_torch.fleet.runner import run_fleet_scenario

        return run_fleet_scenario(
            scenario, fm_fracs, policies, db, collect_configs, device=device
        )
    sname = scenario.resolved_name
    trace = _resolve_trace(scenario)
    cap = int(scenario.hw_capacity_pages or trace.rss_pages)
    common = dict(
        hw=scenario.hw,
        hw_capacity_pages=scenario.hw_capacity_pages,
        seed=scenario.seed,
        kswapd_batch=scenario.kswapd_batch,
        device=device,
    )

    def is_full(f: float) -> bool:
        return scenario.fast_only_at_full and f >= 1.0 - 1e-9

    def with_injector(policy):
        # one injector per constructed policy instance: identical seeded
        # schedules, independent per-pool state
        if scenario.faults is not None:
            policy.fault_injector = FaultInjector(scenario.faults)
        return policy

    cells: dict = {}
    chunked = 0
    groups: dict = {}  # (kind, hot_thr, params-json) -> [(pi, spec)]
    for pi, spec in enumerate(policies):
        key = (spec.kind, spec.hot_thr, json.dumps(spec.params, sort_keys=True))
        groups.setdefault(key, []).append((pi, spec))

    for group in groups.values():
        if any(spec.tuner is not None for _, spec in group):
            # one tuned sweep per trace variant carries the whole group;
            # untuned specs ride along as tuner-free slices
            policy = with_injector(group[0][1].build_policy())
            inj = policy.fault_injector
            by_variant: dict = {}
            for pi, spec in group:
                for fi, f in enumerate(_spec_fracs(spec, fm_fracs)):
                    tuner = spec.tuner.build(db) if spec.tuner is not None else None
                    te = spec.tuner.tune_every if spec.tuner is not None else None
                    slices, keys = by_variant.setdefault(is_full(f), ([], []))
                    slices.append(TunedSlice(float(f), tuner, te))
                    keys.append((pi, fi, float(f), spec, tuner))
            for full, (slices, keys) in by_variant.items():
                flog = [] if inj is not None else None
                results = _sweep_tuned(
                    trace.fast_only() if full else trace, slices,
                    policy=policy, faults=inj, fault_log=flog, **common,
                )
                for si, ((pi, fi, f, spec, tuner), res) in enumerate(
                    zip(keys, results)
                ):
                    cells[(pi, fi)] = RunRecord(
                        sname, spec.name, f, "torch_tuned_sweep", res,
                        decisions=(
                            None if tuner is None else list(tuner.decisions)
                        ),
                        watermark_log=(
                            None if tuner is None else list(tuner.controller.log)
                        ),
                        fault_events=None if flog is None else flog[si],
                    )
            chunked += policy.chunked_steps
            continue
        for pi, spec in group:
            policy = with_injector(spec.build_policy())
            inj = policy.fault_injector
            farr = np.asarray(_spec_fracs(spec, fm_fracs), dtype=np.float64)
            full = np.array([is_full(f) for f in farr], dtype=bool)
            parts = []
            if full.any():
                parts.append((np.flatnonzero(full), trace.fast_only()))
            if not full.all():
                parts.append((np.flatnonzero(~full), trace))
            for idxs, tr in parts:
                flog = [] if inj is not None else None
                res = _sweep_fm_fracs(
                    tr, farr[idxs], collect_configs=collect_configs,
                    policy=policy, faults=inj, fault_log=flog, **common,
                )
                for j, fi in enumerate(idxs):
                    f = float(farr[fi])
                    times = res.interval_times[j]
                    cells[(pi, int(fi))] = RunRecord(
                        sname, spec.name, f, "torch_sweep",
                        SimResult(
                            name=res.name,
                            total_time=float(np.sum(times)),
                            interval_times=times.copy(),
                            configs=res.configs[j] if res.configs is not None else [],
                            fm_sizes=np.full(times.size, _effective_fm(cap, f), dtype=np.int64),
                            stats=res.stats[j],
                            costs=list(res.costs[j]),
                        ),
                        fault_events=None if flog is None else flog[j],
                    )
            chunked += policy.chunked_steps
    records = [
        cells[(pi, fi)]
        for pi, spec in enumerate(policies)
        for fi in range(len(_spec_fracs(spec, fm_fracs)))
    ]
    return records, chunked


def _refuse_later_slices(scenarios) -> None:
    for sc in scenarios:
        if getattr(sc, "is_fleet", False):
            continue  # tenants carry traces; the fleet runner checks them
        name = sc.resolved_name
        if sc.faults is not None and not isinstance(sc.faults, FaultSpec):
            raise TypeError(
                f"scenario {name!r}: faults must be a FaultSpec, got "
                f"{type(sc.faults).__name__}"
            )
        if sc.runner is not None:
            raise NotImplementedError(
                f"scenario {name!r}: custom runners wait for {_LATER}"
            )
        if sc.pool_factory is not None:
            raise NotImplementedError(
                f"scenario {name!r}: custom pool factories (the per-size "
                f"engine) wait for {_LATER}"
            )
        if sc.trace is None:
            raise ValueError(f"scenario {name!r} has no trace")


def run(experiment: Experiment, db=None, device=None) -> RunSet:
    """Execute ``experiment`` on ``device`` and return a :class:`RunSet`.

    ``device=None`` runs on the card and raises when no GPU is present;
    ``device="cpu"`` runs the plain PyTorch path (what the CPU tests do).
    ``db`` is the :class:`~repro_torch.core.perfdb.PerfDB` tuned specs
    query (required iff a :class:`PolicySpec` carries a
    :class:`TunerSpec`). Scenarios run one after another.
    """
    dev = resolve_device(device)
    scenarios = list(experiment.scenarios)
    if not scenarios:
        raise ValueError("Experiment needs at least one scenario")
    fm_fracs = tuple(float(f) for f in experiment.fm_fracs)
    if not fm_fracs:
        raise ValueError("Experiment needs at least one fm fraction")
    policies = tuple(experiment.policies)
    if not policies:
        raise ValueError("Experiment needs at least one policy spec")
    _refuse_later_slices(scenarios)
    names = [sc.resolved_name for sc in scenarios]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate scenario names: {names}")
    pnames = [p.name for p in policies]
    if len(set(pnames)) != len(pnames):
        raise ValueError(f"duplicate policy labels: {pnames}")
    if db is None and any(p.tuner is not None for p in policies):
        raise ValueError(
            "experiment has tuned policy specs but no performance database "
            "was passed to run(db=...)"
        )
    runs, chunked = [], 0
    for sc in scenarios:
        records, c = _run_scenario(
            sc, fm_fracs, policies, db, experiment.collect_configs, dev
        )
        runs.extend(records)
        chunked += c
    return RunSet(
        name=experiment.name,
        spec={
            "name": experiment.name,
            "fm_fracs": list(fm_fracs),
            "collect_configs": bool(experiment.collect_configs),
            "scenarios": names,
            "policies": pnames,
            "device": str(dev),
        },
        runs=runs,
        chunked_step_count=chunked,
        backends=tuple(sorted({r.backend for r in runs})),
    )
