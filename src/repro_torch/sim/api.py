"""The port's experiment API: describe runs as data, execute them on the card.

Counterpart of :mod:`repro.sim.api`:

* :class:`Scenario`: what to run (a trace, a workload name of
  :data:`repro_torch.sim.workloads.WORKLOADS`, or a zero-argument callable
  returning a trace; the hardware profile and fast-tier capacity; pool
  overrides, ``pool_factory`` among them; ``fast_only_at_full`` for the
  micro-benchmark's NP_slow = 0 baseline at full size; ``faults``, a
  :class:`~repro_torch.sim.faults.FaultSpec` that turns on the seeded
  fault model; or a custom ``runner`` in place of the simulator, such as
  the timing lane's :func:`repro_torch.timing.timing_runner`, with its
  JSON knobs in ``params``);
* :class:`repro_torch.fleet.FleetScenario`: N tenants sharing one
  fast-memory budget, each tenant one slice of the device step, with a
  fleet-level Tuna arbiter (``backend="fleet"``, one :class:`RunRecord`
  per tenant named ``"{fleet}/{tenant}"``);
* :class:`PolicySpec`: how pages are managed (a ``kind`` from
  :data:`repro_torch.tiering.policy.POLICIES`, which
  :func:`~repro_torch.tiering.policy.register_policy` extends, with its
  ``params``, plus an optional :class:`TunerSpec` that puts a Tuna tuner
  in the loop);
* :class:`Experiment`: scenarios x fm-size vector x policy specs;
* :func:`run`: executes an experiment on ``device`` (``None`` = the card)
  and returns a :class:`RunSet`.

The planner picks the backend of each spec from what the device step
replicates (:func:`repro_torch.tiering.policy.device_kind`), never from a
kind string:

==========================  ==================================================
spec shape                  backend
==========================  ==================================================
untuned spec of a kind the  one :func:`~repro_torch.sim.sweep._sweep_fm_fracs`
device step replicates      pass over the spec's size vector
                            (``backend="torch_sweep"``)
any tuner in the loop       one :func:`~repro_torch.sim.sweep._sweep_tuned`
                            pass per (kind, hot_thr, params) group; the
                            group's untuned specs ride along as plain slices
                            (``backend="torch_tuned_sweep"``)
any other class (a plug-in  one per-size :func:`repro_torch.sim.engine.
overriding a hook), and     _simulate` per (spec, size) on the host, with the
every spec of a             scenario's pool (``TieredPagePool`` by default)
``pool_factory`` scenario   and ``kswapd_batch`` bound into the factory
                            (``backend="simulate"``)
``Scenario.runner``         ``runner(scenario, fm_frac, policy_spec, db)``
                            per (spec, size) (``backend="custom"``)
==========================  ==================================================

Results are bit-exact against the JAX package's ``run`` (its numpy sweep,
``backend="sweep"`` / ``"tuned_sweep"`` / ``"fleet"``, and its per-size
engine, ``"simulate"``, which also runs its ``first_touch`` specs), fault
events (``RunRecord.fault_events``) and the fleet arbiter's log
(``RunRecord.arbiter_log``) included.

Process fan-out, as in the JAX package: ``parallelism=None`` is serial
below 12 scenarios, else one worker per core. A scenario that raises in a
worker is re-raised as :class:`ScenarioExecutionError` naming it;
``scenario_timeout`` bounds each scenario's seconds; specs are checked
picklable before anything is submitted. Workers start by spawn whenever
the run's device is CUDA or CUDA is already initialised in the parent
(a forked child of a live CUDA context cannot use the card); fork remains
for ``device="cpu"`` in a parent that never touched CUDA. Each worker gets
the device as a string and the specs' policy classes in its job, and
re-registers them. On the card the kernels are built in the parent
before any worker starts. :attr:`RunSet.fanout` says which process ran
each scenario (``None`` for a serial run).

RunSet JSON (:meth:`RunSet.to_json` / :meth:`RunSet.from_json`) is the
JAX package's ``tuna-runset-v4`` document, losslessly (floats round-trip
through ``repr``); v1 to v3 documents still load. A document of either
package loads in the other. Two things differ: the backend labels
(``torch_sweep`` / ``torch_tuned_sweep`` for ``sweep`` / ``tuned_sweep``)
and the spec's ``device`` entry, which the JAX package does not write.

``run(cache_dir=...)`` memoizes the whole RunSet as its JSON document,
keyed on a hash of the spec echo (``device`` left out: every device gives
the same bits) and the schema. A factory argument with no stable identity
(a default, address-bearing repr) refuses the cache; a corrupt entry is
recomputed and rewritten; a hit runs nothing.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import hashlib
import inspect
import json
import multiprocessing as mp
import os
import pickle
import re
import uuid
from dataclasses import asdict, dataclass, field
from dataclasses import fields as dataclass_fields
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.telemetry import ConfigVector
from repro_torch.core.trace import Trace
from repro_torch.core.tuner import TunaTuner, TunerConfig, TunerDecision
from repro_torch.core.watermark import WatermarkController, WatermarkEvent
from repro_torch.device import resolve_device
from repro_torch.sim.costmodel import HardwareProfile, IntervalCosts, OPTANE_LIKE
from repro_torch.sim.engine import _simulate
from repro_torch.sim.faults import FaultInjector, FaultSpec
from repro_torch.sim.sweep import SimResult, TunedSlice, _sweep_fm_fracs, _sweep_tuned
from repro_torch.tiering.page_pool import TieredPagePool
from repro_torch.tiering.policy import device_kind, register_policy, resolve_policy

RUNSET_SCHEMA = "tuna-runset-v4"
# older schema versions from_json still understands (additive evolution)
RUNSET_SCHEMA_COMPAT = (
    "tuna-runset-v1",
    "tuna-runset-v2",
    "tuna-runset-v3",
    RUNSET_SCHEMA,
)
# spec entries that do not change a result, left out of the cache key
CACHE_NEUTRAL = ("device",)

__all__ = [
    "Experiment",
    "PolicySpec",
    "RunRecord",
    "RunSet",
    "RUNSET_SCHEMA",
    "Scenario",
    "ScenarioExecutionError",
    "TunerSpec",
    "run",
]


class ScenarioExecutionError(RuntimeError):
    """A scenario failed (or timed out) during :func:`run` fan-out.

    Carries the failing scenario's name and its spec echo; the worker's
    exception rides along as ``__cause__``.
    """


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
    (``"tpp"``, ``"admission"``, ``"thrash_guard"``, ``"first_touch"``, or
    a kind a caller registered); ``params`` is passed to its constructor
    and echoed in the RunSet JSON. ``tuner`` puts a Tuna tuner in the loop.
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
            raise ValueError(
                f"policy kind {self.kind!r} ({cls.__qualname__}) is not "
                "tunable (registry tunable=False); tuners require a kind "
                "whose registered class sets tunable=True"
            )
        if "hot_thr" in self.params:
            raise ValueError(
                "pass hot_thr via the PolicySpec.hot_thr field, not params"
            )
        sig = inspect.signature(cls.__init__)
        if any(p.kind is p.VAR_KEYWORD for p in sig.parameters.values()):
            return
        accepted = set(sig.parameters) - {"self"}
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
    identical schedules). ``pool_factory`` builds the host pool of the
    per-size engine for every (spec, size) (``backend="simulate"``; the
    JAX package's ``ReferencePagePool`` is the golden model).
    ``runner(scenario, fm_frac, policy_spec, db) -> dict`` swaps the whole
    execution engine (``backend="custom"``); ``params`` carries its
    JSON-serialisable knobs. Bind a runner's other knobs, its device
    included, with :func:`functools.partial`. A callable in any field
    must be picklable (a module-level function or a partial of one) for
    the process fan-out.
    """

    trace: Trace | str | Callable[[], Trace] | None = None
    name: str | None = None
    hw: HardwareProfile = OPTANE_LIKE
    hw_capacity_pages: int | None = None
    seed: int = 0
    kswapd_batch: int | None = None
    pool_factory: Callable | None = None
    fast_only_at_full: bool = False
    runner: Callable | None = None
    params: dict = field(default_factory=dict)
    faults: FaultSpec | None = None

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
    backend: str  # "torch_sweep" | "torch_tuned_sweep" | "fleet" |
    # "simulate" | "custom"
    result: SimResult | dict
    decisions: list | None = None  # TunerDecision list (tuned specs)
    watermark_log: list | None = None  # WatermarkEvent list (tuned specs)
    fault_events: list | None = None  # injected-fault log (fault runs)
    # fleet runs only: the arbiter's allocation events as plain dicts
    # (shared across the fleet's tenant records)
    arbiter_log: list | None = None


@dataclass
class RunSet:
    """Result of :func:`run`: per-cell records plus provenance (spec echo,
    backends used, the device, ``chunked_step_count``). Lossless
    ``to_json``/``from_json`` (the JAX package's schema).

    ``fanout`` is how this call executed, not part of the result: ``None``
    for a serial run (and for a RunSet read from JSON or the cache), else
    one ``{"scenario", "pid", "peak_hbm_bytes", "launches"}`` per scenario:
    the worker process that ran it, that worker's peak allocated device
    memory so far (``None`` on the CPU) and the kernel launches the
    scenario made there, by kernel (:func:`repro_torch.kernels.
    launch_counts`)."""

    name: str
    spec: dict
    runs: list
    chunked_step_count: int = 0
    backends: tuple = ()
    fanout: list | None = field(default=None, compare=False)

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

    def results(self, **kw) -> list:
        return [r.result for r in self.select(**kw)]

    def total_times(
        self, scenario: str | None = None, policy: str | None = None
    ) -> np.ndarray:
        """Total execution time of every matching run, in ``runs`` order.

        Simulator runs give ``SimResult.total_time``. Custom-runner payloads
        take part by the **interval-times protocol**: a payload ``dict``
        with ``"total_time"`` (preferred) or ``"interval_times"`` (summed).
        A payload with neither raises.
        """
        out = []
        for r in self.select(scenario, policy):
            res = r.result
            if isinstance(res, SimResult):
                out.append(res.total_time)
            elif isinstance(res, dict) and "total_time" in res:
                out.append(float(res["total_time"]))
            elif isinstance(res, dict) and "interval_times" in res:
                out.append(float(np.sum(res["interval_times"])))
            else:
                raise TypeError(
                    f"total_times() needs simulator results or payloads "
                    f"with 'total_time'/'interval_times'; run "
                    f"{r.scenario!r}/{r.policy!r} has backend={r.backend!r}"
                )
        return np.array(out)

    # ----------------------------------------------------- serialization
    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(
            {
                "schema": RUNSET_SCHEMA,
                "name": self.name,
                "spec": self.spec,
                "chunked_step_count": int(self.chunked_step_count),
                "backends": list(self.backends),
                "runs": [
                    {
                        "scenario": r.scenario,
                        "policy": r.policy,
                        "fm_frac": r.fm_frac,
                        "backend": r.backend,
                        "result": _result_to_dict(r.result),
                        "decisions": (
                            None
                            if r.decisions is None
                            else [_decision_to_dict(d) for d in r.decisions]
                        ),
                        "watermark_log": (
                            None
                            if r.watermark_log is None
                            else [asdict(e) for e in r.watermark_log]
                        ),
                        "fault_events": r.fault_events,
                        "arbiter_log": r.arbiter_log,
                    }
                    for r in self.runs
                ],
            },
            indent=indent,
        )

    @classmethod
    def from_json(cls, text: str) -> "RunSet":
        d = json.loads(text)
        if d.get("schema") not in RUNSET_SCHEMA_COMPAT:
            raise ValueError(f"unknown RunSet schema: {d.get('schema')!r}")
        runs = [
            RunRecord(
                scenario=r["scenario"],
                policy=r["policy"],
                fm_frac=float(r["fm_frac"]),
                backend=r["backend"],
                result=_result_from_dict(r["result"]),
                decisions=(
                    None
                    if r["decisions"] is None
                    else [_decision_from_dict(x) for x in r["decisions"]]
                ),
                watermark_log=(
                    None
                    if r["watermark_log"] is None
                    else [WatermarkEvent(**x) for x in r["watermark_log"]]
                ),
                fault_events=r.get("fault_events"),
                arbiter_log=r.get("arbiter_log"),
            )
            for r in d["runs"]
        ]
        return cls(
            name=d["name"],
            spec=d["spec"],
            runs=runs,
            chunked_step_count=int(d["chunked_step_count"]),
            backends=tuple(d["backends"]),
        )


def _result_to_dict(res) -> dict:
    if isinstance(res, SimResult):
        return {
            "kind": "sim",
            "name": res.name,
            "total_time": float(res.total_time),
            "interval_times": [float(x) for x in res.interval_times],
            "fm_sizes": [int(x) for x in res.fm_sizes],
            "configs": [c.to_dict() for c in res.configs],
            "stats": {k: int(v) for k, v in res.stats.items()},
            "costs": [asdict(c) for c in res.costs],
        }
    return {"kind": "custom", "payload": res}


def _result_from_dict(d: dict):
    if d["kind"] == "custom":
        return d["payload"]
    return SimResult(
        name=d["name"],
        total_time=float(d["total_time"]),
        interval_times=np.array(d["interval_times"], dtype=np.float64),
        configs=[ConfigVector(**c) for c in d["configs"]],
        fm_sizes=np.array(d["fm_sizes"], dtype=np.int64),
        stats=dict(d["stats"]),
        costs=[IntervalCosts(**c) for c in d["costs"]],
    )


def _decision_to_dict(d: TunerDecision) -> dict:
    return {
        "t": d.t,
        "config": None if d.config is None else d.config.to_dict(),
        "fm_frac": d.fm_frac,
        "fm_pages": d.fm_pages,
        "predicted_loss": d.predicted_loss,
        "degraded": d.degraded,
    }


def _decision_from_dict(d: dict) -> TunerDecision:
    return TunerDecision(
        t=d["t"],
        config=None if d["config"] is None else ConfigVector(**d["config"]),
        fm_frac=d["fm_frac"],
        fm_pages=d["fm_pages"],
        predicted_loss=d["predicted_loss"],
        degraded=d.get("degraded"),
    )


# ----------------------------------------------------------------- planner


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


def _run_scenario(scenario, fm_fracs, policies, db, collect_configs,
                  device=None, policy_classes: tuple = ()):
    """Every (policy, size) cell of one scenario, in (policy-major, size)
    order, plus the sweeps' chunked-loop count.

    Module-level so the process fan-out can pickle it. ``policy_classes``
    are the specs' resolved classes: a spawned worker imports
    :mod:`repro_torch` but not the module that registered a plug-in kind,
    so the classes ride the job (pickled by reference, which imports their
    module) and are registered here before any spec resolves.
    """
    for cls in policy_classes:
        register_policy(cls)
    if getattr(scenario, "is_fleet", False):
        from repro_torch.fleet.runner import run_fleet_scenario

        return run_fleet_scenario(
            scenario, fm_fracs, policies, db, collect_configs, device=device
        )
    sname = scenario.resolved_name
    if scenario.runner is not None:
        records = [
            RunRecord(sname, spec.name, float(f), "custom",
                      scenario.runner(scenario, float(f), spec, db))
            for spec in policies
            for f in _spec_fracs(spec, fm_fracs)
        ]
        return records, 0
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

    # partition: the per-size engine takes a custom pool and every class
    # the device step does not replicate; the rest group per constructed
    # policy identity (kind, hot_thr, params)
    cells: dict = {}
    chunked = 0
    per_size: list = []  # (pi, spec)
    groups: dict = {}  # (kind, hot_thr, params-json) -> [(pi, spec)]
    for pi, spec in enumerate(policies):
        if scenario.pool_factory is not None or device_kind(spec.policy_cls) is None:
            per_size.append((pi, spec))
            continue
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
                    tr, farr[idxs],
                    # the JAX package runs first touch on its per-size
                    # engine, which always collects the ConfigVectors
                    collect_configs=collect_configs or not spec.policy_cls.migrates,
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

    for (pi, spec), recs in zip(per_size, _run_per_size(
            scenario, trace, fm_fracs, [s for _, s in per_size], db)):
        for fi, rec in enumerate(recs):
            cells[(pi, fi)] = rec
    records = [
        cells[(pi, fi)]
        for pi, spec in enumerate(policies)
        for fi in range(len(_spec_fracs(spec, fm_fracs)))
    ]
    return records, chunked


def _run_per_size(scenario, trace, fm_fracs, policies, db) -> list:
    """Every size of each spec through the per-size engine on the host, one
    list of records a spec (in size order), over the scenario's
    ``pool_factory`` or the default :class:`TieredPagePool`."""
    sname = scenario.resolved_name
    pool_factory = scenario.pool_factory or TieredPagePool
    if scenario.kswapd_batch is not None:
        pool_factory = functools.partial(
            pool_factory, kswapd_batch=scenario.kswapd_batch
        )
    out = []
    for spec in policies:
        records = []
        for f in _spec_fracs(spec, fm_fracs):
            f = float(f)
            tuner = spec.tuner.build(db) if spec.tuner is not None else None
            inj = FaultInjector(scenario.faults) if scenario.faults is not None else None
            full = scenario.fast_only_at_full and f >= 1.0 - 1e-9
            res = _simulate(
                trace.fast_only() if full else trace,
                fm_frac=f,
                policy=spec.build_policy(),
                hw=scenario.hw,
                hw_capacity_pages=scenario.hw_capacity_pages,
                tuner=tuner,
                tune_every=spec.tuner.tune_every if spec.tuner is not None else None,
                seed=scenario.seed,
                pool_factory=pool_factory,
                faults=inj,
            )
            records.append(RunRecord(
                sname, spec.name, f, "simulate", res,
                decisions=None if tuner is None else list(tuner.decisions),
                watermark_log=None if tuner is None else list(tuner.controller.log),
                fault_events=None if inj is None else inj.all_events(),
            ))
        out.append(records)
    return out


def _run_scenario_star(args):
    return _run_scenario(*args)


def _run_scenario_trapped(args):
    """Fan-out wrapper: a job's exception comes back as a value, so the
    parent tells a failing job (re-raise it) from a failing executor (fall
    back to serial). The value also says which process ran the job, its
    peak device memory so far and the kernels the job launched."""
    from repro_torch.kernels import launch_counts

    sc, device = args[0], args[5]
    before = launch_counts()
    try:
        out = _run_scenario(*args)
    except Exception as e:  # noqa: BLE001 - transported, re-raised in parent
        try:
            echo = json.dumps(_scenario_ref(sc), sort_keys=True)
        except Exception:  # noqa: BLE001 - echo is best-effort diagnostics
            echo = "<unserializable scenario spec>"
        return "err", (sc.resolved_name, echo, e)
    peak = None
    if torch.device(device).type == "cuda":
        peak = int(torch.cuda.max_memory_allocated())
    launches = {k: n - before[k] for k, n in launch_counts().items() if n > before[k]}
    return "ok", (out, {"scenario": sc.resolved_name, "pid": os.getpid(),
                        "peak_hbm_bytes": peak, "launches": launches})


# ------------------------------------------------------------- spec echo


def _qualname(obj) -> str | None:
    if obj is None:
        return None
    f = getattr(obj, "func", obj)  # unwrap functools.partial
    if not hasattr(f, "__qualname__"):
        f = type(f)  # instance-based callable: name its class, not its id
    return f"{getattr(f, '__module__', '')}.{f.__qualname__}"


def _arg_ref(v):
    """Deterministic, JSON-serialisable identity of a factory-bound
    argument: arrays by a digest of their whole contents, and a default
    (address-bearing) repr as a marker that :func:`run` refuses to cache."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, np.ndarray):
        return {
            "ndarray": hashlib.sha256(
                np.ascontiguousarray(v).tobytes()
            ).hexdigest()[:16],
            "dtype": str(v.dtype),
            "shape": list(v.shape),
        }
    if isinstance(v, (list, tuple)):
        return [_arg_ref(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _arg_ref(x) for k, x in sorted(v.items())}
    r = repr(v)
    if " at 0x" in r:
        return f"<unidentified:{type(v).__module__}.{type(v).__qualname__}>"
    return r


def _callable_ref(obj) -> dict | str | None:
    """Spec-echo identity of a factory or runner: a partial's bound
    arguments are part of it."""
    if obj is None:
        return None
    if isinstance(obj, functools.partial):
        return {
            "factory": _qualname(obj),
            "args": [_arg_ref(a) for a in obj.args],
            "keywords": {
                k: _arg_ref(v) for k, v in sorted(obj.keywords.items())
            },
        }
    return _qualname(obj)


def _trace_ref(trace) -> dict | str | None:
    if isinstance(trace, Trace):
        return {"name": trace.name, "rss_pages": int(trace.rss_pages)}
    if isinstance(trace, str):
        return trace
    return _callable_ref(trace)


def _scenario_ref(sc) -> dict:
    """One scenario's spec echo (provenance, cache key, error reports)."""
    if getattr(sc, "is_fleet", False):
        return {
            "name": sc.resolved_name,
            "seed": int(sc.seed),
            "hw": asdict(sc.hw),
            "kswapd_batch": sc.kswapd_batch,
            "faults": sc.faults.to_dict() if sc.faults is not None else None,
            "fleet": {
                "budget_frac": float(sc.budget_frac),
                "arbiter": asdict(sc.arbiter),
                "tenants": [
                    {
                        "name": t.resolved_name,
                        "trace": _trace_ref(t.trace),
                        "share": t.share,
                        "floor_frac": float(t.floor_frac),
                        "ceil_frac": float(t.ceil_frac),
                    }
                    for t in sc.tenants
                ],
            },
        }
    return {
        "name": sc.resolved_name,
        "trace": _trace_ref(sc.trace),
        "seed": int(sc.seed),
        "hw": asdict(sc.hw),
        "hw_capacity_pages": sc.hw_capacity_pages,
        "kswapd_batch": sc.kswapd_batch,
        "pool_factory": _callable_ref(sc.pool_factory),
        "fast_only_at_full": bool(sc.fast_only_at_full),
        "runner": _callable_ref(sc.runner),
        "params": sc.params,
        "faults": sc.faults.to_dict() if sc.faults is not None else None,
    }


def _experiment_spec(experiment: Experiment, fm_fracs: tuple, policies: tuple,
                     db, dev) -> dict:
    return {
        "name": experiment.name,
        "fm_fracs": list(fm_fracs),
        "collect_configs": bool(experiment.collect_configs),
        "scenarios": [_scenario_ref(sc) for sc in experiment.scenarios],
        "policies": [
            {
                "label": p.name,
                "kind": p.kind,
                "hot_thr": int(p.hot_thr),
                "fm_frac": p.fm_frac,
                "params": dict(p.params),
                "tuner": asdict(p.tuner) if p.tuner is not None else None,
            }
            for p in policies
        ],
        "db_records": (
            len(db.records) if db is not None and hasattr(db, "records") else None
        ),
        "device": str(dev),
    }


# ---------------------------------------------------------------- fan-out


def _unpicklable_fields(spec_obj) -> list[str]:
    bad = []
    for f in dataclass_fields(spec_obj):
        try:
            pickle.dumps(getattr(spec_obj, f.name))
        except Exception:  # noqa: BLE001 - any pickle failure disqualifies
            bad.append(f.name)
    return bad


def _validate_picklable(scenarios, policies) -> None:
    """Fail fast, naming the field, on a spec that cannot cross into a
    fan-out worker (a lambda or closure as a trace, pool factory or
    runner), instead of an opaque ``PicklingError`` inside the pool."""
    for kind, objs, name_of in (
        ("scenario", scenarios, lambda o: o.resolved_name),
        ("policy spec", policies, lambda o: o.name),
    ):
        for obj in objs:
            try:
                pickle.dumps(obj)
            except Exception as e:  # noqa: BLE001 - report any failure
                bad = _unpicklable_fields(obj) or ["<whole object>"]
                raise ScenarioExecutionError(
                    f"{kind} {name_of(obj)!r} cannot be pickled into a "
                    f"fan-out worker: offending field(s) {bad} "
                    f"({type(e).__name__}: {e}). Use a module-level "
                    "function or functools.partial instead of a lambda/"
                    "closure, or force serial execution with "
                    "parallelism=1"
                ) from e


def _resolve_start_method(requested, cuda: bool, available):
    """The fan-out workers' multiprocessing start method.

    ``cuda`` says the run's device is CUDA or CUDA is initialised in the
    parent: a forked child inherits a CUDA context it cannot use, so the
    fan-out spawns, and an explicit ``"fork"`` raises. Otherwise an
    explicit request wins when available, and the default is fork, which
    spares each worker the interpreter and torch imports. Returns a method
    name from ``available``, or ``None`` for the platform default.
    """
    if requested is not None:
        if requested not in available:
            raise ValueError(
                f"mp_start_method {requested!r} is not available on this "
                f"platform (available: {list(available)})"
            )
        if cuda and requested == "fork":
            raise ValueError(
                "mp_start_method 'fork' cannot serve a CUDA run: a forked "
                "child of a parent with CUDA in use cannot use the card; "
                "use 'spawn'"
            )
        return requested
    if cuda:
        return "spawn" if "spawn" in available else None
    return "fork" if "fork" in available else None


def _fanout(jobs: list, parallelism: int, scenario_timeout: float | None,
            start_method: str | None = None):
    """Submit-based process fan-out over scenario jobs.

    Returns the jobs' trapped ``("ok" | "err", ...)`` values in job order,
    or ``None`` when processes cannot start (a sandbox, or the executor
    broke twice); the caller then runs serially.

    * ``scenario_timeout`` bounds each job's seconds; a hung worker raises
      :class:`ScenarioExecutionError` naming the scenario, and the
      executor is abandoned without joining it.
    * A broken executor (a worker killed for memory) gets one fresh
      executor for the jobs that did not finish; finished results stay.
    * A job's own exception is a value, never a retry or a serial run.
    """
    try:
        ctx = mp.get_context(start_method)
    except ValueError:
        return None
    results: list = [None] * len(jobs)
    pending = list(range(len(jobs)))
    for _attempt in range(2):
        try:
            pool = cf.ProcessPoolExecutor(parallelism, mp_context=ctx,
                                          initializer=_worker_init)
        except (OSError, ValueError):
            return None  # sandboxed / restricted env: serial fallback
        futs = {i: pool.submit(_run_scenario_trapped, jobs[i]) for i in pending}
        broken = False
        timed_out: int | None = None
        for i, fut in futs.items():
            try:
                results[i] = fut.result(timeout=scenario_timeout)
            except cf.TimeoutError:
                # before OSError: since 3.11 cf.TimeoutError is the builtin
                # TimeoutError, an OSError subclass
                timed_out = i
                break
            except (OSError, cf.process.BrokenProcessPool):
                broken = True
                break
        if timed_out is not None:
            # a hung worker ignores cancellation: end the workers, so the
            # run leaves no process behind
            _kill_workers(pool)
        # never shutdown(wait=True): a hung or dying worker would block
        # the parent on join
        pool.shutdown(wait=False, cancel_futures=True)
        if timed_out is not None:
            name = jobs[timed_out][0].resolved_name
            raise ScenarioExecutionError(
                f"scenario {name!r} did not finish within "
                f"scenario_timeout={scenario_timeout:g}s in a fan-out worker"
            )
        if not broken:
            return results
        # keep what finished before the executor died, resubmit the rest
        for i, fut in futs.items():
            if results[i] is None and fut.done() and not fut.cancelled():
                try:
                    results[i] = fut.result(timeout=0)
                except Exception:  # noqa: BLE001 - died with the executor
                    pass
        pending = [i for i in pending if results[i] is None]
        if not pending:
            return results
    return None


def _worker_init() -> None:
    """One intra-op thread a worker: the workers are the parallelism, and a
    forked child of a parent whose OpenMP pool has run would hang in its
    first parallel region with more than one."""
    torch.set_num_threads(1)


def _kill_workers(pool) -> None:
    for proc in list((getattr(pool, "_processes", None) or {}).values()):
        if proc.is_alive():
            proc.kill()


def _cache_path(cache_dir, name: str, spec: dict) -> Path:
    """Cache key: stable hash of the experiment spec echo (its
    :data:`CACHE_NEUTRAL` entries left out) and the RunSet schema
    version, so spec changes and schema bumps miss cleanly."""
    keyed = {k: v for k, v in spec.items() if k not in CACHE_NEUTRAL}
    digest = hashlib.sha256(
        (RUNSET_SCHEMA + "\n" + json.dumps(keyed, sort_keys=True)).encode()
    ).hexdigest()[:16]
    safe = re.sub(r"[^A-Za-z0-9._\[\]-]", "_", name)[:60]
    return Path(cache_dir) / f"runset_{safe}_{digest}.json"


def _validate(scenarios, policies) -> None:
    names = [sc.resolved_name for sc in scenarios]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate scenario names: {names}")
    pnames = [p.name for p in policies]
    if len(set(pnames)) != len(pnames):
        raise ValueError(f"duplicate policy labels: {pnames}")
    for sc in scenarios:
        name = sc.resolved_name
        if getattr(sc, "is_fleet", False):
            # tenants ride slices of the device step
            bad = [p.name for p in policies if device_kind(p.policy_cls) is None]
            if bad:
                raise ValueError(
                    f"fleet scenario {name!r} maps tenants onto slices of "
                    f"the device step; policy specs {bad} are not kinds it "
                    "replicates"
                )
            continue
        if sc.faults is not None and not isinstance(sc.faults, FaultSpec):
            raise TypeError(
                f"scenario {name!r}: faults must be a FaultSpec, got "
                f"{type(sc.faults).__name__}"
            )
        if sc.trace is None and sc.runner is None:
            raise ValueError(f"scenario {name!r} has neither trace nor runner")
        try:
            json.dumps(sc.params, sort_keys=True)
        except TypeError as e:
            raise ValueError(
                f"scenario {name!r} has non-JSON-serializable params "
                f"(they are echoed in the RunSet provenance): {e}"
            ) from None
    for p in policies:
        try:
            json.dumps(p.params, sort_keys=True)
        except TypeError as e:
            raise ValueError(
                f"policy spec {p.name!r} has non-JSON-serializable params "
                f"(they are echoed in the RunSet provenance): {e}"
            ) from None


def run(
    experiment: Experiment,
    db=None,
    parallelism: int | None = None,
    cache_dir=None,
    scenario_timeout: float | None = None,
    mp_start_method: str | None = None,
    device=None,
) -> RunSet:
    """Execute ``experiment`` on ``device`` and return a :class:`RunSet`.

    ``device=None`` runs on the card and raises when no GPU is present;
    ``device="cpu"`` runs the plain PyTorch path (what the CPU tests do).
    ``db`` is the :class:`~repro_torch.core.perfdb.PerfDB` tuned specs
    query (required iff a :class:`PolicySpec` carries a
    :class:`TunerSpec`). ``parallelism`` fans scenarios out across
    processes (``None``: serial below 12 scenarios, else one worker per
    core; serial where processes cannot start); ``scenario_timeout``
    bounds each fanned-out scenario's seconds; ``mp_start_method`` pins
    the workers' start method (see :func:`_resolve_start_method`).
    ``cache_dir`` memoizes the RunSet as its JSON document (module
    docstring).
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
    _validate(scenarios, policies)
    if db is None and any(p.tuner is not None for p in policies):
        raise ValueError(
            "experiment has tuned policy specs but no performance database "
            "was passed to run(db=...)"
        )

    spec = _experiment_spec(experiment, fm_fracs, policies, db, dev)
    cache_file = None
    if cache_dir is not None:
        if '"<unidentified:' in json.dumps(spec, sort_keys=True):
            # a bound object with a default repr has no stable identity:
            # two different experiments could share an entry
            raise ValueError(
                "cache_dir requires every factory-bound argument to have "
                "a stable identity; a bound object with a default repr "
                "cannot be keyed (give it a __repr__, or drop cache_dir): "
                + json.dumps(spec["scenarios"])
            )
        cache_file = _cache_path(cache_dir, experiment.name, spec)
        if cache_file.exists():
            try:
                return RunSet.from_json(cache_file.read_text())
            except (ValueError, KeyError, TypeError):
                pass  # a truncated or corrupt entry: recompute, overwrite

    policy_classes = tuple({p.kind: p.policy_cls for p in policies}.values())
    jobs = [
        (sc, fm_fracs, policies, db, experiment.collect_configs, str(dev),
         policy_classes)
        for sc in scenarios
    ]
    if parallelism is None:
        parallelism = 1 if len(jobs) < 12 else (os.cpu_count() or 1)
    parallelism = max(1, min(int(parallelism), len(jobs)))
    outs = fanout = None
    if parallelism > 1:
        _validate_picklable(scenarios, policies)
        cuda = dev.type == "cuda" or torch.cuda.is_initialized()
        start_method = _resolve_start_method(
            mp_start_method, cuda, mp.get_all_start_methods()
        )
        if dev.type == "cuda":
            # every worker then loads the libraries; none compiles
            from repro_torch.kernels import _build

            _build.build()
        trapped = _fanout(jobs, parallelism, scenario_timeout, start_method)
        if trapped is not None:
            outs, fanout = [], []
            for tag, val in trapped:
                if tag == "err":
                    name, echo, e = val
                    raise ScenarioExecutionError(
                        f"scenario {name!r} failed in a fan-out worker: "
                        f"{type(e).__name__}: {e}\n  scenario spec: {echo}"
                    ) from e
                outs.append(val[0])
                fanout.append(val[1])
    if outs is None:
        outs = [_run_scenario_star(job) for job in jobs]

    runs, chunked = [], 0
    for records, c in outs:
        runs.extend(records)
        chunked += c
    rs = RunSet(
        name=experiment.name,
        spec=spec,
        runs=runs,
        chunked_step_count=chunked,
        backends=tuple(sorted({r.backend for r in runs})),
        fanout=fanout,
    )
    if cache_file is not None:
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        # atomic publish under a per-writer unique temp name: an interrupted
        # run leaves no truncated document under the final name
        tmp = cache_file.with_suffix(f".tmp{uuid.uuid4().hex}")
        tmp.write_text(rs.to_json())
        os.replace(tmp, cache_file)
    return rs
