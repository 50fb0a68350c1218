"""Seeded, deterministic fault injection for the port's tiering stack.

Counterpart of :mod:`repro.sim.faults`, with the same spec, the same hash
and the same event log. Tuna's own sizing signals are migration failures
and direct reclaim; this module injects them on purpose, with the
degraded-input regimes a tiering system must survive: transient promotion
failures with per-page bounded retry and exponential backoff, kswapd stall
windows and shed demotions, telemetry dropout and noise, PerfDB query
outages and watermark-actuation lag.

* :class:`FaultSpec` is a frozen, JSON-round-trippable dataclass carried by
  :class:`repro_torch.sim.api.Scenario` (``faults=...``).
* Every decision is a pure hash of ``(spec.seed, interval, page)``
  (splitmix64, :func:`_u01`), so any execution order reproduces the same
  schedule for the same seed.
* With ``faults=None`` no injector exists and the device step runs its
  fault-free path; a zero-rate spec filters nothing and logs nothing.
* Retry-exhausted promotions are credited into ``pool.stats.
  pgpromote_fail`` and the interval's ``PolicyOutcome.pm_fail``, the
  counters the ConfigVector and the cost model read.

The injector keeps, per pool, the interval cursor and the event log on the
host. The promotion filter's per-page retry state (failure streaks and
backoff deadlines) lives on the device, in the sweep step
(:func:`repro_torch.sim.torch_engine._filter_promotions`), which draws the
per-page failures from :meth:`FaultInjector.promotion_draws` and books
their outcome through :meth:`FaultInjector.record_promotion_faults`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

__all__ = ["FaultSpec", "FaultInjector"]

# splitmix64 mixing constants (public-domain PRNG finalizer)
_C2 = np.uint64(0xBF58476D1CE4E5B9)
_C3 = np.uint64(0x94D049BB133111EB)
_PAGE_STRIDE = np.uint64(0x100000001B3)
_MASK = 0xFFFFFFFFFFFFFFFF

# channel salts: each fault channel draws from an independent stream
_SALT_PROMOTE = 0x01
_SALT_DEMOTE = 0x02
_SALT_STALL = 0x03
_SALT_DROP = 0x04
_SALT_NOISE = 0x05
_SALT_NOISE_MAG = 0x06
_SALT_DB = 0x07


def _u01(keys: np.ndarray, seed: int, salt: int) -> np.ndarray:
    """Vectorized splitmix64-style hash of integer keys into [0, 1)."""
    z = np.atleast_1d(np.asarray(keys)).astype(np.uint64)
    mix = (seed * 0x9E3779B97F4A7C15 + salt * 0xD6E8FEB86659FD93) & _MASK
    z = z + np.uint64(mix)
    z ^= z >> np.uint64(30)
    z *= _C2
    z ^= z >> np.uint64(27)
    z *= _C3
    z ^= z >> np.uint64(31)
    return z.astype(np.float64) / float(2**64)


def _u01_scalar(key: int, seed: int, salt: int) -> float:
    return float(_u01(np.asarray([key], dtype=np.uint64), seed, salt)[0])


@dataclass(frozen=True)
class FaultSpec:
    """Declarative fault model for one scenario (all channels optional).

    Rates are per-draw probabilities in ``[0, 1]``; a default-constructed
    spec injects nothing. :meth:`to_dict` / :meth:`from_dict` round-trip it
    through plain data.
    """

    seed: int = 0
    # --- transient migration failures (per-page bounded retry + backoff)
    promote_fail_rate: float = 0.0  # P(attempted promotion fails) per draw
    max_retries: int = 3  # retries before the migration is abandoned
    backoff_base: int = 1  # intervals; doubles per consecutive failure
    demote_fail_rate: float = 0.0  # fraction of kswapd budget that fails
    # --- kswapd stall windows (background reclaim fully unavailable)
    kswapd_stall_rate: float = 0.0  # P(a stall window opens at interval t)
    kswapd_stall_len: int = 2  # intervals per stall window
    # --- telemetry faults (what the tuner sees at tuning steps)
    telemetry_drop_rate: float = 0.0  # P(tuning window's telemetry lost)
    telemetry_noise_rate: float = 0.0  # P(tuning window's counters noisy)
    telemetry_noise_scale: float = 0.5  # max multiplicative perturbation
    # --- PerfDB query outages (windows keyed on the tuner's step index)
    db_outage_rate: float = 0.0  # P(an outage window opens at step s)
    db_outage_len: int = 2  # tuner steps per outage window
    # --- watermark-actuation lag (set_size takes effect N calls late)
    actuation_lag: int = 0

    def __post_init__(self) -> None:
        for name in (
            "promote_fail_rate", "demote_fail_rate", "kswapd_stall_rate",
            "telemetry_drop_rate", "telemetry_noise_rate", "db_outage_rate",
        ):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultSpec.{name} must be in [0, 1], got {v}")
        for name in ("max_retries", "backoff_base", "kswapd_stall_len",
                     "db_outage_len", "actuation_lag"):
            if int(getattr(self, name)) < 0:
                raise ValueError(f"FaultSpec.{name} must be >= 0")
        if self.telemetry_noise_scale < 0:
            raise ValueError("FaultSpec.telemetry_noise_scale must be >= 0")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        return cls(**d)


class _PoolFaultState:
    """Per-pool fault trajectory on the host: interval cursor + event log."""

    __slots__ = ("t", "events")

    def __init__(self) -> None:
        self.t = -1  # interval cursor, ticked by begin_interval
        self.events: list[dict] = []


@dataclass
class FaultInjector:
    """Live fault engine for one run (or one whole sweep pass).

    Stateless over the schedule (pure hashes of the spec seed), stateful
    only per pool. The sweep step drives it:

    * :meth:`begin_interval`: once per (pool, interval), before the policy
      step; ticks the pool's interval cursor;
    * :meth:`kswapd_budget`: the effective background-reclaim budget of
      this interval (stall windows zero it, ``demote_fail_rate`` sheds a
      seeded fraction of it);
    * :meth:`promotion_draws` / :meth:`record_promotion_faults`: the
      per-(page, interval) failure draws of the device filter, and the
      booking of its per-slice outcome;
    * :meth:`telemetry`: perturbs (or drops) a tuning window's
      ConfigVector and time per access;
    * :meth:`db_outage`: whether the PerfDB is unreachable at a tuner step;
      :meth:`wire_tuner` arms a bound tuner with this injector.
    """

    spec: FaultSpec
    _states: dict = field(default_factory=dict)  # pool -> _PoolFaultState

    def __post_init__(self) -> None:
        if isinstance(self.spec, dict):
            self.spec = FaultSpec.from_dict(self.spec)

    # ------------------------------------------------------------- state
    def _state(self, pool) -> _PoolFaultState:
        st = self._states.get(pool)
        if st is None:
            st = self._states[pool] = _PoolFaultState()
        return st

    def events(self, pool) -> list:
        """The event log of one pool's trajectory (chronological)."""
        st = self._states.get(pool)
        return list(st.events) if st is not None else []

    def all_events(self) -> list:
        """Every logged event, pools in first-seen order."""
        out: list[dict] = []
        for st in self._states.values():
            out.extend(st.events)
        return out

    # ---------------------------------------------------------- interval
    def begin_interval(self, pool) -> int:
        """Advance the pool's interval cursor; returns the new index."""
        st = self._state(pool)
        st.t += 1
        return st.t

    def kswapd_budget(self, pool, base: int) -> int:
        """Effective kswapd batch for this (pool, interval)."""
        sp = self.spec
        st = self._state(pool)
        t = max(st.t, 0)
        if sp.kswapd_stall_rate > 0.0 and sp.kswapd_stall_len > 0:
            for k in range(min(sp.kswapd_stall_len, t + 1)):
                if _u01_scalar(t - k, sp.seed, _SALT_STALL) < sp.kswapd_stall_rate:
                    st.events.append({"i": t, "kind": "kswapd_stall"})
                    return 0
        if sp.demote_fail_rate > 0.0 and base > 0:
            # seeded probabilistic rounding of base * rate failed slots
            u = _u01_scalar(t, sp.seed, _SALT_DEMOTE)
            n_fail = int(base * sp.demote_fail_rate + u)
            if n_fail > 0:
                n_fail = min(n_fail, base)
                st.events.append(
                    {"i": t, "kind": "demote_fail", "count": n_fail}
                )
                return base - n_fail
        return base

    # --------------------------------------------------------- migration
    def promotion_draws(self, pages: np.ndarray, t: int) -> np.ndarray:
        """The promotion channel's draw in [0, 1) for each of ``pages`` at
        interval ``t`` (a page's attempt fails when its draw is below
        ``promote_fail_rate``). Float64, one per page, in order."""
        # the interval term is mixed in Python int space: a scalar uint64
        # product would raise numpy's overflow warning (array ops wrap)
        t_mix = np.uint64((int(t) * 0x9E3779B97F4A7C15) & _MASK)
        keys = np.asarray(pages).astype(np.uint64) * _PAGE_STRIDE + t_mix
        return _u01(keys, self.spec.seed, _SALT_PROMOTE)

    def record_promotion_faults(
        self, pool, n_withheld: int, n_exhausted: int, n_transient: int
    ) -> None:
        """Book one interval's promotion-filter outcome for ``pool``:
        candidates withheld in backoff, migrations abandoned after
        ``max_retries`` (credited to ``pool.stats.pgpromote_fail``) and
        transient failures that will retry, in the reference's log order."""
        st = self._state(pool)
        t = max(st.t, 0)
        if n_withheld:
            st.events.append(
                {"i": t, "kind": "promote_backoff_withheld",
                 "count": int(n_withheld)}
            )
        if n_exhausted:
            pool.stats.pgpromote_fail += int(n_exhausted)
            st.events.append(
                {"i": t, "kind": "promote_fail_exhausted",
                 "count": int(n_exhausted)}
            )
        if n_transient:
            st.events.append(
                {"i": t, "kind": "promote_fail_transient",
                 "count": int(n_transient)}
            )

    # --------------------------------------------------------- telemetry
    def telemetry(self, pool, cv, tpa):
        """Perturb one tuning window's telemetry.

        Returns ``(cv, tpa, ok)``: ``ok=False`` marks a dropout (the tuner
        must hold its last decision); a noise draw scales the ConfigVector's
        migration and access counters and the measured TPA by a seeded
        factor in ``[1 - scale, 1 + scale]``.
        """
        sp = self.spec
        st = self._state(pool)
        t = max(st.t, 0)
        if (
            sp.telemetry_drop_rate > 0.0
            and _u01_scalar(t, sp.seed, _SALT_DROP) < sp.telemetry_drop_rate
        ):
            st.events.append({"i": t, "kind": "telemetry_dropout"})
            return cv, tpa, False
        if (
            sp.telemetry_noise_rate > 0.0
            and _u01_scalar(t, sp.seed, _SALT_NOISE) < sp.telemetry_noise_rate
        ):
            f = 1.0 + sp.telemetry_noise_scale * (
                2.0 * _u01_scalar(t, sp.seed, _SALT_NOISE_MAG) - 1.0
            )
            st.events.append(
                {"i": t, "kind": "telemetry_noise", "factor": f}
            )
            cv = dataclasses.replace(
                cv,
                pacc_f=cv.pacc_f * f,
                pacc_s=cv.pacc_s * f,
                pm_de=cv.pm_de * f,
                pm_pr=cv.pm_pr * f,
            )
            return cv, tpa * f, True
        return cv, tpa, True

    # ------------------------------------------------------------ perfdb
    def db_outage(self, pool, step_idx: int) -> bool:
        """Whether the PerfDB is unreachable at the tuner's ``step_idx``."""
        sp = self.spec
        if sp.db_outage_rate <= 0.0 or sp.db_outage_len <= 0:
            return False
        for k in range(min(sp.db_outage_len, step_idx + 1)):
            if _u01_scalar(step_idx - k, sp.seed, _SALT_DB) < sp.db_outage_rate:
                self._state(pool).events.append(
                    {"i": int(step_idx), "kind": "db_outage"}
                )
                return True
        return False

    # ------------------------------------------------------------ wiring
    def wire_tuner(self, tuner) -> None:
        """Arm a pool-bound tuner with this injector's fault channels."""
        tuner.fault_injector = self
        if self.spec.telemetry_noise_rate > 0.0:
            # a single noisy window must not trigger a multi-step shrink
            tuner.cfg.shrink_confirm = True
        if self.spec.actuation_lag > 0:
            tuner.controller.lag_steps = int(self.spec.actuation_lag)
            self._state(tuner.controller.pool).events.append(
                {"i": -1, "kind": "actuation_lag",
                 "lag": int(self.spec.actuation_lag)}
            )
