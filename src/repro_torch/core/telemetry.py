"""Configuration vectors and interval profiling (paper Sections 3.1, 3.3, 5).

The runtime library in the paper measures, per profiling interval:

* ``pacc_f`` / ``pacc_s`` — page accesses served by fast / slow memory;
* ``pm_de`` / ``pm_pr`` — page demotions / promotions;
* ``AI`` — arithmetic intensity: attainable FLOPS+IOPS per memory access;
* ``RSS`` — resident set size (pages);
* ``hot_thr`` — the management system's promotion threshold;
* ``num_threads`` — worker threads sharing ``pm``/``pacc``.

Counterpart of :mod:`repro.core.telemetry`, same arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.tiering.page_pool import TieredPagePool
from repro_torch.tiering.policy import PolicyOutcome

# Dimensions of the configuration vector, in paper order.
CONFIG_FIELDS = (
    "pacc_f",
    "pacc_s",
    "pm_de",
    "pm_pr",
    "ai",
    "rss_pages",
    "hot_thr",
    "num_threads",
)


@dataclass(frozen=True)
class ConfigVector:
    """The 8-element index of a performance-database record.

    ``intensity`` (cache-line accesses per sampled page touch) is carried
    alongside but NOT part of the index — the micro-benchmark's stride
    knob, measured by the profiler."""

    pacc_f: float
    pacc_s: float
    pm_de: float
    pm_pr: float
    ai: float
    rss_pages: float
    hot_thr: float
    num_threads: float
    intensity: float = 1.0
    warm_pages: float = 0.0  # fast-tier pages seen below hot_thr
    warm_touches: float = 0.0  # their total sampled touches
    # promotion candidates the policy itself declined (admission control)
    # — carried as an extra, not an index dim
    pm_admit_fail: float = 0.0

    def as_array(self) -> np.ndarray:
        # index dims only (intensity is metadata)
        return np.array([getattr(self, f) for f in CONFIG_FIELDS], dtype=np.float64)

    def normalized(self) -> np.ndarray:
        """Distance-space embedding: count-like fields in log1p space,
        AI / hot_thr / num_threads linear."""
        v = self.as_array()
        out = v.copy()
        for i in (0, 1, 2, 3, 5):  # pacc_f, pacc_s, pm_de, pm_pr, rss
            out[i] = np.log1p(v[i])
        return out

    @classmethod
    def from_array(cls, v, intensity: float = 1.0) -> "ConfigVector":
        v = np.asarray(v, dtype=np.float64)
        if v.shape != (len(CONFIG_FIELDS),):
            raise ValueError(f"expected shape ({len(CONFIG_FIELDS)},), got {v.shape}")
        return cls(
            **{f: float(x) for f, x in zip(CONFIG_FIELDS, v)},
            intensity=float(intensity),
        )


class IntervalProfiler:
    """Accumulates pool + policy telemetry into a ConfigVector per interval."""

    def __init__(self, hot_thr: int, num_threads: int = 1) -> None:
        self.hot_thr = int(hot_thr)
        self.num_threads = int(num_threads)
        self.reset()

    def reset(self) -> None:
        self._pacc_f = 0
        self._pacc_s = 0
        self._pm_de = 0
        self._pm_pr = 0
        self._ops = 0.0
        self._accesses = 0
        self._cachelines = 0
        self._warm_pages = 0
        self._warm_touches = 0
        self._pm_admit_fail = 0

    def record_accesses(self, pacc_f: int, pacc_s: int, ops: float,
                        cachelines: int | None = None,
                        warm_pages: int = 0, warm_touches: int = 0) -> None:
        self._pacc_f += int(pacc_f)
        self._pacc_s += int(pacc_s)
        self._accesses += int(pacc_f) + int(pacc_s)
        self._ops += float(ops)
        self._cachelines += int(
            cachelines if cachelines is not None else pacc_f + pacc_s
        )
        self._warm_pages += int(warm_pages)
        self._warm_touches += int(warm_touches)

    def record_policy(self, outcome: PolicyOutcome) -> None:
        self._pm_de += outcome.pm_de
        self._pm_pr += outcome.pm_pr
        self._pm_admit_fail += outcome.pm_admit_fail

    @property
    def ai(self) -> float:
        """Arithmetic intensity: ops per page access (0 if idle)."""
        return self._ops / self._accesses if self._accesses else 0.0

    def finish(self, pool: TieredPagePool) -> ConfigVector:
        cv = ConfigVector(
            pacc_f=float(self._pacc_f),
            pacc_s=float(self._pacc_s),
            pm_de=float(self._pm_de),
            pm_pr=float(self._pm_pr),
            ai=float(self.ai),
            rss_pages=float(pool.rss_pages),
            hot_thr=float(self.hot_thr),
            num_threads=float(self.num_threads),
            intensity=max(1.0, self._cachelines / max(self._accesses, 1)),
            warm_pages=float(self._warm_pages),
            warm_touches=float(self._warm_touches),
            pm_admit_fail=float(self._pm_admit_fail),
        )
        self.reset()
        return cv
