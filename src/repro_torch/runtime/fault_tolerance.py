"""Fault tolerance for the training loop: watchdog, retry, stragglers
(a copy of :mod:`repro.runtime.fault_tolerance`).

At thousand-node scale the failure model is: (a) a step wedges (network
partition, hung collective) — detected by the :class:`StepWatchdog`
deadline; (b) a step dies with a transient error — :func:`retry_step`
re-runs it from the last good state (the data pipeline is stateless/
counter-based, so re-consuming a step is exact); (c) a host slows down —
:class:`StragglerMonitor` tracks per-step latencies and flags outliers so
the launcher can drain/replace the slow host and trigger elastic re-mesh
(:mod:`repro_torch.runtime.elastic`). Unrecoverable failures fall back to
checkpoint-restart (:mod:`repro_torch.checkpoint`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable


class StepTimeoutError(RuntimeError):
    pass


class StepWatchdog:
    """Deadline for a blocking step call; fires a callback (e.g. emergency
    checkpoint + abort) if the step wedges.

    Used as::

        with StepWatchdog(timeout_s=300, on_timeout=cb):
            out = step_fn(...)   # blocking
    """

    def __init__(self, timeout_s: float, on_timeout: Callable[[], None] | None = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._timer: threading.Timer | None = None
        self.fired = False

    def _fire(self):
        self.fired = True
        if self.on_timeout:
            self.on_timeout()

    def __enter__(self):
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer:
            self._timer.cancel()
        if self.fired:
            raise StepTimeoutError(
                f"step exceeded {self.timeout_s}s deadline (hung collective?)"
            )
        return False


def retry_step(step_fn, *args, retries: int = 2, backoff_s: float = 0.5,
               retriable=(RuntimeError,), on_retry=None, **kwargs):
    """Run a step with transient-failure retries from unchanged inputs.

    Correctness relies on the functional step: inputs are not donated on
    the retry path, and the synthetic data pipeline regenerates the same
    batch for the same step id.
    """
    last = None
    for attempt in range(retries + 1):
        try:
            return step_fn(*args, **kwargs)
        except retriable as e:  # noqa: PERF203
            last = e
            if on_retry:
                on_retry(attempt, e)
            time.sleep(backoff_s * (2**attempt))
    raise last


@dataclass
class StragglerMonitor:
    """Per-host step-latency tracker with MAD-based outlier detection.

    In a real deployment each host reports its step wall time through the
    coordinator; here the interface takes {host: latency} dicts per step
    and flags hosts slower than ``threshold`` MADs above the median for
    ``patience`` consecutive steps — the launcher's cue to drain the host
    and re-mesh without it.
    """

    window: int = 20
    threshold: float = 6.0
    patience: int = 3
    _hist: dict = field(default_factory=dict)
    _strikes: dict = field(default_factory=dict)

    def observe(self, latencies: dict) -> list:
        import numpy as np

        flagged = []
        vals = np.array(list(latencies.values()), dtype=np.float64)
        med = float(np.median(vals))
        mad = float(np.median(np.abs(vals - med))) + 1e-9
        for host, lat in latencies.items():
            self._hist.setdefault(host, deque(maxlen=self.window)).append(lat)
            if lat > med + self.threshold * mad and lat > 1.05 * med:
                self._strikes[host] = self._strikes.get(host, 0) + 1
            else:
                self._strikes[host] = 0
            if self._strikes[host] >= self.patience:
                flagged.append(host)
        return flagged
