"""Watermark controller (paper Section 4).

Tuning the fast memory size is actuated purely through the reclaim
watermarks so that demotion happens in the background (kswapd analogue).
The controller adds rate limiting and hysteresis and keeps an audit log.
Counterpart of :mod:`repro.core.watermark` without the fault model's
actuation lag and the fleet's per-tenant ceiling, which later slices port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.tiering.page_pool import TieredPagePool


@dataclass
class WatermarkEvent:
    t: float
    old_fm: int
    new_fm: int


@dataclass
class WatermarkController:
    """Rate-limited, hysteretic actuator over one pool's watermarks.

    ``pool`` may be left ``None`` at construction and bound later via
    :meth:`bind` (or :meth:`repro_torch.core.tuner.TunaTuner.bind_pool`):
    the tuned sweep builds its slice pools only once the trace is known.
    """

    pool: TieredPagePool | None = None
    # never shrink/grow by more than this fraction of hw capacity per call
    max_step_frac: float = 0.10
    # ignore changes smaller than this fraction (hysteresis)
    deadband_frac: float = 0.005
    log: list = field(default_factory=list)

    def bind(self, pool: TieredPagePool) -> "WatermarkController":
        """Attach the pool this controller actuates; returns self."""
        self.pool = pool
        return self

    def set_size(self, new_fm_pages: int, t: float = 0.0) -> int:
        """Request a new fast-memory size; returns the size actually set."""
        if self.pool is None:
            raise RuntimeError(
                "WatermarkController has no pool bound; call bind(pool) "
                "(or TunaTuner.bind_pool) before set_size"
            )
        cap = self.pool.hw_capacity
        cur = self.pool.effective_fm_size
        target = int(max(1, min(cap, new_fm_pages)))
        # a reached target is a no-op even at deadband 0 — it must not
        # append zero-delta events to the audit log
        if target == cur or abs(target - cur) < self.deadband_frac * cap:
            return cur
        max_step = max(1, int(self.max_step_frac * cap))
        step = max(-max_step, min(max_step, target - cur))
        new = cur + step
        self.pool.set_fm_size(new)
        self.log.append(WatermarkEvent(t=t, old_fm=cur, new_fm=new))
        return new
