"""TieredServer: decode service with the Tuna loop closed.

Counterpart of :mod:`repro.serving.server`. Each round: schedule active
sessions (continuous batching), make their KV pages HBM-resident
(promotions, the pm_pr stream, copied by the migration kernel), account one
decoded token per scheduled session, let idle pages cool and reclaim to the
watermark; every tuning interval, build the configuration vector from the
cache telemetry, query the performance database, and retune the HBM page
budget through the watermarks.

As in the JAX package, no model runs: a round is charged by the interval
cost model for the page traffic and ``model_flops_per_token`` per
scheduled session. The tier profile ``hw`` has no default: the JAX
package's default is a TPU's, and the port's profile for one H100 with
pinned host memory is :data:`repro_torch.sim.costmodel.H100_HOST_TIER`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.telemetry import IntervalProfiler
from repro_torch.core.tuner import TunaTuner
from repro_torch.serving.kv_cache import TieredPagedKV
from repro_torch.serving.scheduler import ContinuousBatcher
from repro_torch.sim.costmodel import HardwareProfile, interval_time
from repro_torch.tiering.policy import PolicyOutcome


@dataclass
class RoundStats:
    t: float
    batch: int
    promoted: int
    failed: int
    fm_pages: int
    round_time_s: float


class TieredServer:
    def __init__(
        self,
        kv: TieredPagedKV,
        batcher: ContinuousBatcher,
        tuner: TunaTuner | None = None,
        tune_every: int = 8,
        model_flops_per_token: float = 2e9,
        *,
        hw: HardwareProfile,
    ):
        self.kv = kv
        self.batcher = batcher
        self.tuner = tuner
        self.tune_every = tune_every
        self.hw = hw
        self.model_flops_per_token = model_flops_per_token
        self.profiler = IntervalProfiler(hot_thr=kv.policy.hot_thr)
        self.history: list[RoundStats] = []
        self._t = 0.0

    def run_round(self, round_idx: int) -> RoundStats:
        kv, hw = self.kv, self.hw
        self.batcher.start_turns()
        batch = self.batcher.round_batch()
        promoted = failed = 0
        touched: list[int] = []
        for s in batch:
            if s.pages:
                p, f = kv.ensure_resident(np.asarray(s.pages))
                promoted += p
                failed += f
            # decode one token; a new page may be allocated
            new_pages = self.batcher.commit_tokens(s, 1)
            for np_ in new_pages:
                _, f2 = kv.ensure_resident(np.asarray([np_]))
                failed += f2
            touched.extend(s.pages)
        if touched:
            kv.touch(np.asarray(touched, np.int64))
        demoted = kv.reclaim_to_watermark()
        # ---- charge the round
        pacc_f = sum(len(s.pages) for s in batch)
        cost = interval_time(
            hw,
            pacc_f=pacc_f,
            pacc_s=0,
            ops=self.model_flops_per_token * len(batch),
            pm_pr=promoted,
            pm_de=demoted,
            pm_fail=failed,
            direct_reclaimed=0,
            mlp_eff=hw.mlp,
            rand_frac=0.0,
        )
        self.profiler.record_accesses(pacc_f, promoted, cost.t_compute * 1e9)
        self.profiler.record_policy(
            PolicyOutcome(pm_pr=promoted, pm_de=demoted, pm_fail=failed)
        )
        kv.end_interval()
        self._t += cost.total
        st = RoundStats(
            t=self._t,
            batch=len(batch),
            promoted=promoted,
            failed=failed,
            fm_pages=kv.pool.effective_fm_size,
            round_time_s=cost.total,
        )
        self.history.append(st)
        # ---- Tuna loop
        if self.tuner is not None and (round_idx + 1) % self.tune_every == 0:
            cv = self.profiler.finish(kv.pool)
            decision = self.tuner.step(cv, t=self._t)
            if decision.fm_frac is not None:
                kv.reclaim_to_watermark()
        return st

    def run(self, rounds: int, drift_every: int = 200) -> list:
        for i in range(rounds):
            if i and drift_every and i % drift_every == 0:
                self.batcher.drift()
            self.run_round(i)
        return self.history

    # ------------------------------------------------------------- metrics
    def summary(self) -> dict:
        fm = np.array([h.fm_pages for h in self.history])
        rt = np.array([h.round_time_s for h in self.history])
        return {
            "rounds": len(self.history),
            "mean_fm_pages": float(fm.mean()),
            "fm_saving_vs_cap": 1.0 - float(fm.mean()) / self.kv.pool.hw_capacity,
            "mean_round_ms": float(rt.mean() * 1e3),
            "p99_round_ms": float(np.quantile(rt, 0.99) * 1e3),
            "migrated_in": self.kv.migrated_in,
            "migrated_out": self.kv.migrated_out,
            "promote_failures": self.kv.pool.stats.pgpromote_fail,
        }
