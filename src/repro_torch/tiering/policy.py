"""Page-management policies of the port: the host ``step`` of the per-size
engine, the parameter surface the device sweep step reads, and the
registry :class:`repro_torch.sim.api.PolicySpec` resolves kinds through
(counterpart of :mod:`repro.tiering.policy`).

Two engines run these policies:

* the **per-size engine** (:mod:`repro_torch.sim.engine`) and the timing
  lane (:mod:`repro_torch.timing.runner`) call :meth:`MigrationPolicy.step`
  once per interval on a host :class:`~repro_torch.tiering.page_pool.
  TieredPagePool` (or any pool a ``pool_factory`` builds): the TPP
  promote/reclaim loop through the pool's bulk step, or the chunked loop on
  a pool without one (the JAX package's ``ReferencePagePool``), with the
  :meth:`TPPPolicy._admit` / :meth:`TPPPolicy._note_step` hooks and the
  fault model's promotion filter, copied from the JAX package;
* the **device sweep step** (:mod:`repro_torch.sim.torch_engine`) reads
  only the parameters and flags here and replicates the decision semantics
  of every kind for every swept size at once: the TPP candidate contract,
  the trace-pure admission criterion, the thrash guard's per-size
  ping-pong backoff, and first touch (no migration, no reclaim).

``batchable`` says whether the device step runs a kind: all four do in the
port (the JAX package's numpy sweep did not take ``first_touch``, which ran
per size there).

Chunked-loop telemetry: every policy instance counts executions of the
per-chunk loop in :attr:`MigrationPolicy.chunked_steps`; the bulk path
covers every in-engine regime, so only pools without a bulk path count.
(The JAX package's deprecated thread-local aggregate of the same events
has no counterpart; ``RunSet.chunked_step_count`` carries the sweeps'.)
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np

from repro_torch.tiering.page_pool import Tier


@dataclass
class PolicyOutcome:
    """Per-interval migration telemetry (feeds the Tuna config vector)."""

    pm_pr: int = 0  # successful promotions
    pm_de: int = 0  # demotions (background + direct)
    pm_fail: int = 0  # promotion failures (fast tier full, reclaim spent)
    direct_reclaim: int = 0
    # candidates the policy itself declined to promote (admission control
    # / thrash-guard suppression), distinct from pm_fail, which counts
    # *attempted* promotions the pool could not place
    pm_admit_fail: int = 0


class MigrationPolicy:
    """Per-interval page-management policy (the plug-in protocol).

    ``kind`` is the registry name, ``migrates`` whether the policy moves
    pages at all, ``batchable`` whether the device sweep step runs it,
    ``tunable`` whether a Tuna tuner may run in the loop with it.
    ``fault_injector`` is the :class:`repro_torch.sim.faults.FaultInjector`
    an engine attaches for fault-injected runs (``None`` keeps the
    fault-free step).
    """

    kind: str = ""
    migrates: bool = True
    batchable: bool = False
    tunable: bool = False

    def __init__(self, hot_thr: int = 4) -> None:
        self.hot_thr = int(hot_thr)
        self.chunked_steps = 0
        self.fault_injector = None

    def step(self, pool, touched: np.ndarray, hot_thr: int | None = None) -> PolicyOutcome:
        """One profiling interval's policy decision for one pool."""
        raise NotImplementedError


class TPPPolicy(MigrationPolicy):
    """Hot-threshold promotion + watermark demotion (the paper's TPP).

    ``hot_thr`` is the touch count within a profiling interval that makes a
    page a promotion candidate; ``promote_batch`` bounds promotions per
    interval (``None`` = unbounded). Subclasses override :meth:`_admit`
    (filter the hottest-first candidates before scheduling) and
    :meth:`_note_step` (observe the outcome); the device step replicates
    the built-in kinds' hooks itself.
    """

    kind = "tpp"
    migrates = True
    batchable = True
    tunable = True

    def __init__(self, hot_thr: int = 4, promote_batch: int | None = None) -> None:
        if hot_thr < 2:
            raise ValueError("hot_thr must be >= 2 (paper Eq. 4 divides by hot_thr-1)")
        super().__init__(hot_thr=hot_thr)
        self.promote_batch = promote_batch

    # ------------------------------------------------------ subclass hooks
    def _admit(self, pool, cand: np.ndarray) -> tuple[np.ndarray, int]:
        """Candidate admission hook: ``(admitted, n_rejected)``; the
        admitted vector is a subsequence of ``cand`` (unique ids, hottest
        first). Base TPP admits everything."""
        return cand, 0

    def _note_step(self, pool, admitted: np.ndarray, out: PolicyOutcome) -> None:
        """Post-step hook: the promoted pages are ``admitted[:out.pm_pr]``.
        Base TPP keeps no state."""

    # ------------------------------------------------------------ stepping
    def step(self, pool, touched: np.ndarray, hot_thr: int | None = None) -> PolicyOutcome:
        thr = self.hot_thr if hot_thr is None else int(hot_thr)
        touched = np.asarray(touched, dtype=np.int64)
        # promotion is decided on fault-like touch events within the
        # profiling window; the decayed heat only ranks demotion victims
        acc_now = pool.interval_touch[touched]
        cand_mask = (pool.tier[touched] == Tier.SLOW) & (acc_now >= thr)
        cand = touched[cand_mask]
        hottest_first = np.argsort(-acc_now[cand_mask], kind="stable")
        cand = cand[hottest_first]
        cand, n_rej = self._admit(pool, cand)
        n_inj_fail = 0
        if self.fault_injector is not None:
            # injected transient migration failures (after admission: a
            # failed attempt is an admitted migration the pool lost)
            cand, n_inj_fail = self.fault_injector.filter_promotions(pool, cand)
        assume_unique = bool(
            cand.size
            and hasattr(pool, "_try_bulk_step")
            and np.unique(cand).size == cand.size
        )
        out = self.step_hot_sorted(pool, cand, assume_unique=assume_unique)
        out.pm_admit_fail += n_rej
        out.pm_fail += n_inj_fail
        self._note_step(pool, cand, out)
        return out

    def step_hot_sorted(self, pool, cand: np.ndarray, assume_unique: bool = False) -> PolicyOutcome:
        """Run the promotion/reclaim loop on presorted candidates (slow
        tier, touches >= hot_thr, hottest first in a stable tie order).

        With ``assume_unique`` the pool's bulk path executes the whole
        promote/reclaim schedule at once, thrash regime included. The
        chunked loop runs for non-unique candidates, pools without a bulk
        path (the reference pool) or queue state perturbed from outside a
        policy step, and counts in :attr:`~MigrationPolicy.chunked_steps`.
        """
        out = PolicyOutcome()
        if self.promote_batch is not None and cand.size > self.promote_batch:
            cand = cand[: self.promote_batch]
        promote = pool.promote
        if assume_unique:
            bulk = getattr(pool, "_try_bulk_step", None)
            if bulk is not None:
                res = bulk(cand)
                if res is not None:
                    out.pm_pr, out.pm_de, out.pm_fail, out.direct_reclaim = res
                    return out
            # chunked fallback: the promotion chunks inherit cand's
            # verified invariants (unique, all slow)
            promote = getattr(pool, "_promote_cand", pool.promote)
        if cand.size:
            self.chunked_steps += 1
        # promote only into the headroom above the min watermark, let
        # kswapd restore the watermark, repeat; direct (blocking) reclaim
        # only when kswapd's rate limit cannot keep up
        done = 0
        while done < cand.size:
            headroom = max(0, pool.fast_free - pool.watermarks.min_free)
            if headroom == 0:
                bg, direct = pool.run_reclaim(allow_direct=True)
                out.pm_de += bg + direct
                out.direct_reclaim += direct
                headroom = max(0, pool.fast_free - pool.watermarks.min_free)
                if headroom == 0:
                    # reclaim exhausted: remaining promotions fail
                    out.pm_fail += cand.size - done
                    break
            chunk = cand[done : done + headroom]
            n_ok, n_fail = promote(chunk)
            out.pm_pr += n_ok
            out.pm_fail += n_fail
            done += chunk.size
        bg, direct = pool.run_reclaim()
        out.pm_de += bg + direct
        out.direct_reclaim += direct
        return out


def _effective_heat(pool, pages: np.ndarray) -> np.ndarray:
    """The interval-frozen demotion-ranking key: decayed access history
    carried through the current interval plus this interval's touches."""
    return pool.heat_of(pages) * pool.decay + pool.interval_touch[pages]


class AdmissionTPPPolicy(TPPPolicy):
    """TPP with TierBPF-style migration admission control: a candidate is
    promoted only when its effective heat (decayed history + this
    interval's touches) reaches ``admit_margin * hot_thr``; the rest are
    reported as ``PolicyOutcome.pm_admit_fail``."""

    kind = "admission"

    def __init__(
        self,
        hot_thr: int = 4,
        promote_batch: int | None = None,
        admit_margin: float = 2.0,
    ) -> None:
        super().__init__(hot_thr=hot_thr, promote_batch=promote_batch)
        self.admit_margin = float(admit_margin)
        if not np.isfinite(self.admit_margin) or self.admit_margin < 0:
            raise ValueError("admit_margin must be a finite non-negative float")

    def _admit(self, pool, cand: np.ndarray) -> tuple[np.ndarray, int]:
        if cand.size == 0:
            return cand, 0
        ok = _effective_heat(pool, cand) >= self.admit_margin * self.hot_thr
        n_ok = int(np.count_nonzero(ok))
        if n_ok == cand.size:
            return cand, 0
        return cand[ok], cand.size - n_ok


class _GuardState:
    """Per-pool thrash-guard state of the host step."""

    __slots__ = ("last_promoted", "t", "cooldown")

    def __init__(self, num_pages: int) -> None:
        self.last_promoted = np.full(num_pages, -(2**62), dtype=np.int64)
        self.t = 0  # policy steps taken on this pool
        self.cooldown = 0  # remaining backoff steps


class ThrashGuardPolicy(TPPPolicy):
    """TPP with a Jenga-style thrash guard.

    A promotion candidate that this policy promoted within the last
    ``reuse_window`` steps is slow again, so it was demoted in between: it
    ping-ponged. When ping-pong candidates exceed ``churn_frac`` of the
    interval's candidates, the policy enters a ``backoff_intervals``-step
    backoff during which ping-pong candidates are suppressed (reported as
    :attr:`PolicyOutcome.pm_admit_fail`). Outside backoff it is plain TPP.
    The state (a last-promotion stamp per page, the step and backoff
    counters) is per pool: a :class:`_GuardState` on the host for the
    per-size engine, per swept size on the device in the sweep step.
    """

    kind = "thrash_guard"

    def __init__(
        self,
        hot_thr: int = 4,
        promote_batch: int | None = None,
        reuse_window: int = 2,
        churn_frac: float = 0.25,
        backoff_intervals: int = 2,
    ) -> None:
        super().__init__(hot_thr=hot_thr, promote_batch=promote_batch)
        self.reuse_window = int(reuse_window)
        self.churn_frac = float(churn_frac)
        self.backoff_intervals = int(backoff_intervals)
        if self.reuse_window < 1:
            raise ValueError("reuse_window must be >= 1 (steps)")
        if not 0.0 <= self.churn_frac <= 1.0:
            raise ValueError("churn_frac must be within [0, 1]")
        if self.backoff_intervals < 1:
            raise ValueError("backoff_intervals must be >= 1")
        # weak keys: an instance stepping many pools pins none of them
        self._states = weakref.WeakKeyDictionary()

    def _state(self, pool) -> _GuardState:
        st = self._states.get(pool)
        if st is None:
            st = _GuardState(pool.num_pages)
            self._states[pool] = st
        return st

    def _admit(self, pool, cand: np.ndarray) -> tuple[np.ndarray, int]:
        st = self._state(pool)
        if cand.size == 0:
            return cand, 0
        # stamps are pre-increment step numbers, so >= covers exactly the
        # last `reuse_window` steps
        recent = st.last_promoted[cand] >= st.t - self.reuse_window
        n_ping = int(np.count_nonzero(recent))
        if n_ping > self.churn_frac * cand.size:
            st.cooldown = self.backoff_intervals
        if st.cooldown > 0 and n_ping:
            return cand[~recent], n_ping
        return cand, 0

    def _note_step(self, pool, admitted: np.ndarray, out: PolicyOutcome) -> None:
        st = self._state(pool)
        if out.pm_pr:
            st.last_promoted[admitted[: out.pm_pr]] = st.t
        if st.cooldown > 0:
            st.cooldown -= 1
        st.t += 1


class FirstTouchPolicy(MigrationPolicy):
    """NUMA first-touch with no migration (the paper's Fig. 1 baseline).

    Allocation is already first-touch inside the pool; this policy never
    migrates, and watermark reclaim is off: pages stay where they landed.
    The device step runs it as a kind of its own (first-touch allocation,
    classification and cost, with no candidate pass, schedule, victim
    selection or commit).
    """

    kind = "first_touch"
    migrates = False
    batchable = True
    tunable = False

    def step(self, pool, touched: np.ndarray, hot_thr: int | None = None) -> PolicyOutcome:
        return PolicyOutcome()


# kind -> policy class
POLICIES: dict[str, type] = {
    cls.kind: cls
    for cls in (TPPPolicy, AdmissionTPPPolicy, ThrashGuardPolicy, FirstTouchPolicy)
}


def resolve_policy(kind: str) -> type:
    """The policy class for ``kind``; an unknown kind raises ``ValueError``
    listing the registered ones."""
    try:
        return POLICIES[kind]
    except KeyError:
        raise ValueError(
            f"unknown policy kind {kind!r}; registered kinds: "
            f"{', '.join(sorted(POLICIES))}"
        ) from None
