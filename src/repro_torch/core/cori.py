"""Cori: Frequency Generator + Tuner (paper §IV-B, §IV-C).

Dominant reuse (Eq. 1), with reuses sorted ascending so that the extra
``(N - i)`` weight favours shorter reuse distances:

            sum_i (N - i) * repeat_i * reuse_i
    DR  =  ------------------------------------        i = 1..N
            sum_i (N - i) * repeat_i

Candidate periods (Eq. 2):  [DR, 2*DR, 3*DR, ..., Runtime/2], emitted
shortest period first (highest frequency first) -- this priority ordering is
essential to Cori's trial efficiency (§IV-B).

The Tuner (§IV-C) trials candidates in order against the actual system (here:
the hybrid-memory simulator, or any callable ``period -> runtime``) and stops
either when a trial budget is hit or when performance stops improving
("performance ... shows no significant variation from the last trial",
§IV-D).

Invariants of the online state machine (pinned by tests/test_online.py and
tests/test_sched.py):

  * **Trial-window alignment.**  Every cost window (TRIAL and HOLD) is
    rounded up to a whole multiple of the period being measured, so each
    window contains the same number of tiering events.  Without this, a
    window boundary aliasing against the period makes per-step costs
    oscillate and fakes drift on a perfectly stable workload.  Trials rank
    by the window's *tail* half only -- the head absorbs the residency
    transient inherited from whatever period ran before.
  * **Page-ID recycling contract.**  ``forget_pages`` must be called when
    the serving scheduler frees a logical page ID, *before* the allocator
    may recycle it; a recycled ID's first access by its new owner must
    never pair with the old owner's last access into a bogus reuse gap.
  * **Mass-domain stability.**  The collector thresholds page masses into
    accessed sets.  The fully-paged serving path feeds masses aggregated
    over ALL attention layers (head-normalised, layer-averaged);
    ``rel_threshold`` switches the cut to a fraction of the step's peak
    mass so the accessed-set size does not drift with batch occupancy.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.reuse import ReuseHistogram, StreamingReuseCollector
from repro_torch.obs import telemetry as _obs

__all__ = [
    "dominant_reuse",
    "candidate_periods",
    "TuneResult",
    "Tuner",
    "OnlineTuner",
    "trials_to_best",
]


def dominant_reuse(hist: ReuseHistogram) -> float:
    """Eq. 1: weighted average of reuses, biased towards short ones."""
    if hist.num_bins == 0:
        raise ValueError("empty reuse histogram: nothing to tune from")
    order = np.argsort(hist.values)
    reuse = hist.values[order].astype(np.float64)
    repeat = hist.counts[order].astype(np.float64)
    n = reuse.shape[0]
    if n == 1:
        return float(reuse[0])
    w = (n - np.arange(1, n + 1, dtype=np.float64)) * repeat  # (N - i) * repeat_i
    denom = w.sum()
    if denom <= 0:  # degenerate: all weight on the longest reuse
        return float(reuse[-1])
    return float((w * reuse).sum() / denom)


def candidate_periods(dr: float, runtime: float, max_candidates: int = 64,
                      min_period: float = 1.0) -> np.ndarray:
    """Eq. 2: multiples of DR up to Runtime/2, shortest first.

    `runtime` and the returned periods are in whatever domain DR is measured
    in (requests for the simulator, seconds / decode-steps on a system).
    """
    dr = max(float(dr), float(min_period))
    hi = runtime / 2.0
    if dr > hi:
        return np.array([hi], dtype=np.float64)
    n = int(hi // dr)
    ks = np.arange(1, n + 1, dtype=np.float64)
    if n > max_candidates:
        # Keep the ladder's head exact (the critical low-multiples region),
        # thin the tail geometrically -- same endpoints as Eq. 2.
        head = ks[: max_candidates // 2]
        tail = np.unique(np.geomspace(head[-1] + 1, n,
                                      max_candidates - head.shape[0]).round())
        ks = np.concatenate([head, tail])
    return ks * dr


@dataclasses.dataclass(frozen=True)
class TuneResult:
    chosen_period: float
    chosen_runtime: float
    trials: int                      # trials actually executed
    tried_periods: np.ndarray
    tried_runtimes: np.ndarray
    candidates: np.ndarray           # full candidate ladder

    @property
    def best_runtime_tried(self) -> float:
        finite = self.tried_runtimes[np.isfinite(self.tried_runtimes)]
        return float(finite.min()) if finite.size else float("inf")


class Tuner:
    """Cori's Tuner: trial candidates in order, stop on no-improvement.

    Args:
      evaluate: callable(period) -> runtime (lower is better).  For the
        simulator this wraps `core.sim.simulate`; for the serving runtime it
        wraps a measured window of decode steps.
      patience: stop after this many consecutive non-improving trials
        (the flexible stopping policy of §IV-D).
      rel_tol: a trial must beat the best-so-far by this fraction to count
        as an improvement.
      max_trials: hard trial budget (None = whole ladder).
    """

    def __init__(self, evaluate: Callable[[float], float], patience: int = 2,
                 rel_tol: float = 0.01, max_trials: Optional[int] = None):
        self.evaluate = evaluate
        self.patience = patience
        self.rel_tol = rel_tol
        self.max_trials = max_trials

    def run(self, candidates: Sequence[float]) -> TuneResult:
        candidates = np.asarray(list(candidates), dtype=np.float64)
        if candidates.size == 0:
            raise ValueError(
                "empty candidate ladder: nothing to trial (Eq. 2 produced no "
                "periods -- check the reuse histogram / runtime horizon)")
        best_rt = np.inf
        best_p = float(candidates[0])
        tried_p: List[float] = []
        tried_rt: List[float] = []
        stale = 0
        for p in candidates:
            rt = float(self.evaluate(float(p)))
            tried_p.append(float(p))
            tried_rt.append(rt)
            # a NaN/inf runtime is a failed trial, never an improvement: it
            # must not become best_rt (NaN would poison every later
            # comparison) and counts as a stale trial like any non-improver
            if np.isfinite(rt) and rt < best_rt * (1.0 - self.rel_tol):
                best_rt, best_p, stale = rt, float(p), 0
            else:
                stale += 1
                if stale >= self.patience:
                    break
            if self.max_trials is not None and len(tried_p) >= self.max_trials:
                break
        if not np.isfinite(best_rt):
            # every trial came back non-finite: keep the ladder head but
            # report an infinite runtime rather than adopting a poisoned
            # NaN as the "measured" chosen_runtime
            best_rt, best_p = float("inf"), tried_p[0]
        return TuneResult(best_p, best_rt, len(tried_p),
                          np.asarray(tried_p), np.asarray(tried_rt), candidates)


class OnlineTuner:
    """Closed-loop Cori: profile -> trial -> hold, re-entered on drift.

    The offline ``Tuner`` needs an oracle ``evaluate(period)`` it can call at
    will (the simulator).  Inside a running system there is no oracle -- each
    candidate must be *lived through* for a window of decode steps while the
    system serves traffic.  The OnlineTuner is that state machine:

      PROFILE  feed a ``StreamingReuseCollector`` for ``profile_steps`` steps,
               then derive DR (Eq. 1) and the candidate ladder (Eq. 2) over
               the ``horizon_steps`` trial horizon.  Decode steps are already
               coarse, so reuse gaps bin at width 1 by default -- a wider
               bin floors DR (and hence the shortest candidate) at the bin
               centre, hiding period-1 ladders.
      TRIAL    live each candidate period for a window of decode steps, but
               rank candidates by the per-step cost of the window's *tail*
               half only: the head absorbs the residency transient the
               trial inherits from whatever ran before it (charging that
               transient to the candidate biases the ranking against
               whichever period is trialed first).  The offline Tuner's
               stopping rule (``rel_tol`` improvement, ``patience`` stale
               trials, ``max_trials`` budget) decides when to stop.
      HOLD     run at the winning period.  Every measurement window the
               per-step cost is compared against the post-tune baseline; a
               regression beyond ``drift_ratio`` sustained for
               ``drift_patience`` consecutive windows means the workload
               changed phase -> reset the collector and re-enter PROFILE.
               The detector is symmetric: a *sustained improvement* beyond
               ``improve_ratio`` (cost below baseline/improve_ratio for
               ``improve_patience`` windows) also re-profiles -- a cheaper
               phase may admit an even better period than the one tuned
               for the old, more expensive mix.  Set ``improve_ratio`` to
               ``None`` to restore the regression-only detector.

    Cost windows (TRIAL and HOLD) are rounded up to a whole multiple of the
    period being measured, so every window contains the same number of
    tiering events -- otherwise a window boundary that aliases against the
    period makes per-step costs oscillate and fakes drift on a perfectly
    stable workload.

    Three defenses harden the state machine against *adversarial* traffic
    (flash crowds, correlated bursts, abrupt mix inversions -- the hostile
    suite in ``core.traffic``):

      * **Cost-spike guardrail** (``guard_ratio``).  If a TRIAL window's
        running per-step tail cost blows past ``guard_ratio`` x the
        last *attested* cost (a completed sweep's winner or a clean HOLD
        baseline), the sweep is *aborted* -- the spiked
        candidate is never adopted; the tuner falls back to the cleanly
        ranked best (or the last-good period) and re-enters HOLD.  In
        HOLD, a window beyond the guard ratio is a burst, not a baseline:
        it is discarded rather than baselined or struck, and only
        ``drift_patience`` *consecutive* guard-level windows (a sustained
        regime change) force a re-profile.  Non-finite costs are treated
        as +inf so a NaN can never win a ladder or silently poison the
        baseline.
      * **Variance-scaled trial windows** (``var_cv``).  Trial windows
        whose per-period cost variance is high (coefficient of variation
        over whole-period buckets above ``var_cv``) double, up to
        ``var_max_factor`` x ``trial_steps``; the noisy segment becomes
        head (warmup) and the tail restarts, so a heavy-tailed burst does
        not de-noise into a wrong ranking.  Buckets span whole periods,
        so a stationary workload's within-period migration burst pattern
        does not read as variance.
      * **Warm re-tunes** (``warm_start``).  A drift/improve re-tune
        rebuilds the ladder from the *live* rolling collector window and
        goes straight to TRIAL (no PROFILE stage), exploring outward
        from the previous winner (bandit-style nearest-first) instead of
        shortest-first -- a mild phase change re-converges in
        ~``patience``+1 trials instead of paying a profile window plus a
        full sweep, while a large change still walks to the far end
        because every improvement resets the stopping rule.  Only the
        guard-strike escalation (a hostile regime change) pays the cold
        collector reset + PROFILE.

    Drive it one decode step at a time with ``on_step``; it returns the
    period the tiering runtime should use *now*.
    """

    PROFILE, TRIAL, HOLD = "profile", "trial", "hold"

    _obs_count = 0          # process-wide id counter for telemetry streams

    def __init__(self, n_pages: int, default_period: int = 8,
                 profile_steps: int = 64, trial_steps: int = 32,
                 horizon_steps: Optional[int] = None,
                 window: Optional[int] = None,
                 patience: int = 2, rel_tol: float = 0.01,
                 max_trials: Optional[int] = None,
                 drift_ratio: float = 1.3, drift_patience: int = 2,
                 improve_ratio: Optional[float] = 2.0,
                 improve_patience: Optional[int] = None,
                 bin_width: int = 1,
                 min_period: float = 1.0, access_threshold: float = 0.05,
                 rel_threshold: bool = False,
                 max_candidates: int = 16, cost_log_len: int = 4096,
                 guard_ratio: Optional[float] = 6.0,
                 var_cv: Optional[float] = 0.3,
                 var_max_factor: int = 4,
                 warm_start: bool = True,
                 actuation_lag: int = 0):
        self.collector = StreamingReuseCollector(
            n_pages, window=window or 4 * profile_steps, bin_width=bin_width)
        self.profile_steps = profile_steps
        self.trial_steps = trial_steps
        self.horizon_steps = horizon_steps or 2 * trial_steps
        self.patience = patience
        self.rel_tol = rel_tol
        self.max_trials = max_trials
        self.drift_ratio = drift_ratio
        self.drift_patience = drift_patience
        self.improve_ratio = improve_ratio
        self.improve_patience = (improve_patience if improve_patience
                                 is not None else drift_patience)
        self.min_period = min_period
        self.access_threshold = access_threshold
        self.rel_threshold = rel_threshold
        self.max_candidates = max_candidates
        self.guard_ratio = guard_ratio
        self.var_cv = var_cv
        self.var_max_factor = max(1, int(var_max_factor))
        self.warm_start = warm_start
        # extra HOLD transient windows to discard after a period switch:
        # a pipelined serving loop applies a new period one macro boundary
        # late (the stale-by-one hand-off), so the residency transient the
        # _hold_skip window absorbs stretches `actuation_lag` windows
        # further before the baseline is clean
        self.actuation_lag = max(0, int(actuation_lag))

        self.state = self.PROFILE
        self.period = int(default_period)
        self.step = 0
        self.dominant_reuse: Optional[float] = None
        self.candidates: np.ndarray = np.empty(0)
        self.tried: List[Tuple[float, float]] = []   # (period, cost/step)
        self.baseline_cost: Optional[float] = None
        self.retunes = 0          # completed PROFILE->TRIAL->HOLD cycles
        self.history: List[Tuple[int, int]] = []     # (step, period) changes
        self.converged_at: Optional[int] = None      # step of last HOLD entry
        # guardrail fallback: the last period attested by a clean sweep or
        # HOLD baseline, and the per-step cost it achieved (inf = nothing
        # attested yet, e.g. right after a phase-change re-profile)
        self.last_good_period = int(default_period)
        self.last_good_cost = float("inf")
        self.guard_trips = 0        # guard aborts + discarded HOLD windows
        self.window_extensions = 0  # variance-driven trial-window doublings
        # public rolling window of recent PER-STEP costs (bounded; read by
        # tests and benchmarks for cost-level asserts).  The flight
        # recorder's "tuner.cost_per_step" histogram sees the same stream
        # but keeps full-run quantiles in O(1) memory -- use the deque for
        # exact recent values, the histogram for distributional summaries.
        self.cost_log: "collections.deque[float]" = collections.deque(
            maxlen=cost_log_len)
        OnlineTuner._obs_count += 1
        #: short id tagging this instance's telemetry events ("t1", ...)
        self.obs_id = f"t{OnlineTuner._obs_count}"
        self._drift_strikes = 0
        self._improve_strikes = 0
        self._guard_strikes = 0
        # counts HOLD transient windows still to skip (int; bools coerce)
        self._hold_skip = 0
        self._resweep_pending = False
        self._warm_next = True
        # winner's attested trial cost from the most recent sweep: floors
        # the first clean HOLD baseline (one quiet window must not arm a
        # hair-trigger drift detector)
        self._sweep_cost: Optional[float] = None
        self._trial_idx = 0
        self._best_cost = np.inf
        self._best_period = self.period
        self._stale = 0
        self._win_cost = 0.0
        self._win_steps = 0
        self._tail_cost = 0.0
        self._tail_steps = 0
        self._win_target = self._cost_window()
        self._tail_begin = self._win_target - self._tail_window()
        # per-period cost buckets feeding the window-variance signal
        self._seg_sum = 0.0
        self._seg_sq = 0.0
        self._seg_n = 0
        self._bucket_cost = 0.0
        self._bucket_steps = 0

    # -- per-step entry point ------------------------------------------------
    def on_step(self, page_mass: Optional[np.ndarray] = None,
                cost: float = 0.0,
                accessed_ids: Optional[np.ndarray] = None,
                dt: int = 1) -> int:
        """Feed one observation (attention masses or accessed page ids, plus
        the measured cost); returns the period to tier at.

        ``dt`` is the number of token-steps the observation spans (the
        macro length when the serving loop samples once per movement
        period).  The tuner's clock, reuse gaps, and profile/trial
        windows all advance by ``dt``, so the derived period stays in
        the same token-step units it is actuated in -- ``cost`` must
        then be the total for those ``dt`` steps (window means stay
        per-step)."""
        dt = max(1, int(dt))
        if accessed_ids is not None:
            self.collector.observe(accessed_ids, dt=dt)
        elif page_mass is not None:
            self.collector.observe_mass(page_mass, self.access_threshold,
                                        relative=self.rel_threshold, dt=dt)
        cost = float(cost)
        if not np.isfinite(cost):
            # a NaN/inf measurement is hostile garbage: pin it to +inf so
            # it reads as "arbitrarily expensive" (the guardrail catches
            # it) instead of silently propagating NaN through every
            # window mean and comparison
            cost = float("inf")
        per_step = cost / dt
        self._win_cost += cost
        self._win_steps += dt
        # the log is uniformly PER-STEP: raw observation costs would mix
        # per-token and per-macro magnitudes whenever dt varies
        self.cost_log.append(per_step)
        if (r := _obs.RECORDER).enabled:
            r.observe("tuner.cost_per_step", per_step)
        self.step += dt
        if self.state == self.PROFILE:
            if self._win_steps >= self.profile_steps:
                self._begin_trials()
        elif self.state == self.TRIAL:
            # tail accounting: the observation spans [win_steps - dt,
            # win_steps); an observation straddling the head/tail boundary
            # charges only its tail overlap (charging its whole macro cost
            # to the tail biases the tail mean under macro dt > 1)
            overlap = self._win_steps - max(self._win_steps - dt,
                                            self._tail_begin)
            if overlap > 0:
                self._tail_cost += cost * (overlap / dt)
                self._tail_steps += overlap
                # variance buckets also cover the tail only: the head's
                # residency transient is *expected* to be expensive, and
                # letting it into the buckets would read every period
                # switch as heavy-tailed noise worth extending over
                self._observe_period_bucket(per_step, overlap)
            if self._guard_tripped():
                self._trip_guard()
            elif self._win_steps >= self._win_target:
                if self._should_extend():
                    self._extend_window()
                else:
                    self._finish_trial()
        else:  # HOLD
            if self._win_steps >= self._win_target:
                self._check_drift()
        return self.period

    def _cost_window(self) -> int:
        """Measurement window: >= trial_steps, rounded up to a whole multiple
        of the current period so every window sees the same number of
        tiering events (no aliasing between window and period)."""
        p = max(1, self.period)
        return -(-self.trial_steps // p) * p

    def _tail_window(self) -> int:
        """Measured tail of a trial window: ~half of it, still a whole
        multiple of the period (the head is warmup for the residency
        transient)."""
        p = max(1, self.period)
        return max(1, (self._cost_window() // (2 * p))) * p

    # -- guardrail + variance machinery --------------------------------------
    def _observe_period_bucket(self, per_step: float, dt: int) -> None:
        """Accumulate the observation into whole-period cost buckets (the
        variance signal).  Buckets span exactly one period, so a stationary
        workload's within-period burst structure (a migration burst at
        every tiering boundary) contributes ZERO across-bucket variance;
        only bucket-to-bucket change -- a flash crowd, a correlated burst
        -- reads as noise worth extending the window over.  Always
        accumulated (even with ``var_cv=None``): the guardrail's
        burst-vs-regime verdict reads the same buckets."""
        p = max(1, self.period)
        rem = dt
        while rem > 0:
            take = min(rem, p - self._bucket_steps)
            self._bucket_cost += per_step * take
            self._bucket_steps += take
            rem -= take
            if self._bucket_steps >= p:
                x = self._bucket_cost
                self._seg_sum += x
                self._seg_sq += x * x
                self._seg_n += 1
                self._bucket_cost = 0.0
                self._bucket_steps = 0

    def _guard_ref(self) -> float:
        """Per-step cost the guardrail compares against: the last cost
        *attested* by a completed sweep or a clean HOLD baseline.  The
        in-sweep best is deliberately NOT used -- candidates are measured
        under different stretches of traffic, and a merely-expensive
        candidate must rank (and lose) normally rather than abort the
        sweep against a sibling that happened to be measured cheaply.
        Before anything is attested (first sweep, post-reset) the ref is
        inf and the sweep runs unguarded."""
        return self.last_good_cost

    def _guard_tripped(self) -> bool:
        if self.guard_ratio is None:
            return False
        ref = self._guard_ref()
        if not np.isfinite(ref) or ref <= 0:
            return False                 # nothing attested yet: unguarded
        if self._seg_n < 2:
            # judge only the ranking tail, and only once it holds two
            # whole-period buckets: the head legitimately carries the
            # period-switch residency transient (that is what the head
            # discard is for, and a spike confined to the head cannot
            # poison the ranking anyway), and the burst-vs-regime verdict
            # needs at least two buckets to compare
            return False
        return (self._tail_cost / self._tail_steps
                > self.guard_ratio * ref)

    def _tail_bucket_cv(self) -> float:
        """Coefficient of variation of the tail's whole-period cost buckets
        (NaN when fewer than two buckets or the mean is not usable)."""
        if self._seg_n < 2:
            return float("nan")
        mean = self._seg_sum / self._seg_n
        if not np.isfinite(mean) or mean <= 0:
            return float("nan")
        var = max(0.0, self._seg_sq / self._seg_n - mean * mean)
        return (var ** 0.5) / mean

    def _trip_guard(self) -> None:
        """The TRIAL tail blew past the guard ratio -- decide burst vs
        regime change by the *shape* of the tail: spiky buckets (CV above
        ``var_cv``, or unmeasurable -- e.g. a NaN pinned to inf) mean a
        burst is poisoning the window, so abort the sweep and revert;
        uniformly elevated buckets mean the cost regime itself moved, so
        the stale anchor (and reuse info) must go -- cold re-profile."""
        cv = self._tail_bucket_cv()
        spiky_above = self.var_cv if self.var_cv is not None else 0.5
        burst = bool(not np.isfinite(cv) or cv > spiky_above)
        if (r := _obs.RECORDER).enabled:
            r.emit("tuner.guard", tuner=self.obs_id, step=self.step,
                   where="trial", verdict="burst" if burst else "regime",
                   cv=float(cv), ref=float(self._guard_ref()),
                   cost=self._tail_cost / max(1, self._tail_steps))
            r.count("tuner.guard_trips")
        if burst:
            self._abort_sweep()
        else:
            self.guard_trips += 1
            self._reprofile(cold=True, reason="guard-regime")
            self._arm_window()

    def _abort_sweep(self) -> None:
        """Cost-spike guardrail: the running TRIAL window blew past
        ``guard_ratio`` x the best-known cost -- a burst is poisoning the
        sweep.  Abort it: adopt the best candidate already ranked cleanly
        this sweep (if any), else revert to the last-good period, and
        fall back to HOLD.  A sustained spike then re-profiles through the
        HOLD guard once its patience runs out."""
        self.guard_trips += 1
        adopted = bool(np.isfinite(self._best_cost))
        if (r := _obs.RECORDER).enabled:
            r.emit("tuner.transition", tuner=self.obs_id, step=self.step,
                   frm=self.state, to=self.HOLD, reason="guard-abort",
                   period=int(self._best_period if adopted
                              else self.last_good_period),
                   detail=("adopt ranked winner" if adopted
                           else "revert to last-good"))
        if adopted:
            # the sweep still produced a cleanly ranked winner: adopting it
            # completes the cycle, so it counts as a re-tune
            self._set_period(self._best_period)
            self.last_good_period = self.period
            self.last_good_cost = min(self.last_good_cost, self._best_cost)
            self.retunes += 1
        else:
            self._set_period(self.last_good_period)
        self.state = self.HOLD
        self.baseline_cost = None
        self._sweep_cost = (float(self._best_cost)
                            if np.isfinite(self._best_cost) else None)
        self._drift_strikes = 0
        self._improve_strikes = 0
        self._guard_strikes = 0
        self._hold_skip = 1 + self.actuation_lag
        # the truncated sweep only half-ranked the ladder: once HOLD
        # re-attests a clean baseline (the burst passed, or the new cost
        # level proved real), finish the job with a warm re-sweep
        self._resweep_pending = True
        self.converged_at = self.step
        self._arm_window()

    def revert_last_good(self, reason: str = "external-fault") -> None:
        """Externally-triggered safety revert: a component outside the
        tuner (e.g. the serving loop's DecisionWorker watchdog) detected a
        fault whose cost telemetry may be garbage, so whatever sweep or
        HOLD window is in flight cannot be trusted.  Drop back to the
        last-good period and re-attest from a fresh HOLD window -- the
        same non-adopting tail as a guard abort, but without charging a
        guard trip (the tuner did nothing wrong) and without ranking the
        half-measured sweep."""
        if (r := _obs.RECORDER).enabled:
            r.emit("tuner.transition", tuner=self.obs_id, step=self.step,
                   frm=self.state, to=self.HOLD, reason="external-revert",
                   period=int(self.last_good_period), detail=reason)
        self._set_period(self.last_good_period)
        self.state = self.HOLD
        self.baseline_cost = None
        self._drift_strikes = 0
        self._improve_strikes = 0
        self._guard_strikes = 0
        self._hold_skip = 1 + self.actuation_lag
        self._resweep_pending = True
        self.converged_at = self.step
        self._arm_window()

    def _should_extend(self) -> bool:
        """Variance-scaled trial windows: extend when the window's
        per-period cost buckets are heavy-tailed (coefficient of variation
        above ``var_cv``), up to ``var_max_factor`` x the base window."""
        if self.var_cv is None:
            return False
        if self._win_target >= self.var_max_factor * self._cost_window():
            return False
        cv = self._tail_bucket_cv()
        return np.isfinite(cv) and cv > self.var_cv

    def _extend_window(self) -> None:
        """Double the trial window: the just-measured noisy segment becomes
        head (warmup) and the ranking tail restarts, so the burst that
        triggered the extension cannot de-noise into the ranking."""
        self.window_extensions += 1
        if (r := _obs.RECORDER).enabled:
            r.emit("tuner.extend", tuner=self.obs_id, step=self.step,
                   cv=float(self._tail_bucket_cv()),
                   win_target=int(self._win_target * 2))
            r.count("tuner.window_extensions")
        self._tail_begin = self._win_target
        self._win_target += self._win_target   # stays a period multiple
        self._tail_cost = 0.0
        self._tail_steps = 0
        self._seg_sum = 0.0
        self._seg_sq = 0.0
        self._seg_n = 0
        self._bucket_cost = 0.0
        self._bucket_steps = 0

    # -- state transitions ---------------------------------------------------
    def _set_period(self, period: float) -> None:
        p = max(1, int(round(period)))
        if p != self.period:
            self.history.append((self.step, p))
            if (r := _obs.RECORDER).enabled:
                r.emit("tuner.period", tuner=self.obs_id, step=self.step,
                       period=p, prev=self.period)
                r.gauge(f"tuner.period.{self.obs_id}", p)
        self.period = p

    def _arm_window(self) -> None:
        """Zero the accumulators and re-arm the measurement window for the
        period now in force (call AFTER ``_set_period``)."""
        self._win_cost = 0.0
        self._win_steps = 0
        self._tail_cost = 0.0
        self._tail_steps = 0
        self._win_target = self._cost_window()
        self._tail_begin = self._win_target - self._tail_window()
        self._seg_sum = 0.0
        self._seg_sq = 0.0
        self._seg_n = 0
        self._bucket_cost = 0.0
        self._bucket_steps = 0

    def _begin_trials(self) -> None:
        hist = self.collector.histogram()
        if hist.num_bins == 0:
            # nothing re-accessed yet: keep the default period, try again
            # after another profile window
            if (r := _obs.RECORDER).enabled:
                r.emit("tuner.profile_extend", tuner=self.obs_id,
                       step=self.step)
            self._arm_window()
            return
        self._launch_trials(hist, reason="profile-complete")

    def _launch_trials(self, hist: ReuseHistogram,
                       reason: str = "profile-complete") -> None:
        self.dominant_reuse = dominant_reuse(hist)
        ladder = candidate_periods(self.dominant_reuse,
                                   float(self.horizon_steps),
                                   max_candidates=self.max_candidates,
                                   min_period=self.min_period)
        # a candidate longer than the trial window cannot be observed even
        # once per window -- clip the ladder (keep at least the head)
        feasible = ladder[ladder <= self.trial_steps]
        cand = feasible if feasible.size else ladder[:1]
        if self.warm_start and self.retunes > 0 and self._warm_next:
            # warm re-tune: explore outward from the previous winner
            # (bandit-style) instead of re-walking the ladder shortest-
            # first -- a mild phase change stops after ~patience+1 trials,
            # a large one still reaches the far end because improvements
            # keep resetting the stopping rule.  After a COLD reset the
            # previous winner is exactly what proved stale, so the sweep
            # reverts to the paper's shortest-first priority order.
            order = np.argsort(np.abs(cand - float(self.last_good_period)),
                               kind="stable")
            cand = cand[order]
        self._warm_next = True
        self.candidates = cand
        self.tried = []
        self._trial_idx = 0
        self._best_cost = np.inf
        self._best_period = self.period
        self._stale = 0
        if (r := _obs.RECORDER).enabled:
            r.emit("tuner.transition", tuner=self.obs_id, step=self.step,
                   frm=self.state, to=self.TRIAL, reason=reason,
                   period=int(max(1, round(cand[0]))),
                   detail=f"ladder {[int(round(c)) for c in cand]}, "
                          f"DR={self.dominant_reuse:.1f}")
        self.state = self.TRIAL
        self._set_period(self.candidates[0])
        self._arm_window()

    def _finish_trial(self) -> None:
        cost = self._tail_cost / max(1, self._tail_steps)
        if not np.isfinite(cost):
            cost = float("inf")
        self.tried.append((float(self.period), cost))
        improved = cost < self._best_cost * (1.0 - self.rel_tol)
        if improved:
            self._best_cost, self._best_period = cost, self.period
            self._stale = 0
        else:
            self._stale += 1
        self._trial_idx += 1
        done = (self._stale >= self.patience
                or self._trial_idx >= len(self.candidates)
                or (self.max_trials is not None
                    and self._trial_idx >= self.max_trials))
        if (r := _obs.RECORDER).enabled:
            r.emit("tuner.trial", tuner=self.obs_id, step=self.step,
                   period=self.period, cost=cost,
                   best_period=int(self._best_period),
                   best_cost=float(self._best_cost), stale=self._stale,
                   improved=improved)
            r.observe("tuner.trial_cost", cost)
            if done:
                r.emit("tuner.transition", tuner=self.obs_id,
                       step=self.step, frm=self.state, to=self.HOLD,
                       reason="sweep-complete",
                       period=int(self._best_period),
                       detail=f"{self._trial_idx} trials, winner "
                              f"p={int(self._best_period)}")
                r.count("tuner.retunes")
        if done:
            self.state = self.HOLD
            self.baseline_cost = None
            self._sweep_cost = (float(self._best_cost)
                                if np.isfinite(self._best_cost) else None)
            self._drift_strikes = 0
            self._improve_strikes = 0
            self._guard_strikes = 0
            # the first HOLD window inherits the residency transient from
            # the period switch (the same transient TRIAL's head discard
            # exists for): skip it before baselining -- plus one window
            # per actuation_lag when the serving loop applies the switch
            # a boundary late
            self._hold_skip = 1 + self.actuation_lag
            self._resweep_pending = False
            self.retunes += 1
            self.converged_at = self.step
            self._set_period(self._best_period)
            if np.isfinite(self._best_cost):
                self.last_good_period = self.period
                self.last_good_cost = self._best_cost
        else:
            self._set_period(self.candidates[self._trial_idx])
        self._arm_window()

    def _check_drift(self) -> None:
        if self._hold_skip:
            # period-switch transient window: measure nothing from it (a
            # clean switch must not fake drift via a polluted baseline)
            self._hold_skip = int(self._hold_skip) - 1
            if (r := _obs.RECORDER).enabled:
                r.emit("tuner.hold_window", tuner=self.obs_id,
                       step=self.step, kind="skip-transient",
                       cost=self._win_cost / max(1, self._win_steps),
                       baseline=self.baseline_cost, strikes=0)
            self._arm_window()
            return
        cost = self._win_cost / max(1, self._win_steps)
        ref = (self.baseline_cost if self.baseline_cost is not None
               else self.last_good_cost)
        if (self.guard_ratio is not None and np.isfinite(ref) and ref > 0
                and cost > self.guard_ratio * ref):
            # guardrail (HOLD): an extreme window is a burst, not a
            # baseline -- discard it entirely.  Only a sustained run of
            # guard-level windows (a regime change, not a flash crowd)
            # forces the re-profile.
            self.guard_trips += 1
            self._guard_strikes += 1
            self._drift_strikes = 0
            self._improve_strikes = 0
            escalate = self._guard_strikes >= self.drift_patience
            if (r := _obs.RECORDER).enabled:
                r.emit("tuner.guard", tuner=self.obs_id, step=self.step,
                       where="hold",
                       verdict="escalate" if escalate else "discard",
                       cv=float("nan"), ref=float(ref), cost=cost)
                r.emit("tuner.hold_window", tuner=self.obs_id,
                       step=self.step, kind="discard-guard", cost=cost,
                       baseline=self.baseline_cost,
                       strikes=self._guard_strikes)
                r.count("tuner.guard_trips")
            if escalate:
                self._reprofile(cold=True, reason="guard-escalate")
            self._arm_window()
            return
        self._guard_strikes = 0
        if self.baseline_cost is None:
            floored = (self._sweep_cost is not None
                       and self._sweep_cost > cost)
            if self._sweep_cost is not None:
                # the first clean window after a sweep can *undershoot* the
                # regime's steady cost (residency is still settling), and a
                # too-low baseline arms a hair-trigger drift detector -- the
                # mirror image of the transient the _hold_skip window
                # discards.  Floor the baseline with the winner's attested
                # trial cost so one quiet window cannot set the reference.
                cost = max(cost, self._sweep_cost)
            self.baseline_cost = cost
            if (r := _obs.RECORDER).enabled:
                r.emit("tuner.baseline", tuner=self.obs_id, step=self.step,
                       cost=cost, floored=floored)
            if np.isfinite(cost):
                self.last_good_period = self.period
                self.last_good_cost = cost
            if self._resweep_pending:
                # a guard abort truncated the last sweep; the clean window
                # just re-anchored the guardrail, so re-rank the ladder now
                # (warm -- explores outward from the adopted fallback)
                self._resweep_pending = False
                self._reprofile(reason="resweep")
        elif cost > self.drift_ratio * max(self.baseline_cost, 1e-12):
            self._drift_strikes += 1
            self._improve_strikes = 0
            if (r := _obs.RECORDER).enabled:
                r.emit("tuner.hold_window", tuner=self.obs_id,
                       step=self.step, kind="drift-strike", cost=cost,
                       baseline=self.baseline_cost,
                       strikes=self._drift_strikes)
            if self._drift_strikes >= self.drift_patience:
                # sustained regression == workload phase change: stale
                # reuse info is worse than none
                self._reprofile(reason="drift")
        elif (self.improve_ratio is not None
              and cost * self.improve_ratio < self.baseline_cost):
            self._improve_strikes += 1
            self._drift_strikes = 0
            if (r := _obs.RECORDER).enabled:
                r.emit("tuner.hold_window", tuner=self.obs_id,
                       step=self.step, kind="improve-strike", cost=cost,
                       baseline=self.baseline_cost,
                       strikes=self._improve_strikes)
            if self._improve_strikes >= self.improve_patience:
                # sustained *improvement* is a phase change too: the new,
                # cheaper mix may admit an even better period than the one
                # tuned against the old mix
                self._reprofile(reason="improve")
        else:
            self._drift_strikes = 0
            self._improve_strikes = 0
            if (r := _obs.RECORDER).enabled:
                r.emit("tuner.hold_window", tuner=self.obs_id,
                       step=self.step, kind="ok", cost=cost,
                       baseline=self.baseline_cost, strikes=0)
        self._arm_window()

    def _reprofile(self, cold: bool = False, reason: str = "manual") -> None:
        self._drift_strikes = 0
        self._improve_strikes = 0
        self._guard_strikes = 0
        if not cold and self.warm_start:
            # warm re-tune: the rolling collector window is still live, so
            # the ladder can be rebuilt NOW and trialed outward from the
            # previous winner -- skipping the PROFILE stage entirely.  The
            # window may still carry some pre-drift reuse, but the trials
            # rank candidates by *measured* cost, so a skewed ladder costs
            # at most a few extra trials (and the next drift window gets a
            # fresher histogram).
            hist = self.collector.histogram()
            if hist.num_bins > 0:
                self._launch_trials(hist, reason=f"warm-{reason}")
                return
        # cold reset (guard-strike escalation, or nothing collected yet):
        # stale reuse info is worse than none.  A drift-triggered WARM
        # re-tune keeps last_good_cost as the guard anchor (a mild drift
        # sits far below the guard ratio); only the cold path -- reached
        # when sustained guard-level cost proves a genuine regime change
        # -- drops the stale anchor, so the fresh sweep cannot be trapped
        # aborting against a cost level that no longer exists
        self.last_good_cost = float("inf")
        self._warm_next = False
        self.collector.reset()
        if (r := _obs.RECORDER).enabled:
            r.emit("tuner.transition", tuner=self.obs_id, step=self.step,
                   frm=self.state, to=self.PROFILE,
                   reason=f"cold-{reason}", period=self.period,
                   detail="reuse collector reset")
        self.state = self.PROFILE

    # -- multi-request traffic hooks -----------------------------------------
    def forget_pages(self, ids: np.ndarray) -> None:
        """Invalidate freed logical page IDs in the reuse collector (see
        ``StreamingReuseCollector.forget``): called by the serving scheduler
        when a request retires, so a recycled global page ID does not pair
        the new owner's first access with the old owner's last one."""
        self.collector.forget(ids)


def trials_to_best(runtimes_in_order: Sequence[float], tol: float = 0.005
                   ) -> int:
    """Number of trials until a candidate within `tol` of the sequence's own
    best has been tried (the Fig. 5a metric)."""
    rts = np.asarray(list(runtimes_in_order), dtype=np.float64)
    if rts.size == 0:
        return 0
    target = rts.min() * (1.0 + tol)
    return int(np.argmax(rts <= target)) + 1
