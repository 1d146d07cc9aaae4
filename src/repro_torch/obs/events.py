"""Event taxonomy: the closed registry of flight-recorder event types.

Every ``Recorder.emit`` call site in ``src/`` must name a type registered
here, and every registered type must appear in the taxonomy table of
``docs/observability.md`` -- both directions are enforced by
``scripts/check_events.py`` in CI, so instrumentation and docs cannot
drift apart.  ``Recorder.emit`` itself rejects unregistered types at
runtime.

This module is deliberately stdlib-only (no numpy/jax): the CI docs job
loads it standalone to cross-check the docs table without installing the
runtime dependencies.

Field-name contract: ``seq``, ``t`` and ``type`` are reserved (the
envelope the Recorder wraps every event in); event fields must not reuse
them so the JSONL export can stay flat.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

__all__ = ["Event", "EVENTS", "RESERVED_FIELDS"]

RESERVED_FIELDS = ("seq", "t", "type")


class Event(NamedTuple):
    """One registered event type: its field names and what it records."""
    name: str
    domain: str                 # tuner | tier | pool | serve | ft | meta
    fields: Tuple[str, ...]
    description: str


def _ev(name: str, fields: Tuple[str, ...], description: str) -> Event:
    domain = name.split(".", 1)[0]
    for f in fields:
        if f in RESERVED_FIELDS:
            raise ValueError(f"{name}: field {f!r} shadows the envelope")
    return Event(name, domain, fields, description)


_ALL = [
    # -- tuner: the OnlineTuner decision path (step domain) ------------------
    _ev("tuner.transition",
        ("tuner", "step", "frm", "to", "reason", "period", "detail"),
        "OnlineTuner state change (PROFILE/TRIAL/HOLD) with the decision "
        "reason -- profile-complete, sweep-complete, warm-/cold- re-tune "
        "cause, guard abort/escalation"),
    _ev("tuner.period",
        ("tuner", "step", "period", "prev"),
        "the live tiering period changed (trial candidate switch, sweep "
        "winner adoption, guard revert)"),
    _ev("tuner.trial",
        ("tuner", "step", "period", "cost", "best_period", "best_cost",
         "stale", "improved"),
        "one TRIAL candidate finished: tail-mean per-step cost and its "
        "effect on the sweep ranking"),
    _ev("tuner.guard",
        ("tuner", "step", "where", "verdict", "cv", "ref", "cost"),
        "cost-spike guardrail trip: TRIAL burst-vs-regime verdict, or a "
        "discarded guard-level HOLD window"),
    _ev("tuner.extend",
        ("tuner", "step", "cv", "win_target"),
        "variance-scaled trial window doubled (tail bucket CV above "
        "var_cv); the tail restarts"),
    _ev("tuner.baseline",
        ("tuner", "step", "cost", "floored"),
        "HOLD baseline (re-)attested from a clean window; floored=True "
        "when the sweep winner's trial cost raised it"),
    _ev("tuner.hold_window",
        ("tuner", "step", "kind", "cost", "baseline", "strikes"),
        "one HOLD measurement window closed: skip-transient, "
        "discard-guard, drift-strike, improve-strike or ok"),
    _ev("tuner.profile_extend",
        ("tuner", "step"),
        "PROFILE window elapsed with an empty reuse histogram; profiling "
        "continues for another window"),
    # -- tiering: the page scheduler (step domain) ---------------------------
    _ev("tier.move",
        ("manager", "step", "period", "promoted", "evicted", "pages_moved",
         "cost"),
        "one tiering boundary: pages promoted into HBM, lazily evicted, "
        "total pages of data moved (promotions x the geometry's leaf "
        "planes: k+v, ckv+krope, state) and the modeled "
        "migration+wakeup cost"),
    _ev("tier.move_failed",
        ("manager", "step", "pages", "attempts", "detail"),
        "a planned promotion's migrate_slots failed after bounded "
        "retries: the slot bookkeeping is rolled back, the pages stay "
        "host-resident (demand-fetched later) and the failure is priced "
        "into the tuner's window"),
    # -- pool: the shared slot pool (step domain) ----------------------------
    _ev("pool.attach",
        ("layers", "leaves", "planes"),
        "per-geometry cache leaves attached to a SharedPagedPools: layer "
        "count, the leaf-name set (k,v / ckv,krope / state), and how many "
        "planes one page migration moves"),
    # -- serve: the continuous-batching scheduler (wall clock) ---------------
    _ev("serve.admit",
        ("step", "joiners", "pages", "queue_depth", "wall_ms", "stall_ms"),
        "one admission batch: requests packed-prefilled together, pages "
        "allocated, queue depth after, prefill wall time; the pipelined "
        "loop adds stall_ms, the batch's worst reservation-to-activation "
        "admission stall (the SLO the chunk knob trades against)"),
    _ev("serve.retire",
        ("step", "rid", "tokens", "status", "deadline_ms"),
        "a request left the system with a typed terminal status -- "
        "completed (EOS or length), shed (bounded-queue overflow) or "
        "expired (deadline passed while queued) -- plus wall "
        "milliseconds from submit to retirement; its pages recycle"),
    _ev("serve.preempt",
        ("step", "rid", "pages", "mass", "hbm_need", "hbm_cap"),
        "pool pressure froze the coldest active request (by Cori page "
        "mass): its resident pages demoted to host, HBM slots released, "
        "caches kept intact for later reactivation without recompute"),
    _ev("serve.shed",
        ("step", "rid", "reason", "queue_depth"),
        "admission control refused a request: queue-full at submit or "
        "deadline expiry while waiting; the request retires with a "
        "typed non-completed status instead of stalling the batch"),
    _ev("serve.worker_restart",
        ("step", "reason", "restarts", "degraded"),
        "the DecisionWorker watchdog fired (hang or crash): the boundary "
        "fell back to a synchronous decision, the tuner reverted to "
        "last-good, and the worker was relaunched (degraded=True once "
        "restarts are exhausted and the loop stays synchronous)"),
    _ev("serve.macro",
        ("step", "n_steps", "tokens", "active", "fetched", "wall_ms",
         "straggler"),
        "one macro-step launch: a movement period of device-resident "
        "decode -- scan length, tokens served, mean active rows, up-front "
        "prefetch misses, wall time, StepTimer straggler flag"),
    _ev("serve.stream",
        ("phase", "tokens", "wall_ms"),
        "single-stream monitored_generate started/finished"),
    _ev("serve.pipeline.stage",
        ("step", "stage", "wall_ms"),
        "one overlap-window stage of the pipelined macro loop finished "
        "behind the in-flight scan: decision_wait, prefetch, tables or "
        "admit"),
    _ev("serve.pipeline.decision",
        ("step", "generation", "period", "bring", "evict", "wait_ms"),
        "a background-worker tiering/tuner decision was applied at a "
        "macro boundary (the stale-by-one hand-off): its generation, the "
        "period adopted, planned bring/evict sizes, and how long the "
        "overlap window waited for it"),
    _ev("serve.pipeline.admit_chunk",
        ("step", "rid", "chunk", "tokens", "total", "wall_ms", "done"),
        "one bounded prefill chunk of a long-prompt admission was "
        "dispatched between macro launches (the SLO admission knob); "
        "done=True marks the request's final chunk"),
    # -- ft: fault-tolerance runtime -----------------------------------------
    _ev("ft.straggler",
        ("timer", "step", "dt_s", "ema_s"),
        "StepTimer flagged a step slower than threshold x EMA (serving "
        "macro launches and the training step share this event)"),
    _ev("ft.inject",
        ("kind", "clock", "count", "value"),
        "a FaultPlan injection point fired: the fault kind, the plan's "
        "logical clock, this kind's occurrence counter and the point's "
        "magnitude parameter (chaos runs replay deterministically from "
        "the plan seed)"),
    # -- meta: records written by the exporters, never emit()ed --------------
    _ev("metrics.summary",
        ("schema", "counters", "gauges", "hists"),
        "final JSONL record: the Recorder's counters/gauges/histogram "
        "summaries (written by the exporter, not an emit site)"),
]

EVENTS: Dict[str, Event] = {e.name: e for e in _ALL}
