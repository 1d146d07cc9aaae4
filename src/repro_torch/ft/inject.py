"""Deterministic, seedable fault injection for the serving stack.

A :class:`FaultPlan` is a set of typed injection points threaded through
``SharedPagedPools``, ``TieringManager``, ``DecisionWorker`` and
``ContinuousBatcher``.  Each component *asks* the plan whether its fault
fires at the current point (``plan.fires("pool.migrate_fail")``) instead
of the plan reaching into the component -- so production code paths stay
fault-free when no plan is installed (the default is a shared inert plan
whose every query is two attribute loads and a dict miss).

Determinism contract: a fault decision is a pure function of
``(seed, kind, occurrence_counter)`` -- *not* of wall clock or global
RNG state -- so the same plan replays the same fault schedule on every
run.  The plan keeps a logical ``clock`` advanced once per scheduler
step by the component that owns the plan (the batcher), which windows
each point to a ``[start, stop)`` span of steps.

Injection points (the chaos matrix):

=====================  =====================================================
``pool.squeeze``       HBM capacity squeeze: ``effective_hbm`` drops to
                       ``value`` pages while active (pressure, preemption)
``pool.migrate_fail``  ``migrate_slots`` raises :class:`MigrationError`
                       (retry-with-backoff, degraded pinned-to-host mode)
``pool.migrate_slow``  ``migrate_slots`` sleeps ``value`` seconds first
``worker.delay``       the DecisionWorker sleeps ``value`` seconds before
                       planning (watchdog hang detection)
``worker.crash``       the DecisionWorker raises before planning
                       (watchdog crash recovery)
``mass.nonfinite``     the merged page-mass telemetry is corrupted with
                       NaN/inf before it reaches the monitor
``admit.flood``        the submit queue bound is ignored for this request
                       (admission flood; deadline shedding must absorb it)
=====================  =====================================================
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Tuple

from repro_torch.obs import telemetry as _obs

__all__ = ["FAULT_KINDS", "FaultPoint", "FaultPlan", "MigrationError",
           "NULL_PLAN"]

#: The closed registry of injection-point kinds.
FAULT_KINDS = (
    "pool.squeeze",
    "pool.migrate_fail",
    "pool.migrate_slow",
    "worker.delay",
    "worker.crash",
    "mass.nonfinite",
    "admit.flood",
)


class MigrationError(RuntimeError):
    """A slot migration failed (injected or real transport error)."""


@dataclasses.dataclass(frozen=True)
class FaultPoint:
    """One injection point: *kind* fires with *prob* inside ``[start,
    stop)`` of the plan's logical clock; *value* is the kind-specific
    magnitude (squeeze capacity in pages, delay in seconds)."""
    kind: str
    start: int = 0
    stop: int = 2 ** 31
    prob: float = 1.0
    value: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"registered: {FAULT_KINDS}")


class FaultPlan:
    """A deterministic schedule of fault injections.

    ``fires(kind)`` is the single query surface: it checks the clock
    window, then samples a per-occurrence coin from
    ``sha256(seed, kind, counter)`` -- each call advances that kind's
    counter, so the decision sequence is reproducible as long as each
    kind is queried from one code path (true here: every kind has
    exactly one owner site).  Firing emits an ``ft.inject`` event and
    bumps ``fired[kind]`` so chaos tests can assert coverage.
    """

    def __init__(self, points=(), *, seed: int = 0):
        self.points: Tuple[FaultPoint, ...] = tuple(points)
        self.seed = int(seed)
        self.clock = 0
        self._counts: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}
        self._by_kind: Dict[str, Tuple[FaultPoint, ...]] = {}
        for p in self.points:
            self._by_kind.setdefault(p.kind, ())
            self._by_kind[p.kind] += (p,)

    @property
    def enabled(self) -> bool:
        return bool(self.points)

    def tick(self) -> None:
        """Advance the logical clock (once per scheduler step)."""
        self.clock += 1

    def _coin(self, kind: str, count: int) -> float:
        h = hashlib.sha256(
            f"{self.seed}:{kind}:{count}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64

    def active(self, kind: str):
        """The first point of *kind* whose window covers the clock, or
        None.  Does NOT advance counters (pure span check -- used for
        level-style faults like the capacity squeeze)."""
        for p in self._by_kind.get(kind, ()):
            if p.start <= self.clock < p.stop:
                return p
        return None

    def fires(self, kind: str):
        """Sample whether *kind* fires now; returns the firing
        :class:`FaultPoint` or None.  Advances the kind's occurrence
        counter on every in-window query (hit or miss) so the schedule
        is independent of earlier outcomes."""
        p = self.active(kind)
        if p is None:
            return None
        count = self._counts.get(kind, 0)
        self._counts[kind] = count + 1
        if p.prob < 1.0 and self._coin(kind, count) >= p.prob:
            return None
        n = self.fired.get(kind, 0) + 1
        self.fired[kind] = n
        if (r := _obs.RECORDER).enabled:
            r.emit("ft.inject", kind=kind, clock=self.clock, count=n,
                   value=float(p.value))
            r.count(f"ft.inject.{kind}")
        return p


#: Shared inert plan: every query is a dict miss.  Components default to
#: this so the unfaulted hot path never branches on plan identity.
NULL_PLAN = FaultPlan()
