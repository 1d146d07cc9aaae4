"""Fault-tolerance runtime pieces that run *inside* the training process
(a copy of ``repro/ft/monitor.py``).

``StepTimer``   -- EMA step-time tracker with straggler detection (a step
                   slower than ``threshold x EMA`` is flagged; at scale the
                   flag feeds the supervisor / scheduler to hot-swap the
                   slow host -- here it increments counters and callbacks).
``Heartbeat``   -- background thread touching a file every ``interval``;
                   the supervisor treats a stale heartbeat as a hang (the
                   failure mode checkpoint-restart alone cannot catch).
``Pulse``       -- Heartbeat's in-memory, in-process twin: a worker
                   *thread* touches it around units of work and a watcher
                   thread reads ``age()``; same staleness contract, no
                   filesystem (the DecisionWorker watchdog uses it to
                   tell hung from slow).
``FailureInjector`` -- deterministic fault injection (env
                   ``REPRO_FAIL_AT_STEP``) used by the restart tests.
"""
from __future__ import annotations

import os
import pathlib
import threading
import time
from typing import Callable, List, Optional

from repro_torch.obs import telemetry as _obs

__all__ = ["StepTimer", "Heartbeat", "Pulse", "FailureInjector"]


class StepTimer:
    """EMA step-time tracker with straggler detection.

    When ``name`` is given the timer reports into the flight recorder: a
    straggler emits an ``ft.straggler`` event and every stop observes the
    ``<name>.step_s`` histogram (the training loop and the serving macro
    loop share this path)."""

    def __init__(self, ema_alpha: float = 0.1, threshold: float = 3.0,
                 warmup: int = 3,
                 on_straggler: Optional[Callable[[int, float, float], None]]
                 = None, name: Optional[str] = None):
        self.ema_alpha = ema_alpha
        self.threshold = threshold
        self.warmup = warmup
        self.on_straggler = on_straggler
        self.name = name
        self.ema: Optional[float] = None
        self.count = 0
        self.stragglers: List[int] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> float:
        dt = time.monotonic() - self._t0
        self.count += 1
        straggler = False
        ema_ref = self.ema
        if self.ema is None:
            self.ema = dt
        elif self.count <= self.warmup:
            self.ema = 0.5 * self.ema + 0.5 * dt
        else:
            if dt > self.threshold * self.ema:
                straggler = True
                self.stragglers.append(step)
                if self.on_straggler:
                    self.on_straggler(step, dt, self.ema)
            self.ema = (1 - self.ema_alpha) * self.ema + self.ema_alpha * dt
        if self.name is not None and (r := _obs.RECORDER).enabled:
            r.observe(f"{self.name}.step_s", dt)
            if straggler:
                r.emit("ft.straggler", timer=self.name, step=int(step),
                       dt_s=dt, ema_s=float(ema_ref))
                r.count("ft.stragglers")
        return dt


class Heartbeat:
    def __init__(self, path, interval: float = 1.0):
        self.path = pathlib.Path(path)
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.path.write_text(str(time.time()))
            self._stop.wait(self.interval)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *a):
        self._stop.set()
        self._thread.join(timeout=2)

    @staticmethod
    def age(path) -> float:
        try:
            return time.time() - float(pathlib.Path(path).read_text())
        except (OSError, ValueError):
            return float("inf")


class Pulse:
    """In-memory heartbeat between two threads of one process.

    The worked thread calls ``touch()`` around each unit of work (the
    DecisionWorker touches before and after every ``fn`` call); a watcher
    reads ``age()`` -- seconds since the last touch, ``inf`` before the
    first.  Same staleness contract as :meth:`Heartbeat.age`, minus the
    filesystem: a watcher with a timeout distinguishes *hung* (age keeps
    growing past the deadline) from *slow but alive*.  Writes and reads
    of a float are atomic under the GIL, so there is no lock."""

    def __init__(self):
        self._last: Optional[float] = None

    def touch(self) -> None:
        self._last = time.monotonic()

    def age(self) -> float:
        last = self._last
        return float("inf") if last is None else time.monotonic() - last


class FailureInjector:
    """Crash deterministically at REPRO_FAIL_AT_STEP (once, flagged by a
    sentinel file so the restarted process survives)."""

    ENV = "REPRO_FAIL_AT_STEP"

    def __init__(self, workdir):
        self.fail_at = int(os.environ.get(self.ENV, "-1"))
        self.sentinel = pathlib.Path(workdir) / ".failure_injected"

    def check(self, step: int):
        if (self.fail_at >= 0 and step == self.fail_at
                and not self.sentinel.exists()):
            self.sentinel.write_text(str(step))
            raise RuntimeError(f"injected failure at step {step}")
