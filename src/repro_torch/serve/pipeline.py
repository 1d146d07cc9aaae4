"""Background decision worker for the pipelined macro serving loop (a copy
of ``repro/serve/pipeline.py``: host only, no device work).

The pipelined ``ContinuousBatcher`` ("Pipelined macro loop" in the
reference's serving docs) moves the per-boundary control work -- the
``TieringManager`` accounting, the tiering *plan* and the
``OnlineTuner`` update -- off the dispatch path onto this worker thread,
so it runs while the next macro is in flight on the device.  The
hand-off is deterministic by construction:

  * the dispatch thread ``submit``s exactly one mass snapshot per macro
    boundary and later blocks in ``wait`` for that generation's result;
  * the worker consumes submissions strictly in order and publishes
    exactly one result per generation;
  * between ``wait(g)`` returning and the next ``submit(g+1)`` the
    worker is provably idle (it finished generation ``g`` and has
    nothing queued), so the dispatch thread may touch the shared
    manager/tuner state in that window without locks.

That strict alternation is the documented **stale-by-one contract**: the
decision computed from macro ``k``'s masses is waited on -- and applied
-- in the overlap window of macro ``k+1``, i.e. it takes effect for
macro ``k+2``'s launch.  The dispatch path never blocks on the tuner at
launch time; it blocks only behind an already-launched scan.

The worker is deliberately generic (it runs any ``fn(payload)``), so the
hand-off protocol is testable without a model (the tests hammer it from
a fake dispatch thread).

Watchdog support: each worker maintains a :class:`Pulse` (an in-memory
heartbeat it touches around every ``fn`` call), so a supervisor blocking
in ``wait(generation, timeout=...)`` can tell a *hung* worker (pulse
stale -- ``fn`` never returned) from a merely *slow* one, and
``abandon()`` lets it walk away from a wedged thread without the 30s
``close`` join: the thread is daemonic and its inbox is poisoned, so a
zombie that eventually wakes finds nothing to do and exits.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional, Tuple

from repro_torch.ft.monitor import Pulse

__all__ = ["DecisionWorker"]


class DecisionWorker:
    """One background thread turning boundary snapshots into decisions.

    ``submit(payload)`` enqueues a snapshot and returns its generation
    number; ``wait(generation)`` blocks until that generation's
    ``fn(payload)`` result is published and returns ``(result,
    waited_seconds)``.  Exceptions raised by ``fn`` are re-raised in
    ``wait`` (the dispatch thread is the error domain; the worker never
    dies silently).  ``close()`` drains and joins the thread.
    """

    def __init__(self, fn: Callable[[Any], Any], *,
                 name: str = "decision-worker"):
        self._fn = fn
        self._inbox: "queue.Queue[Optional[Tuple[int, Any]]]" = queue.Queue()
        self._results: dict = {}
        self._errors: dict = {}
        self._cv = threading.Condition()
        self._next_gen = 0
        self._closed = False
        #: in-memory heartbeat: touched around every ``fn`` call, so a
        #: watchdog can tell a hung worker (stale pulse) from a slow one
        self.pulse = Pulse()
        self.pulse.touch()
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    # -- dispatch-thread API -------------------------------------------------
    def submit(self, payload: Any) -> int:
        """Enqueue one boundary snapshot; returns its generation number."""
        if self._closed:
            raise RuntimeError("DecisionWorker is closed")
        gen = self._next_gen
        self._next_gen += 1
        self._inbox.put((gen, payload))
        return gen

    def wait(self, generation: int,
             timeout: Optional[float] = None) -> Tuple[Any, float]:
        """Block until ``generation``'s decision is published.  Returns
        ``(result, waited_seconds)``; re-raises the worker's exception if
        ``fn`` failed on that generation."""
        t0 = time.monotonic()
        with self._cv:
            while (generation not in self._results
                   and generation not in self._errors):
                if not self._cv.wait(timeout=timeout):
                    raise TimeoutError(
                        f"decision generation {generation} not published "
                        f"within {timeout}s")
            if generation in self._errors:
                raise self._errors.pop(generation)
            return self._results.pop(generation), time.monotonic() - t0

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker: no further submits; pending work is drained."""
        if self._closed:
            return
        self._closed = True
        self._inbox.put(None)
        self._thread.join(timeout=timeout)

    def abandon(self) -> None:
        """Walk away from a wedged worker WITHOUT joining it: mark the
        worker closed and poison its inbox so the (daemonic) thread exits
        whenever it wakes up.  The watchdog uses this after a ``wait``
        timeout -- a hung ``fn`` would make ``close()``'s join block for
        its full timeout -- then builds a fresh worker.  Results the
        zombie eventually publishes land in its own orphaned dicts and
        are never observed."""
        if self._closed:
            return
        self._closed = True
        self._inbox.put(None)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._closed

    # -- worker thread -------------------------------------------------------
    def _loop(self) -> None:
        while True:
            item = self._inbox.get()
            if item is None:
                return
            gen, payload = item
            self.pulse.touch()
            try:
                result, err = self._fn(payload), None
            except BaseException as e:          # published, not swallowed
                result, err = None, e
            self.pulse.touch()
            with self._cv:
                if err is None:
                    self._results[gen] = result
                else:
                    self._errors[gen] = err
                self._cv.notify_all()

    def __enter__(self) -> "DecisionWorker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
