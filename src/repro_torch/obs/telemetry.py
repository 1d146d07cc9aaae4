"""The flight recorder: typed ring-buffer events + counters/gauges/histograms.

One process-global ``Recorder`` (module attribute ``RECORDER``; swap it
with ``install``) collects everything the instrumented stack emits:

  * **Events** -- typed records (``emit``) appended to a bounded ring
    buffer: O(1) append, fixed memory, oldest events overwritten (the
    flight-recorder property: the tail of history is always available,
    however long the run).  Every type must be registered in
    ``repro.obs.events.EVENTS`` -- the taxonomy CI keeps in lockstep with
    ``docs/observability.md``.
  * **Counters** -- monotonically accumulated floats (``count``).
  * **Gauges** -- last-value floats (``gauge``).
  * **Histograms** -- streaming fixed-geometric-bucket quantile sketches
    (``observe``): bounded memory, ~9% relative quantile error
    (``ratio = 2**0.25`` buckets), exact count/sum/min/max.

Hot-path contract: instrumented code guards every emission with
``if (r := RECORDER).enabled:`` so a disabled recorder costs one
attribute load and one branch -- no kwargs dict, no event record, zero
allocations.  ``emit`` itself also checks, so un-guarded call sites are
merely slower, never wrong.

The recorder is multi-writer: the pipelined serving loop emits from both
the dispatch thread and the background decision worker, so every mutation
(``emit``/``count``/``gauge``/``observe``) takes one shared lock.  The
lock is uncontended in the common case (a handful of emissions per macro
boundary) and sits behind the ``enabled`` fast-path check, so the
disabled cost is still one attribute load and one branch.  Exporters read
snapshots (``events()``/``summary()``), so a reader racing a writer sees
a consistent prefix at worst.
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.events import EVENTS

__all__ = ["Histogram", "Recorder", "RECORDER", "install", "get"]


class Histogram:
    """Streaming quantiles over fixed geometric buckets.

    Bucket ``i`` spans ``[lo * ratio**i, lo * ratio**(i+1))``; quantiles
    interpolate linearly inside the crossing bucket, so the relative
    error is bounded by ``ratio - 1`` (~9% at the default quarter-octave
    buckets).  Non-positive observations land in bucket 0, non-finite
    ones in the overflow bucket; count/sum/min/max are exact over finite
    observations."""

    __slots__ = ("lo", "ratio", "counts", "count", "total", "vmin", "vmax",
                 "nonfinite", "_inv_log_ratio", "_log_lo")

    def __init__(self, lo: float = 1e-9, ratio: float = 2.0 ** 0.25,
                 n_buckets: int = 256):
        self.lo = float(lo)
        self.ratio = float(ratio)
        self.counts = np.zeros(n_buckets + 1, np.int64)  # [+overflow]
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.nonfinite = 0
        self._inv_log_ratio = 1.0 / math.log(self.ratio)
        self._log_lo = math.log(self.lo)

    def observe(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            self.nonfinite += 1
            self.counts[-1] += 1
            return
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= self.lo:
            i = 0
        else:
            i = int((math.log(v) - self._log_lo) * self._inv_log_ratio)
            if i >= self.counts.shape[0] - 1:
                i = self.counts.shape[0] - 2
        self.counts[i] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (clamped to the exact min/max)."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts[:-1]):
            if c == 0:
                continue
            if cum + c >= target:
                frac = (target - cum) / c
                b_lo = self.lo * self.ratio ** i
                b_hi = b_lo * self.ratio
                est = b_lo + frac * (b_hi - b_lo)
                return float(min(max(est, self.vmin), self.vmax))
            cum += c
        return float(self.vmax)

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "nonfinite": self.nonfinite}
        return {"count": self.count, "mean": self.mean,
                "min": self.vmin, "max": self.vmax,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99), "sum": self.total,
                "nonfinite": self.nonfinite}


class Recorder:
    """Process-global flight recorder (see module docstring).

    ``capacity`` bounds the event ring; ``dropped`` counts overwritten
    events so a truncated log is detectable.  ``enabled`` is a plain
    attribute: flip it to pause/resume recording (hot paths re-read it
    per emission)."""

    def __init__(self, capacity: int = 65536, enabled: Optional[bool] = None):
        if capacity <= 0:
            raise ValueError(f"ring capacity must be positive: {capacity}")
        self.capacity = int(capacity)
        self.enabled = (os.environ.get("REPRO_OBS", "1") != "0"
                        if enabled is None else bool(enabled))
        self._ring: List[Optional[Tuple[int, float, str, dict]]] = \
            [None] * self.capacity
        self._seq = 0
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, Histogram] = {}
        self._t0 = time.monotonic()
        # serialises writers: the pipelined serving loop emits from the
        # dispatch thread AND the background decision worker
        self._lock = threading.Lock()

    # -- events --------------------------------------------------------------
    def emit(self, etype: str, **fields: Any) -> None:
        """Append one typed event (no-op when disabled).  ``etype`` must
        be registered in ``repro.obs.events.EVENTS``."""
        if not self.enabled:
            return
        if etype not in EVENTS:
            raise KeyError(f"unregistered event type {etype!r}: add it to "
                           "repro.obs.events.EVENTS (and the docs taxonomy)")
        with self._lock:
            seq = self._seq
            self._ring[seq % self.capacity] = (
                seq, time.monotonic() - self._t0, etype, fields)
            self._seq = seq + 1

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wrap-around."""
        return max(0, self._seq - self.capacity)

    def events(self, etype: Optional[str] = None,
               prefix: Optional[str] = None) -> List[Dict[str, Any]]:
        """Snapshot the ring in emission order as flat dicts
        (``seq``/``t``/``type`` envelope + the event's fields)."""
        n = min(self._seq, self.capacity)
        start = self._seq - n
        out = []
        for s in range(start, self._seq):
            rec = self._ring[s % self.capacity]
            if rec is None:
                continue
            seq, t, typ, fields = rec
            if etype is not None and typ != etype:
                continue
            if prefix is not None and not typ.startswith(prefix):
                continue
            out.append({"seq": seq, "t": t, "type": typ, **fields})
        return out

    # -- metrics -------------------------------------------------------------
    def count(self, name: str, delta: float = 1.0) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + delta

    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = Histogram()
            h.observe(value)

    def summary(self) -> Dict[str, Any]:
        """Counters, gauges and histogram summaries as one JSON-ready
        dict (the ``metrics.summary`` record of the JSONL export; the
        benchmark JSON schema embeds it verbatim)."""
        return {
            "counters": dict(sorted(self.counters.items())),
            "gauges": dict(sorted(self.gauges.items())),
            "hists": {k: self.hists[k].summary()
                      for k in sorted(self.hists)},
            "events_recorded": self._seq,
            "events_dropped": self.dropped,
        }

    def clear(self) -> None:
        """Drop all events and metrics (the ring keeps its capacity)."""
        with self._lock:
            self._ring = [None] * self.capacity
            self._seq = 0
            self.counters.clear()
            self.gauges.clear()
            self.hists.clear()
            self._t0 = time.monotonic()


#: The process-global recorder every instrumented module reads through
#: module-attribute access (``telemetry.RECORDER``), so ``install`` swaps
#: it everywhere at once.  ``REPRO_OBS=0`` disables recording at import.
RECORDER = Recorder()


def install(recorder: Recorder) -> Recorder:
    """Replace the process-global recorder (tests/benchmarks isolate
    their event streams with a fresh one); returns it."""
    global RECORDER
    RECORDER = recorder
    return recorder


def get() -> Recorder:
    return RECORDER
