"""Synthetic page-access workloads for the tiering runtime (the
reference's ``repro/memtier/workload.py``, numpy only, unchanged).

Decode-time KV access patterns from the serving literature, in the same
spirit as ``core.traces`` but in the (decode-step x page) domain:

  * ``attention_sink``  -- heavy mass on the first pages (sink tokens) +
                           a sliding recent window: the canonical decode
                           pattern; strong short reuse on sinks.
  * ``periodic_context``-- the model repeatedly re-reads a document span
                           every ~K steps (RAG/agent loops): reuse
                           distance == K, the Cori sweet spot.
  * ``random_lookup``   -- zipf random page touches (retrieval-ish).
"""
from __future__ import annotations

import numpy as np

__all__ = ["attention_sink", "periodic_context", "random_lookup"]


def attention_sink(steps: int, n_pages: int, sink_pages: int = 2,
                   window_pages: int = 4, seed: int = 0,
                   drift_every: int = 2) -> np.ndarray:
    """``drift_every`` = decode steps between moves of the recent window; at
    1 the hot set moves every step, so the best tiering period is
    unambiguously the shortest (no aliasing between tier cadence and
    drift)."""
    rng = np.random.default_rng(seed)
    m = np.zeros((steps, n_pages), np.float32)
    for t in range(steps):
        m[t, :sink_pages] = 0.3 + 0.1 * rng.random(sink_pages)
        cur = min(n_pages - 1, (t // drift_every) % n_pages)
        lo = max(0, cur - window_pages)
        m[t, lo:cur + 1] = 0.2 + 0.1 * rng.random(cur + 1 - lo)
    return m


def periodic_context(steps: int, n_pages: int, span_pages: int = 8,
                     period: int = 16, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = np.zeros((steps, n_pages), np.float32)
    span0 = n_pages // 4
    for t in range(steps):
        m[t, :1] = 0.3                      # sink
        if (t % period) < span_pages:       # re-read the span, one page/step
            m[t, span0 + (t % period)] = 0.5
        m[t, min(n_pages - 1, t % n_pages)] += 0.2   # recent window
    return m


def random_lookup(steps: int, n_pages: int, touches: int = 3,
                  zipf_a: float = 1.5, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = np.zeros((steps, n_pages), np.float32)
    ranks = np.arange(1, n_pages + 1, dtype=np.float64)
    p = ranks ** (-zipf_a)
    p /= p.sum()
    for t in range(steps):
        pages = rng.choice(n_pages, size=touches, p=p)
        m[t, pages] = 0.2 + 0.3 * rng.random(touches)
    return m
