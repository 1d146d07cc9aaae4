"""Frequency-tuning baselines (paper Table I and §V-B Eq. 3).

Table I maps prior systems' wall-clock periods onto the simulator's
request-domain analogy (the paper's own mapping: 10 sec == 100 000 requests
... 0.01 sec == 100 requests).

The insight-less step-search baselines (Eq. 3) explore
``[timestep, 2*timestep, ..., Runtime/2]`` in three priority orders:

  base-right   high frequency -> low  (short periods first, like Cori)
  base-left    low frequency -> high  (long periods first)
  base-random  random order (reported as an average over seeds)

A copy of ``repro/core/baselines.py`` (numpy only), kept identical so the
port imports nothing of the reference.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = [
    "TABLE_I_PERIODS",
    "base_candidates",
    "ordered_candidates",
    "BASELINE_ORDERS",
]

# requests per period (paper Table I, right column)
TABLE_I_PERIODS: Dict[str, int] = {
    "thermostat": 100_000,  # 10 s
    "nimble": 50_000,       # 5 s
    "ingens": 20_000,       # 2 s
    "hma": 10_000,          # 1 s
    "hetero-os": 1_000,     # 0.1 s
    "kleio": 100,           # 0.01 s
}

BASELINE_ORDERS = ("base-right", "base-left", "base-random")


def base_candidates(num_requests: int, timestep: int) -> np.ndarray:
    """Eq. 3: periods at every multiple of `timestep` up to Runtime/2."""
    hi = num_requests // 2
    if timestep >= hi:
        return np.array([hi], dtype=np.int64)
    return np.arange(timestep, hi + 1, timestep, dtype=np.int64)


def ordered_candidates(num_requests: int, timestep: int, order: str,
                       seed: int = 0) -> np.ndarray:
    cands = base_candidates(num_requests, timestep)
    if order == "base-right":
        return cands                      # short periods (high freq) first
    if order == "base-left":
        return cands[::-1].copy()         # long periods (low freq) first
    if order == "base-random":
        rng = np.random.default_rng(seed)
        return rng.permutation(cands)
    raise ValueError(f"order must be one of {BASELINE_ORDERS}")


def table_i_periods_for(num_requests: int) -> Dict[str, int]:
    """Table I periods clipped to this trace's feasible range [1, N/2]."""
    hi = max(1, num_requests // 2)
    return {k: min(v, hi) for k, v in TABLE_I_PERIODS.items()}
