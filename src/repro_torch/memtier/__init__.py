"""Cori-tuned KV-page tiering runtime (the counterpart of
``repro/memtier/__init__.py`` for the k/v geometry).

``online_replay`` drives a ``TieringManager`` with an ``OnlineTuner`` in
the loop over a per-step page-mass sequence, on symbolic residency."""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import cori
from repro_torch.core.sim import interleaved_indices
from repro_torch.memtier.tiering import (PAGE_DROP, SharedPagedPools,
                                         TierConfig, TieringManager,
                                         bucket_pages, write_pages_batched)

__all__ = ["PAGE_DROP", "SharedPagedPools", "TierConfig", "TieringManager",
           "bucket_pages", "write_pages_batched", "online_replay",
           "interleaved_resident"]


def interleaved_resident(n: int, hbm_pages: int) -> np.ndarray:
    """Interleaved initial symbolic residency (paper SII-B placement)."""
    resident = np.zeros(n, bool)
    resident[interleaved_indices(n, hbm_pages)] = True
    return resident


def online_replay(page_mass_seq: np.ndarray, cfg: TierConfig,
                  tuner: Optional[cori.OnlineTuner] = None,
                  ) -> "tuple[TieringManager, cori.OnlineTuner]":
    """Closed-loop replay: an ``OnlineTuner`` drives the tiering period live.

    Each step feeds the tuner the page masses and the step's modeled cost
    (including any migration burst the tier just paid); the period it
    returns applies before the next step.  Returns (manager, tuner)."""
    steps, n = page_mass_seq.shape
    mgr = TieringManager(n, cfg)
    if tuner is None:
        tuner = cori.OnlineTuner(n, default_period=cfg.period_steps,
                                 access_threshold=cfg.access_threshold)
    resident = interleaved_resident(n, cfg.hbm_pages)
    for t in range(steps):
        before = mgr.modeled_time
        mgr.on_step(page_mass_seq[t], resident)
        mgr.maybe_tier_symbolic(resident)
        period = tuner.on_step(page_mass_seq[t],
                               cost=mgr.modeled_time - before)
        mgr.set_period(period)
    return mgr, tuner
