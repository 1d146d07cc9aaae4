"""Cori-tuned KV-page tiering runtime (the counterpart of
``repro/memtier/__init__.py`` for the k/v and MLA geometries).

``replay`` drives a ``TieringManager`` over a per-step page-mass sequence
(the masses ``serve.engine.monitored_generate`` returns, or a synthetic
pattern from ``workload``), on symbolic residency or, given
``PagedPools``, moving one layer's k/v pages between the tiers;
``cori_tune_period`` runs the offline Cori loop (profile -> DR ->
candidate ladder -> trial replays) against it and ``AdaptiveTuner``
re-runs that loop when the hit rate drifts; ``online_replay`` puts an
``OnlineTuner`` in the loop instead."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import cori
from repro_torch.core.sim import interleaved_indices
from repro_torch.memtier.tiering import (PAGE_DROP, PagedPools,
                                         SharedPagedPools, TierConfig,
                                         TieringManager, bucket_pages,
                                         write_pages_batched)

__all__ = ["PAGE_DROP", "PagedPools", "SharedPagedPools", "TierConfig",
           "TieringManager", "bucket_pages", "write_pages_batched", "replay",
           "online_replay", "cori_tune_period", "AdaptiveTuner",
           "interleaved_resident", "resident_mask"]


def interleaved_resident(n: int, hbm_pages: int) -> np.ndarray:
    """Interleaved initial symbolic residency (paper SII-B placement)."""
    resident = np.zeros(n, bool)
    resident[interleaved_indices(n, hbm_pages)] = True
    return resident


def resident_mask(mgr: TieringManager,
                  pools: Optional[PagedPools]) -> np.ndarray:
    """The pages resident in HBM: ``pools.slot_of >= 0``, none without
    pools."""
    if pools is None:
        return np.zeros(mgr.n, bool)
    return pools.slot_of >= 0


def replay(page_mass_seq: np.ndarray, cfg: TierConfig,
           pools: Optional[PagedPools] = None) -> TieringManager:
    """Run the tiering loop over a [steps, n_logical] attention-mass
    sequence.  Without ``pools`` residency is tracked symbolically (no
    copies: the fast period trials of ``cori_tune_period``); with them
    every tier migrates the pages' bytes (``TieringManager.maybe_tier``),
    under the same swap rule and accounting."""
    steps, n = page_mass_seq.shape
    mgr = TieringManager(n, cfg)
    if pools is None:
        resident = interleaved_resident(n, cfg.hbm_pages)
    for t in range(steps):
        if pools is None:
            mgr.on_step(page_mass_seq[t], resident)
            mgr.maybe_tier_symbolic(resident)
        else:
            mgr.on_step(page_mass_seq[t], resident_mask(mgr, pools))
            pools = mgr.maybe_tier(pools)
    return mgr


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


def cori_tune_period(page_mass_seq: np.ndarray, cfg: TierConfig,
                     patience: int = 2,
                     max_trials: Optional[int] = None):
    """Full Cori loop over the tiering runtime.

    1. Reuse Collector: one profiling window (tiering at the default
       period) collects the access log.
    2. Frequency Generator: DR + candidate ladder in the step domain.
    3. Tuner: trial windows at each candidate period, stop on
       no-improvement.

    Returns (TuneResult, dominant_reuse)."""
    profile = replay(page_mass_seq, cfg)
    cands = profile.cori_candidates(horizon_steps=page_mass_seq.shape[0])

    def evaluate(period: float) -> float:
        p = max(1, int(round(period)))
        mgr = replay(page_mass_seq,
                     dataclasses.replace(cfg, period_steps=p))
        return mgr.modeled_time

    tuner = cori.Tuner(evaluate, patience=patience, max_trials=max_trials)
    hist = profile.reuse_histogram()
    return tuner.run(cands), cori.dominant_reuse(hist)


class AdaptiveTuner:
    """Offline-resimulation re-tuning: buffer a window of masses, watch the
    hit rate, and re-run the offline Cori loop (``cori_tune_period``, i.e.
    oracle replays of the buffered window) when it drifts.  The online
    path (``online_replay`` with ``core.cori.OnlineTuner``) supersedes it
    in the serving loop; it is kept for replayed mass sequences."""

    def __init__(self, cfg: TierConfig, window: int = 64,
                 retune_ratio: float = 0.7):
        self.cfg = cfg
        self.window = window
        self.retune_ratio = retune_ratio
        self.period = cfg.period_steps
        self.baseline_hit = None
        self.retunes = 0
        self._buf = []

    def _hitrate(self, masses: np.ndarray) -> float:
        mgr = replay(masses, dataclasses.replace(self.cfg,
                                                 period_steps=self.period))
        return mgr.hits / max(mgr.hits + mgr.misses, 1)

    def observe(self, page_mass) -> int:
        """Feed one decode step's page masses; returns the current period."""
        self._buf.append(page_mass)
        if len(self._buf) >= self.window:
            masses = np.stack(self._buf)
            self._buf = []
            hit = self._hitrate(masses)
            if self.baseline_hit is None:
                self.baseline_hit = hit
            elif hit < self.retune_ratio * self.baseline_hit:
                res, _dr = cori_tune_period(
                    masses, dataclasses.replace(self.cfg,
                                                period_steps=self.period))
                self.period = max(1, int(round(res.chosen_period)))
                self.baseline_hit = self._hitrate(masses)
                self.retunes += 1
        return self.period
