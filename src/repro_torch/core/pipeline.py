"""End-to-end Cori pipeline over the simulator (paper Fig. 4 wiring); the
PyTorch port of ``repro/core/pipeline.py``.

Ties the Reuse Collector -> Frequency Generator -> Tuner loop to the
trace-driven hybrid-memory simulator, and provides the comparison harness
against Table-I fixed frequencies and the Eq.-3 step baselines.  Every
simulation runs on the device the trace was binned on (``study``'s
``device``, the card unless the caller asks for another).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import baselines as bl
from repro_torch.core import cori, reuse, sim
from repro_torch.core.traces import Trace, generate

__all__ = [
    "CoriRun",
    "run_cori",
    "optimal_runtime",
    "table_i_runtimes",
    "baseline_trials",
    "baseline_trials_all",
    "AppStudy",
    "study",
]


@dataclasses.dataclass(frozen=True)
class CoriRun:
    trace: str
    scheduler: str
    dominant_reuse: float
    result: cori.TuneResult

    @property
    def chosen_period(self) -> float:
        return self.result.chosen_period

    @property
    def trials(self) -> int:
        return self.result.trials


def _evaluator(bins: sim.TraceBins, scheduler: str, cfg: sim.SimConfig):
    cache: Dict[int, float] = {}

    def evaluate(period: float) -> float:
        key = max(1, int(round(period / bins.block))) * bins.block
        if key not in cache:
            cache[key] = sim.simulate(bins, key, scheduler, cfg).runtime
        return cache[key]

    return evaluate


def run_cori(bins: sim.TraceBins, trace: Trace, scheduler: str,
             cfg: sim.SimConfig = sim.SimConfig(),
             collector: str = "trace", patience: int = 2,
             max_trials: Optional[int] = None,
             significance: float = 0.05) -> CoriRun:
    """Full Cori loop: collect reuse -> DR -> candidate ladder -> tune."""
    if collector == "trace":
        hist = reuse.reuse_distance_histogram(trace.pages, bin_width=bins.block * 10)
    elif collector == "loops":
        hist = reuse.loop_duration_histogram(trace.loop_durations,
                                             bin_width=bins.block * 10)
    else:
        raise ValueError("collector must be 'trace' or 'loops'")
    hist = reuse.prune_insignificant(hist, significance)
    dr = cori.dominant_reuse(hist)
    cands = cori.candidate_periods(dr, float(bins.num_accesses),
                                   min_period=float(bins.block))
    tuner = cori.Tuner(_evaluator(bins, scheduler, cfg), patience=patience,
                       max_trials=max_trials)
    return CoriRun(trace.name, scheduler, dr, tuner.run(cands))


def optimal_runtime(bins: sim.TraceBins, scheduler: str,
                    cfg: sim.SimConfig = sim.SimConfig(),
                    max_candidates: int = 96) -> Dict[str, float]:
    """Best runtime over the (subsampled-)exhaustive period space."""
    periods = sim.exhaustive_periods(bins, max_candidates)
    res = sim.sweep(bins, periods, scheduler, cfg)
    best_p = min(res, key=lambda p: res[p].runtime)
    return {"period": float(best_p), "runtime": res[best_p].runtime}


def table_i_runtimes(bins: sim.TraceBins, scheduler: str,
                     cfg: sim.SimConfig = sim.SimConfig()) -> Dict[str, sim.SimResult]:
    periods = bl.table_i_periods_for(bins.num_accesses)
    return {name: sim.simulate(bins, p, scheduler, cfg)
            for name, p in periods.items()}


def baseline_trials_all(bins: sim.TraceBins, scheduler: str,
                        cfg: sim.SimConfig = sim.SimConfig(),
                        timestep: Optional[int] = None, seeds: int = 5,
                        tol: float = 0.005) -> Dict[str, float]:
    """Trials-to-best for every Eq.-3 baseline order (one shared sweep; the
    three orders are permutations of the same candidate runtimes)."""
    timestep = timestep or max(bins.block, bins.num_accesses // 128)
    ev = _evaluator(bins, scheduler, cfg)
    cands = bl.base_candidates(bins.num_accesses, timestep)
    rts = np.array([ev(float(p)) for p in cands])
    out = {
        "base-right": float(cori.trials_to_best(rts, tol)),
        "base-left": float(cori.trials_to_best(rts[::-1], tol)),
    }
    rnd = []
    for s in range(seeds):
        perm = np.random.default_rng(s).permutation(rts.shape[0])
        rnd.append(cori.trials_to_best(rts[perm], tol))
    out["base-random"] = float(np.mean(rnd))
    return out


def baseline_trials(bins: sim.TraceBins, scheduler: str, order: str,
                    cfg: sim.SimConfig = sim.SimConfig(),
                    timestep: Optional[int] = None, seeds: int = 5,
                    tol: float = 0.005) -> float:
    """Trials-to-best for one Eq.-3 baseline order."""
    return baseline_trials_all(bins, scheduler, cfg, timestep, seeds, tol)[order]


@dataclasses.dataclass(frozen=True)
class AppStudy:
    """Everything the paper reports for one (application, scheduler) cell."""
    trace: str
    scheduler: str
    optimal_period: float
    optimal_runtime: float
    cori: CoriRun
    cori_trials_to_best: int
    table_i: Dict[str, float]          # name -> runtime

    @property
    def cori_slowdown_vs_optimal(self) -> float:
        return self.cori.result.best_runtime_tried / self.optimal_runtime - 1.0

    def table_i_slowdowns(self) -> Dict[str, float]:
        return {k: v / self.optimal_runtime - 1.0 for k, v in self.table_i.items()}


def study(name: str, scheduler: str, cfg: sim.SimConfig = sim.SimConfig(),
          seed: int = 0, collector: str = "trace", device=None,
          **trace_kw) -> AppStudy:
    trace = generate(name, seed=seed, **trace_kw)
    bins = sim.bin_trace(trace, device=device)
    opt = optimal_runtime(bins, scheduler, cfg)
    crun = run_cori(bins, trace, scheduler, cfg, collector=collector)
    # Fig. 5a metric: trials until Cori has *tried* its ladder's best value.
    ev = _evaluator(bins, scheduler, cfg)
    ladder_rts = [ev(float(p)) for p in crun.result.candidates[
        : max(crun.result.trials * 4, 8)]]
    ttb = cori.trials_to_best(ladder_rts)
    t1 = {k: v.runtime for k, v in table_i_runtimes(bins, scheduler, cfg).items()}
    return AppStudy(name, scheduler, opt["period"], opt["runtime"], crun,
                    ttb, t1)
