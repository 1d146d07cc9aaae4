"""The traffic benchmark's model-free replays at its full size: the
streams and the scheduler stack of the reference package's
``benchmarks/traffic.py`` (``run`` and ``hostile``, without their model
parts), replayed over symbolic pools with the online tuner and at a
ladder of fixed movement periods.

  * ``run``: SHORT + LONG requests (``bench_stream``), each kind random
    then sink for 700 steps, 8 rows over 256 logical / 32 HBM pages of
    16; the online tuner (96-step trials) against ``FIXED``;
  * ``hostile``: four 600-step phases of one mix (plain Poisson, flash
    crowds, correlated bursts, a diurnal swing; ``hostile_stream``), the
    online tuner (48-step profile, 24-step trials) against
    ``HOSTILE_FIXED``.

Host only and deterministic given the seeds: the modeled costs, counts
and tuner histories are numbers to hold exactly.  ``window_cost`` reads a
trajectory's cost a step over its last ``STEADY`` steps before a point.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cori import OnlineTuner
from repro_torch.core.traffic import RequestSpec, shifting_mix_stream
from repro_torch.memtier.tiering import (SharedPagedPools, TierConfig,
                                         TieringManager)
from repro_torch.serve.sched import TrafficMonitor, TrafficScheduler

__all__ = ["N_LOGICAL", "HBM_PAGES", "PAGE", "MAX_ACTIVE", "FIXED",
           "STEADY", "SHORT", "LONG", "HOSTILE_MIX", "HOSTILE_FIXED",
           "HOSTILE_PHASES", "RUN_PHASE_STEPS", "HOSTILE_PHASE_STEPS",
           "bench_stream", "hostile_stream", "trajectory", "window_cost",
           "run", "hostile"]

N_LOGICAL, HBM_PAGES, PAGE, MAX_ACTIVE = 256, 32, 16, 8
FIXED = (1, 2, 4, 8, 16, 32, 64, 200)
STEADY = 150
# heavy-tailed lengths: most requests span 2-6 pages, a long one up to 16
SHORT = dict(rate=0.09, prompt_len=(8, 40), new_tokens=(24, 56))
LONG = dict(rate=0.015, prompt_len=(48, 104), new_tokens=(112, 152))
HOSTILE_MIX = {"random": 0.7, "sink": 0.3}
HOSTILE_FIXED = (1, 2, 4, 8, 16, 64)
HOSTILE_PHASES = ("poisson", "flash_crowd", "burst", "diurnal")
RUN_PHASE_STEPS, HOSTILE_PHASE_STEPS = 700, 600


def bench_stream() -> List[RequestSpec]:
    """SHORT (seed 0) + LONG (seed 1) requests, each random for
    ``RUN_PHASE_STEPS`` steps then sink for as many, merged by arrival and
    renumbered."""
    def phases(rate, prompt_len, new_tokens, s):
        phase = RUN_PHASE_STEPS
        return shifting_mix_stream(
            [(phase, rate, {"random": 1.0}), (phase, rate, {"sink": 1.0})],
            prompt_len=prompt_len, new_tokens=new_tokens, seed=s)

    merged = sorted(phases(s=0, **SHORT) + phases(s=1, **LONG),
                    key=lambda r: (r.arrival, r.rid))
    return [dataclasses.replace(r, rid=i) for i, r in enumerate(merged)]


def hostile_stream() -> List[RequestSpec]:
    """Four phases of ``HOSTILE_PHASE_STEPS`` steps, one mix and mean
    rate, escalating in shape: plain Poisson, flash crowds, correlated
    bursts, a diurnal swing (seed 0)."""
    phase, rate = HOSTILE_PHASE_STEPS, 0.09
    return shifting_mix_stream(
        [(phase, rate, HOSTILE_MIX),
         (phase, rate, HOSTILE_MIX,
          {"gen": "flash_crowd", "spike_factor": 6.0, "spike_every": 120,
           "spike_len": 10}),
         (phase, rate, HOSTILE_MIX, {"gen": "burst", "burst_size": 5}),
         (phase, rate, HOSTILE_MIX,
          {"gen": "diurnal", "swing_period": 300, "amplitude": 0.6})],
        prompt_len=(16, 48), new_tokens=(40, 100), seed=0)


def trajectory(specs: List[RequestSpec], steps: int, *, period: int = 8,
               tuner: Optional[OnlineTuner] = None
               ) -> Tuple[TrafficScheduler, np.ndarray]:
    """Replay ``specs`` for ``steps`` steps on fresh symbolic pools;
    returns (the scheduler, the modeled time after every step, 0 first)."""
    mgr = TieringManager(N_LOGICAL, TierConfig(
        page_size=PAGE, hbm_pages=HBM_PAGES, period_steps=period))
    sched = TrafficScheduler(
        specs, TrafficMonitor(SharedPagedPools.create(N_LOGICAL, HBM_PAGES),
                              mgr, tuner),
        page_size=PAGE, max_active=MAX_ACTIVE)
    traj = np.zeros(steps + 1)
    for t in range(steps):
        sched.step()
        traj[t + 1] = mgr.modeled_time
    return sched, traj


def window_cost(traj: np.ndarray, end: Optional[int] = None) -> float:
    """The modeled cost a step over the ``STEADY`` steps before ``end``
    (default: the trajectory's last)."""
    end = len(traj) - 1 if end is None else end
    return float((traj[end] - traj[end - STEADY]) / STEADY)


def run() -> Dict:
    """The benchmark's ``run`` replay over ``bench_stream()`` for
    2 x ``RUN_PHASE_STEPS`` steps: returns the stream, the online run's
    scheduler, tuner and trajectory, and every fixed period's
    trajectory."""
    specs, steps = bench_stream(), 2 * RUN_PHASE_STEPS
    # 96-step trials average over several request lifetimes, so the
    # ladder ranks stably under heavy-tailed traffic
    tuner = OnlineTuner(N_LOGICAL, default_period=8, drift_ratio=1.5,
                        drift_patience=3, trial_steps=96)
    sched, online = trajectory(specs, steps, tuner=tuner)
    fixed = {p: trajectory(specs, steps, period=p)[1] for p in FIXED}
    return dict(specs=specs, sched=sched, tuner=tuner, online=online,
                fixed=fixed)


def hostile() -> Dict:
    """The benchmark's ``hostile`` replay over ``hostile_stream()`` for
    4 x ``HOSTILE_PHASE_STEPS`` steps, in the same form as ``run``'s."""
    specs, steps = hostile_stream(), 4 * HOSTILE_PHASE_STEPS
    tuner = OnlineTuner(N_LOGICAL, default_period=8, profile_steps=48,
                        trial_steps=24, drift_ratio=1.5, drift_patience=3)
    sched, online = trajectory(specs, steps, tuner=tuner)
    fixed = {p: trajectory(specs, steps, period=p)[1]
             for p in HOSTILE_FIXED}
    return dict(specs=specs, sched=sched, tuner=tuner, online=online,
                fixed=fixed)
