"""The port's traffic streams (``core.traffic``) and model-free
``TrafficScheduler`` against the JAX reference's, fed identical inputs:
both are host code over numpy, so every number must be equal, not close.

  * every stream generator, the hostile phases through
    ``shifting_mix_stream`` and ``invert_kinds``, field by field, for
    several seeds and phase lists;
  * ``TrafficScheduler`` replays with and without an online tuner, with
    and without ``ttl_steps`` shedding, and with ``bucket=False``:
    admitted, completed, rejected and shed counts, the peak of allocated
    pages, modeled time, migrations, hits, misses, every merged mass
    vector, the tuner history and the flight recorder's ``serve.*`` and
    ``tier.move`` events;
  * the traffic benchmark's full-size replay (``benchmarks/traffic.py``
    ``run``: 256 logical / 32 HBM pages of 16, 8 rows, 2 x 700 steps,
    SHORT + LONG) as ``repro_torch.serve.traffic_replay`` runs it,
    against the reference's stack built here: online Cori's steady cost
    42.83 equal to the best fixed period's, its history and the peak of
    76 pages against 128 dense; and its hostile four-phase replay, every
    trajectory equal and each phase's regret within 1.15;
  * the reference's behavioural tests of the scheduler
    (``tests/test_sched.py``) on the port: admits and retires, head-of-line
    order, impossible requests rejected, deterministic replay, admission
    independent of the period, online within 5% of the best fixed."""
import dataclasses

import numpy as np
import pytest

from repro import obs as robs
from repro.core import OnlineTuner as RTuner
from repro.core import traffic as RT
from repro.memtier import SharedPagedPools as RPools
from repro.memtier import TierConfig as RTierConfig
from repro.memtier import TieringManager as RManager
from repro.serve import sched as RS

from repro_torch.core import OnlineTuner as TTuner
from repro_torch.core import traffic as TT
from repro_torch.memtier import SharedPagedPools as TPools
from repro_torch.memtier import TierConfig as TTierConfig
from repro_torch.memtier import TieringManager as TManager
from repro_torch.obs import telemetry as tobs
from repro_torch.serve import sched as TS
from repro_torch.serve import traffic_replay as TR

SIDES = {
    "ref": (RT, RPools, RManager, RTierConfig, RTuner, RS),
    "port": (TT, TPools, TManager, TTierConfig, TTuner, TS),
}

HOSTILE = [
    (60, 0.2, {"random": 0.7, "sink": 0.3}),
    (60, 0.2, {"random": 0.7, "sink": 0.3},
     {"gen": "flash_crowd", "spike_factor": 6.0, "spike_every": 20,
      "spike_len": 4}),
    (60, 0.2, {"random": 0.7, "sink": 0.3},
     {"gen": "burst", "burst_size": 5}),
    (60, 0.2, {"random": 0.7, "sink": 0.3},
     {"gen": "diurnal", "swing_period": 30, "amplitude": 0.6}),
    (60, 0.2, {"periodic": 0.5, "sink": 0.2, "random": 0.3},
     {"gen": "inversion", "invert_every": 15}),
]


def _fields(specs):
    return [dataclasses.astuple(s) for s in specs]


def _generators(mod, seed):
    """Every generator of ``mod`` on one seed."""
    kinds = {"sink": 0.5, "random": 0.3, "periodic": 0.2}
    kw = dict(prompt_len=(8, 40), new_tokens=(16, 48), seed=seed)
    return {
        "poisson": mod.poisson_request_stream(80, 0.3, kinds, start=5,
                                              rid0=3, **kw),
        "modulated": mod.modulated_request_stream(
            80, lambda t: 0.1 + 0.01 * (t % 9),
            lambda t: kinds if t < 40 else {"sink": 1.0}, burst_size=3,
            **kw),
        "flash_crowd": mod.flash_crowd_stream(
            120, 0.1, kinds, spike_factor=7.0, spike_every=30,
            spike_len=5, spike_offset=4, **kw),
        "diurnal": mod.diurnal_stream(120, 0.2, kinds, swing_period=50,
                                      amplitude=0.7, phase=0.25, **kw),
        "burst": mod.correlated_burst_stream(120, 0.2, kinds, burst_size=4,
                                             **kw),
        "inversion": mod.mix_inversion_stream(120, 0.2, kinds,
                                              invert_every=25, **kw),
        "shifting": mod.shifting_mix_stream(
            [(50, 0.2, {"random": 1.0}), (50, 0.3, {"sink": 1.0})], **kw),
        "hostile": mod.shifting_mix_stream(HOSTILE, **kw),
    }


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_streams_match_reference(seed):
    ref, port = _generators(RT, seed), _generators(TT, seed)
    for name in ref:
        assert _fields(port[name]) == _fields(ref[name]), name
        assert ref[name], name
    spec = port["poisson"][0]
    assert (spec.total_tokens(8), spec.n_pages(16, 8)) == (
        ref["poisson"][0].total_tokens(8), ref["poisson"][0].n_pages(16, 8))
    for kinds in ({"a": 0.7, "b": 0.2, "c": 0.1}, {"sink": 1.0},
                  {"random": 0.3, "sink": 0.7}):
        assert TT.invert_kinds(kinds) == RT.invert_kinds(kinds)
    assert sorted(TT.PHASE_GENERATORS) == sorted(RT.PHASE_GENERATORS)
    assert sorted(TS.WORKLOAD_KINDS) == sorted(RS.WORKLOAD_KINDS)


# ---------------------------------------------------------------------------
# the scheduler, replay for replay
# ---------------------------------------------------------------------------


def _replay(side, specs, steps, *, period=8, tuned=False, n_logical=128,
            hbm=16, page=16, max_active=6, **kw):
    """Replay ``specs`` on one package with a fresh recorder; returns
    (scheduler, manager, tuner, merged masses, recorded events)."""
    _, pools_c, mgr_c, tier_c, tuner_c, sched = SIDES[side]
    rec = (robs if side == "ref" else tobs).install(
        (robs.Recorder if side == "ref" else tobs.Recorder)())
    pools = pools_c.create(n_logical, hbm)
    mgr = mgr_c(n_logical, tier_c(page_size=page, hbm_pages=hbm,
                                  period_steps=period))
    tuner = (tuner_c(n_logical, default_period=period, profile_steps=24,
                     trial_steps=12, drift_ratio=1.5, drift_patience=3)
             if tuned else None)
    mon = sched.TrafficMonitor(pools, mgr, tuner)
    merges = []
    merge = mon.merge
    mon.merge = lambda c: merges.append(merge(c)) or merges[-1]
    s = sched.TrafficScheduler(specs, mon, page_size=page,
                               max_active=max_active, **kw).run(steps)
    # the timestamps and the process-wide ids of managers and tuners differ
    events = [{k: v for k, v in e.items()
               if k not in ("t", "manager", "tuner")} for e in rec.events()]
    (robs if side == "ref" else tobs).install(
        (robs.Recorder if side == "ref" else tobs.Recorder)())
    return s, mgr, tuner, merges, events


CASES = {
    "plain": dict(),
    "tuned": dict(tuned=True),
    "ttl": dict(ttl_steps=6),
    "tuned_ttl": dict(tuned=True, ttl_steps=10),
    "unbucketed": dict(bucket=False, tuned=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scheduler_matches_reference(case):
    """An overloaded three-kind stream (rows and pages run out, so the
    queue backs up and the TTL sheds) replays identically."""
    specs = TT.shifting_mix_stream(
        [(150, 0.25, {"sink": 0.4, "random": 0.4, "periodic": 0.2}),
         (150, 0.35, {"periodic": 0.6, "sink": 0.4})],
        prompt_len=(8, 120), new_tokens=(8, 90), seed=5)
    rspecs = RT.shifting_mix_stream(
        [(150, 0.25, {"sink": 0.4, "random": 0.4, "periodic": 0.2}),
         (150, 0.35, {"periodic": 0.6, "sink": 0.4})],
        prompt_len=(8, 120), new_tokens=(8, 90), seed=5)
    kw = dict(CASES[case], n_logical=64, hbm=12)
    r, rm, rt, r_merges, r_events = _replay("ref", rspecs, 400, **kw)
    p, pm, pt, p_merges, p_events = _replay("port", specs, 400, **kw)
    for key in ("admitted", "completed", "rejected", "shed",
                "peak_cache_pages", "dense_cache_pages", "row_pages", "now"):
        assert getattr(p, key) == getattr(r, key), key
    for key in ("modeled_time", "migrations", "hits", "misses",
                "data_moved_pages", "period"):
        assert getattr(pm, key) == getattr(rm, key), key
    assert len(p_merges) == len(r_merges) > 0
    for a, b in zip(p_merges, r_merges):
        np.testing.assert_array_equal(a, b)
    if rt is not None:
        assert pt.history == rt.history and pt.state == rt.state
    assert p_events == r_events
    assert p.admitted > 0 and pm.migrations > 0
    if "ttl_steps" in CASES[case]:
        assert p.shed > 0
    else:
        assert p.shed == 0


def _ref_trajectory(specs, steps, *, period=8, tuner=None):
    """The reference's stack of ``benchmarks/traffic.py`` over ``specs``:
    (scheduler, the modeled time after every step, 0 first)."""
    mgr = RManager(TR.N_LOGICAL, RTierConfig(
        page_size=TR.PAGE, hbm_pages=TR.HBM_PAGES, period_steps=period))
    s = RS.TrafficScheduler(
        specs, RS.TrafficMonitor(RPools.create(TR.N_LOGICAL, TR.HBM_PAGES),
                                 mgr, tuner),
        page_size=TR.PAGE, max_active=TR.MAX_ACTIVE)
    traj = np.zeros(steps + 1)
    for t in range(steps):
        s.step()
        traj[t + 1] = mgr.modeled_time
    return s, traj


def _ref_bench_stream(phase):
    """``benchmarks/traffic.py``'s stream: SHORT + LONG, each random then
    sink, merged by arrival and renumbered."""
    def phases(rate, prompt_len, new_tokens, s):
        return RT.shifting_mix_stream(
            [(phase, rate, {"random": 1.0}), (phase, rate, {"sink": 1.0})],
            prompt_len=prompt_len, new_tokens=new_tokens, seed=s)

    short = dict(rate=0.09, prompt_len=(8, 40), new_tokens=(24, 56))
    long_ = dict(rate=0.015, prompt_len=(48, 104), new_tokens=(112, 152))
    merged = sorted(phases(s=0, **short) + phases(s=1, **long_),
                    key=lambda r: (r.arrival, r.rid))
    return [dataclasses.replace(r, rid=i) for i, r in enumerate(merged)]


def _ref_hostile_stream():
    """``benchmarks/traffic.py``'s ``hostile`` stream at full size."""
    mix = {"random": 0.7, "sink": 0.3}
    return RT.shifting_mix_stream(
        [(600, 0.09, mix),
         (600, 0.09, mix, {"gen": "flash_crowd", "spike_factor": 6.0,
                           "spike_every": 120, "spike_len": 10}),
         (600, 0.09, mix, {"gen": "burst", "burst_size": 5}),
         (600, 0.09, mix, {"gen": "diurnal", "swing_period": 300,
                           "amplitude": 0.6})],
        prompt_len=(16, 48), new_tokens=(40, 100), seed=0)


def _assert_replays_equal(port, ref_specs, ref_tuner, steps, ladder):
    """``repro_torch.serve.traffic_replay``'s replay (``port``) against the
    reference's stack over the reference's stream: the stream field by
    field, every trajectory, the online run's counts and tuner state."""
    assert _fields(port["specs"]) == _fields(ref_specs)
    r_sched, r_online = _ref_trajectory(ref_specs, steps, tuner=ref_tuner)
    np.testing.assert_array_equal(port["online"], r_online)
    assert sorted(port["fixed"]) == sorted(ladder)
    for p in ladder:
        np.testing.assert_array_equal(
            port["fixed"][p], _ref_trajectory(ref_specs, steps, period=p)[1])
    p_sched, p_tuner = port["sched"], port["tuner"]
    for key in ("admitted", "completed", "rejected", "peak_cache_pages",
                "dense_cache_pages"):
        assert getattr(p_sched, key) == getattr(r_sched, key), key
    pm, rm = p_sched.monitor.manager, r_sched.monitor.manager
    for key in ("migrations", "hits", "misses", "data_moved_pages"):
        assert getattr(pm, key) == getattr(rm, key), key
    assert (p_tuner.history, p_tuner.state, p_tuner.retunes,
            p_tuner.guard_trips) == (ref_tuner.history, ref_tuner.state,
                                     ref_tuner.retunes, ref_tuner.guard_trips)


def test_full_size_replay_matches_reference():
    """The traffic benchmark at its full size, online and at every fixed
    period of its ladder: equal in both packages, and the reference's
    numbers (online steady 42.83 == the best fixed, period 1)."""
    port = TR.run()
    _assert_replays_equal(
        port, _ref_bench_stream(700),
        RTuner(TR.N_LOGICAL, default_period=8, drift_ratio=1.5,
               drift_patience=3, trial_steps=96), 1400, TR.FIXED)
    steady = {p: TR.window_cost(tr) for p, tr in port["fixed"].items()}
    on = TR.window_cost(port["online"])
    assert on == min(steady.values()) == steady[1]
    assert round(on, 2) == 42.83
    assert [round(steady[p], 2) for p in (8, 32, 200)] \
        == [61.27, 149.64, 416.04]
    s, mgr, tuner = port["sched"], port["sched"].monitor.manager, \
        port["tuner"]
    assert tuner.history == [(64, 1), (448, 2), (832, 3), (1216, 1)]
    assert tuner.state == "hold"
    assert (mgr.migrations, mgr.hits, mgr.misses) == (1470, 15467, 1513)
    assert (s.peak_cache_pages, s.dense_cache_pages) == (76, 128)
    assert 1 - s.peak_cache_pages / s.dense_cache_pages >= 0.25
    assert (s.admitted, s.completed) == (132, 125)


def test_hostile_replay_matches_reference():
    """The hostile four-phase replay at full size: every trajectory and
    the tuner's end state equal in both packages, and each phase's regret
    (online over the best fixed period, last 150 steps) within the
    benchmark's bar of 1.15."""
    port = TR.hostile()
    _assert_replays_equal(
        port, _ref_hostile_stream(),
        RTuner(TR.N_LOGICAL, default_period=8, profile_steps=48,
               trial_steps=24, drift_ratio=1.5, drift_patience=3),
        2400, TR.HOSTILE_FIXED)
    for e in (600, 1200, 1800, 2400):
        cost = {p: TR.window_cost(tr, e) for p, tr in port["fixed"].items()}
        online = TR.window_cost(port["online"], e)
        assert online <= 1.15 * min(cost.values()), (e, online, cost)


# ---------------------------------------------------------------------------
# the reference's behavioural tests, on the port
# ---------------------------------------------------------------------------


def _port(specs, steps, **kw):
    s, mgr, _, _, _ = _replay("port", specs, steps, **kw)
    return s, mgr


def test_scheduler_admits_and_retires():
    specs = TT.poisson_request_stream(120, 0.15, {"sink": 0.5,
                                                  "random": 0.5},
                                      prompt_len=(8, 32),
                                      new_tokens=(16, 40), seed=2)
    s, mgr = _port(specs, 400)
    assert s.admitted == s.completed == len(specs)
    assert s.monitor.pools.free_pages == 128, "every page returned"
    assert mgr.hits + mgr.misses > 0


def test_head_of_line_and_impossible_requests():
    """Admission is FIFO even when a later, smaller request would fit; a
    request larger than the logical space is rejected, not blocking."""
    hol = [TT.RequestSpec(0, 0, 40 * 16 - 8, 8, "sink", 0),   # 40 pages
           TT.RequestSpec(1, 0, 40 * 16 - 8, 8, "sink", 1),   # 40 pages
           TT.RequestSpec(2, 0, 8, 8, "sink", 2)]             # 1 page
    s, _ = _port(hol, 3, n_logical=64, hbm=16)
    assert s.admitted == 1
    big = [TT.RequestSpec(0, 0, 100 * 16 - 8, 8, "sink", 0),  # 100 pages
           TT.RequestSpec(1, 0, 8, 8, "sink", 1)]
    s, _ = _port(big, 3, n_logical=64, hbm=16)
    assert (s.rejected, s.admitted) == (1, 1)


def test_replay_deterministic_and_admission_independent_of_period():
    specs = TT.poisson_request_stream(100, 0.2, {"sink": 1.0}, seed=4)
    runs = [_port(specs, 300, period=p) for p in (1, 1, 64)]
    assert runs[0][1].modeled_time == runs[1][1].modeled_time
    assert runs[0][1].migrations == runs[1][1].migrations
    assert {(s.admitted, s.completed) for s, _ in runs} \
        == {(runs[0][0].admitted, runs[0][0].completed)}


def test_online_tuner_within_5pct_of_best_fixed():
    """``tests/test_sched.py``'s acceptance on the port: on a Poisson
    stream whose mix shifts mid-run, online Cori's end-state cost is
    within 5% of the best fixed period."""
    phase, window = 700, 150
    specs = TT.shifting_mix_stream(
        [(phase, 0.10, {"random": 1.0}), (phase, 0.10, {"sink": 1.0})],
        prompt_len=(16, 48), new_tokens=(40, 100), seed=0)

    def steady(period, tuner=None):
        pools = TPools.create(256, 32)
        mgr = TManager(256, TTierConfig(page_size=16, hbm_pages=32,
                                        period_steps=period))
        s = TS.TrafficScheduler(specs, TS.TrafficMonitor(pools, mgr, tuner),
                                page_size=16, max_active=8)
        s.run(2 * phase - window)
        probe = mgr.modeled_time
        s.run(window)
        return (mgr.modeled_time - probe) / window

    tuner = TTuner(256, default_period=8, drift_ratio=1.5, drift_patience=3)
    online = steady(8, tuner)
    assert tuner.retunes >= 2, "the mix shift must trigger a re-tune"
    best = min(steady(p) for p in (1, 2, 4, 8, 16, 32, 64))
    assert online <= 1.05 * best, (online, best)
