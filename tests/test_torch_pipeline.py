"""The port's offline Cori pipeline against the JAX reference, on the CPU.

``study`` (bin -> exhaustive sweep -> Reuse Collector -> DR -> ladder ->
Tuner -> trials-to-best -> Table I), ``run_cori`` with both collectors,
``optimal_runtime``, ``table_i_runtimes`` and ``baseline_trials_all`` on
the reduced traces tests/test_claims.py uses: dominant reuse, candidate
ladders, trials and the chosen and optimal periods are identical, runtimes
within rtol 1e-6.  The offline Cori loop over the tiering runtime
(``replay``, ``cori_tune_period``, ``AdaptiveTuner``) makes identical
decisions.  JAX stays on the CPU; inputs come from fixed seeds.
``study`` end to end, and the claim bars on its reduced cells, are held
in ``tests/test_torch_pipeline_study.py``."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import pipeline as rp
from repro.core import sim as rsim
from repro.core import traces as rtr
from repro.memtier import AdaptiveTuner as RAdaptive
from repro.memtier import cori_tune_period as r_tune
from repro.memtier import replay as r_replay
from repro.memtier.tiering import TierConfig as RTierConfig

from repro_torch.core import pipeline as tp
from repro_torch.core import sim as tsim
from repro_torch.core import traces as ttr
from repro_torch.memtier import AdaptiveTuner as TAdaptive
from repro_torch.memtier import cori_tune_period as t_tune
from repro_torch.memtier import replay as t_replay
from repro_torch.memtier.tiering import TierConfig as TTierConfig

CPU = "cpu"
# the reduced sizes of tests/test_claims.py
APPS = {"backprop": dict(num_pages=512, sweeps=10, accesses_per_page=4),
        "kmeans": dict(num_pages=512, iters=8, accesses_per_page=3,
                       centroid_pages=16)}
SCHEDS = ["reactive", "predictive"]


@pytest.fixture(scope="module")
def bins():
    return {app: (rsim.bin_trace(rtr.generate(app, **kw)),
                  tsim.bin_trace(ttr.generate(app, **kw), device=CPU))
            for app, kw in APPS.items()}


def _same_tune(a, b):
    """Two TuneResults: identical ladder, trials and choice; runtimes
    within rtol 1e-6."""
    assert a.chosen_period == b.chosen_period and a.trials == b.trials
    np.testing.assert_array_equal(a.candidates, b.candidates)
    np.testing.assert_array_equal(a.tried_periods, b.tried_periods)
    np.testing.assert_allclose(b.tried_runtimes, a.tried_runtimes,
                               rtol=1e-6)
    np.testing.assert_allclose(b.chosen_runtime, a.chosen_runtime, rtol=1e-6)


@pytest.mark.parametrize("collector", ["trace", "loops"])
@pytest.mark.parametrize("sched", SCHEDS)
def test_run_cori_matches_reference(bins, collector, sched):
    rb, tb = bins["backprop"]
    kw = APPS["backprop"]
    a = rp.run_cori(rb, rtr.generate("backprop", **kw), sched,
                    collector=collector)
    b = tp.run_cori(tb, ttr.generate("backprop", **kw), sched,
                    collector=collector)
    assert (a.trace, a.scheduler, a.dominant_reuse) == \
        (b.trace, b.scheduler, b.dominant_reuse)
    _same_tune(a.result, b.result)
    with pytest.raises(ValueError):
        tp.run_cori(tb, ttr.generate("backprop", **kw), sched,
                    collector="pebs")


@pytest.mark.parametrize("sched", SCHEDS)
@pytest.mark.parametrize("app", list(APPS))
def test_baseline_trials_match_reference(bins, app, sched):
    rb, tb = bins[app]
    a = rp.baseline_trials_all(rb, sched, seeds=3)
    b = tp.baseline_trials_all(tb, sched, seeds=3)
    assert a == b
    for order in ("base-right", "base-left"):
        assert tp.baseline_trials(tb, sched, order, seeds=3) == a[order]


@pytest.mark.parametrize("app", list(APPS))
def test_optimal_and_table_i_match_reference(bins, app):
    rb, tb = bins[app]
    for sched in SCHEDS:
        a = rp.optimal_runtime(rb, sched, max_candidates=32)
        b = tp.optimal_runtime(tb, sched, max_candidates=32)
        assert a["period"] == b["period"]
        np.testing.assert_allclose(b["runtime"], a["runtime"], rtol=1e-6)
        ta = rp.table_i_runtimes(rb, sched)
        tb_ = tp.table_i_runtimes(tb, sched)
        assert list(ta) == list(tb_)
        for k in ta:
            assert ta[k].migrations == tb_[k].migrations
            assert ta[k].period_requests == tb_[k].period_requests
            np.testing.assert_allclose(tb_[k].runtime, ta[k].runtime,
                                       rtol=1e-6)


def test_port_claim4_and_predictive_shorter():
    """tests/test_claims.py's reduced claims, run on the port: periods
    below the dominant reuse hurt the reactive scheduler, and predictive
    peaks at a period no longer than reactive."""
    from repro_torch.core import dominant_reuse, reuse_distance_histogram
    tr = ttr.generate("backprop", num_pages=512, sweeps=10,
                      accesses_per_page=4)
    b = tsim.bin_trace(tr, device=CPU)
    dr = dominant_reuse(reuse_distance_histogram(tr.pages, bin_width=1000))
    below = tsim.simulate(b, max(100, int(dr / 4)), "reactive")
    at_dr = tsim.simulate(b, int(dr), "reactive")
    assert below.runtime > at_dr.runtime
    assert below.data_moved_pages >= at_dr.data_moved_pages
    tr = ttr.generate("kmeans", **APPS["kmeans"])
    b = tsim.bin_trace(tr, device=CPU)
    periods = tsim.exhaustive_periods(b, 48)
    r = tsim.sweep(b, periods, "reactive")
    p = tsim.sweep(b, periods, "predictive")
    assert min(p, key=lambda k: p[k].runtime) <= \
        min(r, key=lambda k: r[k].runtime)


# --------------------------------------------------------------------------
# the offline Cori loop over the tiering runtime
# --------------------------------------------------------------------------

def _phased_masses(seed, steps=192, n=48):
    """A hot window that jumps every 24 steps plus sparse random touches;
    the second half shifts the phase length (drift for AdaptiveTuner)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((steps, n), np.float32)
    for t in range(steps):
        every = 24 if t < steps // 2 else 9
        lo = (t // every * 5) % (n - 6)
        out[t, lo: lo + 6] = rng.uniform(0.05, 0.3, 6)
        out[t, rng.integers(0, n, 3)] += rng.uniform(0.0, 0.2, 3)
    return out


@pytest.mark.parametrize("seed,period", [(0, 4), (1, 8), (2, 2)])
def test_replay_and_reuse_identical(seed, period):
    m = _phased_masses(seed)
    a = r_replay(m, RTierConfig(hbm_pages=12, period_steps=period))
    b = t_replay(m, TTierConfig(hbm_pages=12, period_steps=period))
    assert (a.migrations, a.hits, a.misses, a.data_moved_pages, a.step) == \
        (b.migrations, b.hits, b.misses, b.data_moved_pages, b.step)
    assert a.modeled_time == b.modeled_time
    assert len(a.access_log) == len(b.access_log)
    for x, y in zip(a.access_log, b.access_log):
        np.testing.assert_array_equal(x, y)
    ha, hb = a.reuse_histogram(), b.reuse_histogram()
    np.testing.assert_array_equal(ha.values, hb.values)
    np.testing.assert_array_equal(ha.counts, hb.counts)
    np.testing.assert_array_equal(a.cori_candidates(192),
                                  b.cori_candidates(192))


@pytest.mark.parametrize("seed", [0, 3])
def test_cori_tune_period_identical(seed):
    m = _phased_masses(seed)
    (ra, dra) = r_tune(m, RTierConfig(hbm_pages=12, period_steps=4))
    (rb, drb) = t_tune(m, TTierConfig(hbm_pages=12, period_steps=4))
    assert dra == drb
    assert ra.chosen_period == rb.chosen_period and ra.trials == rb.trials
    np.testing.assert_array_equal(ra.candidates, rb.candidates)
    np.testing.assert_array_equal(ra.tried_periods, rb.tried_periods)
    np.testing.assert_array_equal(ra.tried_runtimes, rb.tried_runtimes)


def test_adaptive_tuner_history_identical():
    m = np.concatenate([_phased_masses(5), _phased_masses(6)[::-1]])
    a = RAdaptive(RTierConfig(hbm_pages=12, period_steps=4), window=48,
                  retune_ratio=0.95)
    b = TAdaptive(TTierConfig(hbm_pages=12, period_steps=4), window=48,
                  retune_ratio=0.95)
    hist_a = [a.observe(x) for x in m]
    hist_b = [b.observe(x) for x in m]
    assert hist_a == hist_b and a.retunes >= 1
    assert (a.retunes, a.period, a.baseline_hit) == \
        (b.retunes, b.period, b.baseline_hit)
    assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)
