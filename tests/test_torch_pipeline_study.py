"""The port's offline ``study`` against the JAX reference, on the CPU:
bin -> exhaustive sweep -> Reuse Collector -> DR -> ladder -> Tuner ->
trials-to-best -> Table I on the reduced traces tests/test_claims.py
uses, for both apps and both schedulers (dominant reuse, candidate
ladders, trials and the chosen and optimal periods identical, runtimes
within rtol 1e-6), and the claim bars on those reduced cells.  The
module-scoped ``studies`` runs each package's study once for both
tests.  ``tests/test_torch_pipeline.py`` holds the pipeline's other
stages and the sizes these cases use."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import pipeline as rp

from repro_torch.core import pipeline as tp

from test_torch_pipeline import APPS, CPU, SCHEDS, _same_tune


@pytest.fixture(scope="module")
def studies():
    return {(app, sched): (rp.study(app, sched, **kw),
                           tp.study(app, sched, device=CPU, **kw))
            for app, kw in APPS.items() for sched in SCHEDS}


@pytest.mark.parametrize("sched", SCHEDS)
@pytest.mark.parametrize("app", list(APPS))
def test_study_matches_reference(studies, app, sched):
    a, b = studies[(app, sched)]
    assert (a.trace, a.scheduler) == (b.trace, b.scheduler)
    assert a.optimal_period == b.optimal_period
    np.testing.assert_allclose(b.optimal_runtime, a.optimal_runtime,
                               rtol=1e-6)
    assert a.cori.dominant_reuse == b.cori.dominant_reuse
    assert a.cori.chosen_period == b.cori.chosen_period
    assert a.cori.trials == b.cori.trials
    _same_tune(a.cori.result, b.cori.result)
    assert a.cori_trials_to_best == b.cori_trials_to_best
    assert list(a.table_i) == list(b.table_i)
    for k in a.table_i:
        np.testing.assert_allclose(b.table_i[k], a.table_i[k], rtol=1e-6)
    np.testing.assert_allclose(b.cori_slowdown_vs_optimal,
                               a.cori_slowdown_vs_optimal, rtol=1e-5,
                               atol=1e-7)


def test_reduced_claims_hold_in_the_port(studies):
    """The claim bars of tests/test_claims.py, on the reduced cells: Cori
    near optimal and a real Table-I gap somewhere."""
    slacks = [b.cori_slowdown_vs_optimal for _, b in studies.values()]
    assert max(slacks) <= 0.15 and np.mean(slacks) <= 0.10
    gaps = [max(b.table_i_slowdowns().values()) for _, b in studies.values()]
    assert min(gaps) >= 0.10 and max(gaps) >= 0.80
