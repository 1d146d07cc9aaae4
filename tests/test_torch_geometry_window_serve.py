"""Reduced ``gemma3-12b`` served by the ``ContinuousBatcher`` against the
JAX reference, under both ``attention_impl`` settings: greedy streams
(macro and per-token) rid for rid with the reference batcher's
migrations, hits, misses and tuner history, and ``generate``'s; sampled
rows across the port's own paths.  The models, checks and tolerances are
``tests/test_torch_geometry.py``'s."""
import pytest
import torch

torch.set_num_threads(1)

from test_torch_geometry import (
    _check_batcher_generate, _check_batcher_greedy, _serve)

ARCHS = ["gemma3-12b"]


@pytest.mark.parametrize("macro", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_greedy_streams_match_reference(arch, macro):
    """Greedy streams rid for rid, migrations, hits, misses and the
    tuner's history equal the reference batcher's; the pools carry the
    slots' own leaves."""
    _check_batcher_greedy(arch, macro)


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_streams_match_generate(arch):
    """Greedy rows equal the reference's ``generate``; a sampled row draws
    the same tokens on the port's per-token path, macro path and
    ``generate``."""
    _check_batcher_generate(arch)


@pytest.mark.parametrize("macro", [True, False])
def test_gemma_flash_batcher_streams_match_reference(macro):
    """``attention_impl="pallas"``: the batcher's greedy streams,
    migrations and tuner history equal the reference batcher's."""
    ref, ref_mon = _serve("gemma3-12b", "ref", macro)
    port, port_mon = _serve("gemma3-12b", "port", macro,
                            attention_impl="pallas")
    assert port == ref
    assert port_mon.manager.migrations == ref_mon.manager.migrations
    assert port_mon.tuner.history == ref_mon.tuner.history
