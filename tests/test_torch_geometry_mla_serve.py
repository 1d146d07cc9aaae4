"""Reduced ``deepseek-v3-671b`` served by the ``ContinuousBatcher``
against the JAX reference: greedy streams (macro and per-token) rid for
rid with the reference batcher's migrations, hits, misses and tuner
history, and ``generate``'s; sampled rows across the port's own paths.
The models, checks and tolerances are ``tests/test_torch_geometry.py``'s."""
import pytest
import torch

torch.set_num_threads(1)

from test_torch_geometry import (
    _check_batcher_generate, _check_batcher_greedy)

ARCHS = ["deepseek-v3-671b"]


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

