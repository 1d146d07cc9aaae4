"""Reduced ``xlstm-1.3b`` (seven mLSTM and one sLSTM, no MLP sublayer, no
token pages) against the JAX reference, conv taps drawn from N(0, 0.5):
prefill's final cell states, dense decode, the paged step over state
pages, and the batcher (one state page a request, one prefill a
request) with the reference batcher's streams, migrations, hits, misses
and tuner history, and ``generate``'s.  The models, checks and
tolerances are ``tests/test_torch_geometry.py``'s."""
import pytest
import torch

torch.set_num_threads(1)

from test_torch_geometry import (
    _check_batcher_generate, _check_batcher_greedy, _check_decode_step_paged,
    _check_forward_prefill_decode)

ARCHS = ["xlstm-1.3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match(arch):
    _check_forward_prefill_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_matches(arch):
    """Identical pools and tables: logits, layer-averaged page mass and
    the write-through into both tiers; an inactive row writes nothing
    and carries no mass."""
    _check_decode_step_paged(arch)


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

