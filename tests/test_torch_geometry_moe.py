"""Reduced ``olmoe-1b-7b`` (k/v attention with qk-norm, every layer MoE
without a shared expert) against the JAX reference: the routed MoE
against ``moe_apply_dense``, forward, batched prefill, prefill + dense
decode, the fully-paged decode step, seeded init at the reference's
scales, and the ``ContinuousBatcher``'s streams and accounting against
the reference batcher's and ``generate``'s.  The models, checks and
tolerances are ``tests/test_torch_geometry.py``'s."""
import pytest
import torch

torch.set_num_threads(1)

from test_torch_geometry import (
    _check_batcher_generate, _check_batcher_greedy, _check_decode_step_paged,
    _check_forward_prefill_decode, _check_init_scales, _check_moe_dense)

ARCHS = ["olmoe-1b-7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_dense_reference(arch):
    """Routed MoE == the reference's dense oracle: outputs (shared expert
    included for deepseek) and the load-balance aux loss."""
    _check_moe_dense(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match(arch):
    _check_forward_prefill_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_matches(arch):
    """Identical pools and tables: logits, layer-averaged page mass and
    the write-through into both tiers; an inactive row writes nothing
    and carries no mass."""
    _check_decode_step_paged(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_is_seeded_and_at_reference_scales(arch):
    """Seeded init; each MLA / MoE leaf at N(0, 1/fan_in) with the
    reference's fan-in."""
    _check_init_scales(arch)


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

