"""``model.prefill_chunk`` + ``chunk_past_extend`` against the
reference's on reduced stablelm-12b, and on stablelm-12b and
nemotron-4-340b at their registered head dims (160 and 192, which the
flash route takes), under both ``attention_impl`` settings
(``_check_prefill_chunk``, held in ``tests/test_torch_pipelined_chunk.py``;
``tests/test_torch_pipelined.py`` holds the models)."""
import pytest
import torch

torch.set_num_threads(1)

from test_torch_pipelined import CHUNK_ARCHS, FULL_HEAD_DIMS, _models
from test_torch_pipelined_chunk import _check_prefill_chunk


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("arch", CHUNK_ARCHS[6:])
def test_prefill_chunk_matches_reference(arch, impl):
    _check_prefill_chunk(_models(arch), impl)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("arch,head_dim", FULL_HEAD_DIMS)
def test_prefill_chunk_at_the_registered_head_dim_matches_reference(
        arch, head_dim, impl):
    """The same at stablelm-12b's head dim (160) and nemotron-4-340b's
    (192), which the flash route takes: the bridged weights at that head
    dim, reduced widths otherwise."""
    _check_prefill_chunk(_models(arch, head_dim), impl)
