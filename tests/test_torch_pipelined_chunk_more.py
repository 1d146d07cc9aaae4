"""``model.prefill_chunk`` + ``chunk_past_extend`` against the
reference's on reduced olmoe-1b-7b, musicgen-large (its conditioning) and
nemotron-4-340b under both ``attention_impl`` settings, and against the
port's own ``prefill_batched`` (``_check_prefill_chunk``), and the
refusal on the recurrent configs.  ``tests/test_torch_pipelined_chunk.py``
holds the check; ``tests/test_torch_pipelined.py`` the models."""
import dataclasses

import pytest
import torch

torch.set_num_threads(1)

import repro_torch.configs as TC
from repro_torch.models import model as TM

from test_torch_pipelined import CHUNK_ARCHS, _models
from test_torch_pipelined_chunk import _check_prefill_chunk


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("arch", CHUNK_ARCHS[3:6])
def test_prefill_chunk_matches_reference(arch, impl):
    _check_prefill_chunk(_models(arch), impl)


def test_prefill_chunk_refuses_recurrent_configs():
    for name in ("recurrentgemma-2b", "xlstm-1.3b"):
        cfg = dataclasses.replace(TC.reduced(name), dtype="float32")
        tp = TM.init(cfg, seed=0, device="cpu")
        with pytest.raises(ValueError, match="chunked prefill"):
            TM.prefill_chunk(tp, cfg, torch.zeros((1, 4), dtype=torch.long),
                             torch.tensor([4]), start=0)
