"""The port's pipelined batcher against the reference's on reduced
deepseek-v3-671b (MLA + MoE) and musicgen-large (its conditioning), with
and without chunked admission, and the synchronous batcher on reduced
stablelm-12b at its registered head dim of 160 through the flash route
against the reference's batcher: greedy streams rid for rid,
migrations, hits, misses and the tuner's history.
``tests/test_torch_pipelined.py`` holds the models, the drive loop and
the tolerances."""
import pytest
import torch

torch.set_num_threads(1)

from test_torch_pipelined import SERVED, _check_pipelined_greedy, _drive


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("arch", SERVED[2:])
def test_pipelined_greedy_streams_match_reference(arch, chunk):
    _check_pipelined_greedy(arch, chunk)


def test_flash_route_streams_at_head_dim_160_match_reference():
    """The synchronous batcher on reduced stablelm-12b at its registered
    head dim (160), every admission through the flash route
    (``attention_impl="pallas"``), against the reference's batcher:
    greedy streams rid for rid, migrations, hits, misses and the tuner's
    history."""
    kw = dict(pipeline=False, head_dim=160)
    ref, rmon = _drive("ref", "stablelm-12b", **kw)
    port, tmon = _drive("port", "stablelm-12b", impl="pallas", **kw)
    assert port == ref
    for attr in ("migrations", "hits", "misses"):
        assert getattr(tmon.manager, attr) == getattr(rmon.manager, attr), \
            attr
    assert tmon.tuner.history == rmon.tuner.history
