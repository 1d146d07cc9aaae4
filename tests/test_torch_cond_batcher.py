"""The port's batcher on the conditioned and wide-MLP configs against the
reference's batcher: reduced musicgen-large (a numpy conditioning given
to both packages), nemotron-4-340b and stablelm-12b, greedy streams,
migrations, hits, misses and the tuner's history, macro and per-token.
``tests/test_torch_cond.py`` holds the models, the serving loop and the
tolerances."""
import pytest
import torch

torch.set_num_threads(1)

from test_torch_cond import ARCHS, _serve


@pytest.mark.parametrize("macro", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_greedy_streams_match_reference(arch, macro):
    """Greedy streams rid for rid, migrations, hits, misses and the
    tuner's history equal the reference batcher's; the pools hold k/v
    pages only (the conditioning is not paged)."""
    ref, ref_mon = _serve(arch, "ref", macro)
    port, port_mon = _serve(arch, "port", macro)
    assert port == ref
    for key in ("migrations", "data_moved_pages", "hits", "misses"):
        assert getattr(port_mon.manager, key) \
            == getattr(ref_mon.manager, key), key
    assert port_mon.tuner.history == ref_mon.tuner.history
    assert {k.rsplit("_", 1)[0] for k in port_mon.pools.kv_layers} \
        == {"k", "v"}
