"""The port's macro-step batcher at ``macro_steps`` 1, 4 and 8 against
the reference's batcher on reduced qwen3-14b: greedy streams, migrations
and the tuner's history.  ``tests/test_torch_serve.py`` holds the models,
the stacks and the batcher's other checks."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.obs import telemetry as R_obs

from repro_torch.obs import telemetry as T_obs

from test_torch_serve import _serve


@pytest.mark.parametrize("macro_steps", [1, 4, 8])
def test_batcher_macro_steps_match_reference(macro_steps):
    """``macro_steps`` (the reference's batcher option) pins the macro
    length in place of the tuner's period: greedy streams, every merged
    mass (1e-5), migrations, tuner history and each macro's length (the
    flight recorder's ``serve.macro`` events) equal to the reference
    batcher's with the same ``macro_steps``; no macro is longer, and one
    runs for each monitor feed."""
    res, lens = {}, {}
    for side, obs in (("ref", R_obs), ("port", T_obs)):
        prev = obs.RECORDER
        rec = obs.install(obs.Recorder(enabled=True))
        try:
            res[side] = _serve(side, True, macro_steps=macro_steps)
        finally:
            obs.install(prev)
        lens[side] = [e["n_steps"] for e in rec.events("serve.macro")]
    (ref, ref_m, ref_mon), (port, port_m, port_mon) = res["ref"], \
        res["port"]
    assert port == ref
    assert len(port_m) == len(ref_m)
    for a, b in zip(port_m, ref_m):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert port_mon.manager.migrations == ref_mon.manager.migrations
    assert port_mon.tuner.history == ref_mon.tuner.history
    assert lens["port"] == lens["ref"]
    assert len(lens["port"]) == len(port_m)
    assert max(lens["port"]) == macro_steps, lens
