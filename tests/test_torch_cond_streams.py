"""The port's streams on the conditioned and wide-MLP configs: greedy rows
equal to the reference's ``generate`` and sampled rows four-way in the
port, and musicgen-large under ``attention_impl="pallas"`` (prefill and
the batcher's streams against the reference's).
``tests/test_torch_cond.py`` holds the models, the serving loop and the
tolerances."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from repro.models import model as RM
from repro.serve.engine import generate as r_generate

from repro_torch.models import model as TM
from repro_torch.serve.engine import generate as t_generate

from test_torch_cond import (ARCHS, F32_RTOL, LOGIT_TOL, NEW, TOL, _close,
                             _cond_rows, _models, _serve)


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_streams_match_generate(arch):
    """Four-way parity: greedy rows equal the reference's ``generate``;
    a sampled row draws the same tokens on the port's ``generate`` (the
    dense cache), per-token paged path and macro path."""
    m = _models(arch)
    temps = (0.0, 0.8, 0.0, 0.8)
    per_token, _ = _serve(arch, "port", False, temps)
    macro, _ = _serve(arch, "port", True, temps)
    assert per_token == macro
    for i, p in enumerate(m["prompts"]):
        got = t_generate(m["tp"], m["tcfg"], p[None], steps=NEW[i],
                         temperature=temps[i], seed=100 + i, cond=m["cond"],
                         device="cpu")[0].tolist()
        assert macro[i] == got, i
        if temps[i] == 0:
            ref = np.asarray(r_generate(
                m["rp"], m["rcfg"], jnp.asarray(p[None]), steps=NEW[i],
                cond=None if m["cond"] is None
                else jnp.asarray(m["cond"])))[0].tolist()
            assert got == ref, i


def test_musicgen_flash_prefill_matches_reference():
    """``attention_impl="pallas"``: forward logits, batched-prefill logits
    and caches, and prefill + decode match the reference's, conditioned."""
    m = _models("musicgen-large")
    rcfg, rp, tp = m["rcfg"], m["rp"], m["tp"]
    tcfg = dataclasses.replace(m["tcfg"], attention_impl="pallas")
    toks = np.random.default_rng(5).integers(0, rcfg.vocab_size, (2, 11)) \
        .astype(np.int32)
    tt = torch.from_numpy(toks).long()
    rc, tc = _cond_rows(m, 2)
    _close(TM.forward(tp, tcfg, tt, cond=tc)[0],
           RM.forward(rp, rcfg, toks, cond=rc)[0], LOGIT_TOL)
    lengths = np.asarray([11, 6], np.int32)
    rl, rcache = RM.prefill_batched(rp, rcfg, jnp.asarray(toks),
                                    jnp.asarray(lengths), cond=rc)
    tl, tcache = TM.prefill_batched(tp, tcfg, tt, torch.from_numpy(lengths),
                                    cond=tc)
    _close(tl, rl, LOGIT_TOL)
    for name, a in tcache["segments"][0][0].items():
        np.testing.assert_allclose(
            a.numpy(), np.asarray(rcache["segments"][0][0][name]), atol=TOL,
            rtol=F32_RTOL)
    rl, rcache = RM.prefill(rp, rcfg, jnp.asarray(toks), cond=rc)
    tl, tcache = TM.prefill(tp, tcfg, tt, cond=tc)
    _close(tl, rl, LOGIT_TOL)
    rcache = RM.pad_cache(rcache, rcfg, 16)
    tcache = TM.pad_cache(tcache, tcfg, 16)
    pos, tok = np.full((2,), 11, np.int32), toks[:, -1:]
    for _ in range(3):
        rl, rcache = RM.decode_step(rp, rcfg, rcache, jnp.asarray(tok),
                                    jnp.asarray(pos), cond=rc)
        tl, tcache = TM.decode_step(tp, tcfg, tcache,
                                    torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos).long(), cond=tc)
        _close(tl, rl, LOGIT_TOL)
        tok, pos = np.asarray(rl).argmax(-1).astype(np.int32), pos + 1


@pytest.mark.parametrize("macro", [True, False])
def test_musicgen_flash_batcher_streams_match_reference(macro):
    """``attention_impl="pallas"``: the batcher's greedy streams,
    migrations and tuner history equal the reference batcher's."""
    ref, ref_mon = _serve("musicgen-large", "ref", macro)
    port, port_mon = _serve("musicgen-large", "port", macro,
                            attention_impl="pallas")
    assert port == ref
    assert port_mon.manager.migrations == ref_mon.manager.migrations
    assert port_mon.tuner.history == ref_mon.tuner.history
