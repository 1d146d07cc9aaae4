"""The port's recurrent models end to end against the JAX reference:
reduced ``recurrentgemma-2b`` and ``xlstm-1.3b`` (conv taps drawn from
N(0, 0.5), as ``tests/test_torch_recurrent.py`` draws them): seeded init
at the reference's scales, dense decode from an empty cache against the
reference's logits, and a demoted state page fetched back from the host
tier bit for bit.  ``tests/test_torch_recurrent.py`` holds the cells,
the models and the tolerances."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from repro.models import model as RM

import repro_torch.configs as TC
from repro_torch.core.cori import OnlineTuner
from repro_torch.memtier import tiering as TT
from repro_torch.models import model as TM
from repro_torch.models import recurrent as TR
from repro_torch.serve import sched as TS

from test_torch_recurrent import (ARCHS, F32_RTOL, LOGIT_TOL, TOL, _close,
                                  _models)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_is_seeded_and_at_reference_scales(arch):
    """Seeded init; cell leaves at N(0, 1/fan_in) with the reference's
    fan-in, conv taps zero and out_norm one as the reference's, RG-LRU's
    a = exp(-8 softplus(lambda)) in [0.9, 0.999]; xlstm's slots carry no
    MLP sublayer (d_ff == 0)."""
    tcfg = dataclasses.replace(TC.reduced(arch), dtype="float32")
    a = TM.init(tcfg, seed=3, device="cpu")
    b = TM.init(tcfg, seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    for seg in a.segments:
        for slot in seg:
            if not slot.kind.is_recurrent:
                continue
            cell = slot.cell
            assert torch.all(cell.conv == 0)
            for name, fan in cell.fan_in.items():
                t = getattr(cell, name)
                assert abs(float(t.std()) / fan ** -0.5 - 1) < 0.15, name
            if slot.kind.base == "rglru":
                decay = torch.exp(-TR.RGLRU_C * torch.nn.functional.softplus(
                    cell.lam))
                assert float(decay.min()) >= 0.9 - 1e-6
                assert float(decay.max()) <= 0.999 + 1e-6
            else:
                assert torch.all(cell.out_norm == 1)
            assert hasattr(slot, "wi_gate") == (tcfg.d_ff > 0)
            assert hasattr(slot, "norm2") == (tcfg.d_ff > 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_empty_cache_matches(arch):
    """Token-by-token ``decode_step`` from an empty ``init_cache`` (zero
    cell states, an empty window ring on recurrentgemma's local slot)
    against the reference doing the same."""
    rcfg, rp, tcfg, tp = _models(arch)
    toks = np.random.default_rng(6).integers(0, rcfg.vocab_size, (2, 10)) \
        .astype(np.int32)
    rcache = RM.init_cache(rcfg, 2, 16, dtype=jnp.float32)
    tcache = TM.init_cache(tcfg, 2, 16, device="cpu")
    for i in range(toks.shape[1]):
        pos = np.full((2,), i, np.int32)
        rl, rcache = RM.decode_step(rp, rcfg, rcache,
                                    jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(pos))
        tl, tcache = TM.decode_step(tp, tcfg, tcache,
                                    torch.from_numpy(toks[:, i:i + 1]).long(),
                                    torch.from_numpy(pos).long())
        _close(tl, rl, LOGIT_TOL)
    for tseg, rseg in zip(tcache["segments"], rcache["segments"]):
        for t, r in zip(tseg, rseg):
            for k, v in t.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(r[k]),
                                           atol=TOL, rtol=F32_RTOL, err_msg=k)


def _serve(arch, demote_every=0):
    """Serve four requests over two rows; every ``demote_every`` steps
    (0 = never) demote the oldest active request's pages, as a
    preemption does, so the next decode fetches its state page back from
    the host tier.  Returns (streams, misses, demoted pages)."""
    _, _, tcfg, tp = _models(arch)
    n_logical, hbm = 48, 10
    mon = TS.TrafficMonitor(
        TT.SharedPagedPools.create(n_logical, hbm),
        TT.TieringManager(n_logical, TT.TierConfig(page_size=4,
                                                   hbm_pages=hbm,
                                                   period_steps=2)),
        OnlineTuner(n_logical, default_period=2, profile_steps=8,
                    trial_steps=4))
    b = TS.ContinuousBatcher(tp, tcfg, monitor=mon, max_active=2, max_len=32,
                             page_size=4, device="cpu")
    rng = np.random.default_rng(8)
    for i, (n, new) in enumerate(((6, 9), (9, 7), (5, 8), (11, 6))):
        b.submit(TS.Request(rid=i, prompt=rng.integers(
            0, tcfg.vocab_size, n).astype(np.int32), max_new_tokens=new,
            temperature=0.8 if i == 1 else 0.0, seed=i))
    demoted, t = 0, 0
    while not b.idle:
        b.step()
        t += 1
        if demote_every and t % demote_every == 0 and b.active:
            req = min(b.active.values(), key=lambda q: q.rid)
            demoted += mon.pools.demote(req.gids)
    return ({r.rid: r.tokens for r in b.completed}, mon.manager.misses,
            demoted)


@pytest.mark.parametrize("arch", ARCHS)
def test_demoted_state_page_is_fetched_back_exact(arch):
    """Demoting a request's pages mid-decode moves no data (the host copy
    is written through every step); the next macro fetches its state page
    back from the host tier, and the streams equal a run without
    demotions."""
    want, misses, _ = _serve(arch)
    got, misses_demoted, demoted = _serve(arch, demote_every=2)
    assert demoted > 0
    assert misses_demoted > misses
    assert got == want
