"""The port's one-layer monitor against the JAX reference: ``make_monitor``
(the monitor layer's masses on reduced gemma3-12b and paligemma-3b) and
``monitored_generate`` (tokens and masses against the reference's and
against ``generate``; the ``on_mass`` hook sees each mass in order,
before the step that follows it).  ``tests/test_torch_engine.py`` holds
the models and the tolerances."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from repro.models import model as RM
from repro.serve import engine as RE

from repro_torch.models import model as TM
from repro_torch.serve import engine as TE

from test_torch_engine import _close, _models


@pytest.mark.parametrize("arch", ["gemma3-12b", "paligemma-3b"])
def test_make_monitor_matches_reference(arch):
    """The monitor over the same dense cache (prefill, padded, and one
    decode step in), at the pending token: per-row page masses within
    1e-5 of the reference's."""
    m = _models(arch)
    rcfg, rp, tcfg, tp = m["rcfg"], m["rp"], m["tcfg"], m["tp"]
    toks, page = m["prompts"], 4
    p = rcfg.prefix_len
    max_len = p + 10 + 6
    n_pages = -(-max_len // page)
    kw_r = {} if m["ex"] is None else dict(extra_embeds=jnp.asarray(m["ex"]))
    kw_t = {} if m["ex"] is None else dict(
        extra_embeds=torch.from_numpy(m["ex"]))
    rl, rcache = RM.prefill(rp, rcfg, jnp.asarray(toks), **kw_r)
    tl, tcache = TM.prefill(tp, tcfg, torch.from_numpy(toks).long(), **kw_t)
    rcache = RM.pad_cache(rcache, rcfg, max_len)
    tcache = TM.pad_cache(tcache, tcfg, max_len)
    tok = np.asarray(rl).argmax(-1).astype(np.int32)
    pos = np.full((2,), p + 10, np.int32)
    rmon = RE.make_monitor(rp, rcfg, page, n_pages)
    tmon = TE.make_monitor(tp, tcfg, page, n_pages)
    for _ in range(2):
        want = rmon(rcache, jnp.asarray(tok), jnp.asarray(pos))
        got = tmon(tcache, torch.from_numpy(tok).long(),
                   torch.from_numpy(pos).long())
        _close(got, want)
        rl, rcache = RM.decode_step(rp, rcfg, rcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        _, tcache = TM.decode_step(tp, tcfg, tcache,
                                   torch.from_numpy(tok).long(),
                                   torch.from_numpy(pos).long())
        tok, pos = np.asarray(rl).argmax(-1).astype(np.int32), pos + 1


@pytest.mark.parametrize("arch", ["gemma3-12b", "paligemma-3b"])
def test_monitored_generate_matches_reference(arch):
    """Greedy tokens equal the reference's, each step's masses (max over
    the batch) within 1e-5 of its, and the tokens equal the port's
    ``generate``'s; masses are probability-like (the bounds of the
    reference's own test)."""
    m = _models(arch)
    rcfg, rp, tcfg, tp = m["rcfg"], m["rp"], m["tcfg"], m["tp"]
    ex = m["ex"]
    rt, rmass = RE.monitored_generate(
        rp, rcfg, jnp.asarray(m["prompts"]), steps=8, page_size=4,
        extra_embeds=None if ex is None else jnp.asarray(ex))
    tt, tmass = TE.monitored_generate(tp, tcfg, m["prompts"], steps=8,
                                      page_size=4, extra_embeds=ex,
                                      device="cpu")
    assert tt.tolist() == np.asarray(rt).tolist()
    assert tmass.shape == np.asarray(rmass).shape == (
        7, -(-(rcfg.prefix_len + 10 + 8) // 4))
    _close(tmass, rmass)
    assert (tmass >= 0).all()
    sums = tmass.sum(axis=1)
    assert (sums <= 2 * tcfg.num_heads + 1e-3).all() and (sums > 0.5).all()
    assert tt.tolist() == TE.generate(tp, tcfg, m["prompts"], steps=8,
                                      extra_embeds=ex,
                                      device="cpu").tolist()


def test_monitored_generate_on_mass_hook(monkeypatch):
    """The hook sees exactly the masses the engine returns, in order, each
    before the decode step that follows it."""
    m = _models("gemma3-12b")
    seen, steps = [], []
    orig = TM.decode_step

    def counted(*a, **kw):
        steps.append(len(seen))
        return orig(*a, **kw)

    monkeypatch.setattr(TM, "decode_step", counted)
    _, mass = TE.monitored_generate(
        m["tp"], m["tcfg"], m["prompts"], steps=6, page_size=4,
        on_mass=lambda i, x: seen.append((i, x)), device="cpu")
    assert [i for i, _ in seen] == list(range(mass.shape[0]))
    np.testing.assert_array_equal(np.stack([x for _, x in seen]), mass)
    assert steps == list(range(1, mass.shape[0] + 1))
