"""The port's batcher over shared prefix pages against the JAX reference,
on reduced paligemma-3b with one numpy prefix given to both packages:
greedy streams and accounting against the reference batcher's, sampled
rows across the port's paths and ``generate``, and the two reference
behaviours of ROADMAP Queue 3 (prefix pages never ranked and evicted
first; every admission's forward runs the prefix again), each pinned in
both packages.  ``tests/test_torch_prefix.py`` holds the model, the
stacks and the tolerances."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from repro.serve.engine import generate as r_generate

from repro_torch.models import model as TM
from repro_torch.serve.engine import generate as t_generate

from test_torch_prefix import NEW, PAGE, _models, _serve, _stack


@pytest.mark.parametrize("macro", [True, False])
def test_batcher_greedy_streams_match_reference(macro):
    """Greedy streams rid for rid, migrations, hits, misses and the
    tuner's history equal the reference batcher's."""
    ref, ref_mon = _serve("ref", macro)
    port, port_mon = _serve("port", macro)
    assert port == ref
    for key in ("migrations", "data_moved_pages", "hits", "misses"):
        assert getattr(port_mon.manager, key) \
            == getattr(ref_mon.manager, key), key
    assert port_mon.tuner.history == ref_mon.tuner.history
    np.testing.assert_array_equal(port_mon.pools.slot_of,
                                  ref_mon.pools.slot_of)


def test_batcher_streams_match_generate():
    """Four-way parity with the prefix: greedy rows equal the reference's
    ``generate``; a sampled row draws the same tokens on the port's
    ``generate`` (the dense cache), per-token paged path and macro
    path."""
    m = _models()
    temps = (0.0, 0.8, 0.0, 0.8)
    per_token, _ = _serve("port", False, temps)
    macro, _ = _serve("port", True, temps)
    assert per_token == macro
    for i, p in enumerate(m["prompts"]):
        got = t_generate(m["tp"], m["tcfg"], p[None], steps=NEW[i],
                         temperature=temps[i], seed=100 + i,
                         extra_embeds=m["ex"], device="cpu")[0].tolist()
        assert macro[i] == got, i
        if temps[i] == 0:
            ref = np.asarray(r_generate(
                m["rp"], m["rcfg"], jnp.asarray(p[None]), steps=NEW[i],
                extra_embeds=jnp.asarray(m["ex"])))[0].tolist()
            assert got == ref, i


def test_prefix_pages_never_ranked_and_evicted_first():
    """The prefix pages are allocated to owner -1, so ``allocated_mask``
    (what ``maybe_tier`` ranks) leaves them out although every row's
    table maps them; ``_plan_swaps`` evicts in page-id order, and they
    hold the lowest ids, so the first tier with evictions takes them and
    the next launch fetches them back.  Both packages do so alike: the
    same evictions, and the same prefix re-fetches, counted on each."""
    pp = _models()["rcfg"].prefix_len // PAGE
    seen = {}
    for side in ("ref", "port"):
        evicts, fetched = [], []

        def hook(b, evicts=evicts, fetched=fetched):
            mgr, pools = b.monitor.manager, b.monitor.pools
            apply_plan, ensure = mgr.apply_plan, pools.ensure_resident

            def plan(pools_, bring, evict):
                assert not pools.allocated_mask[:pp].any()
                evicts.append(np.asarray(evict).tolist())
                return apply_plan(pools_, bring, evict)

            def fetch(gids):
                pre = np.asarray(gids)[np.asarray(gids) < pp]
                fetched.append(int((pools.slot_of[pre] < 0).sum()))
                return ensure(gids)
            mgr.apply_plan, pools.ensure_resident = plan, fetch

        _serve(side, True, mon=_stack(side, hbm=7), hook=hook)
        seen[side] = (evicts, fetched)
        first = next(e for e in evicts if e)
        n = min(pp, len(first))
        assert first[:n] == list(range(n)), first
        assert sum(fetched) > 0
    assert seen["port"] == seen["ref"]


def test_each_admission_runs_the_prefix_again(monkeypatch):
    """Every admission's packed forward takes the prefix embeddings again
    (P = 8 positions ahead of each joiner's prompt), in both packages,
    though the prefix's pages were written once at construction."""
    p = _models()["rcfg"].prefix_len
    seen = {"ref": [], "port": []}

    def note(side, ex, toks, lens):
        seen[side].append((ex.shape[1], toks.shape[1],
                           np.asarray(lens).tolist()))

    def hook(b):
        fn = b._prefill_fn

        def wrapped(toks, lens, **kw):
            note("ref", kw["extra_embeds"], toks, lens)
            return fn(toks, lens, **kw)
        b._prefill_fn = wrapped

    fn = TM.prefill_batched

    def port_prefill(params, cfg, toks, lens, **kw):
        note("port", kw["extra_embeds"], toks, lens)
        return fn(params, cfg, toks, lens, **kw)

    monkeypatch.setattr(TM, "prefill_batched", port_prefill)
    _serve("ref", True, hook=hook)
    _serve("port", True)
    assert seen["port"] == seen["ref"]
    assert len(seen["port"]) >= 3          # the up-front pair, 2 joiners
    for ex_len, _, lens in seen["port"]:
        assert ex_len == p
        assert all(n == 1 or n > p for n in lens)
