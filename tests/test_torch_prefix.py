"""The port's shared prefix (PaliGemma's image tokens) against the JAX
reference.

Reduced ``paligemma-3b`` (4/1 heads of 16, a prefix of 8 positions: two
pages of 4), float32, with the reference's parameters carried over
through ``repro_torch.bridge`` and the same prefix embeddings, drawn
N(0, 1) in numpy from a seed, given to both packages:

  * ``causal_mask`` over a grid of window x prefix;
  * forward logits, ``prefill`` and ``prefill_batched`` logits and caches
    with ``extra_embeds``; the prefix attends itself both ways and never
    the text;
  * prefill + dense decode, and ``generate``'s greedy tokens;
  * the fully-paged decode step with two rows mapping the same prefix
    pages (logits, page mass, write-through);
  * the prefix pages written once, and the batcher's refusals.

The ``ContinuousBatcher``'s streams, and two behaviours of the reference
the port keeps (ROADMAP Queue 3: the prefix pages, owned by no request,
are never ranked into the working set and are the first evicted; every
admission's forward runs over the prefix again), are held in
``tests/test_torch_prefix_serve.py`` on this file's model.

Tolerances: 1e-4 absolute on logits, 1e-5 on page masses and caches
(float32, different reduction orders)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.core.cori import OnlineTuner as RTuner
from repro.memtier.tiering import SharedPagedPools as RPools
from repro.memtier.tiering import TierConfig as RTierConfig
from repro.memtier.tiering import TieringManager as RManager
from repro.models import layers as RL
from repro.models import model as RM
from repro.serve import sched as RS
from repro.serve.engine import generate as r_generate

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.core.cori import OnlineTuner as TTuner
from repro_torch.memtier.tiering import SharedPagedPools as TPools
from repro_torch.memtier.tiering import TierConfig as TTierConfig
from repro_torch.memtier.tiering import TieringManager as TManager
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import sched as TS
from repro_torch.serve.engine import generate as t_generate

ARCH = "paligemma-3b"
LOGIT_TOL, TOL = 1e-4, 1e-5
# float32 relative term: two frameworks' summation orders on different CPUs
F32_RTOL = 4e-6
N_LOGICAL, HBM, PAGE = 48, 10, 4
PROMPT_LENS = (6, 9, 5, 11)
NEW = (6, 4, 9, 7)

_CACHE = {}


def _models():
    if not _CACHE:
        rcfg = dataclasses.replace(RC.reduced(ARCH), dtype="float32")
        tcfg = dataclasses.replace(TC.reduced(ARCH), dtype="float32")
        rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
        tp = bridge.from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                   device="cpu")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32)
                   for n in PROMPT_LENS]
        ex = rng.standard_normal((1, rcfg.prefix_len, rcfg.d_model)) \
            .astype(np.float32)
        _CACHE.update(rcfg=rcfg, rp=rp, tcfg=tcfg, tp=tp, prompts=prompts,
                      ex=ex)
    return _CACHE


def _close(t, r, tol, rtol=F32_RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(r), atol=tol,
                               rtol=rtol)


def _ex_rows(b, ex=None):
    """The prefix broadcast to ``b`` rows: (reference's, port's)."""
    ex = _models()["ex"] if ex is None else ex
    e = np.broadcast_to(ex, (b,) + ex.shape[1:]).copy()
    return jnp.asarray(e), torch.from_numpy(e)


def _caches_close(tcache, rcache):
    for t, r in zip(tcache["segments"][0], rcache["segments"][0]):
        assert sorted(t) == sorted(r)
        for name, a in t.items():
            np.testing.assert_allclose(a.numpy(), np.asarray(r[name]),
                                       atol=TOL, rtol=F32_RTOL)


# ---------------------------------------------------------------------------
# the mask and the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 3, 6])
@pytest.mark.parametrize("prefix_len", [0, 1, 4, 8])
def test_causal_mask_matches_reference(window, prefix_len):
    """The mask over a grid of window x prefix, with queries offset from
    the keys and a -1 key (an empty cache slot)."""
    k_pos = np.concatenate([np.arange(12), [-1]])[None]
    for q_pos in (np.arange(12)[None], np.arange(5, 9)[None]):
        r = RL.causal_mask(jnp.asarray(q_pos), jnp.asarray(k_pos),
                           window=window, prefix_len=prefix_len)
        t = TL.causal_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                           window, prefix_len)
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


def test_forward_prefill_match():
    """forward, prefill and prefill_batched with ``extra_embeds``: logits
    over every position, the caches (the timeline starts at the prefix;
    ``lengths`` count it) and the last logits of each padded row."""
    m = _models()
    rcfg, rp, tcfg, tp = m["rcfg"], m["rp"], m["tcfg"], m["tp"]
    p = rcfg.prefix_len
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (2, 11)) \
        .astype(np.int32)
    tt = torch.from_numpy(toks).long()
    rex, tex = _ex_rows(2)
    tl = TM.forward(tp, tcfg, tt, extra_embeds=tex)[0]
    assert tl.shape == (2, p + 11, rcfg.vocab_size)
    _close(tl, RM.forward(rp, rcfg, toks, extra_embeds=rex)[0], LOGIT_TOL)

    rl, rcache = RM.prefill(rp, rcfg, jnp.asarray(toks), extra_embeds=rex)
    tl, tcache = TM.prefill(tp, tcfg, tt, extra_embeds=tex)
    _close(tl, rl, LOGIT_TOL)
    _caches_close(tcache, rcache)

    lengths = np.asarray([p + 11, p + 6], np.int32)
    rl, rcache = RM.prefill_batched(rp, rcfg, jnp.asarray(toks),
                                    jnp.asarray(lengths), extra_embeds=rex)
    tl, tcache = TM.prefill_batched(tp, tcfg, tt, torch.from_numpy(lengths),
                                    extra_embeds=tex)
    _close(tl, rl, LOGIT_TOL)
    _caches_close(tcache, rcache)
    assert tcache["segments"][0][0]["pos"][0, 1].tolist() == \
        list(range(p + 6)) + [-1] * 5


def test_prefix_is_bidirectional_and_independent_of_text():
    """A prefix position attends the whole prefix, later positions
    included (its logits move when only the last prefix embedding does),
    and no text position (its logits and cache rows stay put when the
    text changes); the text attends the prefix.  The reference agrees on
    each input."""
    m = _models()
    rcfg, rp, tcfg, tp = m["rcfg"], m["rp"], m["tcfg"], m["tp"]
    p = rcfg.prefix_len
    rng = np.random.default_rng(2)
    toks = rng.integers(0, rcfg.vocab_size, (1, 5)).astype(np.int32)
    other = (toks + 1) % rcfg.vocab_size
    ex2 = m["ex"].copy()
    ex2[:, -1] += 1.0
    base = TM.forward(tp, tcfg, torch.from_numpy(toks).long(),
                      extra_embeds=_ex_rows(1)[1])[0]
    text = TM.forward(tp, tcfg, torch.from_numpy(other).long(),
                      extra_embeds=_ex_rows(1)[1])[0]
    late = TM.forward(tp, tcfg, torch.from_numpy(toks).long(),
                      extra_embeds=_ex_rows(1, ex2)[1])[0]
    assert torch.equal(base[:, :p], text[:, :p])
    assert float((base[:, 0] - late[:, 0]).abs().max()) > 100 * LOGIT_TOL
    assert float((base[:, p:] - late[:, p:]).abs().max()) > 100 * LOGIT_TOL
    _, c1 = TM.prefill(tp, tcfg, torch.from_numpy(toks).long(),
                       extra_embeds=_ex_rows(1)[1])
    _, c2 = TM.prefill(tp, tcfg, torch.from_numpy(other).long(),
                       extra_embeds=_ex_rows(1)[1])
    for name in ("k", "v"):
        assert torch.equal(c1["segments"][0][0][name][:, :, :p],
                           c2["segments"][0][0][name][:, :, :p])
    for tk, ex, got in ((other, m["ex"], text), (toks, ex2, late)):
        _close(got, RM.forward(rp, rcfg, tk,
                               extra_embeds=_ex_rows(1, ex)[0])[0],
               LOGIT_TOL)


def test_prefill_decode_and_generate_match():
    """prefill + three dense decode steps (positions counting the prefix)
    and ``generate``'s greedy tokens equal the reference's."""
    m = _models()
    rcfg, rp, tcfg, tp = m["rcfg"], m["rp"], m["tcfg"], m["tp"]
    p = rcfg.prefix_len
    toks = np.random.default_rng(3).integers(0, rcfg.vocab_size, (2, 9)) \
        .astype(np.int32)
    rex, tex = _ex_rows(2)
    rl, rcache = RM.prefill(rp, rcfg, jnp.asarray(toks), extra_embeds=rex)
    tl, tcache = TM.prefill(tp, tcfg, torch.from_numpy(toks).long(),
                            extra_embeds=tex)
    rcache = RM.pad_cache(rcache, rcfg, p + 16)
    tcache = TM.pad_cache(tcache, tcfg, p + 16)
    pos, tok = np.full((2,), p + 9, np.int32), toks[:, -1:]
    for _ in range(3):
        rl, rcache = RM.decode_step(rp, rcfg, rcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = TM.decode_step(tp, tcfg, tcache,
                                    torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos).long())
        _close(tl, rl, LOGIT_TOL)
        tok, pos = np.asarray(rl).argmax(-1).astype(np.int32), pos + 1
    want = r_generate(rp, rcfg, jnp.asarray(toks), steps=6,
                      extra_embeds=rex)
    got = t_generate(tp, tcfg, toks, steps=6, extra_embeds=m["ex"][0:1]
                     .repeat(2, 0), device="cpu")
    assert got.tolist() == np.asarray(want).tolist()


def test_decode_step_paged_shares_prefix_pages():
    """Two rows whose tables start with the same two prefix pages (one of
    them at another HBM slot than its logical id would suggest) and an
    inactive row: logits, page mass (the prefix columns carry mass in
    both rows) and the write-through into both tiers equal the
    reference's."""
    m = _models()
    rcfg, rp, tcfg, tp = m["rcfg"], m["rp"], m["tcfg"], m["tp"]
    page, hbm, n_logical = PAGE, 12, 20
    tables = np.asarray([[6, 2, 3, 7, -1, -1],
                         [6, 2, 0, 5, 9, 11],
                         [-1, -1, -1, -1, -1, -1]], np.int32)
    gid_tables = np.asarray([[0, 1, 4, 5, -1, -1],
                             [0, 1, 8, 9, 10, 11],
                             [-1, -1, -1, -1, -1, -1]], np.int32)
    rng = np.random.default_rng(4)
    pools = {}
    for r, leaves in TM.slot_leaf_specs(tcfg, page):
        for name, trail in leaves.items():
            for tier, n in (("hbm", hbm), ("host", n_logical)):
                pools.setdefault(f"{name}_{tier}", []).append(
                    rng.standard_normal((r, n) + trail).astype(np.float32))
    cur_pos = np.asarray([13, 21, -1], np.int32)
    tokens = rng.integers(0, rcfg.vocab_size, (3, 1)).astype(np.int32)
    rkv = {k: [jnp.asarray(a) for a in v] for k, v in pools.items()}
    rl, rkv2, rmass = RM.decode_step_paged(
        rp, rcfg, rkv, jnp.asarray(tables), jnp.asarray(gid_tables),
        jnp.asarray(tokens), jnp.asarray(cur_pos), page_size=page,
        impl="reference")
    tkv = {k: [torch.from_numpy(np.concatenate(
                   [a, np.zeros_like(a[:, :1])], axis=1)) for a in v]
           for k, v in pools.items()}
    tl, tmass = TM.decode_step_paged(
        tp, tcfg, tkv, torch.from_numpy(tables), torch.from_numpy(gid_tables),
        torch.from_numpy(tokens).long(), torch.from_numpy(cur_pos).long(),
        page_size=page)
    active = cur_pos >= 0
    _close(tl[active], np.asarray(rl)[active], LOGIT_TOL)
    _close(tmass, rmass, TOL, rtol=0)
    assert bool((tmass[:2, :2] > 0).all())
    np.testing.assert_allclose(tmass.sum(dim=1).numpy()[active], 1.0,
                               atol=TOL)
    for k in pools:
        for t, r in zip(tkv[k], rkv2[k]):
            np.testing.assert_allclose(t[:, :-1].numpy(), np.asarray(r),
                                       atol=TOL, rtol=F32_RTOL)


# ---------------------------------------------------------------------------
# the serving loop
# ---------------------------------------------------------------------------


def _stack(side, n_logical=N_LOGICAL, hbm=HBM):
    tier = dict(page_size=PAGE, hbm_pages=hbm, period_steps=2)
    tune = dict(default_period=2, profile_steps=8, trial_steps=4)
    if side == "ref":
        return RS.TrafficMonitor(RPools.create(n_logical, hbm),
                                 RManager(n_logical, RTierConfig(**tier)),
                                 RTuner(n_logical, **tune))
    return TS.TrafficMonitor(TPools.create(n_logical, hbm),
                             TManager(n_logical, TTierConfig(**tier)),
                             TTuner(n_logical, **tune))


def _batcher(side, mon, macro, **kw):
    m = _models()
    if side == "ref":
        return RS.ContinuousBatcher(m["rp"], m["rcfg"], max_active=2,
                                    max_len=32, page_size=PAGE, monitor=mon,
                                    paged_impl="reference", macro=macro,
                                    extra_embeds=m["ex"], **kw)
    return TS.ContinuousBatcher(m["tp"], m["tcfg"], max_active=2, max_len=32,
                                page_size=PAGE, monitor=mon, macro=macro,
                                extra_embeds=m["ex"], device="cpu", **kw)


def _serve(side, macro, temps=(0.0, 0.0, 0.0, 0.0), mon=None, hook=None):
    """Serve the four requests with two rows after the shared prefix: two
    submitted up front, the others joining mid-flight (staggered,
    recycled rows).  ``hook(b)`` runs once the batcher is built."""
    m = _models()
    mon = mon or _stack(side)
    b = _batcher(side, mon, macro)
    if hook is not None:
        hook(b)
    if side == "ref":
        mk = lambda i: RS.Request(rid=i, prompt=m["prompts"][i],
                                  max_new_tokens=NEW[i],
                                  key=jax.random.PRNGKey(0))
    else:
        mk = lambda i: TS.Request(rid=i, prompt=m["prompts"][i],
                                  max_new_tokens=NEW[i],
                                  temperature=temps[i], seed=100 + i)
    b.submit(mk(0))
    b.submit(mk(1))
    for t in range(200):
        if t in (1, 3):
            b.submit(mk(2 if t == 1 else 3))
        b.step()
        if t > 3 and not b.queue and not b.active:
            break
    got = {r.rid: list(r.tokens) for r in b.completed}
    assert sorted(got) == [0, 1, 2, 3]
    pp = m["rcfg"].prefix_len // PAGE
    # every owned page came back; the prefix pages stay mapped
    assert mon.pools.free_pages == mon.pools.n_logical - pp
    return got, mon


def test_prefix_pages_written_once_at_construction():
    """The construction writes the prefix's k/v rows into the first two
    logical pages, both tiers, equal to a plain prefill's first 8 cache
    positions and to the reference batcher's pages."""
    m = _models()
    tmon, rmon = _stack("port"), _stack("ref")
    _batcher("port", tmon, True)
    _batcher("ref", rmon, True)
    p = m["rcfg"].prefix_len
    _, cache = TM.prefill(m["tp"], m["tcfg"], torch.zeros((1, 3),
                          dtype=torch.int64), extra_embeds=_ex_rows(1)[1])
    gids = np.arange(p // PAGE)
    assert tmon.pools.owner_of[gids].tolist() == [-1] * len(gids)
    slots = tmon.pools.slot_of[gids]
    np.testing.assert_array_equal(slots, rmon.pools.slot_of[gids])
    rkv = rmon.pools.kv_view()
    for name in ("k", "v"):
        want = cache["segments"][0][0][name][:, 0, :p].reshape(
            (1, len(gids), PAGE) + cache["segments"][0][0][name].shape[3:])
        host = tmon.pools.kv_layers[f"{name}_host"][0][:, gids]
        hbm = tmon.pools.kv_layers[f"{name}_hbm"][0][:, slots]
        _close(host, want.numpy(), TOL)
        assert torch.equal(host, hbm)
        _close(host, np.asarray(rkv[f"{name}_host"][0])[:, gids], TOL)


@pytest.mark.parametrize("case", ["no_prefix", "unaligned", "too_long",
                                  "too_many_pages"])
def test_batcher_refusals(case):
    """A missing prefix, a prefix not on a page boundary, a request whose
    positions overflow a row once the prefix is counted, and one whose
    pages with the prefix's overflow the HBM slots, each raise
    ``ValueError``."""
    m = _models()
    mon = _stack("port")
    if case == "no_prefix":
        with pytest.raises(ValueError, match="extra_embeds"):
            TS.ContinuousBatcher(m["tp"], m["tcfg"], max_active=2,
                                 max_len=32, page_size=PAGE, monitor=mon,
                                 device="cpu")
        return
    if case == "unaligned":
        with pytest.raises(ValueError, match="page-aligned"):
            TS.ContinuousBatcher(m["tp"], m["tcfg"], max_active=2,
                                 max_len=32, page_size=3, monitor=mon,
                                 extra_embeds=m["ex"], device="cpu")
        return
    if case == "too_many_pages":
        mon = _stack("port", hbm=6)
    b = _batcher("port", mon, True)
    # 25 positions fit a row of 32 alone, not after the prefix of 8; 18
    # take 5 own pages, which with the 2 prefix pages overflow 6 slots
    plen, new, match = ((16, 9, "positions") if case == "too_long"
                        else (13, 5, "HBM slot"))
    with pytest.raises(ValueError, match=match):
        b.submit(TS.Request(rid=0, prompt=np.zeros(plen, np.int32),
                            max_new_tokens=new))


@pytest.mark.parametrize("arch,change", [
    ("paligemma-3b", dict(attention_impl="pallas")),
    ("recurrentgemma-2b", dict(prefix_len=8))])
def test_check_supported_refuses_a_prefix_it_cannot_serve(arch, change):
    """A prefix under the flash route (the kernel has no prefix-LM mask)
    and a prefix beside recurrent cells (its pages cannot seed a cell's
    state; the reference batcher refuses it too) raise; paligemma-3b as
    registered passes."""
    TM.check_supported(TC.get(ARCH))
    with pytest.raises(NotImplementedError, match="prefix"):
        TM.check_supported(dataclasses.replace(TC.reduced(arch), **change))


# ---------------------------------------------------------------------------
# the reference's behaviours the port keeps (ROADMAP Queue 3)
# ---------------------------------------------------------------------------


