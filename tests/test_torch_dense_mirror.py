"""The port's dense batcher with a monitor and ``mirror_pages``, and
``paged_context`` in both modes, against the JAX reference:

  * reduced qwen3-14b (GQA 4/2, two repeats), gemma3-12b (window 8) and
    paligemma-3b (prefix of 8 drawn N(0, 1) in numpy) against the
    reference's dense batcher: greedy streams, every merged mass vector,
    migrations, hits, misses, the tuner history, and the mirrored
    ``k_host``/``v_host`` and ``k_hbm``/``v_hbm`` arrays;
  * ``paged_context`` in both modes against the reference's and against
    the paged kernel's plain version over the host pages, with the
    demand fetches it returns and charges;
  * the dense mirror's prefix page range (a reference behaviour, ROADMAP
    Queue 3).

``tests/test_torch_dense.py`` holds the models, the stacks and the
tolerances these cases share."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.serve import sched as RS

from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.models import model as TM
from repro_torch.serve import sched as TS

from test_torch_dense import (DENSE_HBM, HBM, MASS_TOL, MIRRORED, NEW,
                              N_LOGICAL, PAGE, PROBE_STEPS, _close,
                              _mirror_stack, _models, _probe_q)


def _record_merges(mon):
    seen = []
    merge = mon.merge

    def rec(contrib):
        out = merge(contrib)
        seen.append(out.copy())
        return out

    mon.merge = rec
    return seen


def _serve_mirrored(arch, side, paged=False, hbm=HBM):
    """The four requests, greedy, two rows (two up front, two joining
    mid-flight), with a monitor over physical pools; ``paged_context`` of
    every in-flight request at ``PROBE_STEPS``.  Returns (streams, merged
    masses, monitor, probes: [(step, rid, context, fetched, misses
    charged, modeled time charged, host-page oracle)]).  Before the
    second probe of a request its first own page is demoted to the host,
    so that probe fetches at least that page."""
    m = _models(arch)
    cfg = m["rcfg"]
    mon = _mirror_stack(side, cfg, hbm)
    merges = _record_merges(mon)
    if side == "ref":
        b = RS.ContinuousBatcher(m["rp"], cfg, max_active=2, max_len=32,
                                 page_size=PAGE, monitor=mon, paged=paged,
                                 mirror_pages=True, paged_impl="reference",
                                 extra_embeds=m["ex"])
        mk = lambda i: RS.Request(rid=i, prompt=m["prompts"][i],
                                  max_new_tokens=NEW[i],
                                  key=jax.random.PRNGKey(0))
    else:
        b = TS.ContinuousBatcher(m["tp"], m["tcfg"], max_active=2,
                                 max_len=32, page_size=PAGE, monitor=mon,
                                 paged=paged, mirror_pages=True,
                                 extra_embeds=m["ex"], device="cpu")
        mk = lambda i: TS.Request(rid=i, prompt=m["prompts"][i],
                                  max_new_tokens=NEW[i])
    assert b.paged == paged and b.mirror_pages == (not paged)
    probes = []
    b.submit(mk(0))
    b.submit(mk(1))
    for t in range(200):
        if t in (1, 3):
            b.submit(mk(2 if t == 1 else 3))
        b.step()
        if t in PROBE_STEPS:
            for req in sorted(b.active.values(), key=lambda r: r.rid):
                if t == PROBE_STEPS[1]:
                    # the probe must fetch it back (a preemption's demote)
                    mon.pools.demote(req.gids[:1])
                q = _probe_q(cfg, req.rid, t)
                misses, cost = mon.manager.misses, mon.manager.modeled_time
                if side == "ref":
                    out, fetched = b.paged_context(req.rid, jnp.asarray(q),
                                                   impl="reference")
                    oracle = None
                else:
                    out, fetched = b.paged_context(req.rid, q)
                    oracle = _host_oracle(b, req, q)
                probes.append((t, req.rid, np.asarray(out), fetched,
                               mon.manager.misses - misses,
                               mon.manager.modeled_time - cost, oracle))
        if t > 3 and not b.queue and not b.active:
            break
    got = {r.rid: list(r.tokens) for r in b.completed}
    assert sorted(got) == [0, 1, 2, 3]
    pp = (cfg.prefix_len or 0) // PAGE if paged else 0
    assert mon.pools.free_pages == N_LOGICAL - pp
    return got, merges, mon, probes


def _host_oracle(b, req, q):
    """The kernel's plain version over the host tier through the
    request's logical page ids: what ``paged_context`` must return."""
    pools = b.monitor.pools
    length = int(b.pos[req.row])
    n = -(-length // b.page_size)
    if b.paged:
        li = TM.attn_slot_index(b.cfg, b._si, b._sj)
        k, v = (pools.kv_layers[f"{x}_host"][li][-1] for x in ("k", "v"))
        gids = req.table_gids[:n]
    else:
        k, v, gids = pools.k_host, pools.v_host, req.gids[:n]
    out, _ = paged_attention_plain(
        torch.from_numpy(q), k, v,
        torch.from_numpy(np.asarray(gids, np.int32)[None]),
        torch.tensor([length], dtype=torch.int32))
    return out.numpy()


def _check_probes(port, ref, mgr_cfg):
    assert [p[:2] for p in port] == [p[:2] for p in ref]
    assert sum(p[3] for p in port) >= sum(p[0] == PROBE_STEPS[1]
                                          for p in port) > 0
    for (_, _, out, fetched, misses, cost, oracle), r in zip(port, ref):
        _close(out, r[2])
        _close(out, oracle)
        assert (fetched, misses) == (r[3], r[4]) == (fetched, fetched)
        assert cost == r[5] == fetched * mgr_cfg.miss_penalty


@pytest.mark.parametrize("arch", MIRRORED)
def test_dense_mirror_matches_reference(arch):
    """The dense batcher with a monitor and ``mirror_pages``: greedy
    streams, every merged mass vector, migrations, hits, misses and the
    tuner history equal the reference dense batcher's; the mirrored legacy
    pair holds the reference's pages on both tiers; ``paged_context``
    returns the reference's context and demand fetches, and equals the
    plain kernel over the host pages."""
    ref, ref_m, ref_mon, ref_p = _serve_mirrored(arch, "ref", hbm=DENSE_HBM)
    port, port_m, port_mon, port_p = _serve_mirrored(arch, "port",
                                                     hbm=DENSE_HBM)
    assert port == ref
    assert len(port_m) == len(ref_m) > 0
    for a, b in zip(port_m, ref_m):
        _close(a, b, MASS_TOL, rtol=0)
    for key in ("migrations", "data_moved_pages", "hits", "misses",
                "modeled_time"):
        assert getattr(port_mon.manager, key) \
            == getattr(ref_mon.manager, key), key
    assert port_mon.manager.migrations > 0
    assert port_mon.tuner.history == ref_mon.tuner.history
    np.testing.assert_array_equal(port_mon.pools.slot_of,
                                  ref_mon.pools.slot_of)
    for name in ("k_host", "v_host", "k_hbm", "v_hbm"):
        got = getattr(port_mon.pools, name).numpy()
        assert np.abs(got).sum() > 0, name
        _close(got, getattr(ref_mon.pools, name))
    _check_probes(port_p, ref_p, port_mon.manager.cfg)


def test_paged_context_paged_mode_matches_reference():
    """On the fully-paged path (per-token here; the layered leaves
    attached beside the legacy pair) ``paged_context`` reads the monitor
    slot's layered HBM leaf: the reference's context and fetches, and the
    plain kernel over the layered host leaf."""
    ref, _, ref_mon, ref_p = _serve_mirrored("paligemma-3b", "ref",
                                             paged=True)
    port, _, port_mon, port_p = _serve_mirrored("paligemma-3b", "port",
                                                paged=True)
    assert port == ref
    assert port_mon.manager.misses == ref_mon.manager.misses
    assert not port_mon.pools.k_host.abs().sum(), \
        "the paged path never writes the legacy pair"
    _check_probes(port_p, ref_p, port_mon.manager.cfg)


def test_dense_mirror_prefix_page_range():
    """The reference's dense mirror, kept: at admission it writes the
    pages ``range(ceil((prefix + plen) / page))`` of the request's own
    run -- the prefix's rows are copied into every request's own first
    pages (nothing is shared on the dense path) -- and skips any page
    past the request's exact footprint.  The same pages, both packages."""
    written = {}
    for side in ("ref", "port"):
        m = _models("paligemma-3b")
        mon = _mirror_stack(side, m["rcfg"])
        calls = []
        write = mon.pools.write_page

        def rec(gid, k, v, write=write, calls=calls):
            calls.append(int(gid))
            return write(gid, k, v)

        mon.pools.write_page = rec
        kw = dict(max_active=2, max_len=32, page_size=PAGE, monitor=mon,
                  paged=False, mirror_pages=True, extra_embeds=m["ex"])
        if side == "ref":
            b = RS.ContinuousBatcher(m["rp"], m["rcfg"], **kw)
            req = RS.Request(rid=0, prompt=m["prompts"][1], max_new_tokens=3)
        else:
            b = TS.ContinuousBatcher(m["tp"], m["tcfg"], device="cpu", **kw)
            req = TS.Request(rid=0, prompt=m["prompts"][1], max_new_tokens=3)
        b.submit(req)
        b._admit()
        plen, prefix = len(req.prompt), m["rcfg"].prefix_len
        assert req.n_pages == -(-(prefix + plen + 3) // PAGE)
        assert calls == req.gids[: -(-(prefix + plen) // PAGE)].tolist()
        pages = np.asarray(mon.pools.k_host)[req.gids[: prefix // PAGE]]
        written[side] = pages
        # the request's own first pages hold the prefix's rows
        c = b.cache["segments"][b._si][b._sj]["k"][-1, req.row, :prefix]
        _close(pages.reshape(c.shape), np.asarray(c))
    _close(written["port"], written["ref"])
