"""The port's single-stream tiered path against the JAX reference: the
monitor layer's attention mass (``serve.engine``), ``monitored_generate``
and the physical replay over ``memtier.PagedPools``.

Reduced ``gemma3-12b`` (local and global layers, window 8) and reduced
``paligemma-3b`` (its prefix of 8 positions drawn N(0, 1) in numpy from a
seed and given to both packages), float32, with the reference's
parameters carried over through ``repro_torch.bridge``:

  * ``monitor_slot`` for every registered architecture (xlstm-1.3b, which
    has no attention, raises);
  * ``page_mass_from_attention`` with GQA, empty (-1) slots and a cache
    that ends inside a page, against the reference's;
  * the ``workload`` generators' arrays, ``PagedPools.create``'s
    residency, the physical ``replay`` step for step against the
    reference's and against the symbolic ``replay`` (with a period change
    mid-run), migrated bytes, and the paged kernel's plain version over
    the HBM tier equal to its oracle over the host pages.

``make_monitor`` and ``monitored_generate`` are held in
``tests/test_torch_engine_monitor.py``, on this file's models.
Tolerances: 1e-5 on masses and attention outputs (float32; the
scatter-add that sums a page's mass is unordered on a card)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.kernels import ops as rops
from repro.memtier import PagedPools as RPagedPools
from repro.memtier import TierConfig as RTierConfig
from repro.memtier import TieringManager as RManager
from repro.memtier import interleaved_resident as r_interleaved
from repro.memtier import replay as r_replay
from repro.memtier import workload as RW
from repro.models import model as RM
from repro.serve import engine as RE

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch import memtier as TMT
from repro_torch import serve as TSV
from repro_torch.kernels import ops as tops
from repro_torch.memtier import workload as TW
from repro_torch.models import model as TM
from repro_torch.serve import engine as TE

TOL = 1e-5
_CACHE = {}


def _models(arch):
    if arch not in _CACHE:
        rcfg = dataclasses.replace(RC.reduced(arch), dtype="float32")
        tcfg = dataclasses.replace(TC.reduced(arch), dtype="float32")
        rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
        tp = bridge.from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                   device="cpu")
        rng = np.random.default_rng(1)
        prompts = rng.integers(0, rcfg.vocab_size, (2, 10)).astype(np.int32)
        ex = None
        if rcfg.prefix_len:
            ex = rng.standard_normal((2, rcfg.prefix_len, rcfg.d_model)) \
                .astype(np.float32)
        _CACHE[arch] = dict(rcfg=rcfg, rp=rp, tcfg=tcfg, tp=tp,
                            prompts=prompts, ex=ex)
    return _CACHE[arch]


def _close(t, r, tol=TOL):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(t, np.asarray(r), atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_monitor_slot_matches_reference(arch):
    """The deepest full-attention slot of every registered config, or a
    ``ValueError`` naming an attention-free arch on both sides."""
    try:
        want = RE.monitor_slot(RC.get(arch))
    except ValueError as e:
        assert "attention-free" in str(e)
        with pytest.raises(ValueError, match="attention-free"):
            TE.monitor_slot(TC.get(arch))
        return
    assert TE.monitor_slot(TC.get(arch)) == want


@pytest.mark.parametrize("h,kv,t,page", [(4, 1, 13, 4), (8, 2, 16, 4),
                                         (4, 4, 7, 3)])
def test_page_mass_from_attention_matches_reference(h, kv, t, page):
    """GQA groups, empty (-1) slots, a slot past the current position and
    a cache whose length is not a whole number of pages (the reference
    pads it to whole pages): per-row masses within 1e-5, each row's
    masses summing to the head count."""
    rng = np.random.default_rng(h * 100 + t)
    b, d = 3, 16
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    pos = np.tile(np.arange(t), (b, 1)).astype(np.int64)
    pos[1, t - 3:] = -1
    pos[2, 2] = -1
    cur = np.asarray([t - 1, t - 4, t - 2], np.int64)
    n_pages = -(-t // page) + 1
    r = RE.page_mass_from_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(pos), jnp.asarray(cur), page,
                                    n_pages)
    got = TE.page_mass_from_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(pos),
                                      torch.from_numpy(cur), page, n_pages)
    assert got.shape == (b, n_pages) and got.dtype == torch.float32
    _close(got, r)
    _close(got.sum(dim=1), np.full(b, float(h)))


def test_attention_free_arch_has_no_monitor():
    cfg = dataclasses.replace(TC.reduced("xlstm-1.3b"), dtype="float32")
    params = TM.init(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="attention-free"):
        TE.monitored_generate(params, cfg, np.zeros((1, 8), np.int32),
                              steps=4, device="cpu")


def test_serve_exports():
    """The serve package exports the reference's single-stream names and
    the batcher's."""
    for name in ("generate", "monitored_generate", "make_monitor",
                 "monitor_slot", "page_mass_from_attention",
                 "ContinuousBatcher", "Request", "TrafficMonitor"):
        assert name in TSV.__all__ and hasattr(TSV, name), name


# ---------------------------------------------------------------------------
# workloads, PagedPools and the physical replay
# ---------------------------------------------------------------------------

CFG = dict(hbm_pages=8, period_steps=4)
WORKLOADS = ["attention_sink", "periodic_context", "random_lookup"]


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_matches_reference(name):
    for args in ((120, 32), (400, 64)):
        np.testing.assert_array_equal(getattr(TW, name)(*args),
                                      getattr(RW, name)(*args))


@pytest.mark.parametrize("n,hbm", [(32, 8), (16, 16), (17, 5)])
def test_paged_pools_create_matches_reference(n, hbm):
    """Interleaved initial residency: the same slot tables as the
    reference's, and each HBM slot a copy of its page."""
    k = np.random.default_rng(n).standard_normal((n, 4, 2, 8)) \
        .astype(np.float32)
    r = RPagedPools.create(jnp.asarray(k), jnp.asarray(2 * k), hbm)
    t = TMT.PagedPools.create(torch.from_numpy(k), torch.from_numpy(2 * k),
                              hbm)
    np.testing.assert_array_equal(t.slot_of, r.slot_of)
    np.testing.assert_array_equal(t.page_of_slot, r.page_of_slot)
    np.testing.assert_array_equal(t.slot_of >= 0, r_interleaved(n, hbm))
    np.testing.assert_array_equal(t.k_hbm.numpy(), np.asarray(r.k_hbm))
    np.testing.assert_array_equal(t.v_hbm.numpy(), np.asarray(r.v_hbm))
    assert t.move_planes == 2 and t.slot_epoch == 0


def _pools(side, n=32, hbm=8):
    k = np.random.default_rng(5).standard_normal((n, 4, 2, 8)) \
        .astype(np.float32)
    if side == "ref":
        return RPagedPools.create(jnp.asarray(k), jnp.asarray(-k), hbm)
    return TMT.PagedPools.create(torch.from_numpy(k), torch.from_numpy(-k),
                                 hbm)


@pytest.mark.parametrize("name", WORKLOADS)
def test_physical_replay_matches_reference_and_symbolic(name):
    """Step for step, with a live period change at step 50: the port's
    physical tiering keeps the same residency as the reference's physical
    one and as its own symbolic one, with equal migrations, modeled time,
    pages moved, hits and misses; ``replay`` with pools gives the
    reference's accounting, and every resident HBM slot holds its host
    page's bytes."""
    wl = getattr(TW, name)(120, 32)
    rcfg, tcfg = RTierConfig(**CFG), TMT.TierConfig(**CFG)
    rpools, tpools = _pools("ref"), _pools("port")
    rmgr, tmgr = RManager(32, rcfg), TMT.TieringManager(32, tcfg)
    smgr = TMT.TieringManager(32, tcfg)
    resident = TMT.interleaved_resident(32, 8)
    for t in range(wl.shape[0]):
        rmgr.on_step(wl[t], rpools.slot_of >= 0)
        rpools = rmgr.maybe_tier(rpools)
        tmgr.on_step(wl[t], TMT.resident_mask(tmgr, tpools))
        tpools = tmgr.maybe_tier(tpools)
        smgr.on_step(wl[t], resident)
        smgr.maybe_tier_symbolic(resident)
        if t == 50:
            for mgr in (rmgr, tmgr, smgr):
                mgr.set_period(2)
        np.testing.assert_array_equal(tpools.slot_of, rpools.slot_of,
                                      err_msg=f"step {t}")
        np.testing.assert_array_equal(tpools.slot_of >= 0, resident,
                                      err_msg=f"step {t}")
    for key in ("migrations", "modeled_time", "data_moved_pages", "hits",
                "misses"):
        assert getattr(tmgr, key) == getattr(rmgr, key) \
            == getattr(smgr, key), key
    live = np.nonzero(tpools.slot_of >= 0)[0]
    assert torch.equal(tpools.k_hbm[torch.from_numpy(tpools.slot_of[live])
                                    .long()],
                       tpools.k_host[torch.from_numpy(live)])
    assert torch.equal(tpools.v_hbm, torch.from_numpy(np.array(
        rpools.v_hbm)))

    cfg = TMT.TierConfig(**CFG)
    got = TMT.replay(wl, cfg, pools=_pools("port"))
    want = r_replay(wl, RTierConfig(**CFG), pools=_pools("ref"))
    sym = TMT.replay(wl, cfg)
    for key in ("migrations", "modeled_time", "data_moved_pages", "hits",
                "misses", "step"):
        assert getattr(got, key) == getattr(want, key) \
            == getattr(sym, key), key
    assert TMT.resident_mask(got, None).sum() == 0


def test_migration_moves_page_contents():
    """After tiering, the HBM tier holds the hot pages' bytes at the slots
    ``slot_of`` names."""
    n, page, kv, d = 32, 4, 2, 8
    k_host = torch.arange(n * page * kv * d, dtype=torch.float32).reshape(
        n, page, kv, d)
    pools = TMT.PagedPools.create(k_host, k_host * 2, hbm_pages=4)
    mgr = TMT.TieringManager(n, TMT.TierConfig(hbm_pages=4, period_steps=2))
    m = np.zeros((8, n), np.float32)
    m[:, [5, 9]] = 1.0
    for t in range(8):
        mgr.on_step(m[t], pools.slot_of >= 0)
        pools = mgr.maybe_tier(pools)
    assert mgr.migrations > 0 and mgr.data_moved_pages == 2 * mgr.migrations
    for logical in (5, 9):
        slot = pools.slot_of[logical]
        assert slot >= 0 and pools.page_of_slot[slot] == logical
        assert torch.equal(pools.k_hbm[slot], k_host[logical])
        assert torch.equal(pools.v_hbm[slot], 2 * k_host[logical])


def test_paged_attention_consumes_tiered_pool():
    """The paged kernel's plain version over the HBM tier through
    ``slot_of`` equals the reference's oracle over the host pages through
    logical ids, for a sequence whose pages are all resident."""
    n, page, kv, d, h = 16, 8, 2, 32, 4
    rng = np.random.default_rng(7)
    k_host = rng.standard_normal((n, page, kv, d)).astype(np.float32)
    v_host = rng.standard_normal((n, page, kv, d)).astype(np.float32)
    pools = TMT.PagedPools.create(torch.from_numpy(k_host),
                                  torch.from_numpy(v_host), hbm_pages=8)
    mgr = TMT.TieringManager(n, TMT.TierConfig(hbm_pages=8, period_steps=1))
    mass = np.zeros((4, n), np.float32)
    mass[:, :4] = 1.0
    for t in range(4):
        mgr.on_step(mass[t], pools.slot_of >= 0)
        pools = mgr.maybe_tier(pools)
    assert (pools.slot_of[:4] >= 0).all()
    assert not np.array_equal(pools.slot_of[:4], np.arange(4))
    q = rng.standard_normal((1, h, d)).astype(np.float32)
    lengths = np.asarray([4 * page - 3], np.int32)
    got = tops.paged_attention(
        torch.from_numpy(q), pools.k_hbm, pools.v_hbm,
        torch.from_numpy(pools.slot_of[:4][None].astype(np.int32)),
        torch.from_numpy(lengths))
    want = rops.paged_attention(
        jnp.asarray(q), jnp.asarray(k_host), jnp.asarray(v_host),
        jnp.arange(4, dtype=jnp.int32)[None], jnp.asarray(lengths),
        impl="reference")
    _close(got, want)
