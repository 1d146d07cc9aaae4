"""The port's offline simulator against the JAX reference, on the CPU.

Trace generators and baselines are identical copies; the ``page_hist``
histogram (kernel wrapper and oracle) agrees with the Pallas kernel in
interpret mode and the jnp oracle; ``bin_trace`` is array-equal; the plain
version of the ``sim_scan`` kernel is bit-equal to the Pallas ``sim_scan``
in interpret mode; ``simulate``/``sweep``/``sweep_loop`` agree with the
reference's and with the numpy oracle ``simulate_reference``.

Tolerances: page counts, masks, migrations and fast hits are exact
(integer-valued float32); hotness within rtol 1e-6 (the reference's XLA
build fuses the EMA's multiply-add, the plain version does not); runtime
is bit-equal to the Pallas kernel (both sum one period after another) and
within rtol 1e-6 of the reference's default ``lax.scan`` path (which sums
the per-period runtimes with ``jnp.sum``); against the float64 numpy
oracle within the rtol the reference's own tests use.  Inputs are made
from fixed seeds with numpy.  JAX stays on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import baselines as r_bl
from repro.core import sim as rsim
from repro.core import traces as rtr
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels import sim_step as r_sim_step

from repro_torch.core import baselines as t_bl
from repro_torch.core import sim as tsim
from repro_torch.core import traces as ttr
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import page_hist as t_page_hist
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import sim_step as t_sim_step

SCHEDS = ["reactive", "predictive"]
CPU = "cpu"


def _small(mod, seed=0):
    return mod.generate("backprop", seed=seed, num_pages=256, sweeps=6,
                        accesses_per_page=3)


def _toy(mod):
    """20 pages, heavy ties: the reference's bitwise kernel test input."""
    rng = np.random.default_rng(7)
    return mod.Trace("toy", rng.integers(0, 20, 3000).astype(np.int64), 20,
                     np.asarray([50]))


def _bins(case):
    """(reference bins, port bins, block) for a named input."""
    if case == "toy":
        return (rsim.bin_trace(_toy(rtr), block=50),
                tsim.bin_trace(_toy(ttr), block=50, device=CPU))
    return rsim.bin_trace(_small(rtr)), tsim.bin_trace(_small(ttr),
                                                       device=CPU)


# --------------------------------------------------------------------------
# host-only copies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("app", rtr.available_traces())
def test_traces_identical(app):
    """Every generator, at its full (default) size and a second seed."""
    assert ttr.available_traces() == rtr.available_traces()
    for seed in (0, 3):
        a, b = rtr.generate(app, seed=seed), ttr.generate(app, seed=seed)
        assert (a.name, a.num_pages) == (b.name, b.num_pages)
        np.testing.assert_array_equal(a.pages, b.pages)
        np.testing.assert_array_equal(a.loop_durations, b.loop_durations)


@pytest.mark.parametrize("n,timestep", [(327680, 2560), (1000, 100),
                                        (1000, 700), (50, 100)])
def test_baselines_identical(n, timestep):
    assert t_bl.TABLE_I_PERIODS == r_bl.TABLE_I_PERIODS
    assert t_bl.BASELINE_ORDERS == r_bl.BASELINE_ORDERS
    assert t_bl.table_i_periods_for(n) == r_bl.table_i_periods_for(n)
    np.testing.assert_array_equal(t_bl.base_candidates(n, timestep),
                                  r_bl.base_candidates(n, timestep))
    for order in t_bl.BASELINE_ORDERS:
        for seed in (0, 1):
            np.testing.assert_array_equal(
                t_bl.ordered_candidates(n, timestep, order, seed),
                r_bl.ordered_candidates(n, timestep, order, seed))


# --------------------------------------------------------------------------
# page_hist: kernel wrapper (plain version on the CPU) and oracle
# --------------------------------------------------------------------------

def _hist_inputs(num_pages, n_ids, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, num_pages, n_ids).astype(np.int32)
    ids[rng.random(n_ids) < 0.1] = -1                  # padding lanes
    hot = (rng.random(num_pages) * 3).astype(np.float32)
    return ids, hot


@pytest.mark.parametrize("num_pages,n_ids", [(512, 100), (1024, 1000),
                                             (2048, 4096), (300, 257)])
def test_page_hist_matches_reference(num_pages, n_ids):
    """ops.page_hist == the Pallas kernel (interpret) and the jnp oracle:
    counts exact, hotness within rtol 1e-6, masks equal -- over an
    alpha/threshold grid, -1 padding and a page count that is not a
    multiple of the Pallas tile (300)."""
    ids, hot = _hist_inputs(num_pages, n_ids, num_pages + n_ids)
    for alpha, thr in ((0.5, 1.0), (0.3, 0.7), (0.9, 2.5)):
        c, h, m = t_ops.page_hist(torch.from_numpy(ids),
                                  torch.from_numpy(hot), alpha=alpha,
                                  threshold=thr)
        tc, th, tm = t_ref.page_hist_ref(torch.from_numpy(ids),
                                         torch.from_numpy(hot), alpha=alpha,
                                         threshold=thr)
        for impl in ("interpret", "reference"):
            rc, rh, rm = (np.asarray(x) for x in r_ops.page_hist(
                jnp.asarray(ids), jnp.asarray(hot), alpha=alpha,
                threshold=thr, impl=impl))
            for got_c, got_h, got_m in ((c, h, m), (tc, th, tm)):
                np.testing.assert_array_equal(got_c.numpy(), rc)
                np.testing.assert_allclose(got_h.numpy(), rh, rtol=1e-6)
                np.testing.assert_array_equal(got_m.numpy(), rm)
        np.testing.assert_array_equal(
            c.numpy(), np.bincount(ids[ids >= 0], minlength=num_pages))


def test_page_hist_padding_and_out_of_range():
    """-1 padding is ignored by every version.  Ids >= num_pages are the
    reference's own split (ROADMAP Queue 3): the Pallas kernel ignores
    them, the jnp oracle clips them into the last page.  The port's kernel
    wrapper mirrors the kernel and its oracle mirrors the oracle."""
    n = 64
    hot = np.zeros(n, np.float32)
    ids = np.array([3, 3, -1, 7, -1, 63, 64, 70, 1000, -5], np.int32)
    c, _, _ = t_ops.page_hist(torch.from_numpy(ids), torch.from_numpy(hot))
    rc, _, _ = r_ops.page_hist(jnp.asarray(ids), jnp.asarray(hot),
                               impl="interpret")
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    assert c[3] == 2 and c[7] == 1 and c[63] == 1 and c.sum() == 4
    tc, _, _ = t_ref.page_hist_ref(torch.from_numpy(ids),
                                   torch.from_numpy(hot))
    rc, _, _ = r_ref.page_hist_ref(jnp.asarray(ids), jnp.asarray(hot))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    assert tc[63] == 4 and tc.sum() == 7                # 64, 70, 1000 clipped


def test_page_hist_rows_in_one_call():
    """[R, P] ids give each row's 1-D result (how bin_trace calls it), and
    the CPU path never counts a kernel launch."""
    rng = np.random.default_rng(5)
    ids = rng.integers(-1, 40, (6, 33)).astype(np.int32)
    hot = rng.random(40).astype(np.float32)
    before = t_page_hist.page_hist.launches
    c, h, m = t_ops.page_hist(torch.from_numpy(ids), torch.from_numpy(hot),
                              alpha=0.25, threshold=0.6)
    assert c.shape == h.shape == m.shape == (6, 40)
    for r in range(6):
        c1, h1, m1 = t_ops.page_hist(torch.from_numpy(ids[r]),
                                     torch.from_numpy(hot), alpha=0.25,
                                     threshold=0.6)
        assert torch.equal(c[r], c1) and torch.equal(h[r], h1) \
            and torch.equal(m[r], m1)
    assert t_page_hist.page_hist.launches == before


@pytest.mark.parametrize("block", [100, 64])
def test_bin_trace_matches_reference(block):
    """The port's bin_trace (page_hist over [num_blocks, block] ids, the
    tail padded with -1) == the reference's bincount and Pallas paths."""
    tr_r, tr_t = _small(rtr, seed=2), _small(ttr, seed=2)
    got = tsim.bin_trace(tr_t, block=block, device=CPU)
    assert got.block_hist.dtype == torch.float32
    assert got.block_hist.device.type == "cpu"
    for impl in ("numpy", "interpret"):
        ref = rsim.bin_trace(tr_r, block=block, impl=impl)
        np.testing.assert_array_equal(got.block_hist.numpy(), ref.block_hist)
        assert (got.block, got.num_accesses, got.num_pages) == \
            (ref.block, ref.num_accesses, ref.num_pages)


def test_entry_points_default_to_the_card():
    """Without a device argument bin_trace runs on the card, and raises
    where there is none (it never carries on on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.bin_trace(_toy(ttr))


# --------------------------------------------------------------------------
# sim_scan: plain version vs the Pallas kernel (interpret) and lax.scan path
# --------------------------------------------------------------------------

def _scan_kw(cfg, num_pages, scheduler):
    return dict(predictive=(scheduler == "predictive"),
                capacity=cfg.fast_capacity(num_pages),
                lat_fast=cfg.lat_fast, lat_slow=cfg.lat_slow,
                bw_slow=cfg.bw_slow, bw_penalty=cfg.bw_penalty,
                mig_cost=cfg.mig_cost,
                period_overhead=cfg.period_overhead(num_pages),
                ema_alpha=cfg.ema_alpha)


@pytest.mark.parametrize("scheduler", SCHEDS)
@pytest.mark.parametrize("case,periods", [
    ("toy", [100, 250, 600, 1500]),
    ("backprop", [100, 300, 700, 1000, 2300])])
def test_sim_scan_plain_bitequal_to_pallas(scheduler, case, periods):
    """sim_scan_plain == repro.kernels.sim_step.sim_scan(interpret=True),
    bit for bit in runtime, swaps and hits, on the default SimConfig."""
    _, tb = _bins(case)
    cfg = tsim.SimConfig()
    kw = _scan_kw(cfg, tb.num_pages, scheduler)
    init = tsim._interleaved_init(tb.num_pages, kw["capacity"])
    for _, stack, nreals in tsim.sweep_stacks(tb, periods):
        got = t_sim_step.sim_scan_plain(
            stack, torch.tensor(nreals, dtype=torch.int32),
            torch.from_numpy(init), **kw)
        ref = r_sim_step.sim_scan(jnp.asarray(stack.numpy()),
                                  jnp.asarray(nreals, jnp.int32),
                                  jnp.asarray(init), interpret=True, **kw)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_sim_scan_plain_bitequal_off_default_config():
    """Every cost constant away from its default (non-dyadic alpha and
    latencies): the fused multiply-adds sit where the reference's are."""
    cfg_kw = dict(fast_frac=0.23, lat_fast=1.3, lat_slow=2.9, bw_slow=0.41,
                  bw_penalty=2.7, mig_cost=13.3, period_cost=7.7,
                  scan_cost_per_page=0.31, ema_alpha=0.3)
    _, tb = _bins("backprop")
    for scheduler in SCHEDS:
        kw = _scan_kw(tsim.SimConfig(**cfg_kw), tb.num_pages, scheduler)
        init = tsim._interleaved_init(tb.num_pages, kw["capacity"])
        (_, stack, nreals), = tsim.sweep_stacks(tb, [300, 400, 500])
        got = t_sim_step.sim_scan_plain(
            stack, torch.tensor(nreals, dtype=torch.int32),
            torch.from_numpy(init), **kw)
        ref = r_sim_step.sim_scan(jnp.asarray(stack.numpy()),
                                  jnp.asarray(nreals, jnp.int32),
                                  jnp.asarray(init), interpret=True, **kw)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("scheduler", SCHEDS)
@pytest.mark.parametrize("case", ["toy", "backprop"])
def test_sweep_matches_reference_lax_scan(scheduler, case):
    """The port's sweep vs the reference's default (vmapped lax.scan)
    sweep: migrations and fast hits exact, runtime within rtol 1e-6 (the
    reference sums per-period runtimes with jnp.sum)."""
    rb, tb = _bins(case)
    periods = rsim.exhaustive_periods(rb, 24)
    a = rsim.sweep(rb, periods, scheduler)
    b = tsim.sweep(tb, periods, scheduler)
    assert list(a) == list(b)
    for p in a:
        assert a[p].migrations == b[p].migrations
        assert a[p].fast_hits == b[p].fast_hits
        assert a[p].data_moved_pages == b[p].data_moved_pages
        assert (a[p].period_requests, a[p].num_accesses, a[p].scheduler) \
            == (b[p].period_requests, b[p].num_accesses, b[p].scheduler)
        np.testing.assert_allclose(b[p].runtime, a[p].runtime, rtol=1e-6)


def test_fast_set_follows_lax_top_k_where_torch_topk_does_not():
    """On tie-heavy scores torch.topk picks another set than lax.top_k;
    the plain version's selection picks lax.top_k's, and a two-period
    scan whose second period depends on the first's set stays bit-equal
    to the Pallas kernel."""
    rng = np.random.default_rng(11)
    n, cap = 4096, 819
    differs = 0
    for _ in range(5):
        score = rng.integers(0, 6, n).astype(np.float32) * np.float32(0.5)
        ref = set(np.asarray(jax.lax.top_k(jnp.asarray(score), cap)[1]))
        mine = set(np.nonzero(t_sim_step._fast_set(
            torch.from_numpy(score)[None], cap)[0].numpy())[0])
        topk = set(torch.topk(torch.from_numpy(score), cap).indices.numpy())
        assert mine == ref
        differs += topk != ref
    assert differs == 5
    # two predictive periods over tie-heavy counts, empty initial fast set
    hist = rng.integers(0, 3, (1, 2, n)).astype(np.float32)
    kw = _scan_kw(tsim.SimConfig(), n, "predictive")
    init = np.zeros(n, bool)
    got = t_sim_step.sim_scan_plain(torch.from_numpy(hist),
                                    torch.tensor([2], dtype=torch.int32),
                                    torch.from_numpy(init), **kw)
    ref = r_sim_step.sim_scan(jnp.asarray(hist), jnp.asarray([2], jnp.int32),
                              jnp.asarray(init), interpret=True, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# --------------------------------------------------------------------------
# the CUDA sim_scan kernel's select and division, emulated here as built
# (the kernel itself runs only on the card: tests/test_torch_gpu.py)
# --------------------------------------------------------------------------

def _kernel_layout(n):
    """(threads, pages a thread) of the kernel's instance for n pages
    (``sim_scan_launch`` in csrc/sim_scan.cu)."""
    if n <= 256:
        return 32, 1 << (-(-n // 32) - 1).bit_length()
    if n <= 4096:
        return 1 << (-(-n // 8) - 1).bit_length(), 8
    return 512, 16 if n <= 8192 else 32


def _order_keys(score):
    """The kernel's order-preserving float -> uint32 map, -0 folded to +0."""
    s = np.where(score == 0, np.float32(0), score).astype(np.float32)
    b = s.view(np.uint32).astype(np.int64)
    return np.where(b & 0x80000000, ~b & 0xffffffff, b | 0x80000000)


def _radix_pass(keys, shift, prefix, known, want, above):
    """One radix pass as every warp of the kernel scans it: 8-bit digits,
    lane l holding bins 255-8l..248-8l; with ``above`` the keys whose known
    bits exceed ``prefix`` are counted first.  Returns (digit, rest,
    in_bin), or None where the want-th key is not in the histogram."""
    mk = keys & known
    hist = np.bincount((keys[mk == prefix] >> shift) & 255, minlength=256)
    if above:
        want -= int((mk > prefix).sum())
    cnt = hist[::-1].reshape(32, 8)
    incl = np.cumsum(cnt.sum(axis=1))
    excl = incl - cnt.sum(axis=1)
    lanes = np.nonzero((want > 0) & (excl < want) & (want <= incl))[0]
    if not len(lanes):
        return None
    lane, seen = lanes[0], excl[lanes[0]]
    for b in range(8):
        if seen + cnt[lane, b] >= want:
            return 255 - 8 * lane - b, want - seen, cnt[lane, b]
        seen += cnt[lane, b]


def _kernel_select(score, capacity, guess):
    """The kernel's fast set for one period's scores: the guess pass over
    the keys sharing ``guess`` (the previous threshold's top 16 bits), one
    more pass when it holds, else four passes from the top byte, each
    stopping early once the threshold's bin holds exactly the keys still
    to take; then the ties ranked as the kernel ranks them (ballots a run
    position inside a warp, the last-byte pass's per-warp counts across
    warps, over the (thread, run position) page order).  Returns (members,
    next guess, the known bits, guess held, passes)."""
    n = len(score)
    keys = _order_keys(score)
    g = _radix_pass(keys, 8, guess, 0xffff0000, capacity, True)
    passes, all_in = 1, False
    if g is not None:
        digit, remaining, in_bin = g
        prefix, known = guess | digit << 8, 0xffffff00
        all_in = in_bin == remaining
        if not all_in:
            digit, remaining, in_bin = _radix_pass(keys, 0, prefix, known,
                                                   remaining, False)
            prefix, known, passes = prefix | digit, 0xffffffff, 2
            all_in = in_bin == remaining
    else:
        prefix, known, remaining = 0, 0, capacity
        for shift in (24, 16, 8, 0):
            digit, remaining, in_bin = _radix_pass(keys, shift, prefix,
                                                   known, remaining, False)
            prefix |= digit << shift
            known |= 255 << shift
            passes += 1
            if in_bin == remaining:
                all_in = True
                break
    mk = keys & known
    members = mk > prefix
    tie = mk == prefix
    if all_in:
        members |= tie
    else:
        threads, per = _kernel_layout(n)
        t = np.zeros(threads * per, bool)
        t[:n] = tie
        t = t.reshape(threads // 32, 32, per)     # [warp, lane, position]
        lane_ties, warp_ties = t.sum(axis=2), t.sum(axis=(1, 2))
        rank = ((np.cumsum(warp_ties) - warp_ties)[:, None, None]
                + (np.cumsum(lane_ties, axis=1) - lane_ties)[:, :, None]
                + np.cumsum(t, axis=2) - t).reshape(-1)[:n]
        members |= tie & (rank < remaining)
    return members, prefix & 0xffff0000, known, g is not None, passes


def _scores(kind, n, rng):
    if kind == "random":
        return (rng.standard_normal(n) * 10).astype(np.float32)
    if kind == "ties":
        return rng.integers(0, 6, n).astype(np.float32) * np.float32(0.5)
    if kind == "equal":
        return np.full(n, 1.25, np.float32)
    if kind == "recency":
        # the simulator's cold pages: (last + 1) / (i + 2) over a few
        # hundred last accesses, plus 0.5 in fast memory -- runs of equal
        # scores a few to a few dozen long
        last = rng.choice(rng.integers(-1, 999, 300), n).astype(np.float32)
        return ((last + 1) / np.float32(1001)
                + np.float32(0.5) * (rng.random(n) < 0.2)).astype(np.float32)
    # +0 and -0 (equal to the reference), a few positives between them
    s = np.where(rng.random(n) < 0.5, np.float32(-0.0), np.float32(0.0))
    s[rng.random(n) < 0.1] = 1.0
    return s.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "equal", "signed_zeros",
                                  "recency"])
@pytest.mark.parametrize("n", [20, 1023, 4096, 4097, 16384])
def test_kernel_select_is_lax_top_k_membership(kind, n):
    """The kernel's select, emulated as built, picks ``_fast_set``'s and
    ``jax.lax.top_k``'s members (-0 folded into +0 for the latter, as the
    plain version and the kernel rank them) at capacity 1, ~20% and n,
    whether the
    guess pass holds (the threshold's own top 16 bits), misses (0) or
    misses by one (the next group up); the guess it passes on agrees with
    the threshold's top 16 bits wherever it knows them; the guess pass
    holds exactly when the guess is right, and then takes at most two
    passes; at capacity n the first pass over all keys ends it."""
    rng = np.random.default_rng(n + len(kind))
    score = _scores(kind, n, rng)
    keys = _order_keys(score)
    # lax.top_k ranks +0 above -0 where the plain version's stable sort and
    # the kernel tie them; the simulator's scores are never -0 (every term
    # is >= +0), so lax.top_k is asked about the scores with -0 folded
    folded = np.where(score == 0, np.float32(0), score).astype(np.float32)
    for cap in sorted({1, max(1, round(0.2 * n)), n}):
        ref = np.zeros(n, bool)
        ref[np.asarray(jax.lax.top_k(jnp.asarray(folded), cap)[1])] = True
        plain = t_sim_step._fast_set(torch.from_numpy(score)[None], cap)[0]
        np.testing.assert_array_equal(plain.numpy(), ref)
        top16 = int(np.sort(keys)[::-1][cap - 1]) & 0xffff0000
        for guess in (top16, 0, (top16 + 0x10000) & 0xffffffff):
            got, nxt, known, held, passes = _kernel_select(score, cap, guess)
            np.testing.assert_array_equal(got, ref)
            assert (nxt ^ top16) & known & 0xffff0000 == 0
            assert held == (guess == top16)
            if cap == n:                     # the first full pass stops
                assert passes == (1 if held else 2)
        assert _kernel_select(score, cap, top16)[4] <= 2


def _div_by(a, d):
    """The kernel's branch-free a / d (``div_by`` in csrc/sim_scan.cu):
    y = RN(1/d), q0 = RN(a*y), then two corrections by the exact residual,
    with exactly rounded fused multiply-adds."""
    y = torch.ones_like(d) / d
    q0 = (a.double() * y.double()).float()
    q1 = t_sim_step._fma32(t_sim_step._fma32(-d, q0, a), y, q0)
    return t_sim_step._fma32(t_sim_step._fma32(-d, q1, a), y, q1)


def test_kernel_division_is_ieee_division():
    """The recency's division as the kernel computes it equals IEEE float32
    division for every numerator last + 1 <= i at every period i < 4096
    (denominator i + 2) and for 2**21 random pairs with denominators up to
    2**24."""
    for lo in range(0, 4096, 1024):
        i = torch.arange(lo, lo + 1024)
        a = torch.cat([torch.arange(k + 1) for k in i.tolist()]).float()
        d = (torch.repeat_interleave(i, i + 1) + 2).float()
        assert torch.equal(_div_by(a, d).view(torch.int32),
                           (a / d).view(torch.int32))
    g = torch.Generator().manual_seed(0)
    d = torch.randint(2, 2 ** 24 + 1, (2 ** 21,), generator=g)
    a = (torch.rand(2 ** 21, generator=g, dtype=torch.float64)
         * d).floor().long()
    a, d = a.float(), d.float()
    keep = a < d
    assert torch.equal(_div_by(a[keep], d[keep]).view(torch.int32),
                       (a[keep] / d[keep]).view(torch.int32))


@pytest.mark.parametrize("scheduler", SCHEDS)
def test_one_launch_grouping_matches_per_chunk_route(scheduler,
                                                     monkeypatch):
    """``sweep_groups`` -- what ``sweep`` launches -- covers every candidate
    exactly once with its own real period rows, keeps each launch within
    ``SWEEP_CHUNK_ELEMS`` (one launch at the default), and through
    ``sim_scan_rows`` gives results bit-equal to ``sim_scan_plain`` over
    the per-chunk stacks of ``sweep_stacks``."""
    _, tb = _bins("backprop")
    periods = tsim.exhaustive_periods(tb, 24)
    ks = sorted({max(1, round(int(p) / tb.block)) for p in periods})
    kw = _scan_kw(tsim.SimConfig(), tb.num_pages, scheduler)
    init = torch.from_numpy(tsim._interleaved_init(tb.num_pages,
                                                   kw["capacity"]))
    chunked = {}
    for cks, stack, nreals in tsim.sweep_stacks(tb, periods):
        out = t_sim_step.sim_scan_plain(
            stack, torch.tensor(nreals, dtype=torch.int32), init, **kw)
        for j, k in enumerate(cks):
            chunked[k] = tuple(o[j].item() for o in out)
    default = tsim.SWEEP_CHUNK_ELEMS
    for limit in (default, tb.num_blocks * tb.num_pages, 1):
        monkeypatch.setattr(tsim, "SWEEP_CHUNK_ELEMS", limit)
        launches = tsim.sweep_launches(tb, periods)
        assert sorted(k for ks_ in launches for k in ks_) == ks
        if limit == default:
            assert len(launches) == 1
        got = {}
        groups = list(tsim.sweep_groups(tb, periods))
        assert [g[0] for g in groups] == launches
        for gks, rows, starts, nreals in groups:
            assert rows.numel() <= limit or len(gks) == 1
            assert starts == [sum(nreals[:j]) for j in range(len(gks))]
            for j, k in enumerate(gks):
                ph, nr = tsim._aggregate_periods(tb, k)
                assert nreals[j] == nr
                assert torch.equal(rows[starts[j]: starts[j] + nr], ph[:nr])
            out = t_sim_step.sim_scan_rows(rows, starts, nreals, init, **kw)
            for j, k in enumerate(gks):
                got[k] = tuple(o[j].item() for o in out)
        assert got == chunked
    assert len(tsim.sweep_launches(tb, periods)) == len(ks)


def test_sim_scan_rows_checks_its_rows():
    """Candidates whose rows lie outside the array raise on either route;
    an empty candidate set gives empty results."""
    rows = torch.zeros((5, 8))
    init = torch.zeros(8, dtype=torch.bool)
    kw = _scan_kw(tsim.SimConfig(), 8, "reactive")
    for starts, nreals in (([0, 3], [3, 3]), ([-1], [1]), ([0], [-1]),
                           ([0, 1], [1])):
        with pytest.raises(ValueError):
            t_sim_step.sim_scan_rows(rows, starts, nreals, init, **kw)
    out = t_sim_step.sim_scan_rows(rows, [], [], init, **kw)
    assert all(o.shape == (0,) for o in out)


# --------------------------------------------------------------------------
# simulate / sweep / sweep_loop / exhaustive_periods
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", SCHEDS)
@pytest.mark.parametrize("period", [100, 700, 2300])
def test_simulate_matches_reference(scheduler, period):
    """simulate == the reference's simulate (migrations, hits exact;
    runtime rtol 1e-6) and == both numpy oracles (rtol 1e-5, as
    tests/test_sim.py); the port's oracle equals the reference's."""
    rb, tb = _bins("backprop")
    a = rsim.simulate(rb, period, scheduler)
    b = tsim.simulate(tb, period, scheduler)
    assert (a.migrations, a.fast_hits, a.period_requests) == \
        (b.migrations, b.fast_hits, b.period_requests)
    np.testing.assert_allclose(b.runtime, a.runtime, rtol=1e-6)
    ra = rsim.simulate_reference(rb, period, scheduler)
    rt = tsim.simulate_reference(tb, period, scheduler)
    assert dataclasses.astuple(ra) == dataclasses.astuple(rt)
    assert (b.migrations, b.fast_hits) == (rt.migrations, rt.fast_hits)
    np.testing.assert_allclose(b.runtime, rt.runtime, rtol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_random_traces_match_oracle(seed):
    """Random small footprints (8-64 pages, block 50): simulate == the
    numpy oracle, hit rate in [0, 1], runtime above the all-fast floor."""
    rng = np.random.default_rng(seed)
    n_pages = int(rng.integers(8, 65))
    n = int(rng.integers(200, 2001))
    pages = rng.integers(0, n_pages, size=n).astype(np.int32)
    bins = tsim.bin_trace(ttr.Trace("rand", pages, n_pages, np.array([n])),
                          block=50, device=CPU)
    period = int(rng.choice([50, 100, 250]))
    sched = SCHEDS[seed % 2]
    a = tsim.simulate(bins, period, sched)
    b = tsim.simulate_reference(bins, period, sched)
    np.testing.assert_allclose(a.runtime, b.runtime, rtol=1e-4)
    assert a.migrations == b.migrations and a.fast_hits == b.fast_hits
    assert 0.0 <= a.fast_hitrate <= 1.0
    assert a.runtime >= n * 1.0


@pytest.mark.parametrize("scheduler", SCHEDS)
def test_sweep_matches_loop(scheduler):
    """The batched sweep == the per-candidate simulate loop, bit for bit
    (both scan with the same per-period arithmetic)."""
    _, tb = _bins("backprop")
    periods = [100, 300, 700, 1000, 2300]
    a = tsim.sweep_loop(tb, periods, scheduler)
    b = tsim.sweep(tb, periods, scheduler)
    assert a == b


def test_sweep_empty_duplicates_and_snapping():
    _, tb = _bins("backprop")
    assert tsim.sweep(tb, []) == {}
    out = tsim.sweep(tb, [100, 120, 149])
    assert list(out) == [100]
    assert tsim.simulate(tb, 149, "reactive").period_requests == 100
    assert tsim.simulate(tb, 151, "reactive").period_requests == 200
    with pytest.raises(ValueError):
        tsim.sweep(tb, [100], scheduler="lru")


@pytest.mark.parametrize("case", ["toy", "backprop"])
def test_exhaustive_periods_identical(case):
    rb, tb = _bins(case)
    for m in (8, 96, 128):
        np.testing.assert_array_equal(tsim.exhaustive_periods(tb, m),
                                      rsim.exhaustive_periods(rb, m))


def test_both_aggregation_paths_and_chunking(monkeypatch):
    """Lowering the 2**24 exactness guard switches sweep to the reshape-sum
    aggregation, and a tiny chunk limit splits every pow2 group into
    one-candidate launches: the results stay bit-identical."""
    _, tb = _bins("backprop")
    periods = tsim.exhaustive_periods(tb, 24)
    base = tsim.sweep(tb, periods, "reactive")
    hists = tsim._device_period_hists(tb, [1, 3, 7])
    monkeypatch.setattr(tsim, "EXACT_CUMSUM_LIMIT", 1)
    summed = tsim._device_period_hists(tb, [1, 3, 7])
    for k in (1, 3, 7):
        assert hists[k][1] == summed[k][1]
        assert torch.equal(hists[k][0], summed[k][0])
        ph, nr = tsim._aggregate_periods(tb, k)
        assert nr == hists[k][1] and torch.equal(ph[:nr], hists[k][0])
    assert tsim.sweep(tb, periods, "reactive") == base
    plan = tsim.sweep_plan(tb, periods)
    monkeypatch.setattr(tsim, "SWEEP_CHUNK_ELEMS", 1)
    assert len(tsim.sweep_plan(tb, periods)) == len(base) > len(plan)
    assert tsim.sweep(tb, periods, "reactive") == base
