"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor the reference, so it runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card each test skips (decided inside the test).  Tolerances:
paged attention 1e-5 absolute in float32 (summation order), 2e-2 for
bfloat16 outputs, page masses 1e-5 (the same for ``paged_attention_mla``,
whose bfloat16 rows are also held within 2^-6 of their norm), at the
kernels' usual shapes and at the edges of their splits over pages;
``flash_attention`` 2e-5 in float32 up to 512 keys, 1e-4 beyond (longer
sums in another order), 2e-2 in bfloat16 with each output row within 2^-6
of its norm (one bfloat16 ulp of the output is <= 2^-7 of it), and repeats
bit-identical; ``mlstm_scan``'s C, n and m bit-equal to its plain
version for one position (the strip kernel rounds where the plain
version rounds; h within ``h_tolerance``) and, over a sequence (the
chunkwise kernel), m bit-equal, C, n and h within ``tolerances``;
``slstm_scan`` each position within the one-step
bound of its plain cell (``tolerance``) and its sequence launch
bit-identical to chained one-position launches; ``rglru_scan`` within
``h_tolerance``; the recurrences' backward kernels (``rglru_scan``'s
too) within ``grad_check``'s bars; ``routed_experts`` within 1e-5 of the
largest output magnitude (float32 sums of up to 7168 products in another
order) and repeats bit-identical; ``page_hist`` and ``sim_scan`` are
bit-equal to their plain versions (the kernels round where the plain
versions round), ``sim_scan`` at every run length of pages a thread it
instantiates and in one launch over candidates of different lengths."""
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import page_hist as tph
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import paged_attention_mla as tpam
from repro_torch.kernels import routed_experts as tre
from repro_torch.kernels import sim_step as tss


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,window,softcap", [(40, 8, 0, 0.0),
                                                 (16, 16, 0, 0.0),
                                                 (4, 4, 3, 0.0),
                                                 (8, 2, 0, 5.0),
                                                 (8, 1, 8, 5.0)])
def test_cuda_kernel_matches_plain(dtype, h, kv, window, softcap):
    """The CUDA kernel against its plain version on the card (ragged -1
    rows and a length-0 row included), and the launch counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python -m pytest -m gpu)")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(h * 10 + kv)
    b, d, page, n, p_phys = 4, 128, 16, 16, 96
    q = torch.randn((b, h, d), generator=g, device=dev).to(dt)
    kp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dt)
    vp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dt)
    pt = torch.randperm(p_phys, generator=g, device=dev)[: b * n] \
        .reshape(b, n).to(torch.int32)
    pt[1, 10:] = -1
    ln = torch.tensor([n * page, 10 * page - 3, 0, 37], dtype=torch.int32,
                      device=dev)
    before = tpa.paged_attention.launches
    out, mass = tpa.paged_attention(q, kp, vp, pt, ln, window=window,
                                    softcap=softcap)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    ref_o, ref_m = tpa.paged_attention_plain(q, kp, vp, pt, ln,
                                             window=window, softcap=softcap)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref_o.float(), atol=tol, rtol=0)
    torch.testing.assert_close(mass, ref_m, atol=1e-5, rtol=0)
    active = ln > 0
    torch.testing.assert_close(mass.sum(dim=1)[active],
                               torch.ones(int(active.sum()), device=dev),
                               atol=1e-5, rtol=0)


# the edges of the kernel's split over pages (``split_plan``: 4 pages a
# split at B=4, KV=8, n=64 or window 1000, 3 at n=50), as chip_smoke.py's
# phase 3: spans ending inside the first split or on a split boundary
# beside a full row, -1 slots inside a split and a split of -1 slots only,
# a window whose short spans leave the later splits empty, n not a
# multiple of the split, a length-0 row
SPLIT_EDGES = [
    (64, 0, 0.0, [1024, 20, 64, 320], [(0, 5), (3, 2), (0, 8), (0, 9),
                                       (0, 10), (0, 11)]),
    (128, 1000, 0.0, [2048, 1030, 700, 1], [(1, 40)]),
    (50, 0, 5.0, [800, 799, 48, 0], []),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,window,softcap,lengths,holes", SPLIT_EDGES)
def test_cuda_kernel_split_edges(dtype, n, window, softcap, lengths, holes):
    """The kernel against its plain version where its split over pages can
    go wrong; zeros for a length-0 row; two calls bit-identical (the
    combine has no atomics)."""
    dev = _card()
    dt = getattr(torch, dtype)
    h, kv, d = (16, 8, 256) if window else (40, 8, 128)
    b, page, p_phys = 4, 16, 4 * n
    g = torch.Generator(device=dev).manual_seed(n + window)
    q = torch.randn((b, h, d), generator=g, device=dev).to(dt)
    kp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dt)
    vp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dt)
    pt = torch.randperm(p_phys, generator=g, device=dev)[: b * n] \
        .reshape(b, n).to(torch.int32)
    for row, length in enumerate(lengths):
        pt[row, -(-length // page):] = -1
    for row, pg in holes:
        pt[row, pg] = -1
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(window=window, softcap=softcap)
    out, mass = tpa.paged_attention(q, kp, vp, pt, ln, **kw)
    out2, mass2 = tpa.paged_attention(q, kp, vp, pt, ln, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(mass, mass2)
    ref_o, ref_m = tpa.paged_attention_plain(q, kp, vp, pt, ln, **kw)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref_o.float(), atol=tol, rtol=0)
    torch.testing.assert_close(mass, ref_m, atol=1e-5, rtol=0)
    active = ln > 0
    torch.testing.assert_close(mass.sum(dim=1)[active],
                               torch.ones(int(active.sum()), device=dev),
                               atol=1e-5, rtol=0)
    assert torch.count_nonzero(out[~active]) == 0
    assert torch.count_nonzero(mass[~active]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_at_recurrentgemma_decode_shape(dtype):
    """recurrentgemma-2b's local layers: 10 query heads over 1 KV head
    (five groups of two at D 256), window 2048, rows past the window, a
    row without a request, and the served tables' last column -- the state
    page, past every length -- which the kernel must not read: it holds
    to its plain version, the masses sum to 1 with none at that column,
    and two calls are bit-identical."""
    dev = _card()
    dt = getattr(torch, dtype)
    b, h, kv, d, page, n, p_phys = 4, 10, 1, 256, 16, 193, 800
    lengths = [3000, 2100, 2049, 0]
    g = torch.Generator(device=dev).manual_seed(10)
    q = torch.randn((b, h, d), generator=g, device=dev).to(dt)
    kp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dt)
    vp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dt)
    perm = torch.randperm(p_phys, generator=g, device=dev).to(torch.int32)
    pt = perm[: b * n].reshape(b, n).clone()
    for row, length in enumerate(lengths):
        pt[row, -(-length // page):] = -1
    pt[:3, -1] = perm[b * n: b * n + 3]            # the state pages
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out, mass = tpa.paged_attention(q, kp, vp, pt, ln, window=2048)
    out2, mass2 = tpa.paged_attention(q, kp, vp, pt, ln, window=2048)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(mass, mass2)
    ref_o, ref_m = tpa.paged_attention_plain(q, kp, vp, pt, ln, window=2048)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref_o.float(), atol=tol, rtol=0)
    torch.testing.assert_close(mass, ref_m, atol=1e-5, rtol=0)
    torch.testing.assert_close(mass.sum(dim=1)[:3],
                               torch.ones(3, device=dev), atol=1e-5, rtol=0)
    assert torch.count_nonzero(mass[:, -1]) == 0
    assert torch.count_nonzero(out[3]) == 0


# (h, kv, d, lengths) of the decode shapes of musicgen-large (32/32 heads of
# 64: a GQA group of one), nemotron-4-340b (96/8 heads of 192: six blocks
# of two heads a KV head, the rows filling half of the second 128-column
# chunk) and stablelm-12b (32/8 heads of 160), B=4 over 64 pages of 16
DECODE_SHAPES = {
    "musicgen-large": (32, 32, 64, [1024, 777, 0, 129]),
    "nemotron-4-340b": (96, 8, 192, [1024, 600, 301, 0]),
    "stablelm-12b": (32, 8, 160, [1000, 1024, 0, 17]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", list(DECODE_SHAPES))
def test_cuda_kernel_at_more_decode_shapes(model, dtype):
    """The kernel at musicgen's, nemotron's and stablelm's decode shapes,
    split as the wrapper plans it (head groups counted): it holds to its
    plain version, each active row's masses sum to 1, a length-0 row gives
    zeros, and two calls are bit-identical."""
    dev = _card()
    dt = getattr(torch, dtype)
    h, kv, d, lengths = DECODE_SHAPES[model]
    b, page, n, p_phys = 4, 16, 64, 300
    g = torch.Generator(device=dev).manual_seed(h + d)
    q = torch.randn((b, h, d), generator=g, device=dev).to(dt)
    kp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dt)
    vp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dt)
    pt = torch.randperm(p_phys, generator=g, device=dev)[: b * n] \
        .reshape(b, n).to(torch.int32)
    for row, length in enumerate(lengths):
        pt[row, -(-length // page):] = -1
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out, mass = tpa.paged_attention(q, kp, vp, pt, ln)
    out2, mass2 = tpa.paged_attention(q, kp, vp, pt, ln)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(mass, mass2)
    ref_o, ref_m = tpa.paged_attention_plain(q, kp, vp, pt, ln)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref_o.float(), atol=tol, rtol=0)
    torch.testing.assert_close(mass, ref_m, atol=1e-5, rtol=0)
    active = ln > 0
    torch.testing.assert_close(mass.sum(dim=1)[active],
                               torch.ones(int(active.sum()), device=dev),
                               atol=1e-5, rtol=0)
    assert torch.count_nonzero(out[~active]) == 0
    assert torch.count_nonzero(mass[~active]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_at_paligemma_decode_shape(dtype):
    """paligemma-3b's decode shape: 8 query heads over 1 KV head of 256
    (four head groups of two), B=4 over 64 pages of 16, every row's first
    16 columns the same shared prefix pages (its 256 image positions), a
    length-0 row: the kernel holds to its plain version, the prefix
    columns carry mass in every active row, and two calls are
    bit-identical."""
    dev = _card()
    dt = getattr(torch, dtype)
    b, h, kv, d, page, n, p_phys, pp = 4, 8, 1, 256, 16, 64, 300, 16
    lengths = [1024, 640, 257, 0]
    g = torch.Generator(device=dev).manual_seed(23)
    q = torch.randn((b, h, d), generator=g, device=dev).to(dt)
    kp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dt)
    vp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dt)
    perm = torch.randperm(p_phys, generator=g, device=dev).to(torch.int32)
    pt = torch.cat([perm[:pp].expand(b, pp),
                    perm[pp: pp + b * (n - pp)].reshape(b, n - pp)], dim=1)
    for row, length in enumerate(lengths):
        pt[row, -(-length // page):] = -1
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out, mass = tpa.paged_attention(q, kp, vp, pt, ln)
    out2, mass2 = tpa.paged_attention(q, kp, vp, pt, ln)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(mass, mass2)
    assert tpa.head_groups(h, kv, d) == 4
    ref_o, ref_m = tpa.paged_attention_plain(q, kp, vp, pt, ln)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref_o.float(), atol=tol, rtol=0)
    torch.testing.assert_close(mass, ref_m, atol=1e-5, rtol=0)
    active = ln > 0
    assert bool((mass[active, :pp] > 0).all())
    assert torch.count_nonzero(out[~active]) == 0


@pytest.mark.gpu
def test_cuda_kernel_over_paged_pools_hbm_tier():
    """The single-stream tiered pool on the card: after tiering brings a
    hot run of pages into HBM, the kernel over ``k_hbm``/``v_hbm`` through
    ``slot_of`` equals its plain version over the host pages through the
    logical ids, and each resident slot holds its page's bytes."""
    import numpy as np
    from repro_torch.memtier import PagedPools, TierConfig, TieringManager
    dev = _card()
    n, page, kv, d, h, hbm = 64, 16, 1, 256, 8, 16
    g = torch.Generator(device=dev).manual_seed(29)
    k_host = torch.randn((n, page, kv, d), generator=g, device=dev)
    v_host = torch.randn((n, page, kv, d), generator=g, device=dev)
    pools = PagedPools.create(k_host, v_host, hbm_pages=hbm)
    mgr = TieringManager(n, TierConfig(hbm_pages=hbm, period_steps=1))
    hot = np.arange(3, 3 + 12)
    mass = np.zeros(n, np.float32)
    mass[hot] = 1.0
    for _ in range(4):
        mgr.on_step(mass, pools.slot_of >= 0)
        pools = mgr.maybe_tier(pools)
    assert (pools.slot_of[hot] >= 0).all() and mgr.migrations > 0
    slots = torch.as_tensor(pools.slot_of[hot].astype(np.int64), device=dev)
    assert torch.equal(pools.k_hbm[slots], k_host[hot])
    assert torch.equal(pools.v_hbm[slots], v_host[hot])
    q = torch.randn((1, h, d), generator=g, device=dev)
    ln = torch.tensor([len(hot) * page - 5], dtype=torch.int32, device=dev)
    out, m = tpa.paged_attention(q, pools.k_hbm, pools.v_hbm,
                                 slots.to(torch.int32)[None], ln)
    ref_o, ref_m = tpa.paged_attention_plain(
        q, k_host, v_host,
        torch.as_tensor(hot, dtype=torch.int32, device=dev)[None], ln)
    torch.testing.assert_close(out, ref_o, atol=1e-5, rtol=0)
    torch.testing.assert_close(m, ref_m, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_cuda_kernel_rejects_what_it_does_not_take():
    """The split kernel copies 16-byte pieces of head dims up to 512: rows
    of another size raise instead of launching."""
    dev = _card()
    pt = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    ln = torch.ones((1,), dtype=torch.int32, device=dev)
    for d, dtype in ((6, torch.float32), (12, torch.bfloat16),
                     (1024, torch.float32)):
        q = torch.zeros((1, 4, d), device=dev, dtype=dtype)
        kp = torch.zeros((2, 4, 2, d), device=dev, dtype=dtype)
        with pytest.raises(ValueError, match="16-byte"):
            tpa.paged_attention(q, kp, kp, pt, ln)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python -m pytest -m gpu)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rows,p,n", [(1, 100, 512), (7, 1000, 1024),
                                      (3277, 100, 4096), (5, 257, 300)])
def test_page_hist_kernel_matches_plain(rows, p, n):
    """Counts, EMA and mask bit-equal to the plain version over an
    alpha/threshold grid, with -1 padding and out-of-range ids (ignored)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(rows + p + n)
    ids = torch.randint(-2, n + 3, (rows, p), generator=g, device=dev,
                        dtype=torch.int32)
    hot = torch.rand((n,), generator=g, device=dev) * 3
    for alpha, thr in ((0.5, 1.0), (0.3, 0.7), (0.9, 2.5)):
        before = tph.page_hist.launches
        got = tph.page_hist(ids, hot, alpha=alpha, threshold=thr)
        torch.cuda.synchronize()
        assert tph.page_hist.launches == before + 1
        ref = tph.page_hist_plain(ids, hot, alpha=alpha, threshold=thr)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    one = tph.page_hist(ids[0].contiguous(), hot)
    assert all(torch.equal(a, b[0]) for a, b in
               zip(one, tph.page_hist(ids[:1].contiguous(), hot)))


def _sim_kw(n, predictive, capacity=None):
    return dict(predictive=predictive,
                capacity=capacity or max(1, round(0.2 * n)), lat_fast=1.0,
                lat_slow=3.0, bw_slow=0.37, bw_penalty=3.0, mig_cost=20.0,
                period_overhead=10.0 + 0.25 * n, ema_alpha=0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("predictive", [False, True])
@pytest.mark.parametrize("c,p,n,hi", [(4, 64, 20, 30), (3, 40, 4096, 6),
                                      (2, 16, 1000, 200)])
def test_sim_scan_kernel_matches_plain(predictive, c, p, n, hi):
    """Runtime, swaps and hits bit-equal to the plain version: a tie-heavy
    20-page stack, the 4096-page footprint with small counts (many ties at
    the capacity boundary) and a ragged set of real period counts."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(c * 1000 + n)
    hists = torch.randint(0, hi, (c, p, n), generator=g, device=dev).float()
    nreals = torch.tensor([p - 3 * j for j in range(c)], dtype=torch.int32,
                          device=dev)
    init = torch.zeros((n,), dtype=torch.bool, device=dev)
    init[torch.arange(0, n, 5, device=dev)] = True
    kw = _sim_kw(n, predictive)
    before = tss.sim_scan.launches
    got = tss.sim_scan(hists, nreals, init, **kw)
    torch.cuda.synchronize()
    assert tss.sim_scan.launches == before + 1
    ref = tss.sim_scan_plain(hists, nreals, init, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b), (a, b)


def _interleaved(n, capacity, dev):
    init = torch.zeros((n,), dtype=torch.bool, device=dev)
    init[(torch.arange(capacity, device=dev) * n) // capacity] = True
    return init


# (n, capacity, counts in [0, hi)): 16 pages a thread; runs of 8 with one
# page in the last; one page short of a full block at a page a thread;
# capacity 1 and n; all-zero counts (every key ties but the 0.5 bonus)
SIM_EDGES = [(16384, None, 4), (4097, None, 3), (1023, None, 5),
             (4096, 1, 3), (4096, 4096, 3), (4096, None, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("predictive", [False, True])
@pytest.mark.parametrize("n,capacity,hi", SIM_EDGES)
def test_sim_scan_kernel_edges(predictive, n, capacity, hi):
    """Bit-equal to the plain version at every run length the kernel
    instantiates, at capacity 1 and n, over all-zero period rows, and two
    calls on the same inputs bit-identical."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(n + (capacity or 0) + hi)
    c, p = 3, 24
    hists = torch.randint(0, max(hi, 1), (c, p, n), generator=g,
                          device=dev).float()
    hists[:, 5] = 0
    nreals = torch.tensor([p, p - 5, 1], dtype=torch.int32, device=dev)
    kw = _sim_kw(n, predictive, capacity)
    init = _interleaved(n, kw["capacity"], dev)
    got = tss.sim_scan(hists, nreals, init, **kw)
    again = tss.sim_scan(hists, nreals, init, **kw)
    torch.cuda.synchronize()
    ref = tss.sim_scan_plain(hists, nreals, init, **kw)
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b), (a, b)
        assert torch.equal(a, r), (a, r)


@pytest.mark.gpu
@pytest.mark.parametrize("predictive", [False, True])
def test_sim_scan_rows_one_launch_equals_per_chunk_launches(predictive):
    """Candidates of different lengths in one ``sim_scan_rows`` launch
    equal their per-chunk ``sim_scan`` launches (zero-padded pow2 stacks,
    as ``core.sim.sweep_plan`` groups them) and the plain version."""
    dev = _card()
    n, lens = 4096, [40, 17, 33, 1, 64, 5]
    g = torch.Generator(device=dev).manual_seed(17)
    rows = torch.randint(0, 4, (sum(lens), n), generator=g,
                         device=dev).float()
    starts = [sum(lens[:j]) for j in range(len(lens))]
    kw = _sim_kw(n, predictive)
    init = _interleaved(n, kw["capacity"], dev)
    before = tss.sim_scan.launches
    got = tss.sim_scan_rows(rows, starts, lens, init, **kw)
    torch.cuda.synchronize()
    assert tss.sim_scan.launches == before + 1
    chunks = {}
    for j, length in enumerate(lens):
        chunks.setdefault(1 << (length - 1).bit_length(), []).append(j)
    for p2, js in chunks.items():
        stack = torch.zeros((len(js), p2, n), device=dev)
        for i, j in enumerate(js):
            stack[i, : lens[j]] = rows[starts[j]: starts[j] + lens[j]]
        nr = torch.tensor([lens[j] for j in js], dtype=torch.int32,
                          device=dev)
        part = tss.sim_scan(stack, nr, init, **kw)
        for a, b in zip(got, part):
            assert torch.equal(a[js], b), (a[js], b)
    ref = tss.sim_scan_rows_plain(rows, starts, lens, init, **kw)
    for a, r in zip(got, ref):
        assert torch.equal(a, r), (a, r)


@pytest.mark.gpu
def test_sim_scan_kernel_rejects_what_it_does_not_take():
    dev = _card()
    init = torch.zeros((tss.MAX_PAGES + 1,), dtype=torch.bool, device=dev)
    big = torch.zeros((1, 1, tss.MAX_PAGES + 1), device=dev)
    one = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        tss.sim_scan(big, one, init, **_sim_kw(tss.MAX_PAGES + 1, False))
    small = torch.zeros((1, 1, 8), device=dev)
    with pytest.raises(ValueError):
        tss.sim_scan(small, one, init[:8], **_sim_kw(8, False, capacity=9))
    with pytest.raises(TypeError):
        tss.sim_scan(small.double(), one, init[:8], **_sim_kw(8, False))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["paged_attention", "paged_attention_mla"])
def test_paged_kernels_on_a_zero_page_table(kernel):
    """A table of zero pages attends to nothing: both CUDA wrappers return
    written zeros (a freed block of NaNs is offered to the allocator
    first, so an output left unwritten would show) and an empty mass."""
    dev = _card()
    b, h, d = 3, 8, 128
    torch.full((b, h, d), float("nan"), device=dev)
    pt = torch.zeros((b, 0), dtype=torch.int32, device=dev)
    ln = torch.tensor([0, 5, 0], dtype=torch.int32, device=dev)
    q = torch.randn((b, h, d), device=dev)
    if kernel == "paged_attention":
        kp = torch.randn((4, 16, 2, d), device=dev)
        out, mass = tpa.paged_attention(q, kp, kp, pt, ln)
    else:
        qr = torch.randn((b, h, 64), device=dev)
        out, mass = tpam.paged_attention_mla(
            q, qr, torch.randn((4, 16, d), device=dev),
            torch.randn((4, 16, 64), device=dev), pt, ln, scale=0.1)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.count_nonzero(out) == 0 and not out.isnan().any()
    assert mass.shape == (b, 0) and mass.dtype == torch.float32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,r,k,page", [(128, 512, 64, 16), (16, 512, 64, 16),
                                        (12, 64, 16, 8), (4, 32, 8, 32),
                                        (40, 256, 64, 48)])
def test_mla_kernel_matches_plain(dtype, h, r, k, page):
    """The CUDA MLA kernel against its plain version on the card: full
    head groups, a partial last head group (12 and 40 heads), pages of a
    whole tile (32 tokens) and pages that straddle tiles (48), ragged -1
    rows and a length-0 row; the launch counter moves by one."""
    dev = _card()
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(h * 10 + page)
    b, n, p_phys = 4, 12, 64
    f = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)
    q, qr, ckv, kr = f(b, h, r), f(b, h, k), f(p_phys, page, r), \
        f(p_phys, page, k)
    pt = torch.randperm(p_phys, generator=g, device=dev)[: b * n] \
        .reshape(b, n).to(torch.int32)
    pt[1, 7:] = -1
    ln = torch.tensor([n * page, 7 * page - 3, 0, page + 1],
                      dtype=torch.int32, device=dev)
    scale = 1.0 / (r ** 0.5)
    before = tpam.paged_attention_mla.launches
    out, mass = tpam.paged_attention_mla(q, qr, ckv, kr, pt, ln, scale=scale)
    torch.cuda.synchronize()
    assert tpam.paged_attention_mla.launches == before + 1
    ref_o, ref_m = tpam.paged_attention_mla_plain(q, qr, ckv, kr, pt, ln,
                                                  scale=scale)
    assert out.dtype == dt
    _check_mla(out, mass, ref_o, ref_m, ln)


# each bfloat16 output row (b, h) within 2^-6 of its norm, beside 2e-2: a
# row of ~1000 tokens has a small |ctx|, where 2e-2 alone would pass a
# split dropped or counted twice (one bfloat16 ulp is <= 2^-7 of a value)
BF16_ROW_TOL = 2.0 ** -6


def _check_mla(out, mass, ref_o, ref_m, ln):
    """The MLA kernel's outputs against its plain version's: 1e-5 in
    float32, 2e-2 and ``BF16_ROW_TOL`` in bfloat16; masses 1e-5, each
    active row's summing to 1, and zeros for a length-0 row."""
    bf16 = out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref_o.float(),
                               atol=2e-2 if bf16 else 1e-5, rtol=0)
    if bf16:
        err = (out.float() - ref_o.float()).norm(dim=-1)
        assert bool((err <= BF16_ROW_TOL * ref_o.float().norm(dim=-1)).all())
    torch.testing.assert_close(mass, ref_m, atol=1e-5, rtol=0)
    active = ln > 0
    torch.testing.assert_close(mass.sum(dim=1)[active],
                               torch.ones(int(active.sum()),
                                          device=mass.device),
                               atol=1e-5, rtol=0)
    assert torch.count_nonzero(out[~active]) == 0
    assert torch.count_nonzero(mass[~active]) == 0


def _mla_inputs(dev, dt, *, b, h, r, k, page, n, p_phys, lengths, holes=(),
                seed=0):
    """Random MLA operands on the card: rows padded with -1 past their
    length, and -1 at each (row, first page, last page) of ``holes``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)
    pt = torch.randperm(p_phys, generator=g, device=dev)[: b * n] \
        .reshape(b, n).to(torch.int32)
    for row, length in enumerate(lengths):
        pt[row, -(-length // page):] = -1
    for row, lo, hi in holes:
        pt[row, lo:hi] = -1
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (f(b, h, r), f(b, h, k), f(p_phys, page, r), f(p_phys, page, k),
            pt, ln)


# where the split over pages can go wrong, at the served widths (H=128,
# R=512, K=64, page 16; mla_split_plan: 8 pages a split at n=64, 7 at
# n=50, whose last split holds one page): spans ending on a split boundary
# (128 tokens), one past it, inside the first tile and inside a page; -1
# slots inside a split, a split of -1 slots only, and a row whose splits
# are all empty but one; n not a multiple of the split; a length-0 row
MLA_SPLIT_EDGES = [
    (64, [128, 129, 1, 1024], [(0, 3, 4), (3, 8, 16)]),
    (64, [1024, 777, 1000, 16], [(2, 0, 16), (2, 24, 64)]),
    (50, [800, 112, 113, 0], [(0, 48, 49)]),
    (50, [799, 17, 785, 33], [(2, 0, 49)]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,lengths,holes", MLA_SPLIT_EDGES)
def test_mla_kernel_split_edges(dtype, n, lengths, holes):
    """The CUDA MLA kernel at the edges of its split over pages, against
    its plain version (``_check_mla``'s bars)."""
    dev = _card()
    dt = getattr(torch, dtype)
    args = _mla_inputs(dev, dt, b=4, h=128, r=512, k=64, page=16, n=n,
                       p_phys=256, lengths=lengths, holes=holes,
                       seed=n + lengths[1])
    scale = 1.0 / 192 ** 0.5
    out, mass = tpam.paged_attention_mla(*args, scale=scale)
    torch.cuda.synchronize()
    ref_o, ref_m = tpam.paged_attention_mla_plain(*args, scale=scale)
    _check_mla(out, mass, ref_o, ref_m, args[5])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_kernel_repeats_are_bit_identical(dtype):
    """No atomics and a fixed order of every sum, the combine's included:
    two calls at the served shape give the same bits."""
    dev = _card()
    args = _mla_inputs(dev, getattr(torch, dtype), b=4, h=128, r=512, k=64,
                       page=16, n=64, p_phys=256,
                       lengths=[1024, 777, 513, 301])
    one = tpam.paged_attention_mla(*args, scale=0.07)
    two = tpam.paged_attention_mla(*args, scale=0.07)
    torch.cuda.synchronize()
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


@pytest.mark.gpu
def test_mla_kernel_rejects_what_it_does_not_take():
    dev = _card()
    q = torch.zeros((1, 8, 16), device=dev)
    qr = torch.zeros((1, 8, 8), device=dev)
    ckv = torch.zeros((2, 4, 16), device=dev)
    kr = torch.zeros((2, 4, 8), device=dev)
    pt = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    ln = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        tpam.paged_attention_mla(q, qr, ckv[:, :, :8], kr, pt, ln, scale=1.0)
    with pytest.raises(TypeError):
        tpam.paged_attention_mla(q, qr.bfloat16(), ckv, kr, pt, ln,
                                 scale=1.0)
    with pytest.raises(TypeError):
        tpam.paged_attention_mla(q, qr, ckv, kr, pt.long(), ln, scale=1.0)
    # rows the 16-byte copies cannot take: 3 float32 krope a token
    with pytest.raises(ValueError, match="16-byte"):
        tpam.paged_attention_mla(q, qr[:, :, :3].contiguous(),
                                 ckv[:, :3].contiguous(),
                                 torch.zeros((2, 3, 3), device=dev), pt, ln,
                                 scale=1.0)
    # value rows wider than the kernel's 4 x 128 columns
    with pytest.raises(ValueError, match="R <= 512"):
        tpam.paged_attention_mla(torch.zeros((1, 8, 520), device=dev), qr,
                                 torch.zeros((2, 4, 520), device=dev), kr,
                                 pt, ln, scale=1.0)


def _flash_inputs(dev, dt, b, s, t, h, kv, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=g, device=dev).to(dt)
    return f(b, s, h, d), f(b, t, kv, d), f(b, t, kv, d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,t,h,kv,d,causal,window", [
    (2, 256, 256, 16, 8, 256, True, 64), (2, 37, 37, 4, 2, 64, True, 0),
    (2, 1, 1, 8, 1, 128, True, 0), (2, 200, 200, 4, 4, 16, False, 0),
    (2, 600, 600, 40, 8, 128, True, 1024), (2, 64, 64, 4, 4, 32, True, 7),
    (2, 100, 100, 4, 2, 256, False, 33),
    # the served shapes: gemma3-12b's packed admissions of 4 and 2 prompts
    (4, 2048, 2048, 16, 8, 256, True, 1024), (4, 2048, 2048, 16, 8, 256,
                                              True, 0),
    (2, 2048, 2048, 16, 8, 256, True, 1024), (2, 2048, 2048, 16, 8, 256,
                                              True, 0),
    # D = 32; rep 5 (one head a block); S < T
    (2, 300, 300, 8, 2, 32, True, 64), (1, 333, 333, 40, 8, 256, True, 0),
    (2, 70, 300, 16, 8, 256, True, 0), (1, 37, 100, 10, 2, 64, False, 16),
    # head dims that are no power of two: stablelm-12b's admissions (32/8
    # of 160), nemotron-4-340b's (96/8 of 192: rep 12, one head a block),
    # 96 and 224
    (4, 512, 512, 32, 8, 160, True, 0), (1, 333, 333, 32, 8, 160, True, 64),
    (2, 300, 300, 96, 8, 192, True, 0), (1, 37, 100, 96, 8, 192, False, 16),
    (2, 100, 100, 8, 2, 96, True, 33), (1, 200, 200, 4, 4, 224, True, 0)])
def test_flash_kernel_matches_plain(dtype, b, s, t, h, kv, d, causal,
                                   window):
    """The CUDA flash kernel against its plain version on the card: GQA
    (rep 1, 2, 4, 5, 8, 12), every head dim it takes, lengths no tile
    divides (S = 1 included), S < T, causal, sliding-window and
    non-causal masks, and the served shapes; the launch counter moves by
    one and the output has q's dtype."""
    dev = _card()
    dt = getattr(torch, dtype)
    q, k, v = _flash_inputs(dev, dt, b, s, t, h, kv, d, s + h + d)
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    ref = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == dt and out.shape == q.shape
    tol = 2e-2 if dt == torch.bfloat16 else (2e-5 if t <= 512 else 1e-4)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    if dt == torch.bfloat16:
        # rows of many keys have a small |out|, where 2e-2 alone would pass
        # a kv tile dropped or counted twice
        err = (out.float() - ref.float()).norm(dim=-1)
        assert bool((err <= 2.0 ** -6 * ref.float().norm(dim=-1)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_repeats_are_bit_identical(dtype):
    """No atomics and a fixed order of every sum: two calls on the same
    inputs give the same bits (the served shape, window 1024)."""
    dev = _card()
    q, k, v = _flash_inputs(dev, getattr(torch, dtype), 4, 2048, 2048, 16,
                            8, 256, 1)
    one = tfa.flash_attention(q, k, v, window=1024)
    two = tfa.flash_attention(q, k, v, window=1024)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,q_offset,h,kv,d,window", [
    # a gemma3-12b admission chunk of 512 positions at each start the
    # served prompts reach, causal and window 1024
    (1, 512, 0, 16, 8, 256, 1024), (1, 512, 512, 16, 8, 256, 1024),
    (1, 512, 1024, 16, 8, 256, 1024), (1, 512, 1536, 16, 8, 256, 1024),
    (1, 512, 1536, 16, 8, 256, 0),
    # a start that is no multiple of the kernel's 32-key tile, S = 1 at
    # the last position, and smaller head dims
    (1, 512, 496, 16, 8, 256, 1024), (1, 512, 496, 16, 8, 256, 0),
    (1, 1, 2047, 16, 8, 256, 1024), (1, 1, 2047, 16, 8, 256, 0),
    (2, 70, 33, 10, 2, 64, 16), (2, 130, 300, 4, 4, 32, 0)])
def test_flash_kernel_query_offset_matches_plain(dtype, b, s, q_offset, h,
                                                 kv, d, window):
    """The kernel with a query offset (query i at position q_offset + i
    over keys 0..q_offset + S - 1) against its plain version on the
    card, with the phase's tolerances."""
    dev = _card()
    dt = getattr(torch, dtype)
    t = q_offset + s
    q, k, v = _flash_inputs(dev, dt, b, s, t, h, kv, d, q_offset + s + d)
    out = tfa.flash_attention(q, k, v, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    ref = tfa.flash_attention_plain(q, k, v, window=window,
                                    q_offset=q_offset)
    tol = 2e-2 if dt == torch.bfloat16 else (2e-5 if t <= 512 else 1e-4)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    if dt == torch.bfloat16:
        err = (out.float() - ref.float()).norm(dim=-1)
        assert bool((err <= 2.0 ** -6 * ref.float().norm(dim=-1)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_query_offset_zero_is_the_kernel_without_one(dtype):
    """q_offset = 0 passed explicitly gives the bits of a call without it,
    and a chunk's rows equal the one pass's rows within the float32 bar
    (the same keys, the same tiles)."""
    dev = _card()
    dt = getattr(torch, dtype)
    q, k, v = _flash_inputs(dev, dt, 1, 2048, 2048, 16, 8, 256, 3)
    one = tfa.flash_attention(q, k, v, window=1024)
    zero = tfa.flash_attention(q, k, v, window=1024, q_offset=0)
    part = tfa.flash_attention(q[:, 1536:].contiguous(), k, v, window=1024,
                               q_offset=1536)
    torch.cuda.synchronize()
    assert torch.equal(one, zero)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    torch.testing.assert_close(part.float(), one[:, 1536:].float(),
                               atol=tol, rtol=0)


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_does_not_take():
    dev = _card()
    q = torch.zeros((1, 8, 4, 64), device=dev)
    k = torch.zeros((1, 8, 2, 64), device=dev)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(TypeError):
        tfa.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            k, k)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q[..., :48], k[..., :48], k[..., :48])
    with pytest.raises(ValueError, match="q_offset"):
        tfa.flash_attention(q, k, k, q_offset=1)


# the routed-expert kernel's cases: (T, k, E, d, f, case) -- olmoe-1b-7b's
# and deepseek-v3-671b's decode widths (deepseek with 16 of its 256
# experts, so its 32 pairs share experts four tokens a group), one token,
# every token on the same experts, a group of more than the 8 tokens a
# pass, and widths that leave column tiles and shared-memory chunks
# partial
ROUTED_CASES = [(4, 8, 64, 2048, 1024, "random"),
                (4, 8, 16, 7168, 2048, "random"),
                (1, 8, 64, 2048, 1024, "random"),
                (4, 8, 64, 2048, 1024, "same"),
                (11, 2, 3, 600, 100, "random"),
                (3, 3, 5, 516, 36, "same")]


def _routed_case(t, k, e, d, f, case, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((t, d), generator=g, device=dev)
    if case == "same":
        idx = torch.randperm(e, generator=g, device=dev)[:k].repeat(t, 1)
    else:
        idx = torch.stack([torch.randperm(e, generator=g, device=dev)[:k]
                           for _ in range(t)])
    w = torch.rand((t, k), generator=g, device=dev)
    w = w / w.sum(dim=1, keepdim=True)
    mat = lambda fan, *shape: torch.randn(shape, generator=g, device=dev) \
        / fan ** 0.5
    return (x, idx.contiguous(), w, mat(d, e, d, f), mat(d, e, d, f),
            mat(f, e, f, d))


@pytest.mark.gpu
@pytest.mark.parametrize("t,k,e,d,f,case", ROUTED_CASES)
def test_routed_experts_kernel_matches_plain(t, k, e, d, f, case):
    """The routed-expert kernel against its plain version on the card,
    within 1e-5 of the largest output magnitude; a second call
    bit-identical; one launch counted a call."""
    dev = _card()
    args = _routed_case(t, k, e, d, f, case, dev)
    before = tre.routed_experts.launches
    y = tre.routed_experts(*args)
    again = tre.routed_experts(*args)
    torch.cuda.synchronize()
    assert tre.routed_experts.launches == before + 2
    assert torch.equal(y, again)
    ref = tre.routed_experts_plain(*args)
    scale = float(ref.abs().max())
    assert scale > 0 and float((y - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
def test_routed_experts_kernel_rejects_what_it_does_not_take():
    dev = _card()
    x, idx, w, wg, wu, wo = _routed_case(2, 2, 4, 64, 32, "random", dev)
    with pytest.raises(TypeError):
        tre.routed_experts(x.bfloat16(), idx, w, wg.bfloat16(),
                           wu.bfloat16(), wo.bfloat16())
    with pytest.raises(TypeError):
        tre.routed_experts(x, idx.int(), w, wg, wu, wo)
    with pytest.raises(ValueError, match="contiguous"):
        tre.routed_experts(x, idx.t().contiguous().t(), w, wg, wu, wo)
    with pytest.raises(ValueError, match="16-byte"):
        tre.routed_experts(x[:, :62].contiguous(), idx, w,
                           wg[:, :62].contiguous(), wu[:, :62].contiguous(),
                           wo[..., :62].contiguous())
    with pytest.raises(ValueError, match="shape"):
        tre.routed_experts(x, idx, w, wg, wu, wo[:, :16].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("nh,hd,b,s", [(4, 32, 3, 5), (4, 32, 4, 1),
                                       (4, 1024, 1, 3), (4, 1024, 4, 1),
                                       (4, 64, 2, 35), (4, 1024, 1, 17),
                                       (4, 1024, 1, 40)])
def test_mlstm_scan_kernel_matches_plain(nh, hd, b, s):
    """The mLSTM recurrence kernels against their plain version on the
    card, at reduced xlstm-1.3b's width (4 heads of 32, and 64) and its
    full one (4 of 1024), S = 1 (the strip kernel) and S > 1 (the
    chunkwise kernel, over chunk boundaries), in place over page rows of
    two tiers, one row with no source (a zero C) writing a sink.  S = 1:
    C (every byte of both tiers), n and m bit-equal, h within
    ``h_tolerance``, one kernel launch counted a call; S > 1: m bit-equal,
    each destination row's C, n and h within ``tolerances``, every other
    byte of both tiers bit-equal, two kernel launches counted a call (the
    pre-pass and the chunkwise kernel).  A second call from the same
    bytes bit-identical."""
    from repro_torch.kernels import mlstm_scan as tms
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(hd + s)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    q, k, v, i = r(b, s, nh, hd), r(b, s, nh, hd), r(b, s, nh, hd), \
        r(b, s, nh)
    f = torch.nn.functional.logsigmoid(r(b, s, nh) + 2.0)
    n, m = r(b, nh, hd).mul_(0.3), r(b, nh)
    cols = nh * hd * hd
    width = cols + 11
    hbm, host = r(b + 2, width).mul_(0.3), r(b + 3, width).mul_(0.3)
    src = torch.arange(b, device=dev)
    src[-1] = -1
    at_hbm = src.clone()
    at_hbm[-1] = b + 1
    at_host = torch.arange(b, device=dev).flip(0) + 2
    runs = []
    for _ in range(2):
        tiers = (hbm.clone(), host.clone())
        before = tms.mlstm_scan.launches
        out = tms.mlstm_scan(q, k, v, i, f, n, m, tiers[0], src,
                             [(tiers[0], at_hbm), (tiers[1], at_host)])
        torch.cuda.synchronize()
        assert tms.mlstm_scan.launches == before + (1 if s == 1 else 2)
        runs.append(out + tiers)
    plain = (hbm.clone(), host.clone())
    want = tms.mlstm_scan_plain(q, k, v, i, f, n, m, plain[0], src,
                                [(plain[0], at_hbm), (plain[1], at_host)])
    bits = lambda t: t.view(torch.int32)
    h, n_k, m_k, hbm_k, host_k = runs[0]
    assert torch.equal(bits(m_k), bits(want[2]))
    if s == 1:
        tol = tms.h_tolerance(q, k, v, i, f, n, m, hbm, src)
        for got, ref in ((n_k, want[1]), (hbm_k, plain[0]),
                         (host_k, plain[1])):
            assert torch.equal(bits(got), bits(ref))
    else:
        tol, tol_c, tol_n = tms.tolerances(q, k, v, i, f, n, m, hbm, src)
        assert bool(((n_k - want[1]).abs() <= tol_n).all())
        for got, ref, at in ((hbm_k, plain[0], at_hbm),
                             (host_k, plain[1], at_host)):
            assert bool(((got[at, :cols] - ref[at, :cols]).abs()
                         <= tol_c.reshape(b, cols)).all())
            rest = torch.ones(got.shape[0], dtype=torch.bool, device=dev)
            rest[at] = False
            assert torch.equal(bits(got[rest]), bits(ref[rest]))
            assert torch.equal(bits(got[:, cols:]), bits(ref[:, cols:]))
    assert bool(((h - want[0]).abs() <= tol).all())
    assert all(torch.equal(bits(x), bits(y)) for x, y in zip(*runs))
    assert torch.equal(hbm_k[b], hbm[b])      # a row no destination names


@pytest.mark.gpu
def test_mlstm_scan_kernel_rejects_what_it_does_not_take():
    from repro_torch.kernels import mlstm_scan as tms
    dev = _card()
    q = torch.zeros((1, 2, 4, 32), device=dev)
    g = torch.zeros((1, 2, 4), device=dev)
    n, m = torch.zeros((1, 4, 32), device=dev), torch.zeros((1, 4),
                                                             device=dev)
    buf = torch.zeros((2, 4 * 32 * 32), device=dev)
    rows = torch.zeros((1,), dtype=torch.int64, device=dev)
    ok = (q, q, q, g, g, n, m, buf, rows, [(buf, rows)])
    tms.mlstm_scan(*ok)
    with pytest.raises(TypeError):
        tms.mlstm_scan(*ok[:7], buf, rows.int(), [(buf, rows)])
    with pytest.raises(ValueError, match="contiguous"):
        tms.mlstm_scan(q.transpose(1, 2).contiguous().transpose(1, 2),
                       *ok[1:])
    with pytest.raises(ValueError, match="multiples of 32"):
        q2 = torch.zeros((1, 2, 4, 48), device=dev)
        tms.mlstm_scan(q2, q2, q2, g, g, torch.zeros((1, 4, 48), device=dev),
                       m, torch.zeros((2, 4 * 48 * 48), device=dev), rows,
                       [(torch.zeros((2, 4 * 48 * 48), device=dev), rows)])
    with pytest.raises(ValueError, match="2-D"):
        tms.mlstm_scan(*ok[:7], buf[:, :100], rows, [(buf, rows)])
    with pytest.raises(ValueError, match="one or two"):
        tms.mlstm_scan(*ok[:9], [(buf, rows)] * 3)


# ---------------------------------------------------------------------------
# the decode macro as a CUDA graph (``models.graphs``) against the eager
# route: reduced GQA, sliding-window, MLA + MoE, GQA + MoE and recurrent
# configs (the recurrent
# cells' conv taps drawn from N(0, 0.5): the reference's zero taps make
# every cell an identity), float32, two rows, four requests admitted in
# turn, two of them sampled
# ---------------------------------------------------------------------------

GRAPH_ARCHS = {"gqa": "qwen3-14b", "window": "gemma3-12b",
               "rglru": "recurrentgemma-2b", "xlstm": "xlstm-1.3b",
               "mla": "deepseek-v3-671b", "olmoe": "olmoe-1b-7b",
               "prefix": "paligemma-3b"}
_GRAPH_MODELS = {}


def _graph_model(kind):
    import dataclasses
    import repro_torch.configs as TC
    from repro_torch.models import model as TM
    if kind not in _GRAPH_MODELS:
        cfg = dataclasses.replace(TC.reduced(GRAPH_ARCHS[kind]),
                                  dtype="float32")
        params = TM.init(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(5)
        for seg in params.segments:
            for slot in seg:
                if slot.kind.is_recurrent:
                    slot.cell.conv.normal_(generator=g).mul_(0.5)
        _GRAPH_MODELS[kind] = (cfg, params)
    return _GRAPH_MODELS[kind]


def _graph_batcher(kind, eager, max_active=2, max_len=32, **opts):
    """(batcher, recorded merges, submit) of one route; the monitor feeds
    every merged mass into ``merges``; ``opts`` go to the batcher."""
    import numpy as np
    from repro_torch.core.cori import OnlineTuner
    from repro_torch.memtier.tiering import (SharedPagedPools, TierConfig,
                                             TieringManager)
    from repro_torch.serve import sched as TS
    cfg, params = _graph_model(kind)
    mon = TS.TrafficMonitor(
        SharedPagedPools.create(48, 10),
        TieringManager(48, TierConfig(page_size=4, hbm_pages=10,
                                      period_steps=2)),
        OnlineTuner(48, default_period=2, profile_steps=8, trial_steps=4))
    merges = []
    merge = mon.merge
    mon.merge = lambda c: merges.append(merge(c)) or merges[-1]
    ex = None
    if cfg.prefix_len:      # the shared prefix, drawn N(0, 1) from a seed
        ex = torch.randn((1, cfg.prefix_len, cfg.d_model), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(7))
    b = TS.ContinuousBatcher(params, cfg, monitor=mon, max_active=max_active,
                             max_len=max_len, page_size=4, eager=eager,
                             extra_embeds=ex, device="cuda", **opts)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 5, 11)]
    new, temps = (6, 4, 9, 7), (0.0, 0.8, 0.0, 0.8)

    def submit(i):
        b.submit(TS.Request(rid=i, prompt=prompts[i], max_new_tokens=new[i],
                            temperature=temps[i], seed=100 + i))
    return b, merges, submit


def _drive(batchers):
    """Step the (batcher, merges, submit) triples in turn, two requests
    up front and two joining mid-flight, until all drain; return each
    one's (streams, merges, tiering, tuner history, pools)."""
    for _, _, submit in batchers:
        submit(0)
        submit(1)
    t = 0
    while any(not b.idle for b, _, _ in batchers) or t < 4:
        for b, _, submit in batchers:
            if t in (1, 3):
                submit(2 if t == 1 else 3)
            b.step()
        t += 1
    torch.cuda.synchronize()
    out = []
    for b, merges, _ in batchers:
        mgr, pools = b.monitor.manager, b.monitor.pools
        out.append(dict(
            streams={r.rid: r.tokens for r in b.completed},
            merges=merges, tiering=(mgr.migrations, mgr.hits, mgr.misses),
            history=list(b.monitor.tuner.history),
            pools={k: [t.clone() for t in v if t is not None]
                   for k, v in pools.kv_layers.items()}))
    return out


def _same(a, b):
    assert a["streams"] == b["streams"]
    assert len(a["merges"]) == len(b["merges"])
    for x, y in zip(a["merges"], b["merges"]):
        assert (x == y).all()
    assert a["tiering"] == b["tiering"]
    assert a["history"] == b["history"]
    for k in a["pools"]:
        for x, y in zip(a["pools"][k], b["pools"][k]):
            assert torch.equal(x, y), k


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(GRAPH_ARCHS))
def test_graph_route_equals_eager_route(kind):
    """Greedy and sampled streams, every merged mass, the tiering counts,
    the tuner history and the pools' bytes are identical by both
    routes."""
    _card()
    graph, eager = _graph_batcher(kind, False), _graph_batcher(kind, True)
    assert graph[0].route == "graph" and eager[0].route == "eager"
    (g,), (e,) = _drive([graph]), _drive([eager])
    assert sorted(g["streams"]) == [0, 1, 2, 3]
    _same(g, e)


@pytest.mark.gpu
def test_two_graphs_captured_and_replayed_in_turn():
    """Two batchers of different shapes, captured one after the other and
    stepped in turn (their replays interleaved), each equal to its eager
    run: neither graph's scratch is another's."""
    _card()
    first = _graph_batcher("gqa", False)
    second = _graph_batcher("window", False, max_active=3, max_len=48)
    both = _drive([first, second])
    alone = [_drive([_graph_batcher("gqa", True)])[0],
             _drive([_graph_batcher("window", True, max_active=3,
                                    max_len=48)])[0]]
    for got, want in zip(both, alone):
        _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("eager", [False, True])
def test_launches_are_layers_times_device_steps(eager):
    """Under replay each graph launch counts the kernel launches captured
    in one step; the graph runs every step of a macro, the eager route
    only the live ones."""
    _card()
    b, _, submit = _graph_batcher("window", eager)
    cfg = b.cfg
    tpa.paged_attention.launches = 0
    _drive([(b, [], submit)])
    assert b.decode_steps > 0
    assert tpa.paged_attention.launches == cfg.num_layers * b.device_steps
    if eager:
        assert b.device_steps == b.decode_steps
    else:
        assert b.device_steps >= b.decode_steps


@pytest.mark.gpu
def test_graph_capture_and_replay_make_no_host_sync():
    """``DecodeGraph`` captures and replays under
    ``torch.cuda.set_sync_debug_mode("error")`` (which does raise on a
    read back), and its macro equals the eager ``decode_macro_step`` on
    the same pools."""
    from repro_torch.memtier.tiering import SharedPagedPools
    from repro_torch.models import graphs
    from repro_torch.models import model as TM
    dev = _card()
    cfg, params = _graph_model("window")
    tables = torch.tensor([[3, 7, 1, -1, -1], [0, 2, 5, 9, 11]],
                          dtype=torch.int32, device=dev)
    gids = torch.where(tables >= 0, tables + 5, -1).to(torch.int32)
    pools = []
    for _ in range(2):
        p = SharedPagedPools.create(20, 12)
        p.attach_layered(TM.slot_leaf_specs(cfg, 4), device=dev)
        g = torch.Generator(device=dev).manual_seed(1)
        for leaves in p.kv_with_sink.values():
            for t in leaves:
                if t is not None:
                    t.normal_(generator=g)
        pools.append(p)
    i64 = lambda *v: torch.tensor(v, dtype=torch.int64, device=dev)
    inputs = (i64([5], [9]), i64(9, 6), i64(1, 2), i64(0, 3), i64(1, 4),
              i64(20, 20), i64(-1, 7),
              torch.tensor([0.0, 0.8], device=dev))
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        with pytest.raises(RuntimeError):
            torch.zeros(1, device=dev).item()
        dg = graphs.DecodeGraph(params, cfg, pools[0].kv_with_sink, tables,
                                gids, max_steps=8, page_size=4)
        toks, st = dg.launch(*inputs, n_steps=6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref_toks, ref_st = TM.decode_macro_step(
        params, cfg, pools[1].kv_with_sink, tables, gids, *inputs,
        n_steps=6, page_size=4)
    assert torch.equal(toks, ref_toks)
    for k in ("mass_sum", "alive_steps", "pos", "iters", "emitted",
              "stopped", "last_tok"):
        assert torch.equal(st[k], ref_st[k]), k
    for k, leaves in pools[0].kv_with_sink.items():
        for a, b in zip(leaves, pools[1].kv_with_sink[k]):
            assert torch.equal(a[:, :-1], b[:, :-1]), k
    assert st["alive_steps"].tolist()[0] == 6


@pytest.mark.gpu
def test_recurrentgemma_launches_are_local_layers_times_device_steps():
    """recurrentgemma's paged kernel runs in its local layers only (one of
    the reduced config's five), once per replayed step."""
    from repro_torch.models import model as TM
    _card()
    b, _, submit = _graph_batcher("rglru", False)
    local = sum(r for _, _, r, w, _ in TM.state_slot_meta(b.cfg) if w > 0)
    tpa.paged_attention.launches = 0
    _drive([(b, [], submit)])
    assert b.decode_steps > 0 and local == 1
    assert tpa.paged_attention.launches == local * b.device_steps


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rglru", "xlstm"])
def test_recurrent_graph_capture_makes_no_host_sync(kind):
    """A recurrent config's ``DecodeGraph`` (state pages at a static
    ``state_cols`` column) captures and replays under
    ``torch.cuda.set_sync_debug_mode("error")``, and its macro equals the
    eager ``decode_macro_step`` on the same pools: tokens, carry and both
    tiers of every leaf."""
    from repro_torch.memtier.tiering import SharedPagedPools
    from repro_torch.models import graphs
    from repro_torch.models import model as TM
    dev = _card()
    cfg, params = _graph_model(kind)
    tables = torch.tensor([[3, 7, 1, -1, -1, 12], [0, 2, 5, 9, 11, 13]],
                          dtype=torch.int32, device=dev)
    gids = torch.where(tables >= 0, tables + 5, -1).to(torch.int32)
    state_cols = torch.full((2,), 5, dtype=torch.int64, device=dev)
    pools = []
    for _ in range(2):
        p = SharedPagedPools.create(20, 16)
        p.attach_layered(TM.slot_leaf_specs(cfg, 4), device=dev)
        g = torch.Generator(device=dev).manual_seed(1)
        for key, leaves in p.kv_with_sink.items():
            for t in leaves:
                if t is not None:
                    t.uniform_(0.5, 1.5, generator=g) \
                        if key.startswith("state") else t.normal_(generator=g)
        pools.append(p)
    i64 = lambda *v: torch.tensor(v, dtype=torch.int64, device=dev)
    inputs = (i64([5], [9]), i64(9, 6), i64(1, 2), i64(0, 3), i64(1, 4),
              i64(20, 20), i64(-1, 7),
              torch.tensor([0.0, 0.8], device=dev))
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        dg = graphs.DecodeGraph(params, cfg, pools[0].kv_with_sink, tables,
                                gids, max_steps=8, page_size=4,
                                state_cols=state_cols)
        toks, st = dg.launch(*inputs, n_steps=6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref_toks, ref_st = TM.decode_macro_step(
        params, cfg, pools[1].kv_with_sink, tables, gids, *inputs,
        n_steps=6, page_size=4, state_cols=state_cols)
    assert torch.equal(toks, ref_toks)
    for k in ("mass_sum", "alive_steps", "pos", "iters", "emitted",
              "stopped", "last_tok"):
        assert torch.equal(st[k], ref_st[k]), k
    for k, leaves in pools[0].kv_with_sink.items():
        for a, b in zip(leaves, pools[1].kv_with_sink[k]):
            if a is not None:
                assert torch.equal(a[:, :-1], b[:, :-1]), k
    assert float(st["mass_sum"][0, 5]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mla", "olmoe"])
def test_moe_graph_capture_makes_no_host_sync(kind):
    """A routed MoE config's ``DecodeGraph`` captures and replays under
    ``torch.cuda.set_sync_debug_mode("error")`` (its tokens are grouped by
    expert on the device), one routed-expert launch a MoE layer a step,
    and its macro equals the eager ``decode_macro_step`` on the same
    pools: tokens, carry and both tiers of every leaf."""
    from repro_torch.memtier.tiering import SharedPagedPools
    from repro_torch.models import graphs
    from repro_torch.models import model as TM
    dev = _card()
    cfg, params = _graph_model(kind)
    moe_layers = sum(r for _, _, r, _, k in TM.state_slot_meta(cfg)
                     if k.moe)
    tables = torch.tensor([[3, 7, 1, -1, -1], [0, 2, 5, 9, 11]],
                          dtype=torch.int32, device=dev)
    gids = torch.where(tables >= 0, tables + 5, -1).to(torch.int32)
    pools = []
    for _ in range(2):
        p = SharedPagedPools.create(20, 12)
        p.attach_layered(TM.slot_leaf_specs(cfg, 4), device=dev)
        g = torch.Generator(device=dev).manual_seed(1)
        for leaves in p.kv_with_sink.values():
            for t in leaves:
                if t is not None:
                    t.normal_(generator=g)
        pools.append(p)
    i64 = lambda *v: torch.tensor(v, dtype=torch.int64, device=dev)
    inputs = (i64([5], [9]), i64(9, 6), i64(1, 2), i64(0, 3), i64(1, 4),
              i64(20, 20), i64(-1, 7),
              torch.tensor([0.0, 0.8], device=dev))
    torch.cuda.synchronize()
    before = tre.routed_experts.launches
    try:
        torch.cuda.set_sync_debug_mode("error")
        dg = graphs.DecodeGraph(params, cfg, pools[0].kv_with_sink, tables,
                                gids, max_steps=8, page_size=4)
        toks, st = dg.launch(*inputs, n_steps=6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the warm-up's eager call, then 6 replays of the captured step
    assert moe_layers >= 1
    assert tre.routed_experts.launches - before == moe_layers * 7
    ref_toks, ref_st = TM.decode_macro_step(
        params, cfg, pools[1].kv_with_sink, tables, gids, *inputs,
        n_steps=6, page_size=4)
    assert torch.equal(toks, ref_toks)
    for k in ("mass_sum", "alive_steps", "pos", "iters", "emitted",
              "stopped", "last_tok"):
        assert torch.equal(st[k], ref_st[k]), k
    for k, leaves in pools[0].kv_with_sink.items():
        for a, b in zip(leaves, pools[1].kv_with_sink[k]):
            if a is not None:
                assert torch.equal(a[:, :-1], b[:, :-1]), k


# ---------------------------------------------------------------------------
# ``paged_context``: kernel 1 over the pools' legacy single-layer pair (the
# dense batcher's mirror) and over the layered monitor leaf (paged)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gqa", "prefix"])
@pytest.mark.parametrize("paged", [False, True])
def test_paged_context_launches_kernel(kind, paged):
    """Reduced qwen3-14b and paligemma-3b, float32, the dense batcher with
    ``mirror_pages`` over physical pools and the fully-paged batcher:
    every ``paged_context`` probe of an in-flight request launches the
    paged kernel once and is within 1e-5 of the plain version over the
    host pages through the request's logical ids; the dense streams equal
    the graph route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python -m pytest -m gpu)")
    import numpy as np
    from repro_torch.core.cori import OnlineTuner
    from repro_torch.memtier.tiering import (SharedPagedPools, TierConfig,
                                             TieringManager)
    from repro_torch.models import model as TM
    from repro_torch.serve import sched as TS
    cfg, params = _graph_model(kind)
    mon = TS.TrafficMonitor(
        SharedPagedPools.create(48, 10, page_size=4,
                                kv_heads=cfg.num_kv_heads,
                                head_dim=cfg.head_dim, device="cuda"),
        TieringManager(48, TierConfig(page_size=4, hbm_pages=10,
                                      period_steps=2)),
        OnlineTuner(48, default_period=2, profile_steps=8, trial_steps=4))
    ex = None
    if cfg.prefix_len:
        ex = torch.randn((1, cfg.prefix_len, cfg.d_model), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(7))
    b = TS.ContinuousBatcher(params, cfg, monitor=mon, max_active=2,
                             max_len=32, page_size=4, paged=paged,
                             mirror_pages=True, extra_embeds=ex,
                             device="cuda")
    assert b.mirror_pages != paged and b.route == ("graph" if paged
                                                   else "eager")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 5, 11)]
    new, temps = (6, 4, 9, 7), (0.0, 0.8, 0.0, 0.8)
    for i in range(4):
        b.submit(TS.Request(rid=i, prompt=prompts[i], max_new_tokens=new[i],
                            temperature=temps[i], seed=100 + i))
    g = torch.Generator(device="cuda").manual_seed(3)
    probes = 0
    while not b.idle:
        b.step()
        for req in list(b.active.values()):
            q = torch.randn((1, cfg.num_heads, cfg.head_dim), device="cuda",
                            generator=g)
            before = tpa.paged_attention.launches
            out, _ = b.paged_context(req.rid, q)
            torch.cuda.synchronize()
            assert tpa.paged_attention.launches == before + 1
            probes += 1
            length = int(b.pos[req.row])
            n = -(-length // 4)
            if paged:
                li = TM.attn_slot_index(cfg, b._si, b._sj)
                k, v = (mon.pools.kv_layers[f"{x}_host"][li][-1]
                        for x in ("k", "v"))
                gids = req.table_gids[:n]
            else:
                k, v, gids = mon.pools.k_host, mon.pools.v_host, req.gids[:n]
            ref, _ = tpa.paged_attention_plain(
                q, k, v, torch.as_tensor(np.asarray(gids, np.int32)[None],
                                         device="cuda"),
                torch.tensor([length], dtype=torch.int32, device="cuda"))
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert probes > 0
    streams = {r.rid: r.tokens for r in b.completed}
    graph, _, submit = _graph_batcher(kind, eager=False)
    _drive([(graph, [], submit)])
    assert streams == {r.rid: r.tokens for r in graph.completed}


# ---------------------------------------------------------------------------
# the pipelined loop on the card: reduced GQA and sliding-window configs
# (the latter with its prefill on the flash route, in chunks of 4
# positions), the graph route, against the synchronous loop
# ---------------------------------------------------------------------------


def _pipelined_batcher(kind, *, pipeline, chunk=None, impl="reference",
                       fault_plan=None):
    import dataclasses
    import numpy as np
    from repro_torch.core.cori import OnlineTuner
    from repro_torch.memtier.tiering import (SharedPagedPools, TierConfig,
                                             TieringManager)
    from repro_torch.serve import sched as TS
    cfg, params = _graph_model(kind)
    cfg = dataclasses.replace(cfg, attention_impl=impl)
    mon = TS.TrafficMonitor(
        SharedPagedPools.create(48, 16),
        TieringManager(48, TierConfig(page_size=4, hbm_pages=16,
                                      period_steps=2)),
        OnlineTuner(48, default_period=2, profile_steps=8, trial_steps=4))
    b = TS.ContinuousBatcher(params, cfg, monitor=mon, max_active=2,
                             max_len=32, page_size=4, pipeline=pipeline,
                             admit_chunk_tokens=chunk, fault_plan=fault_plan,
                             device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 5, 14)]
    new, temps = (6, 4, 7, 5), (0.0, 0.7, 0.7, 0.0)

    def submit(i):
        b.submit(TS.Request(rid=i, prompt=prompts[i], max_new_tokens=new[i],
                            temperature=temps[i], seed=100 + i))
    return b, submit


def _run_pipelined(b, submit):
    submit(0)
    submit(1)
    t = 0
    while not b.idle or t < 3:
        if t == 2:
            submit(2)
            submit(3)
        b.step()
        t += 1
    b.close()
    torch.cuda.synchronize()
    assert b.monitor.pools.free_pages == 48
    return {r.rid: r.tokens for r in b.completed}


@pytest.mark.gpu
@pytest.mark.parametrize("kind,chunk,impl", [
    ("gqa", None, "reference"), ("gqa", 4, "reference"),
    ("window", None, "pallas"), ("window", 4, "pallas")])
def test_pipelined_batcher_equals_synchronous(kind, chunk, impl):
    """The pipelined loop (graph route; with ``chunk`` each prompt in
    chunks of 4 positions, on the flash route one kernel launch a layer a
    chunk) emits the synchronous graph route's streams, greedy and
    sampled, returns every page, and launches the paged kernel layers x
    device steps."""
    _card()
    sync, s_submit = _pipelined_batcher(kind, pipeline=False, impl=impl)
    want = _run_pipelined(sync, s_submit)
    b, submit = _pipelined_batcher(kind, pipeline=True, chunk=chunk,
                                   impl=impl)
    assert b.route == "graph"
    tpa.paged_attention.launches = 0
    tfa.flash_attention.launches = 0
    got = _run_pipelined(b, submit)
    assert sorted(got) == [0, 1, 2, 3]
    assert got == want
    assert tpa.paged_attention.launches == b.cfg.num_layers * b.device_steps
    if impl == "pallas" and chunk:
        chunks = sum(-(-n // 4) for n in (6, 9, 5, 14))
        assert tfa.flash_attention.launches == b.cfg.num_layers * chunks


@pytest.mark.gpu
@pytest.mark.parametrize("kind,chunk,impl", [
    ("gqa", None, "reference"), ("window", 4, "pallas")])
def test_pipelined_step_waits_only_for_the_macro_read_back(kind, chunk,
                                                          impl):
    """After a warm-up, pipelined steps run under
    ``torch.cuda.set_sync_debug_mode("error")``: no read back and no
    blocking copy anywhere in a step -- packed or chunked admission,
    flash route included -- but for the completion's one event wait on
    the macro's pinned copies."""
    from repro_torch.serve import sched as TS
    _card()
    b, submit = _pipelined_batcher(kind, pipeline=True, chunk=chunk,
                                   impl=impl)
    submit(0)
    submit(1)
    b.step()
    b.step()
    submit(2)
    submit(3)
    waits = []
    real = TS._wait_back

    def wait(host, done):
        waits.append(done is not None)
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(host, done)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    TS._wait_back = wait
    try:
        torch.cuda.set_sync_debug_mode("error")
        while not b.idle:
            b.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        TS._wait_back = real
        b.close()
    assert waits and all(waits)
    assert sorted(r.rid for r in b.completed) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the degradation ladder on the card: a capacity squeeze preempts and thaws
# rows of the graph route (reduced qwen3-14b, float32, the requests above:
# 3-5 pages each, two rows; a squeeze to 4 of the 16 HBM pages from step 2
# to step 6 holds one row)
# ---------------------------------------------------------------------------


def _squeeze():
    from repro_torch.ft.inject import FaultPlan, FaultPoint
    return FaultPlan([FaultPoint("pool.squeeze", start=2, stop=6, value=4)])


@pytest.mark.gpu
@pytest.mark.parametrize("pipeline", [False, True])
def test_squeezed_graph_route_streams_equal_unsqueezed(pipeline):
    """Under the squeeze a row is preempted (its pages demoted) and thawed
    later, on the synchronous and the pipelined graph route; the streams,
    greedy and sampled, are the unsqueezed run's and no admission runs
    twice."""
    _card()
    free, f_submit = _pipelined_batcher("gqa", pipeline=pipeline)
    want = _run_pipelined(free, f_submit)
    b, submit = _pipelined_batcher("gqa", pipeline=pipeline,
                                   fault_plan=_squeeze())
    assert b.route == "graph"
    tpa.paged_attention.launches = 0
    got = _run_pipelined(b, submit)
    assert b.preemptions >= 1 and not b._frozen
    assert got == want
    assert tpa.paged_attention.launches == b.cfg.num_layers * b.device_steps


@pytest.mark.gpu
def test_rebalance_reads_nothing_back():
    """Every ``_rebalance`` of a squeezed pipelined run -- a preemption
    and a thaw among them -- runs under
    ``torch.cuda.set_sync_debug_mode("error")``: the frozen row's next
    input is ``tokens[-1]`` (held equal to ``tok[row, 0]``, read outside
    the guard) and the thaw writes it on the device."""
    _card()
    b, submit = _pipelined_batcher("gqa", pipeline=True,
                                   fault_plan=_squeeze())
    calls = {"preempt": 0, "thaw": 0}
    rebalance, preempt, thaw = b._rebalance, b._preempt, b._thaw

    def guarded():
        torch.cuda.set_sync_debug_mode("error")
        try:
            rebalance()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def checked_preempt(req):
        torch.cuda.set_sync_debug_mode("default")
        try:
            assert req.tokens[-1] == int(b.tok[req.row, 0])
        finally:
            torch.cuda.set_sync_debug_mode("error")
        calls["preempt"] += 1
        preempt(req)

    def counted_thaw(req):
        calls["thaw"] += 1
        thaw(req)

    b._rebalance, b._preempt, b._thaw = guarded, checked_preempt, \
        counted_thaw
    got = _run_pipelined(b, submit)
    assert sorted(got) == [0, 1, 2, 3]
    assert calls["preempt"] >= 1 and calls["thaw"] == calls["preempt"]


# ---------------------------------------------------------------------------
# training on the card: the train step against the CPU's, and checkpoints
# across devices.  Bars as chip_smoke.py's phase 39: loss 1e-5 and
# gradient norm 1e-4 relative (float32 sums in other orders, TF32 off; the
# token table's gradient summed in bfloat16 in another order), every
# parameter within 0.1 of a step of the CPU's and at most 0.1% of them
# beyond 1e-3 of a step (AdamW's first step is about sign(g)); int8 codes:
# m's within one and 99.9% equal, v's 99.5% equal.
# ---------------------------------------------------------------------------

TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)


def _card_and_cpu_states(name, dtype):
    import repro_torch.configs as TC
    from repro_torch.models import model as TM
    from repro_torch.train import optim as TO
    from repro_torch.train import step as TS
    dev = torch.device("cuda")
    cfg = TC.reduced(name)
    ocfg = TO.OptConfig(**TRAIN_OPT, state_dtype=dtype)
    cpu = TS.init_state(cfg, ocfg, seed=0, device="cpu")
    params = TM.Transformer(cfg, dev)
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(cpu["params"].get_parameter(n))
    TS.trainable(params)
    card = {"params": params, "opt": TO.init(params, ocfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
    return cfg, ocfg, cpu, card


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype", [("qwen3-14b", "float32"),
                                        ("deepseek-v3-671b", "float32"),
                                        ("olmoe-1b-7b", "int8"),
                                        ("xlstm-1.3b", "float32"),
                                        ("recurrentgemma-2b", "float32")])
def test_train_step_on_card_matches_cpu(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python -m pytest -m gpu)")
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.train import step as TS
    cfg, ocfg, cpu, card = _card_and_cpu_states(name, dtype)
    batch = batch_at(DataConfig(seed=0, global_batch=4, seq_len=16), cfg, 0)
    step = TS.make_train_step(cfg, ocfg)
    cpu, mc = step(cpu, batch)
    card, mg = step(card, batch)
    assert card["params"].tok.is_cuda
    lr = float(mc["lr"])
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= \
        1e-5 * abs(float(mc["loss"]))
    assert abs(float(mg["grad_norm"]) - float(mc["grad_norm"])) <= \
        1e-4 * float(mc["grad_norm"])
    far, total = 0, 0
    for n, p in card["params"].named_parameters():
        d = (p.detach().cpu() - cpu["params"].get_parameter(n).detach()).abs()
        assert float(d.max()) <= 0.1 * lr, n
        far += int((d > 1e-3 * lr).sum())
        total += d.numel()
        if dtype == "int8":
            for key, share in (("m", 0.999), ("v", 0.995)):
                a = card["opt"][key][n].q.cpu().int()
                b = cpu["opt"][key][n].q.int()
                assert int((a == b).sum()) >= share * a.numel() - 1, (n, key)
                if key == "m":
                    assert int((a - b).abs().max()) <= 1, n
    assert far <= 1e-3 * total


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_checkpoint_saved_on_card_restores_on_cpu(tmp_path, dtype):
    """A state stepped on the card, saved, and restored into a CPU
    template: every leaf bit-equal to the card's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python -m pytest -m gpu)")
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.train import step as TS
    cfg, ocfg, cpu, card = _card_and_cpu_states("stablelm-12b", dtype)
    batch = batch_at(DataConfig(seed=0, global_batch=2, seq_len=8), cfg, 0)
    card, _ = TS.make_train_step(cfg, ocfg)(card, batch)
    ckpt.save(tmp_path, 1, card)
    restored = ckpt.restore(tmp_path, 1, cpu)
    for a, b in zip(ckpt._leaves(card), ckpt._leaves(restored)):
        assert b.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a.detach().cpu(), b.detach())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_batcher_macro_steps_on_the_card(kind):
    """``macro_steps=4`` on the graph route: the streams equal the
    default's, the paged kernel (MLA's for "mla") launches on every
    decode step, and no macro (the flight recorder's ``serve.macro``
    events) is longer than 4 steps, most of them 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python -m pytest -m gpu)")
    from repro_torch.obs import telemetry as T_obs
    wrapper = tpam.paged_attention_mla if kind == "mla" \
        else tpa.paged_attention
    want = _drive([_graph_batcher(kind, False)])[0]
    prev = T_obs.RECORDER
    rec = T_obs.install(T_obs.Recorder(enabled=True))
    try:
        before = wrapper.launches
        b = _graph_batcher(kind, False, macro_steps=4)
        got = _drive([b])[0]
        launched = wrapper.launches - before
    finally:
        T_obs.install(prev)
    assert got["streams"] == want["streams"]
    assert launched >= b[0].device_steps > 0
    lens = [e["n_steps"] for e in rec.events("serve.macro")]
    assert max(lens) == 4 and all(n == 4 for n in lens[:-2]), lens


@pytest.mark.gpu
def test_mesh_step_on_a_one_rank_nccl_mesh():
    """The mesh step on a (1, 1) NCCL mesh equals the single-device step
    on the card (reduced qwen3-14b): loss within 1e-6 relative,
    parameters within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run: python -m pytest -m gpu)")
    import socket

    import torch.distributed as dist

    import repro_torch.configs as TC
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    from repro_torch.train import optim as TO
    from repro_torch.train import step as TS
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        cfg, ocfg = TC.reduced("qwen3-14b"), TO.OptConfig(lr=1e-3)
        batch = batch_at(DataConfig(seed=0, global_batch=4, seq_len=32),
                         cfg, 0)
        mesh = make_host_mesh(1, 1)
        st = TS.init_state(cfg, ocfg, device="cuda", mesh=mesh)
        st, m = TS.make_train_step(cfg, ocfg, mesh, param_specs=TM.param_specs(
            st["params"]))(st, batch)
        whole = TS.gather_state(st)["params"]
        one, m1 = TS.make_train_step(cfg, ocfg)(
            TS.init_state(cfg, ocfg, device="cuda"), batch)
        torch.testing.assert_close(m["loss"].cpu(), m1["loss"].cpu(),
                                   rtol=1e-6, atol=0)
        for n, p in one["params"].named_parameters():
            torch.testing.assert_close(whole[n], p.detach(), rtol=0,
                                       atol=1e-6)
    finally:
        dist.destroy_process_group()


def _slstm_inputs(dev, b, s, nh, hd, seed):
    """Seeded wx ~ N(0, 1), r_gates ~ N(0, 1/nh) and the state the plain
    version reaches from the zero state over 5 positions."""
    from repro_torch.kernels import slstm_scan as tsl
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    wx, rg = r(b, s, nh, 4 * hd), r(nh, hd, 4 * hd).mul_(nh ** -0.5)
    full = lambda v: torch.full((b, nh, hd), v, device=dev)
    st = tsl.slstm_scan_plain(r(b, 5, nh, 4 * hd), rg, full(0.0),
                              full(1e-6), full(-1e30), full(0.0))[1:]
    return wx, rg, st


@pytest.mark.gpu
@pytest.mark.parametrize("nh,hd,b,s", [(4, 16, 3, 1), (4, 16, 2, 9),
                                       (4, 64, 1, 5), (4, 512, 2, 3),
                                       (2, 128, 9, 4)])
def test_slstm_scan_kernel_matches_plain(nh, hd, b, s):
    """The sLSTM kernel on the card: each position from the plain
    version's state, run as one launch of B S one-position rows, within
    the one-step bound (``tolerance``) of the plain cell; the sequence
    launch bit-identical to one-position launches chained on its own
    state and to a second call; one launch counted a call."""
    from repro_torch.kernels import slstm_scan as tsl
    dev = _card()
    wx, r, st = _slstm_inputs(dev, b, s, nh, hd, seed=hd + s)
    before = tsl.slstm_scan.launches
    runs = [tsl.slstm_scan(wx, r, *st) for _ in range(2)]
    torch.cuda.synchronize()
    assert tsl.slstm_scan.launches == before + 2
    bits = lambda t: t.view(torch.int32)
    assert all(torch.equal(bits(x), bits(y)) for x, y in zip(*runs))
    hs, k_st, starts = [], st, []
    p_st = st
    for t in range(s):
        out = tsl.slstm_scan(wx[:, t:t + 1].contiguous(), r, *k_st)
        hs.append(out[0])
        k_st = out[1:]
        starts.append(p_st)
        p_st = tsl.slstm_scan_plain(wx[:, t:t + 1], r, *p_st)[1:]
    assert torch.equal(bits(torch.cat(hs, dim=1)), bits(runs[0][0]))
    assert all(torch.equal(bits(x), bits(y))
               for x, y in zip(k_st, runs[0][1:]))
    rows = tuple(torch.cat([x[i] for x in starts]) for i in range(4))
    wx_rows = wx.transpose(0, 1).reshape(s * b, 1, nh, 4 * hd)
    got = tsl.slstm_scan(wx_rows, r, *rows)
    want = tsl.slstm_scan_plain(wx_rows, r, *rows)
    tol_h, tol_st = tsl.tolerance(wx_rows, r, *rows)
    assert bool(((got[0] - want[0]).abs() <= tol_h).all())
    for i, k in ((1, "c"), (2, "n"), (3, "m")):
        assert bool(((got[i] - want[i]).abs() <= tol_st[k]).all())


@pytest.mark.gpu
def test_slstm_scan_kernel_rejects_what_it_does_not_take():
    from repro_torch.kernels import slstm_scan as tsl
    dev = _card()
    wx, r, st = _slstm_inputs(dev, 2, 3, 4, 16, seed=0)
    tsl.slstm_scan(wx, r, *st)
    with pytest.raises(TypeError):
        tsl.slstm_scan(wx.double(), r, *st)
    with pytest.raises(ValueError, match="contiguous"):
        tsl.slstm_scan(wx.transpose(0, 1).contiguous().transpose(0, 1), r,
                       *st)
    with pytest.raises(ValueError, match="multiples of 16"):
        wx2, r2, st2 = _slstm_inputs(dev, 1, 2, 4, 24, seed=0)
        tsl.slstm_scan(wx2, r2, *st2)
    with pytest.raises(ValueError, match="16-byte"):
        r_off = torch.empty(r.numel() + 1, device=dev)[1:].view_as(r)
        r_off.copy_(r)
        tsl.slstm_scan(wx, r_off, *st)
    with pytest.raises(ValueError, match="shape"):
        tsl.slstm_scan(wx[..., :-16].contiguous(), r, *st)


def _rglru_inputs(dev, b, s, w, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    u = torch.rand((w,), generator=g, device=dev) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / 8.0))
    return r(b, s, w), r(b, s, w), r(b, s, w), lam, r(b, w)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,w", [(4, 1, 64), (1, 64, 130), (2, 65, 64),
                                   (1, 1000, 2560), (3, 129, 256),
                                   (2, 200, 130)])
def test_rglru_scan_kernel_matches_plain(b, s, w):
    """The RG-LRU kernel on the card within ``h_tolerance`` of its plain
    version, one launch counted a call, a second call bit-identical."""
    from repro_torch.kernels import rglru_scan as trg
    dev = _card()
    args = _rglru_inputs(dev, b, s, w, seed=s + w)
    before = trg.rglru_scan.launches
    runs = [trg.rglru_scan(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert trg.rglru_scan.launches == before + 2
    assert torch.equal(runs[0].view(torch.int32), runs[1].view(torch.int32))
    want = trg.rglru_scan_plain(*args)
    assert bool(((runs[0] - want).abs() <= trg.h_tolerance(*args)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,w,carried", [(4, 256, 2560, False),
                                           (4, 256, 2560, True),
                                           (2, 5, 64, True),
                                           (1, 64, 2560, True),
                                           (3, 130, 100, True),
                                           (2, 200, 130, False),
                                           (1, 1000, 256, True)])
def test_rglru_backward_kernel_matches_plain(b, s, w, carried):
    """The RG-LRU backward kernel on the card within ``grad_check``'s bar
    (from the forward kernel's h), one launch counted a call, a second
    call bit-identical; among the cases phase 50's shape, S <= 64 (the
    short kernel), ragged S and w (the scalar loads)."""
    from repro_torch.kernels import rglru_scan as trg
    dev = _card()
    args = list(_rglru_inputs(dev, b, s, w, seed=s + w + carried))
    if not carried:
        args[4].zero_()
    dh = torch.randn((b, s, w), generator=torch.Generator(
        device=dev).manual_seed(s), device=dev)
    h = trg.rglru_scan(*args)
    before = trg.rglru_scan_backward.launches
    runs = [trg.rglru_scan_backward(*args, h, dh) for _ in range(2)]
    torch.cuda.synchronize()
    assert trg.rglru_scan_backward.launches == before + 2
    bits = lambda t: t.view(torch.int32)
    assert all(torch.equal(bits(x), bits(y)) for x, y in zip(*runs))
    for name, (dist, bar) in trg.grad_check(runs[0], *args, dh).items():
        assert dist <= bar, (name, dist, bar)


@pytest.mark.gpu
def test_rglru_backward_holds_its_tiles_an_sm():
    """The card holds as many tiles of the S > 64 backward an SM as the
    kernel is built for (both forms), so phase 50's 640 tiles run in one
    wave."""
    from repro_torch.kernels import rglru_scan as trg
    _card()
    plan = trg.backward_plan(4, 256, 2560)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for vec in (True, False):
        assert trg.backward_blocks_per_sm(vec) >= plan["per_sm"] >= 5
    assert plan["blocks"] <= plan["per_sm"] * sms


@pytest.mark.gpu
def test_rglru_scan_kernel_rejects_what_it_does_not_take():
    from repro_torch.kernels import rglru_scan as trg
    dev = _card()
    ra, ia, xc, lam, h0 = _rglru_inputs(dev, 2, 3, 16, seed=0)
    trg.rglru_scan(ra, ia, xc, lam, h0)
    with pytest.raises(TypeError):
        trg.rglru_scan(ra, ia, xc.double(), lam, h0)
    with pytest.raises(ValueError, match="shape"):
        trg.rglru_scan(ra, ia, xc, lam[:8], h0)
    with pytest.raises(ValueError, match="contiguous"):
        trg.rglru_scan(ra.transpose(0, 1).contiguous().transpose(0, 1), ia,
                       xc, lam, h0)


# ---------------------------------------------------------------------------
# the recurrences' backward kernels
# ---------------------------------------------------------------------------


def _mlstm_grad_inputs(dev, b, s, nh, hd, scale, carried, seed):
    """Seeded q, k ~ N(0, scale^2), v, i ~ N(0, 1), log f =
    logsigmoid(N(2, 1)), the zero or a carried state, dh ~ N(0, 1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    q, k = r(b, s, nh, hd).mul_(scale), r(b, s, nh, hd).mul_(scale)
    v, i = r(b, s, nh, hd), r(b, s, nh)
    f = torch.nn.functional.logsigmoid(r(b, s, nh) + 2.0)
    if carried:
        st = (r(b, nh, hd, hd).mul_(0.3), r(b, nh, hd).mul_(0.3), r(b, nh))
    else:
        st = (torch.zeros((b, nh, hd, hd), device=dev),
              torch.zeros((b, nh, hd), device=dev),
              torch.full((b, nh), -1e30, device=dev))
    return (q, k, v, i, f) + st, r(b, s, nh, hd)


def _mlstm_kernel_grads(tms, args, dh, calls=1, ends=None):
    """The chunkwise forward with its saves, then ``calls`` calls of the
    backward kernel: (their gradients, the saves).  ``ends``: the final
    state's gradients (dC, dn, dm), or None."""
    b, _, nh, hd = args[0].shape
    saves = tms._saves(args[0])
    rows = torch.arange(b, device=args[0].device)
    out = torch.empty((b, nh * hd * hd), device=args[0].device)
    h, n1, _ = tms._launch(*args[:5], args[6], args[7],
                           args[5].reshape(b, -1).contiguous(), rows,
                           [(out, rows)], chunked=True, save=saves)
    extra = () if ends is None else (*ends, out.view(b, nh, hd, hd), n1)
    return [tms.mlstm_scan_backward(*args[:5], args[7], h, dh, saves,
                                    *extra)
            for _ in range(calls)], saves


def _mlstm_plain_grads(tms, args, dh, dt, ends=None):
    x = [t.to(dt) for t in args]
    C, n, _, h, saves = tms.mlstm_save_plain(*x)
    extra = () if ends is None else (*(e.to(dt) for e in ends), C, n)
    return tms.mlstm_backward_plain(*x[:5], x[7], h, dh.to(dt), saves,
                                    *extra)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,hd,scale,carried", [
    (4, 16, 32, 1.0, False), (4, 16, 32, 1.0, True), (2, 37, 64, 0.1, True),
    (1, 50, 256, 1.0, False), (2, 33, 1024, 1.0, True),
    (2, 17, 96, 1.0, True), (3, 1, 128, 1.0, True), (1, 17, 1024, 1.0, False)])
def test_mlstm_backward_kernel_matches_plain(b, s, hd, scale, carried):
    """The mLSTM backward kernel on the card: each gradient within
    ``grad_check``'s bar of the float64 plain backward (``GRAD_MULT``
    times the float32 plain backward's own distance), four launches
    counted a call, a second call bit-identical.  The layout's edges: hd
    = 96 (12 k-steps of 8 rows: warps 6 and 7 own none in the dv pass,
    the last dq / dk tile is 32 columns), S = 1, and S = 17 (a last
    chunk of one position, the first the dv pass takes)."""
    from repro_torch.kernels import mlstm_scan as tms
    dev = _card()
    args, dh = _mlstm_grad_inputs(dev, b, s, 4, hd, scale, carried,
                                  seed=s + hd)
    before = tms.mlstm_scan_backward.launches
    (got, again), _ = _mlstm_kernel_grads(tms, args, dh, calls=2)
    torch.cuda.synchronize()
    assert tms.mlstm_scan_backward.launches == before + 8
    bits = lambda t: t.view(torch.int32)
    assert all(torch.equal(bits(x), bits(y)) for x, y in zip(got, again))
    chk = tms.grad_check(got, _mlstm_plain_grads(tms, args, dh,
                                                 torch.float32),
                         _mlstm_plain_grads(tms, args, dh, torch.float64))
    for name, (dist, bar) in chk.items():
        assert dist <= bar, (name, dist, bar)


@pytest.mark.gpu
def test_mlstm_backward_kernel_with_final_state_gradients():
    """The backward kernel given the final state's gradients (dC, dn, dm):
    each gradient within ``grad_check``'s bar of the float64 plain
    backward given the same."""
    from repro_torch.kernels import mlstm_scan as tms
    dev = _card()
    args, dh = _mlstm_grad_inputs(dev, 2, 37, 4, 64, 1.0, True, seed=77)
    b, _, nh, hd = args[0].shape
    g = torch.Generator(device=dev).manual_seed(78)
    ends = tuple(torch.randn(shape, generator=g, device=dev) for shape in
                 ((b, nh, hd, hd), (b, nh, hd), (b, nh)))
    (got,), _ = _mlstm_kernel_grads(tms, args, dh, ends=ends)
    chk = tms.grad_check(got, _mlstm_plain_grads(tms, args, dh,
                                                 torch.float32, ends),
                         _mlstm_plain_grads(tms, args, dh, torch.float64,
                                            ends))
    for name, (dist, bar) in chk.items():
        assert dist <= bar, (name, dist, bar)


def _drop_m_chain(i, fm, a, K, Q, e_end, dm_end):
    """``mlstm_scan._gate_grads`` without the m chain: each gate keeps its
    own share and none of the stabiliser's."""
    dd = torch.float64
    da = torch.zeros(i.shape[0], i.shape[2], dtype=dd, device=i.device)
    cut = torch.exp(a) == 0
    di, df = [], []
    for t in range(i.shape[1] - 1, -1, -1):
        da = torch.where(cut[:, t], torch.zeros_like(da),
                         Q[:, t].to(dd) - K[:, t].to(dd) + da)
        di.append(K[:, t].to(dd))
        df.append(da)
    return (torch.stack(di[::-1], 1).to(i.dtype),
            torch.stack(df[::-1], 1).to(i.dtype))


@pytest.mark.gpu
def test_mlstm_backward_without_the_m_chain_misses_the_bar(monkeypatch):
    """Where the clamp max(|n . q|, 1) binds (q and k small), the kernel's
    gate gradients are within the bar and a backward that drops the m
    chain (the plain one, mutated, on the card) is not."""
    from repro_torch.kernels import mlstm_scan as tms
    dev = _card()
    args, dh = _mlstm_grad_inputs(dev, 2, 40, 4, 64, 0.1, False, seed=5)
    (got,), saves = _mlstm_kernel_grads(tms, args, dh)
    assert bool((saves[2].abs() < 1).all())
    p32 = _mlstm_plain_grads(tms, args, dh, torch.float32)
    p64 = _mlstm_plain_grads(tms, args, dh, torch.float64)
    chk = tms.grad_check(got, p32, p64)
    assert all(d <= bar for d, bar in chk.values()), chk
    monkeypatch.setattr(tms, "_gate_grads", _drop_m_chain)
    bad = tms.grad_check(_mlstm_plain_grads(tms, args, dh, torch.float32),
                         p32, p64)
    assert bad["di"][0] > bad["di"][1] and bad["df"][0] > bad["df"][1]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,nh,hd,fan_in", [(4, 16, 4, 16, "nh"),
                                              (3, 20, 4, 64, "nh"),
                                              (2, 64, 4, 512, "hd"),
                                              (9, 5, 2, 128, "hd"),
                                              (4, 256, 4, 512, "hd"),
                                              (9, 5, 4, 512, "hd"),
                                              (3, 33, 1, 16, "hd")])
def test_slstm_backward_kernel_matches_plain(b, s, nh, hd, fan_in):
    """The sLSTM backward kernel on the card over a sequence short enough
    (or r_gates at fan-in hd) for float32 to follow float64: dwx and dr
    within ``grad_check``'s bar, one launch counted a call, a second call
    bit-identical.  Among the cases phase 48's shape; nine rows at full
    width (two row passes through one ring); one block of hd = 16, whose
    units' recurrent gradient is a single partial."""
    from repro_torch.kernels import slstm_scan as tsl
    dev = _card()
    wx, r, st = _slstm_inputs(dev, b, s, nh, hd, seed=hd + s)
    if fan_in == "hd":
        r.mul_((nh / hd) ** 0.5)
    dh = torch.randn((b, s, nh, hd), generator=torch.Generator(
        device=dev).manual_seed(s), device=dev)
    saves = tsl._saves(wx)
    hs = tsl._launch(wx, r, *st, save=saves)[0]
    before = tsl.slstm_scan_backward.launches
    runs = [tsl.slstm_scan_backward(wx, r, *st, hs, saves, dh)[:2]
            for _ in range(2)]
    torch.cuda.synchronize()
    assert tsl.slstm_scan_backward.launches == before + 2
    bits = lambda t: t.view(torch.int32)
    assert all(torch.equal(bits(x), bits(y)) for x, y in zip(*runs))

    def plain(dt):
        x = [t.to(dt) for t in (wx, r) + tuple(st)]
        h, *_, sv = tsl.slstm_save_plain(*x)
        return tsl.slstm_backward_plain(*x, h, sv, dh.to(dt))[:2]

    chk = tsl.grad_check(runs[0], plain(torch.float32),
                         plain(torch.float64))
    for name, (dist, bar) in chk.items():
        assert dist <= bar, (name, dist, bar)


@pytest.mark.gpu
def test_recurrent_route_rule_under_autograd_on_the_card():
    """Under autograd on the card the mLSTM's dense form and the sLSTM
    launch their forward kernels with the saves and, in the backward,
    their backward kernels, and the RG-LRU its forward and backward
    kernels; the mLSTM's paged branch takes its plain version (no launch);
    a head dim the kernels do not take raises."""
    from repro_torch.kernels import mlstm_scan as tms
    from repro_torch.kernels import rglru_scan as trg
    from repro_torch.kernels import slstm_scan as tsl
    from repro_torch.models import recurrent as TR
    dev = _card()
    counters = (tms.mlstm_scan, tms.mlstm_scan_backward, tsl.slstm_scan,
                tsl.slstm_scan_backward, trg.rglru_scan,
                trg.rglru_scan_backward)
    count = lambda: [c.launches for c in counters]
    args, dh = _mlstm_grad_inputs(dev, 2, 20, 4, 32, 1.0, True, seed=1)
    q = args[0].clone().requires_grad_()
    state = dict(zip(("C", "n", "m"), args[5:]))
    before = count()
    h, _ = TR._mlstm_scan(q, *args[1:5], state)
    h.backward(dh)
    assert [x - y for x, y in zip(count(), before)] == [2, 4, 0, 0, 0, 0]
    src = args[5].reshape(2, -1).contiguous()
    rows = torch.arange(2, device=dev)
    before = count()
    h, _ = TR._mlstm_scan(q, *args[1:5], state,
                          (src, rows, [(torch.empty_like(src), rows)]))
    h.sum().backward()
    assert count() == before
    wx, r, st = _slstm_inputs(dev, 2, 6, 4, 16, seed=2)
    wg = wx.reshape(2, 6, -1).clone().requires_grad_()
    before = count()
    hs, _ = TR._slstm_scan(wg, r, dict(zip("cnmh", st)))
    hs.sum().backward()
    assert [x - y for x, y in zip(count(), before)] == [0, 0, 1, 1, 0, 0]
    xc = torch.randn((2, 5, 16), device=dev).requires_grad_()
    w = lambda *shape: torch.randn(shape, device=dev) * 0.1
    p = type("P", (), {})()
    p.w_a, p.w_a2, p.w_i, p.w_i2 = [w(16, 2)], [w(2, 16)], [w(16, 2)], \
        [w(2, 16)]
    p.lam = [w(16)]
    before = count()
    TR._rglru_scan(p, 0, xc, torch.zeros((2, 16), device=dev)).sum() \
        .backward()
    assert [x - y for x, y in zip(count(), before)] == [0, 0, 0, 0, 1, 1]
    bad, _ = _mlstm_grad_inputs(dev, 1, 3, 4, 48, 1.0, False, seed=3)
    with pytest.raises(ValueError, match="head dims"):
        TR._mlstm_scan(bad[0].requires_grad_(), *bad[1:5],
                       dict(zip(("C", "n", "m"), bad[5:])))
