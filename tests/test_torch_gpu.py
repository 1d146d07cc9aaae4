"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor the reference, so it runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card each test skips (decided inside the test).  Tolerances:
paged attention 1e-5 absolute in float32 (summation order), 2e-2 for
bfloat16 outputs, page masses 1e-5; ``page_hist`` and ``sim_scan`` are
bit-equal to their plain versions (the kernels round where the plain
versions round)."""
import pytest
import torch

from repro_torch.kernels import page_hist as tph
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import sim_step as tss


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,window,softcap", [(40, 8, 0, 0.0),
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
