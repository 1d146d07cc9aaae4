"""The port's paged-attention kernel layer against the JAX reference.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode and its jnp oracle.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Tolerances: 1e-5 absolute in float32 (the three implementations reduce in
different orders); 3e-2 for bfloat16 inputs, as the reference's own kernel
test allows."""
import inspect
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from repro.kernels import ops as rops
from repro.kernels import ref as rref

from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref

TABLE = np.asarray([[2, 7, 11, 3, 9],
                    [5, 1, 20, -1, -1],          # ragged short row
                    [8, 4, 6, 12, 17]], np.int32)


def _inputs(seed, h, kv, d=16, page=4, p_phys=24, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, h, d)).astype(dtype)
    kp = rng.standard_normal((p_phys, page, kv, d)).astype(dtype)
    vp = rng.standard_normal((p_phys, page, kv, d)).astype(dtype)
    n = TABLE.shape[1]
    lengths = np.asarray([n * page - 2, 3 * page - 1, 2 * page + 3], np.int32)
    return q, kp, vp, TABLE.copy(), lengths


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2), (8, 1)])  # GQA ratios
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (3, 0.0), (0, 5.0),
                                            (8, 5.0)])
def test_ref_and_plain_match_jax(h, kv, window, softcap):
    """Torch oracle == JAX interpret-mode kernel == JAX oracle, outputs and
    mass; the port's wrapper (plain version on CPU) agrees on every active
    row, and each row's mass sums to 1."""
    q, kp, vp, pt, ln = _inputs(h * 100 + window, h, kv)
    kw = dict(window=window, softcap=softcap, return_mass=True)
    j_int = rops.paged_attention(*_j(q, kp, vp, pt, ln), impl="interpret",
                                 **kw)
    j_ref = rops.paged_attention(*_j(q, kp, vp, pt, ln), impl="reference",
                                 **kw)
    tq, tk, tv, tt, tl = _t(q, kp, vp, pt, ln)
    t_ref = tref.paged_attention_ref(tq, tk, tv, tt.clamp_min(0), tl, **kw)
    t_ops = tops.paged_attention(tq, tk, tv, tt, tl, **kw)
    for jo, jm in (j_int, j_ref):
        for to, tm in (t_ref, t_ops):
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(t_ops[1].sum(dim=1).numpy(), np.ones(3),
                               atol=1e-5)


@pytest.mark.parametrize("h,kv,d,page", [(4, 4, 64, 16), (8, 2, 64, 32),
                                         (8, 1, 128, 16)])
def test_bf16_matches_jax(h, kv, d, page):
    """bfloat16 pools: the torch oracle and the port's wrapper against the
    JAX oracle on full-length, ragged and short rows."""
    import ml_dtypes
    b, n, p_phys = 3, 8, 64
    rng = np.random.default_rng(h + kv + d)
    f = lambda *s: rng.standard_normal(s).astype(ml_dtypes.bfloat16)
    q, kp, vp = f(b, h, d), f(p_phys, page, kv, d), f(p_phys, page, kv, d)
    pt = rng.permutation(p_phys)[: b * n].reshape(b, n).astype(np.int32)
    ln = np.asarray([n * page, n * page - 7, page + 3], np.int32)
    j = rref.paged_attention_ref(*_j(q, kp, vp, pt, ln))
    tb = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    args = (tb(q), tb(kp), tb(vp), torch.from_numpy(pt),
            torch.from_numpy(ln))
    for out in (tref.paged_attention_ref(*args),
                tops.paged_attention(*args)):
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(j, np.float32), atol=3e-2)


def test_page_permutation_invariance():
    """Physically permuting pages (table updated to match) cannot change
    the output or the mass -- the invariant tiering relies on."""
    b, h, kv, d, page, n, p_phys = 2, 4, 2, 64, 16, 4, 32
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    kp = torch.from_numpy(
        rng.standard_normal((p_phys, page, kv, d)).astype(np.float32))
    vp = torch.from_numpy(
        rng.standard_normal((p_phys, page, kv, d)).astype(np.float32))
    pt = torch.arange(b * n, dtype=torch.int32).reshape(b, n)
    ln = torch.full((b,), n * page - 5, dtype=torch.int32)
    o1, m1 = tops.paged_attention(q, kp, vp, pt, ln, return_mass=True)
    perm = torch.from_numpy(rng.permutation(p_phys))
    inv = torch.argsort(perm).to(torch.int32)
    o2, m2 = tops.paged_attention(q, kp[perm], vp[perm], inv[pt.long()], ln,
                                  return_mass=True)
    torch.testing.assert_close(o1, o2, atol=1e-5, rtol=0)
    torch.testing.assert_close(m1, m2, atol=1e-6, rtol=0)


def test_plain_empty_rows_and_unmapped_pages():
    """A row with length 0 gets zeros (out and mass); a table entry < 0
    inside the length is never read and carries no mass; the reference
    oracle agrees on the rows it defines."""
    q, kp, vp, pt, ln = _inputs(7, 8, 2)
    ln[1] = 0
    pt[2, 1] = -1                       # unmapped page inside row 2's span
    tq, tk, tv, tt, tl = _t(q, kp, vp, pt, ln)
    out, mass = tpa.paged_attention_plain(tq, tk, tv, tt, tl)
    assert torch.count_nonzero(out[1]) == 0
    assert torch.count_nonzero(mass[1]) == 0
    assert mass[2, 1] == 0
    np.testing.assert_allclose(mass.sum(dim=1).numpy()[[0, 2]], [1, 1],
                               atol=1e-5)
    ro, rm = rref.paged_attention_ref(*_j(q, kp, vp, np.maximum(pt, 0), ln),
                                      return_mass=True)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ro)[0], atol=1e-5)
    np.testing.assert_allclose(mass[0].numpy(), np.asarray(rm)[0], atol=1e-5)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (3, 5.0)])
def test_zero_page_table_gives_the_oracles_zeros(window, softcap):
    """A table of zero pages attends to nothing: the plain version (the
    wrapper's CPU route) returns the JAX oracle's zeros and its empty
    [B, 0] mass, whatever the lengths say."""
    q, kp, vp, _, _ = _inputs(5, 8, 2)
    pt = np.zeros((3, 0), np.int32)
    ln = np.asarray([0, 5, 0], np.int32)
    kw = dict(window=window, softcap=softcap)
    ro, rm = rref.paged_attention_ref(*_j(q, kp, vp, pt, ln),
                                      return_mass=True, **kw)
    for fn in (tpa.paged_attention, tpa.paged_attention_plain):
        out, mass = fn(*_t(q, kp, vp, pt, ln), **kw)
        assert out.dtype == torch.float32 and mass.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), np.asarray(ro))
        assert mass.shape == np.asarray(rm).shape == (3, 0)
        assert torch.count_nonzero(out) == 0


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; a tensor elsewhere that is
    not on a CUDA card raises instead of falling back."""
    args = [torch.empty((1, 4, 16), device="meta"),
            torch.empty((2, 4, 4, 16), device="meta"),
            torch.empty((2, 4, 4, 16), device="meta"),
            torch.zeros((1, 2), dtype=torch.int32, device="meta"),
            torch.ones((1,), dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpa.paged_attention(*args)


# --- the CUDA kernel's split over pages, emulated (the kernel itself runs
# only on the card; tests/test_torch_gpu.py holds it to the plain version)

def _visited(length, window, page, n):
    """Logical pages [lo, hi) a row visits, as the kernel computes them."""
    if length <= 0:
        return 0, 0
    start = max(0, length - window) if window > 0 else 0
    return start // page, min(n, -(-length // page))


def _runs(length, window, page, n, pps, splits):
    """Each split's run of logical pages [p0, p1) of a row (empty runs
    included), as the kernel's blocks take them."""
    lo, hi = _visited(length, window, page, n)
    return [(lo + s * pps, min(hi, lo + (s + 1) * pps))
            for s in range(splits)]


def _split_emulation(q, kp, vp, pt, ln, *, window, softcap, pps, splits):
    """The kernel's arithmetic in torch: per split its (m, l, acc) and
    per page its exp-sum s_page under the split's max m_page = m; then the
    combine: m_f = max_s m_s, l_f = sum_s l_s exp(m_s - m_f), out =
    sum_s acc_s exp(m_s - m_f) / max(l_f, 1e-30), mass = sum_h s_page
    exp(m_page - m_f) / l_f / H -- empty splits (m = -inf) weigh 0."""
    b, h, d = q.shape
    n_phys, page, kvh, _ = kp.shape
    n = pt.shape[1]
    rep = h // kvh
    out = torch.zeros((b, h, d))
    mass = torch.zeros((b, n))
    for row in range(b):
        length = int(ln[row])
        span_lo = length - window if window > 0 else 0
        qg = q[row].float().reshape(kvh, rep, d)
        m = torch.full((h, splits), -math.inf)
        l = torch.zeros((h, splits))
        acc = torch.zeros((h, splits, d))
        s_page = torch.zeros((h, n))
        page_split = {}
        for s, (p0, p1) in enumerate(_runs(length, window, page, n, pps,
                                           splits)):
            pages = [pi for pi in range(p0, p1)
                     if 0 <= int(pt[row, pi]) < n_phys]
            if not pages:
                continue
            for pi in range(p0, p1):
                page_split[pi] = s
            slots = torch.tensor([int(pt[row, pi]) for pi in pages])
            k = kp[slots].float().reshape(-1, kvh, d)
            v = vp[slots].float().reshape(-1, kvh, d)
            lg = torch.einsum("grd,tgd->grt", qg, k) / math.sqrt(d)
            if softcap > 0:
                lg = torch.tanh(lg / softcap) * softcap
            pos = (torch.tensor(pages)[:, None] * page
                   + torch.arange(page)[None, :]).reshape(-1)
            valid = (pos < length) & (pos >= span_lo)
            lg = lg.masked_fill(~valid, -math.inf).reshape(h, -1)
            ms = lg.amax(dim=1)
            p = torch.where(torch.isfinite(lg), torch.exp(lg - ms[:, None]),
                            torch.zeros_like(lg))
            m[:, s], l[:, s] = ms, p.sum(dim=1)
            vr = v.permute(1, 0, 2).repeat_interleave(rep, dim=0)
            acc[:, s] = torch.einsum("ht,htd->hd", p, vr)
            s_page[:, pages] = p.reshape(h, len(pages), page).sum(dim=2)
        mf = m.amax(dim=1, keepdim=True)
        live = torch.isfinite(m)
        e = torch.where(live, torch.exp(m - mf), torch.zeros_like(m))
        lf = (l * e).sum(dim=1, keepdim=True)
        w = e / lf.clamp_min(1e-30)
        out[row] = (acc * w[:, :, None]).sum(dim=1)
        for pi, s in page_split.items():
            if 0 <= int(pt[row, pi]) < n_phys:
                mass[row, pi] = (s_page[:, pi] * w[:, s]).sum() / h
    return out, mass


# (h, kv, window, softcap, lengths, holes) over 7 pages of 4: spans ending
# in the first page, on a page boundary and at the table's end; -1 slots
# inside a span; a window whose span starts past page 0; a length-0 row
SPLIT_CASES = [
    (8, 2, 0, 0.0, [28, 3, 8, 0], [(0, 2)]),
    (8, 2, 6, 0.0, [28, 13, 5, 0], []),
    (4, 1, 0, 5.0, [27, 16, 12, 1], [(1, 1), (1, 2)]),
    (4, 4, 9, 5.0, [25, 20, 9, 0], [(0, 4)]),
]


@pytest.mark.parametrize("h,kv,window,softcap,lengths,holes", SPLIT_CASES)
def test_split_combine_matches_plain_and_jax(h, kv, window, softcap,
                                             lengths, holes):
    """The split kernel's per-split partials merged by the combine's
    formulas equal the plain version for every split size 1..n (and the
    JAX oracle on the rows it defines: active, no -1 inside the span);
    empty splits give no NaN and a length-0 row gives zeros."""
    n, page, d, p_phys = 7, 4, 16, 40
    rng = np.random.default_rng(h * 10 + window)
    q = rng.standard_normal((4, h, d)).astype(np.float32)
    kp = rng.standard_normal((p_phys, page, kv, d)).astype(np.float32)
    vp = rng.standard_normal((p_phys, page, kv, d)).astype(np.float32)
    pt = rng.permutation(p_phys)[: 4 * n].reshape(4, n).astype(np.int32)
    for row, length in enumerate(lengths):
        pt[row, -(-length // page):] = -1
    for row, pg in holes:
        pt[row, pg] = -1
    ln = np.asarray(lengths, np.int32)
    tq, tk, tv, tt, tl = _t(q, kp, vp, pt, ln)
    kw = dict(window=window, softcap=softcap)
    ref_o, ref_m = tpa.paged_attention_plain(tq, tk, tv, tt, tl, **kw)
    jo, jm = rref.paged_attention_ref(*_j(q, kp, vp, np.maximum(pt, 0), ln),
                                      return_mass=True, **kw)
    rows = [r for r, length in enumerate(lengths)
            if length > 0 and all(hr != r for hr, _ in holes)]
    span = n if window <= 0 else min(n, -(-window // page) + 1)
    for pps in range(1, n + 1):
        out, mass = _split_emulation(tq, tk, tv, tt, tl, pps=pps,
                                     splits=-(-span // pps), **kw)
        assert torch.isfinite(out).all() and torch.isfinite(mass).all()
        torch.testing.assert_close(out, ref_o, atol=1e-5, rtol=0)
        torch.testing.assert_close(mass, ref_m, atol=1e-5, rtol=0)
        np.testing.assert_allclose(out.numpy()[rows], np.asarray(jo)[rows],
                                   atol=1e-5)
        np.testing.assert_allclose(mass.numpy()[rows], np.asarray(jm)[rows],
                                   atol=1e-5)
        dead = [r for r, length in enumerate(lengths) if length == 0]
        assert torch.count_nonzero(out[dead]) == 0
        assert torch.count_nonzero(mass[dead]) == 0


@pytest.mark.parametrize("n,window,page,b,kv", [
    (64, 0, 16, 4, 8), (128, 1024, 16, 4, 8), (50, 0, 16, 4, 8),
    (128, 1000, 16, 4, 8), (7, 6, 4, 4, 2), (12, 3, 4, 3, 4),
    (300, 0, 16, 1, 1), (2048, 0, 16, 64, 8)])
def test_split_plan_covers_each_visited_page_once(n, window, page, b, kv):
    """One plan, made from the shapes alone, serves every length: the
    splits' runs cover each row's visited pages [lo, hi) exactly once and
    no run holds a page past them or more than MAX_PAGES_PER_SPLIT."""
    assert "lengths" not in inspect.signature(tpa.split_plan).parameters
    pps, splits = tpa.split_plan(n, window, page, b, kv, 1)
    assert 1 <= pps <= tpa.MAX_PAGES_PER_SPLIT
    for length in range(0, n * page + 1, max(1, page // 3)):
        lo, hi = _visited(length, window, page, n)
        covered = []
        for p0, p1 in _runs(length, window, page, n, pps, splits):
            assert p1 - p0 <= pps
            covered += range(p0, p1)
        assert covered == list(range(lo, hi)), (length, pps, splits)


@pytest.mark.parametrize("model,n,window", [("qwen3-14b", 64, 0),
                                            ("gemma3-12b", 128, 1024)])
def test_split_plan_fills_the_card_at_served_shapes(model, n, window):
    """At both served decode shapes (B=4, KV=8, page 16) the grid holds at
    least 2 x 132 blocks, and a windowed layer launches no more splits
    than its span (ceil(1024 / 16) + 1 = 65 pages) can fill."""
    pps, splits = tpa.split_plan(n, window, 16, 4, 8, 1)
    assert 4 * 8 * splits >= 2 * 132
    span = n if not window else -(-window // 16) + 1
    assert splits == -(-span // pps)


# (h, kv, d, n, window, lengths) of the decode shapes whose GQA group the
# launcher splits into several blocks: nemotron-4-340b's 96/8 heads of 192
# (six blocks of two heads) over 64 pages, and recurrentgemma-2b's 10/1
# heads of 256 (five of two) with window 2048 over 192 token pages and the
# state page's column
GROUPED_SHAPES = {
    "nemotron-4-340b": (96, 8, 192, 64, 0, [1024, 777, 0, 301]),
    "recurrentgemma-2b": (10, 1, 256, 193, 2048, [3000, 2100, 2049, 0]),
}


@pytest.mark.parametrize("model", list(GROUPED_SHAPES))
def test_split_plan_counts_head_groups(model):
    """At B=4, page 16: ``head_groups`` is the launcher's rule (6 and 5
    groups), and counting them keeps the grid within 2x of
    ``TARGET_BLOCKS`` where the plan without them made 3072 and 2580
    blocks; the plan's runs still cover each visited page once, and its
    split and combine emulated in torch equal the plain version."""
    h, kv, d, n, window, lengths = GROUPED_SHAPES[model]
    b, page = 4, 16
    groups = tpa.head_groups(h, kv, d)
    assert groups == {"nemotron-4-340b": 6, "recurrentgemma-2b": 5}[model]
    blocks = lambda plan: b * kv * groups * plan[1]
    assert blocks(tpa.split_plan(n, window, page, b, kv, 1)) \
        == {"nemotron-4-340b": 3072, "recurrentgemma-2b": 2580}[model]
    pps, splits = tpa.split_plan(n, window, page, b, kv, groups)
    assert tpa.TARGET_BLOCKS / 2 <= blocks((pps, splits)) \
        <= 2 * tpa.TARGET_BLOCKS
    for length in range(0, n * page + 1, 5):
        covered = []
        for p0, p1 in _runs(length, window, page, n, pps, splits):
            assert p1 - p0 <= pps
            covered += range(p0, p1)
        assert covered == list(range(*_visited(length, window, page, n)))
    g = torch.Generator().manual_seed(h)
    p_phys = b * n + 8
    q = torch.randn((b, h, d), generator=g)
    kp = torch.randn((p_phys, page, kv, d), generator=g)
    vp = torch.randn((p_phys, page, kv, d), generator=g)
    pt = torch.randperm(p_phys, generator=g)[: b * n].reshape(b, n) \
        .to(torch.int32)
    for row, length in enumerate(lengths):
        pt[row, -(-length // page):] = -1
    ln = torch.tensor(lengths, dtype=torch.int32)
    out, mass = _split_emulation(q, kp, vp, pt, ln, window=window,
                                 softcap=0.0, pps=pps, splits=splits)
    ref_o, ref_m = tpa.paged_attention_plain(q, kp, vp, pt, ln,
                                             window=window)
    torch.testing.assert_close(out, ref_o, atol=1e-5, rtol=0)
    torch.testing.assert_close(mass, ref_m, atol=1e-5, rtol=0)


@pytest.mark.parametrize("model,h,kv,d,n,window,plan", [
    ("qwen3-14b", 40, 8, 128, 64, 0, (4, 16)),
    ("gemma3-12b", 16, 8, 256, 128, 1024, (4, 17)),
    ("olmoe-1b-7b", 16, 16, 128, 64, 0, (8, 8)),
    ("musicgen-large", 32, 32, 64, 64, 0, (16, 4))])
def test_split_plan_keeps_one_group_shapes(model, h, kv, d, n, window, plan):
    """Shapes whose GQA group fits one block (one head group) keep the
    plan they had before head groups were counted (pinned)."""
    assert tpa.head_groups(h, kv, d) == 1
    assert tpa.split_plan(n, window, 16, 4, kv, 1) == plan


def test_build_cache_key_covers_source_and_flags(tmp_path, monkeypatch):
    """A kernel's library is named after its source and its flags: editing
    either names a new library, so a stale one is never loaded, and the
    same source and flags name the same one."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    (tmp_path / "k.cu").write_text('extern "C" int f() { return 1; }\n')
    flags = ("-O3",)
    first = _build._lib_path("k", flags)
    assert first.parent == tmp_path / "build"
    assert first.name.startswith("libk_") and first.suffix == ".so"
    assert _build._lib_path("k", flags) == first
    (tmp_path / "k.cu").write_text('extern "C" int f() { return 2; }\n')
    second = _build._lib_path("k", flags)
    assert second != first
    assert _build._lib_path("k", ("-O2",)) != second
