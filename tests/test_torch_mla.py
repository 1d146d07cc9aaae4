"""The port's MLA paged-attention kernel layer against the JAX reference.

On the CPU the port's wrapper runs its plain PyTorch version
(``paged_attention_mla_plain``); the JAX side runs the Pallas
``paged_attention_mla`` in interpret mode and its jnp oracle.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``; here its split over
pages (``mla_split_plan``), its per-split partials, page records and
fixed-order combine and its 3xTF32 operand splits are emulated in torch
and held to the JAX kernel at the float32 bars (one TF32 pass is shown to
miss them).  The emulation sums each product in one float32 einsum: the
tensor core's own float32 accumulation, and the kernel's fresh accumulator
a 16-dim step that bounds it, are held to the bars only on the card.

Inputs come from a numpy seed: ragged rows padded with -1 and, in the
grid, a length-0 row (the reference gives such a row uniform weights, the
port zeros, so it is compared on the active rows and checked for zeros).
Tolerances: 1e-5 absolute in float32 (the implementations reduce in
different orders); 3e-2 for bfloat16 inputs, as
``tests/test_torch_kernels.py::test_bf16_matches_jax`` allows."""
import inspect
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp
import ml_dtypes

from repro.kernels import ops as rops
from repro.kernels import ref as rref

from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention_mla as tpam
from repro_torch.kernels import ref as tref

K = 8
TABLE = np.asarray([[2, 7, 11, 3, 9],
                    [5, 1, 20, -1, -1],          # ragged short row
                    [8, 4, 6, 12, 17],
                    [10, -1, -1, -1, -1]], np.int32)   # length-0 row
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(seed, h, r, page, dtype="float32", p_phys=24):
    rng = np.random.default_rng(seed)
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    f = lambda *s: rng.standard_normal(s).astype(dt)
    b, n = TABLE.shape
    lengths = np.asarray([n * page - 2, 3 * page - 1, 2 * page + 3, 0],
                         np.int32)
    return (f(b, h, r), f(b, h, K), f(p_phys, page, r), f(p_phys, page, K),
            TABLE.copy(), lengths)


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("r", [16, 32])
@pytest.mark.parametrize("h", [4, 8])
def test_plain_and_oracle_match_jax(h, r, page, dtype):
    """Torch oracle and the port's wrapper (plain version on the CPU)
    against the JAX interpret-mode kernel and the JAX oracle, context and
    mass, on the active rows; each active row's mass sums to 1 and the
    length-0 row gets zeros."""
    args = _inputs(h * 1000 + r * 10 + page, h, r, page, dtype)
    scale = 1.0 / np.sqrt(24.0)
    kw = dict(scale=scale, return_mass=True)
    jargs = [jnp.asarray(a) for a in args]
    j_int = rops.paged_attention_mla(*jargs, impl="interpret", **kw)
    j_ref = rops.paged_attention_mla(*jargs, impl="reference", **kw)
    targs = [_t(a) for a in args]
    t_ref = tref.paged_attention_mla_ref(*targs[:4], targs[4].clamp_min(0),
                                         targs[5], **kw)
    t_ops = tops.paged_attention_mla(*targs, **kw)
    active = args[5] > 0
    tol = TOL[dtype]
    for jo, jm in (j_int, j_ref):
        for to, tm in (t_ref, t_ops):
            np.testing.assert_allclose(_np(to)[active], _np(jo)[active],
                                       atol=tol, rtol=0)
            np.testing.assert_allclose(tm.numpy()[active],
                                       np.asarray(jm)[active], atol=1e-5,
                                       rtol=0)
    out, mass = t_ops
    np.testing.assert_allclose(mass.sum(dim=1).numpy()[active], 1.0,
                               atol=1e-5)
    assert torch.count_nonzero(out[~torch.from_numpy(active)]) == 0
    assert torch.count_nonzero(mass[~torch.from_numpy(active)]) == 0
    assert out.dtype == t_ref[0].dtype == getattr(torch, dtype)


def test_output_dtypes_follow_the_reference():
    """The oracle returns the ckv dtype, as the JAX oracle; the wrapper
    returns q_abs's dtype, as the Pallas kernel (ROADMAP Queue 3)."""
    q, qr, ckv, kr, pt, ln = _inputs(5, 4, 16, 4, "float32")
    ckv16, kr16 = (a.astype(ml_dtypes.bfloat16) for a in (ckv, kr))
    scale = 0.25
    pt = np.maximum(pt, 0)
    j_ref = rref.paged_attention_mla_ref(
        *[jnp.asarray(a) for a in (q, qr, ckv16, kr16, pt, ln)], scale=scale)
    t_ref = tref.paged_attention_mla_ref(
        _t(q), _t(qr), _t(ckv16), _t(kr16), _t(pt), _t(ln), scale=scale)
    assert str(j_ref.dtype) == "bfloat16" and t_ref.dtype == torch.bfloat16
    q16 = q.astype(ml_dtypes.bfloat16)
    out, _ = tpam.paged_attention_mla_plain(_t(q16), _t(qr), _t(ckv),
                                            _t(kr), _t(pt), _t(ln),
                                            scale=scale)
    assert out.dtype == torch.bfloat16
    out, _ = tpam.paged_attention_mla_plain(_t(q), _t(qr), _t(ckv16),
                                            _t(kr16), _t(pt), _t(ln),
                                            scale=scale)
    assert out.dtype == torch.float32


def test_page_permutation_invariance():
    """Physically permuting pages (table updated to match) cannot change
    the context or the mass -- the invariant tiering relies on."""
    b, h, r, page, n, p_phys = 2, 4, 32, 8, 4, 16
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, qr, ckv, kr = f(b, h, r), f(b, h, K), f(p_phys, page, r), \
        f(p_phys, page, K)
    pt = torch.arange(b * n, dtype=torch.int32).reshape(b, n)
    ln = torch.tensor([n * page - 5, 2 * page + 1], dtype=torch.int32)
    o1, m1 = tops.paged_attention_mla(q, qr, ckv, kr, pt, ln, scale=0.2,
                                      return_mass=True)
    perm = torch.from_numpy(rng.permutation(p_phys))
    inv = torch.argsort(perm).to(torch.int32)
    o2, m2 = tops.paged_attention_mla(q, qr, ckv[perm], kr[perm],
                                      inv[pt.long()], ln, scale=0.2,
                                      return_mass=True)
    torch.testing.assert_close(o1, o2, atol=1e-5, rtol=0)
    torch.testing.assert_close(m1, m2, atol=1e-6, rtol=0)


def test_plain_unmapped_page_carries_no_mass():
    """A table entry < 0 inside the length is never read and carries no
    mass; the remaining pages of the row still sum to 1."""
    q, qr, ckv, kr, pt, ln = (_t(a) for a in _inputs(3, 4, 16, 4))
    pt[2, 1] = -1
    out, mass = tpam.paged_attention_mla_plain(q, qr, ckv, kr, pt, ln,
                                               scale=0.3)
    assert mass[2, 1] == 0
    np.testing.assert_allclose(mass.sum(dim=1).numpy()[:3], 1.0, atol=1e-5)
    assert torch.isfinite(out).all()


def test_zero_page_table_gives_zeros():
    """A table of zero pages attends to nothing: the wrapper's CPU route
    and the plain version return zeros of q_abs's shape and dtype and an
    empty [B, 0] mass, as the k/v kernel does.  There is no oracle to pin
    this to: the JAX ``paged_attention_mla_ref`` raises at n == 0
    (ZeroDivisionError in its reshape), as does the port's copy."""
    q, qr, ckv, kr, _, _ = _inputs(3, 8, 32, 4)
    pt = np.zeros((q.shape[0], 0), np.int32)
    ln = np.zeros((q.shape[0],), np.int32)
    with pytest.raises(ZeroDivisionError):
        rref.paged_attention_mla_ref(*(jnp.asarray(a) for a in
                                       (q, qr, ckv, kr, pt, ln)),
                                     scale=0.25, return_mass=True)
    for fn in (tpam.paged_attention_mla, tpam.paged_attention_mla_plain):
        out, mass = fn(*(_t(a) for a in (q, qr, ckv, kr, pt, ln)),
                       scale=0.25)
        assert out.shape == q.shape and out.dtype == torch.float32
        assert torch.count_nonzero(out) == 0
        assert mass.shape == (q.shape[0], 0) and mass.dtype == torch.float32


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; a tensor elsewhere that is
    not on a CUDA card raises instead of falling back."""
    meta = lambda *s, **kw: torch.empty(s, device="meta", **kw)
    args = [meta(1, 4, 16), meta(1, 4, 8), meta(2, 4, 16), meta(2, 4, 8),
            meta(1, 2, dtype=torch.int32), meta(1, dtype=torch.int32)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpam.paged_attention_mla(*args, scale=0.1)


# --- the CUDA kernel's split over pages and its tensor-core arithmetic,
# emulated (the kernel itself runs only on the card; tests/test_torch_gpu.py
# holds it to the plain version).  float32 runs both products as 3xTF32:
# each operand x is split as hi = rna(x), where rna is cvt.rna.tf32.f32
# (round to nearest, ties away from zero, to a 10-bit mantissa), and lo = x
# - hi, which the tensor core truncates to TF32; a product is lo*hi +
# hi*lo, then + hi*hi, in float32.

def _rna(x):
    """cvt.rna.tf32.f32 on the int32 view: add half of the 13 dropped bits'
    range to the magnitude, then clear them."""
    bits = (x.float().contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def _trunc(x):
    """A float32 operand as the tensor core reads it in TF32: the low 13
    mantissa bits dropped."""
    return (x.float().contiguous().view(torch.int32) & -0x2000) \
        .view(torch.float32)


def _product(a, b, eq, passes):
    """einsum ``eq`` of a and b as the kernel's TF32 passes compute it: 3
    (lo*hi + hi*lo + hi*hi) or 1 (hi*hi)."""
    ah, bh = _rna(a), _rna(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = _trunc(a.float() - ah), _trunc(b.float() - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) \
        + torch.einsum(eq, ah, bh)


def _visited(length, page, n):
    """Logical pages [0, hi) a row visits, as the kernel computes them."""
    return 0 if length <= 0 else min(n, -(-length // page))


def _mla_emulation(q, qr, ckv, kr, pt, ln, *, scale, passes):
    """The kernel's arithmetic in torch.  Per split of ``mla_split_plan``:
    tiles of ``TILE`` tokens, logits (q_abs ++ q_rope) . (ckv ++ krope) in
    base 2, an online softmax over the tiles, p . ckv, and per visited page
    its exp-sum under the running max after the tile that ends it (rescaled
    when the page began in an earlier tile); then the combine: m_f = max_s
    m_s, l_f = sum_s l_s 2^(m_s - m_f), out = sum_s acc_s 2^(m_s - m_f) /
    l_f, mass = sum_h s_page 2^(m_page - m_f) / l_f / H -- empty splits
    (m = -inf) weigh 0.  It checks the split, the page records, the
    combine and the operands' TF32 rounding; it does not model how the
    tensor core accumulates in float32 (each product here is one float32
    einsum), so it is no witness for the kernel's float32 accumulation."""
    b, h, r = q.shape
    n_phys, page, _ = ckv.shape
    n = pt.shape[1]
    pps, splits = tpam.mla_split_plan(n, page, b, h)
    qq = torch.cat([q, qr], dim=-1).float()
    rows = torch.cat([ckv, kr], dim=-1).float()
    scale2 = scale / math.log(2.0)
    out = torch.zeros((b, h, r))
    mass = torch.zeros((b, n))
    for row in range(b):
        length = int(ln[row])
        hi = _visited(length, page, n)
        slot = [int(pt[row, pi]) for pi in range(n)]
        live = [0 <= x < n_phys for x in slot]
        part_m = torch.full((h, splits), -math.inf)
        part_l = torch.zeros((h, splits))
        part_acc = torch.zeros((h, splits, r))
        m_page = torch.full((h, n), -math.inf)
        s_page = torch.zeros((h, n))
        for s in range(splits):
            p0, p1 = s * pps, min(s * pps + pps, hi)
            t_end = min(p1 * page, length)
            m = torch.full((h,), -math.inf)
            l = torch.zeros(h)
            acc = torch.zeros((h, r))
            for a in range(p0 * page, t_end, tpam.TILE):
                pos = list(range(a, a + tpam.TILE))
                ok = torch.tensor([t < t_end and live[t // page]
                                   for t in pos])
                if not ok.any():
                    continue
                kv = torch.stack([rows[slot[t // page], t % page] if o
                                  else torch.zeros(rows.shape[-1])
                                  for t, o in zip(pos, ok.tolist())])
                x = _product(qq[row], kv, "hd,td->ht", passes) * scale2
                x = x.masked_fill(~ok, -math.inf)
                m_new = torch.maximum(m, x.amax(dim=1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new[:, None])
                l = l * corr + p.sum(dim=1)
                acc = acc * corr[:, None] + _product(p, kv[:, :r],
                                                     "ht,tr->hr", passes)
                m = m_new
                for pi in sorted({t // page for t, o in
                                  zip(pos, ok.tolist()) if o}):
                    sel = torch.tensor([t // page == pi for t in pos]) & ok
                    ssum = p[:, sel].sum(dim=1)
                    if pi * page < a:
                        ssum = ssum + s_page[:, pi] \
                            * torch.exp2(m_page[:, pi] - m_new)
                    s_page[:, pi], m_page[:, pi] = ssum, m_new
            part_m[:, s], part_l[:, s], part_acc[:, s] = m, l, acc
        mf = part_m.amax(dim=1)
        e = torch.where(torch.isfinite(part_m),
                        torch.exp2(part_m - mf[:, None]),
                        torch.zeros_like(part_m))
        inv = 1.0 / (part_l * e).sum(dim=1).clamp_min(1e-30)
        out[row] = (part_acc * (e * inv[:, None])[..., None]).sum(dim=1)
        for pi in range(hi):
            if live[pi]:
                mass[row, pi] = (s_page[:, pi]
                                 * torch.exp2(m_page[:, pi] - mf)
                                 * inv).sum() / h
    return out.to(q.dtype), mass


# (h, r, k, page, lengths, holes) over a table of 6 pages: 4, 16 or 20
# heads (one head group of 32, pad rows) and 40 (a partial second group); pages of 8 (four a tile), 16 (two) and 48 (straddling tiles);
# spans ending on a page boundary, inside the first tile and at the table's
# end; -1 slots inside a span; a length-0 row; the served R = 512, K = 64
MLA_EMU_CASES = [
    (4, 32, 8, 8, [48, 17, 1, 0], [(1, 1)]),
    (20, 16, 8, 16, [96, 31, 32, 0], [(0, 2), (0, 3)]),
    (40, 64, 16, 48, [288, 100, 47, 0], [(1, 0)]),
    (16, 512, 64, 16, [96, 40, 3, 0], [(0, 4)]),
]


def _emu_inputs(h, r, k, page, lengths, holes, n=6, p_phys=32):
    rng = np.random.default_rng(h + r + page)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pt = rng.permutation(p_phys)[: 4 * n].reshape(4, n).astype(np.int32)
    for row, length in enumerate(lengths):
        pt[row, -(-length // page):] = -1
    for row, pg in holes:
        pt[row, pg] = -1
    return (f(4, h, r), f(4, h, k), f(p_phys, page, r), f(p_phys, page, k),
            pt, np.asarray(lengths, np.int32))


@pytest.mark.parametrize("h,r,k,page,lengths,holes", MLA_EMU_CASES)
def test_3xtf32_split_emulation_matches_jax(h, r, k, page, lengths, holes):
    """The CUDA kernel's split partials, page records and fixed-order
    combine, with its 3xTF32 operand splits, against the plain version (every
    row) and the JAX Pallas ``paged_attention_mla`` in interpret mode and
    its oracle (the rows they define: active, no -1 inside the span), at
    the float32 bars: 1e-5 on the context and the mass."""
    args = _emu_inputs(h, r, k, page, lengths, holes)
    scale = 1.0 / np.sqrt(r + k)
    targs = [_t(a) for a in args]
    out, mass = _mla_emulation(*targs, scale=scale, passes=3)
    assert torch.isfinite(out).all() and torch.isfinite(mass).all()
    ref_o, ref_m = tpam.paged_attention_mla_plain(*targs, scale=scale)
    torch.testing.assert_close(out, ref_o, atol=1e-5, rtol=0)
    torch.testing.assert_close(mass, ref_m, atol=1e-5, rtol=0)
    rows = [i for i, length in enumerate(lengths)
            if length > 0 and all(hr != i for hr, _ in holes)]
    jargs = [jnp.asarray(a) for a in args[:4]] \
        + [jnp.asarray(np.maximum(args[4], 0)), jnp.asarray(args[5])]
    for impl in ("interpret", "reference"):
        jo, jm = rops.paged_attention_mla(*jargs, scale=scale,
                                          return_mass=True, impl=impl)
        np.testing.assert_allclose(out.numpy()[rows], _np(jo)[rows],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(mass.numpy()[rows], _np(jm)[rows],
                                   atol=1e-5, rtol=0)
    dead = [i for i, length in enumerate(lengths) if length == 0]
    assert torch.count_nonzero(out[dead]) == 0
    assert torch.count_nonzero(mass[dead]) == 0


@pytest.mark.parametrize("h,r,k,page,lengths,holes", MLA_EMU_CASES)
def test_one_tf32_pass_misses_the_float32_bars(h, r, k, page, lengths,
                                               holes):
    """Why the kernel splits its float32 operands: the same emulation with
    one TF32 pass (hi*hi) misses the 1e-5 bar on the same inputs."""
    args = [_t(a) for a in _emu_inputs(h, r, k, page, lengths, holes)]
    scale = 1.0 / np.sqrt(r + k)
    out, _ = _mla_emulation(*args, scale=scale, passes=1)
    ref_o, _ = tpam.paged_attention_mla_plain(*args, scale=scale)
    assert float((out - ref_o).abs().max()) > 1e-5


@pytest.mark.parametrize("n,page,b,h", [
    (64, 16, 4, 128), (50, 16, 4, 128), (6, 16, 3, 128), (12, 8, 4, 12),
    (12, 32, 4, 4), (12, 48, 4, 40), (300, 16, 1, 128), (2048, 16, 64, 128),
    (1, 16, 1, 1), (7, 1, 2, 17), (100, 4, 8, 16)])
def test_mla_split_plan_covers_each_visited_page_once(n, page, b, h):
    """One plan, made from the shapes alone, serves every length: the
    splits' runs cover each row's visited pages [0, hi) exactly once, no run
    holds more than ``MAX_PAGES_PER_SPLIT`` pages, and every head falls in
    exactly one head group."""
    assert "lengths" not in inspect.signature(tpam.mla_split_plan).parameters
    hb = tpam.HEADS_PER_BLOCK
    pps, splits = tpam.mla_split_plan(n, page, b, h)
    assert 1 <= pps <= tpam.MAX_PAGES_PER_SPLIT
    groups = -(-h // hb)
    assert sorted(g * hb + i for g in range(groups) for i in range(hb)
                  if g * hb + i < h) == list(range(h))
    for length in range(0, n * page + 1, max(1, page // 3)):
        hi = _visited(length, page, n)
        covered = []
        for s in range(splits):
            p0, p1 = s * pps, min(s * pps + pps, hi)
            assert p1 - p0 <= pps
            covered += range(p0, p1)
        assert covered == list(range(hi)), (length, pps, splits)


def test_mla_split_plan_fills_the_card_at_the_served_shape():
    """At deepseek's served decode shape (B=4, 128 heads, 64 pages of 16)
    the grid holds at least 128 blocks, each page is read by 4 head groups
    (not 16), and a split holds whole tiles of tokens."""
    hb = tpam.HEADS_PER_BLOCK
    pps, splits = tpam.mla_split_plan(64, 16, 4, 128)
    assert 4 * (128 // hb) * splits >= 128
    assert 128 // hb == 4
    assert pps * 16 % tpam.TILE == 0
