"""The mLSTM recurrence kernel's CPU side (``kernels/mlstm_scan.py``).

On the CPU ``mlstm_scan`` takes its plain version, so these tests hold
what the CUDA kernel is compared with on the card, and what surrounds it:

  * ``mlstm_scan_plain`` against the reference's ``mlstm_apply`` (from
    the zero state -- source row -1 -- and from a carried one) and
    ``mlstm_step``, through ``bridge``, on reduced xlstm-1.3b (dm 128, 4
    heads of 32) with conv taps drawn from N(0, 0.5) (the reference's
    zero taps make the cell an identity), within the 1e-5 bar of
    ``tests/test_torch_recurrent.py``;
  * the strip kernel's decomposition emulated in torch -- each strip of
    32 columns of C on its own, the scalars, n and the denominator
    recomputed per strip, C^T q summed per warp's rows then across warps
    -- at hd 32, 64 and 1024 (S <= 3): C, n and m bit-equal to the plain
    version, h within the strip kernel's ``h_tolerance``;
  * the chunkwise kernel's decomposition (S > 1) emulated in torch --
    the plain version's m chain, the chunk's decay matrix from double
    sums, 3xTF32 products with operands split as the kernel splits them,
    C carried chunk to chunk -- at hd 32, 64 and 1024 over chunk
    boundaries from the zero and a carried state: m bit-equal, C, n and
    h within ``tolerances``; with one position's k v^T left out it fails
    them, and with one TF32 pass a product (no split) it misses the
    bound on C;
  * the paged decode's mLSTM branch, in place on the state pages
    (``model._mlstm_paged``), bit-equal to the unpack / step / pack /
    ``index_put_`` branch it replaced (``_old_core`` below, with the old
    cell): logits of live rows and every page of both tiers but the
    sinks; dropped rows (a dead row, a live row whose state page is
    unmapped, a dead row whose clamped page is a live row's) write only
    the sinks;
  * the route rule: under autograd the autograd Function with its
    backward (``recurrent.grad_route``; its own tests are
    ``tests/test_torch_mlstm_grad.py``); otherwise the wrapper.

Inputs are drawn with numpy from seeds."""
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.models import model as RM
from repro.models import recurrent as RR

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.kernels import mlstm_scan as MS
from repro_torch.memtier.tiering import SharedPagedPools
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models import recurrent as TR

TOL = 1e-5
F32_RTOL = 4e-6
CONV_STD = 0.5
_CACHE = {}


def _models():
    """(reference cfg, reference numpy params, port cfg, port params) of
    reduced xlstm-1.3b, conv taps drawn from N(0, 0.5)."""
    if not _CACHE:
        rcfg = dataclasses.replace(RC.reduced("xlstm-1.3b"), dtype="float32")
        tcfg = dataclasses.replace(TC.reduced("xlstm-1.3b"), dtype="float32")
        rp = jax.tree.map(np.asarray, RM.init(jax.random.PRNGKey(0),
                                              rcfg)[0])
        rng = np.random.default_rng(7)
        for seg in rp["segments"]:
            for slot in seg:
                if "cell" in slot:
                    slot["cell"]["conv"] = rng.normal(
                        0.0, CONV_STD, slot["cell"]["conv"].shape) \
                        .astype(np.float32)
        _CACHE["m"] = (rcfg, rp, tcfg,
                       bridge.from_reference(rp, tcfg, device="cpu"))
    return _CACHE["m"]


def _cell():
    rcfg, rp, tcfg, tp = _models()
    ref = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       rp["segments"][0][0]["cell"])
    return rcfg, ref, tcfg, tp.segments[0][0].cell


def _close(t, r):
    np.testing.assert_allclose(t.numpy(), np.asarray(r), atol=TOL,
                               rtol=F32_RTOL)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _plain_from_x(cell, cfg, x, state, seq: bool):
    """The mLSTM slot's output and state with the recurrence through
    ``mlstm_scan_plain`` (source row -1 where ``state`` is None)."""
    b, s, _ = x.shape
    nh = cfg.num_kv_heads
    dm = 2 * cfg.d_model
    hd = dm // nh
    if state is None:
        zero = TR.mlstm_zero_state(cfg, b)
        conv0, n0, m0 = zero["conv"], zero["n"], zero["m"]
        src, src_rows = torch.zeros((1, nh * hd * hd)), torch.full((b,), -1)
    else:
        conv0, n0, m0 = state["conv"], state["n"], state["m"]
        src, src_rows = state["C"].reshape(b, -1), torch.arange(b)
    up, gate = x @ cell.w_up[0], x @ cell.w_gate[0]
    if seq:
        xc, conv = TR._conv_seq(conv0, up, cell.conv[0])
    else:
        conv, xc = TR.conv_step(conv0, up[:, 0], cell.conv[0])
        xc = xc[:, None]
    q, k, v, i, f = TR._mlstm_inputs(cell, 0, F.silu(xc), nh)
    out = torch.full((b, nh * hd * hd), float("nan"))
    rows = torch.arange(b)
    h, n, m = MS.mlstm_scan_plain(q, k, v, i.contiguous(), f.contiguous(),
                                  n0, m0, src, src_rows, [(out, rows)])
    y = TR._mlstm_out(cell, 0, h.reshape(b, s, dm), gate)
    return y, {"C": out.reshape(b, nh, hd, hd), "n": n, "m": m, "conv": conv}


def test_plain_matches_the_reference_apply_and_step():
    """From the zero state over 5 tokens (source -1), from the carried
    state over 4 more, then two decode steps: the slot's output and C, n,
    m, conv against the reference's ``mlstm_apply`` / ``mlstm_step``."""
    rcfg, ref, tcfg, cell = _cell()
    x = np.random.default_rng(2).standard_normal(
        (2, 11, rcfg.d_model)).astype(np.float32)
    ry, rst = RR.mlstm_apply(ref, rcfg, jnp.asarray(x[:, :5]))
    ty, tst = _plain_from_x(cell, tcfg, torch.from_numpy(x[:, :5]), None,
                            True)
    _close(ty, ry)
    for key in rst:
        _close(tst[key], rst[key])
    ry, rst = RR.mlstm_apply(ref, rcfg, jnp.asarray(x[:, 5:9]), rst)
    ty, tst = _plain_from_x(cell, tcfg, torch.from_numpy(x[:, 5:9]), tst,
                            True)
    _close(ty, ry)
    for t in (9, 10):
        ry, rst = RR.mlstm_step(ref, rcfg, jnp.asarray(x[:, t:t + 1]), rst)
        ty, tst = _plain_from_x(cell, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                tst, False)
        _close(ty, ry)
        for key in rst:
            _close(tst[key], rst[key])


def _inputs(b, s, nh, hd, seed):
    """Seeded q, k, v [B, S, nh, hd], gates i, log f [B, S, nh], a carried
    state (C [B, nh, hd, hd], n, m): data of the cell's scales."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32))
    q, k, v = t(b, s, nh, hd), t(b, s, nh, hd), t(b, s, nh, hd)
    i = t(b, s, nh)
    f = F.logsigmoid(t(b, s, nh) + 2.0)
    C, n = t(b, nh, hd, hd, scale=0.3), t(b, nh, hd, scale=0.3)
    m = t(b, nh)
    return q, k, v, i, f, C, n, m


def _emulated_kernel(q, k, v, i, f, C0, n0, m0, tv=32, warps=8,
                     skip_row=False):
    """The CUDA kernel's decomposition in torch: each strip of ``tv``
    columns of C walks the positions on its own, recomputing the scalars,
    n and the denominator; a strip's C^T q is summed over each warp's
    rows (hd / ``warps`` of them) and then across warps in order.
    ``skip_row`` leaves row 0 out of C^T q (a fault the tolerance must
    catch).  Returns (C, n, m, h)."""
    b, s, nh, hd = q.shape
    rows = hd // warps
    C = torch.empty_like(C0)
    h = torch.empty_like(q)
    sq = math.sqrt(hd)
    for j in range(hd // tv):
        cols = slice(j * tv, (j + 1) * tv)
        c, n, m = C0[..., cols].clone(), n0.clone(), m0.clone()
        for t in range(s):
            ks = k[:, t] / torch.full_like(k[:, t], sq)
            fm = f[:, t] + m
            m_new = torch.maximum(fm, i[:, t])
            i_p = torch.exp(i[:, t] - m_new)[..., None]
            f_p = torch.exp(fm - m_new)[..., None]
            m = m_new
            n = f_p * n + i_p * ks
            den = torch.clamp_min((n * q[:, t]).sum(-1).abs(), 1.0)
            kv = ks[..., :, None] * v[:, t][..., None, cols]
            c = f_p[..., None] * c + i_p[..., None] * kv
            qn = q[:, t].clone()
            if skip_row:
                qn[..., 0] = 0.0
            part = (c * qn[..., None]).reshape(b, nh, warps, rows, tv).sum(3)
            num = part[:, :, 0]
            for w in range(1, warps):
                num = num + part[:, :, w]
            h[:, t, :, cols] = num / den[..., None]
        C[..., cols] = c
    return C, n, m, h


@pytest.mark.parametrize("b,s,nh,hd", [(3, 3, 4, 32), (2, 2, 2, 64),
                                       (1, 3, 4, 1024), (2, 1, 1, 1024)])
def test_emulated_decomposition_is_bit_equal_to_plain(b, s, nh, hd):
    """C, n and m of the strip decomposition bit-equal to the plain
    version's (from a carried state); h within ``h_tolerance``, which a
    sum that leaves one row of C out does not meet."""
    q, k, v, i, f, C0, n0, m0 = _inputs(b, s, nh, hd, seed=hd + s)
    rows = torch.arange(b)
    out = torch.empty((b, nh * hd * hd))
    h, n, m = MS.mlstm_scan_plain(q, k, v, i, f, n0, m0, C0.reshape(b, -1),
                                  rows, [(out, rows)])
    C_e, n_e, m_e, h_e = _emulated_kernel(q, k, v, i, f, C0, n0, m0)
    assert torch.equal(_bits(C_e.reshape(b, -1)), _bits(out))
    assert torch.equal(_bits(n_e), _bits(n))
    assert torch.equal(_bits(m_e), _bits(m))
    tol = MS.h_tolerance(q, k, v, i, f, n0, m0, C0.reshape(b, -1), rows)
    assert bool(((h_e - h).abs() <= tol).all())
    h_bad = _emulated_kernel(q, k, v, i, f, C0, n0, m0, skip_row=True)[3]
    assert not bool(((h_bad - h).abs() <= tol).all())


def _tf32(x):
    """Round to TF32 (10-bit mantissa, to nearest, ties away from zero) on
    the bit pattern, as the kernel's ``tf32``."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & 0xFFFFE000).to(torch.int32).view(torch.float32)


def _mm3(a, b):
    """The kernel's 3xTF32 product a @ b: lo*hi + hi*lo + hi*hi, each
    operand split as hi = tf32(x), lo = tf32(x - hi)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulated_chunks(q, k, v, i, f, C0, n0, m0, chunk=MS.CHUNK,
                     drop=None, mm=_mm3):
    """The chunkwise kernel's decomposition in torch: the plain version's
    m chain, the chunk's log-forget summed in float64 (each step clamped
    at -1e4) and its exponents rounded to float once, D q . k~ and the
    carried C^T q as 3xTF32 products, the state updated once a chunk.
    ``drop`` leaves that position's k v^T out of everything, ``mm`` takes
    the products (faults the bounds must catch).  Returns (C, n, m, h)."""
    b, s, nh, hd = q.shape
    sq = torch.full((), math.sqrt(hd))
    C, n, m = C0.clone(), n0.clone(), m0.clone()
    h = torch.empty_like(q)
    for c0 in range(0, s, chunk):
        lc = min(chunk, s - c0)
        a, bb = [], []
        for t in range(c0, c0 + lc):
            fm = f[:, t] + m
            m_new = torch.maximum(fm, i[:, t])
            a.append(fm - m_new)
            bb.append(i[:, t] - m_new)
            m = m_new
        cum = torch.cumsum(torch.stack(a, -1).double().clamp_min(-1e4), -1)
        g = torch.exp(cum.float())                         # [b, nh, lc]
        arg = torch.stack(bb, -1).double()[..., None, :] \
            + (cum[..., :, None] - cum[..., None, :])
        keep = torch.ones(lc, lc).tril().bool()
        if drop is not None and c0 <= drop < c0 + lc:
            keep[:, drop - c0] = False
        dt = torch.where(keep, torch.exp(arg.float()) / sq,
                         torch.zeros(()))                  # D / sqrt(hd)
        qc, kc, vc = (x[:, c0:c0 + lc].transpose(1, 2) for x in (q, k, v))
        P = dt * mm(qc, kc.transpose(-1, -2))
        nq = (qc.double() * n.double()[..., None, :]).sum(-1).float()
        den = torch.clamp_min((P.double().sum(-1).float() + g * nq).abs(),
                              1.0)
        num = g[..., None] * mm(qc, C) + mm(P, vc)
        h[:, c0:c0 + lc] = (num / den[..., None]).transpose(1, 2)
        wt = dt[..., lc - 1, :]
        C = g[..., -1, None, None] * C \
            + mm(kc.transpose(-1, -2), wt[..., None] * vc)
        n = g[..., -1, None] * n \
            + (wt.double()[..., None] * kc.double()).sum(-2).float()
    return C, n, m, h


def _chunk_case(b, nh, hd, s, carried, seed):
    """Seeded inputs (``_inputs``) from a carried state, or from the zero
    state (source row -1, n 0, m -1e30)."""
    q, k, v, i, f, C0, n0, m0 = _inputs(b, s, nh, hd, seed)
    if not carried:
        C0, n0 = torch.zeros_like(C0), torch.zeros_like(n0)
        m0 = torch.full_like(m0, -1e30)
    rows = torch.arange(b) if carried else torch.full((b,), -1)
    return (q, k, v, i, f, n0, m0), C0, rows


def _within_bounds(data, C0, rows, emulated):
    """(m bit-equal, C and n within their bounds, h within its bound;
    ``tolerances``) of ``emulated`` (C, n, m, h) against the plain
    version."""
    b, _, nh, hd = data[0].shape
    src = C0.reshape(b, -1)
    out = torch.empty((b, nh * hd * hd))
    h, n, m = MS.mlstm_scan_plain(*data, src, rows, [(out, torch.arange(b))])
    tol_h, tol_c, tol_n = MS.tolerances(*data, src, rows)
    C_e, n_e, m_e, h_e = emulated
    return (torch.equal(_bits(m_e), _bits(m)),
            bool(((C_e.reshape(b, -1) - out).abs()
                  <= tol_c.reshape(b, -1)).all())
            and bool(((n_e - n).abs() <= tol_n).all()),
            bool(((h_e - h).abs() <= tol_h).all()))


@pytest.mark.parametrize("b,nh,hd,s,carried", [
    (2, 2, 32, MS.CHUNK - 1, False), (2, 2, 32, MS.CHUNK, True),
    (2, 2, 32, MS.CHUNK + 1, False), (2, 2, 32, 2 * MS.CHUNK + 3, True),
    (1, 4, 64, MS.CHUNK - 1, True), (1, 4, 64, MS.CHUNK, False),
    (1, 4, 64, MS.CHUNK + 1, True), (1, 4, 64, 2 * MS.CHUNK + 3, False),
    (1, 1, 1024, MS.CHUNK - 1, False), (1, 1, 1024, MS.CHUNK, True),
    (1, 1, 1024, MS.CHUNK + 1, True)])
def test_chunked_decomposition_is_within_the_bounds(b, nh, hd, s, carried):
    """The chunkwise kernel's decomposition (``_emulated_chunks``) against
    the plain version, from the zero and from a carried state, over
    chunk boundaries: m bit-equal, C, n and h within ``tolerances`` (the
    bounds the card holds the kernel to)."""
    data, C0, rows = _chunk_case(b, nh, hd, s, carried, seed=hd + s)
    emulated = _emulated_chunks(*data[:5], C0, *data[5:])
    assert _within_bounds(data, C0, rows, emulated) == (True, True, True)


@pytest.mark.parametrize("hd,s,drop", [(32, MS.CHUNK + 1, MS.CHUNK - 1),
                                       (64, 2 * MS.CHUNK + 3, 5)])
def test_chunked_decomposition_without_one_position_fails_the_bounds(
        hd, s, drop):
    """The bounds are tight enough to see one position's k v^T left out:
    the state and the outputs from it on fail them."""
    data, C0, rows = _chunk_case(2, 2, hd, s, True, seed=hd)
    emulated = _emulated_chunks(*data[:5], C0, *data[5:], drop=drop)
    m_ok, c_ok, h_ok = _within_bounds(data, C0, rows, emulated)
    assert m_ok and not c_ok and not h_ok


def test_chunked_decomposition_with_one_tf32_pass_fails_the_c_bound():
    """The bounds see the 3xTF32 split: the same decomposition with one
    TF32 pass a product (operands rounded to TF32, as a kernel without
    the split would give them to the tensor cores) misses the C bound."""
    data, C0, rows = _chunk_case(2, 2, 32, MS.CHUNK + 1, True, seed=32)
    emulated = _emulated_chunks(*data[:5], C0, *data[5:],
                                mm=lambda a, b: _tf32(a) @ _tf32(b))
    m_ok, c_ok, _ = _within_bounds(data, C0, rows, emulated)
    assert m_ok and not c_ok


def test_plain_writes_each_destination_and_reads_source_rows():
    """Rows of a 2-D buffer: C read from the source rows (-1 a zero C),
    written to two destinations at other rows and the same columns; the
    columns past C and every other row untouched; in place (the source
    is a destination) equal to out of place."""
    b, s, nh, hd = 3, 2, 2, 32
    q, k, v, i, f, C0, n0, m0 = _inputs(b, s, nh, hd, seed=5)
    cols = nh * hd * hd
    pages = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (6, cols + 7)).astype(np.float32))
    pages[[4, 1, 0], :cols] = C0.reshape(b, -1)
    host = torch.zeros((5, cols + 7))
    src = torch.tensor([4, 1, -1])
    at_h, at_host = torch.tensor([4, 1, 5]), torch.tensor([2, 0, 4])
    before = pages.clone()
    h, n, m = MS.mlstm_scan_plain(q, k, v, i, f, n0, m0, pages, src,
                                  [(pages, at_h), (host, at_host)])
    C_want = C0.clone()
    C_want[2] = 0.0
    Cw, nw, mw, hw = MS.mlstm_loop(C_want, n0, m0, q, k, v, i, f)
    assert torch.equal(h, hw) and torch.equal(n, nw) and torch.equal(m, mw)
    for row, at in enumerate(at_h.tolist()):
        assert torch.equal(pages[at, :cols], Cw[row].reshape(-1))
    for row, at in enumerate(at_host.tolist()):
        assert torch.equal(host[at, :cols], Cw[row].reshape(-1))
    assert torch.equal(pages[:, cols:], before[:, cols:])
    for row in (0, 2, 3):
        assert torch.equal(pages[row], before[row])
    assert float(host[[1, 3]].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# the paged decode branch
# ---------------------------------------------------------------------------

PAGE, N_ROW, HBM, N_LOGICAL = 4, 5, 16, 20
TABLES = np.asarray([[3, 7, 1, -1, -1, 12],
                     [0, 2, 5, 9, 11, 13],
                     [-1, -1, -1, -1, -1, -1],
                     [4, 6, 8, 10, -1, 14]], np.int32)


def _case(name):
    """(tables, gid_tables, cur_pos) of a paged case; column 5 holds each
    row's state page.  Row 2 is dead in every case."""
    tables = TABLES.copy()
    cur = np.asarray([9, 18, -1, 13], np.int64)
    if name == "unmapped":           # live row 3's state page has no slot
        tables[3, 5] = -1
    elif name == "clamp_collides":   # dead row 2 clamps to live row 0's page
        tables[0, 5] = 0
        tables[1, 0] = 15
    elif name == "all_dead":
        cur = np.full((4,), -1, np.int64)
    gids = np.where(tables >= 0, tables + 3, -1).astype(np.int32)
    return tables, gids, cur


def _pools(cfg, seed=1):
    """Sinked pools filled with seeded values in [0.5, 1.5), sinks
    included (the sLSTM's normaliser clear of its floor)."""
    pools = SharedPagedPools.create(N_LOGICAL, HBM)
    pools.attach_layered(TM.slot_leaf_specs(cfg, PAGE), device="cpu")
    rng = np.random.default_rng(seed)
    for leaves in pools.kv_with_sink.values():
        for t in leaves:
            if t is not None:
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)
                                         .astype(np.float32)))
    return pools


def _old_mlstm_step(p, r, cfg, x, state):
    """The port's mLSTM decode step before the kernel: one cell over the
    dense state, k divided by a Python scalar."""
    up, gate = (x @ p.w_up[r])[:, 0], (x @ p.w_gate[r])[:, 0]
    conv, xc = TR.conv_step(state["conv"], up, p.conv[r])
    q, k, v, i, f = TR._mlstm_inputs(p, r, F.silu(xc)[:, None],
                                     cfg.num_kv_heads)
    q, k, v, i, f = q[:, 0], k[:, 0], v[:, 0], i[:, 0], f[:, 0]
    C, n, m = state["C"], state["n"], state["m"]
    k = k / math.sqrt(q.shape[-1])
    m_new = torch.maximum(f + m, i)
    i_p = torch.exp(i - m_new)[..., None]
    f_p = torch.exp(f + m - m_new)[..., None]
    n_new = f_p * n + i_p * k
    C_new = f_p[..., None] * C + i_p[..., None] * (k[..., :, None]
                                                   * v[..., None, :])
    num = torch.einsum("bhkv,bhk->bhv", C_new, q)
    den = torch.clamp_min(torch.einsum("bhk,bhk->bh", n_new, q).abs(), 1.0)
    h = num / den[..., None]
    y = TR._mlstm_out(p, r, h.reshape(h.shape[0], -1), gate)
    return y[:, None], {"C": C_new, "n": n_new, "m": m_new, "conv": conv}


def _old_core(params, cfg, kv, tables, gid_tables, tokens, cur_pos,
              state_cols):
    """The port's paged decode core before the kernel, for a config of
    recurrent slots only: every state page gathered whole, unpacked,
    stepped, packed and written through both tiers with ``index_put_``.
    Returns the logits."""
    b = tokens.shape[0]
    rows = torch.arange(b)
    active = cur_pos >= 0
    sink_hbm, sink_host = TM._sink_page(kv, "_hbm"), \
        TM._sink_page(kv, "_host")
    scol = state_cols.long().clamp_min(0)
    sslot = tables[rows, scol].long()
    sgid = gid_tables[rows, scol].long()
    svalid = active & (state_cols >= 0) & (sslot >= 0)
    s_read = sslot.clamp_min(0)
    s_hbm = torch.where(svalid, sslot, sink_hbm)
    s_host = torch.where(svalid, sgid, sink_host)
    x = L.embed(params.tok, cfg, tokens)
    for li, r, slot in TM._layers(params, cfg):
        hbm, host = kv["state_hbm"][li][r], kv["state_host"][li][r]
        h = L.rms_norm(x, slot.norm1[r])
        state = TM.unpack_state(hbm[s_read],
                                TR.zero_state(cfg, slot.kind, 1, "meta"))
        step = _old_mlstm_step if slot.kind.base == "mlstm" else TR.step
        out, new = step(slot.cell, r, cfg, h, state)
        flat = TM.pack_state(new)
        hbm.index_put_((s_hbm,), flat)
        host.index_put_((s_host,), flat)
        x, _ = TM._block_tail(slot, r, cfg, x + out, None)
    return L.unembed(params, cfg, L.rms_norm(x, params.final_norm))


@pytest.mark.parametrize("case", ["dead_row", "unmapped", "clamp_collides",
                                  "all_dead"])
def test_paged_branch_is_bit_equal_to_the_old_one(case):
    """Two decode steps in place on the state pages against the old
    unpack / step / pack / ``index_put_`` branch: live rows' logits and
    every page of both tiers but the sinks bit for bit, and only live
    rows' pages moved.  A dropped row steps from a zero C (the old branch
    read its clamped page), so its logits and the sinks are its own."""
    _, _, cfg, params = _models()
    tables, gids, cur = _case(case)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 4, 1))
    state_cols = torch.full((4,), N_ROW, dtype=torch.int64)
    new, old = _pools(cfg), _pools(cfg)
    fresh = _pools(cfg)
    live = torch.from_numpy((cur >= 0)
                            & (tables[np.arange(4), N_ROW] >= 0))
    for step in range(2):
        args = (torch.from_numpy(tables), torch.from_numpy(gids),
                torch.from_numpy(tokens[step]),
                torch.from_numpy(np.where(cur >= 0, cur + step, -1)))
        logits, _ = TM.decode_step_paged(params, cfg, new.kv_with_sink,
                                         *args, page_size=PAGE,
                                         state_cols=state_cols)
        ref = _old_core(params, cfg, old.kv_with_sink, *args,
                        state_cols=state_cols)
        assert torch.equal(logits[live], ref[live])
    for li in range(len(TM.state_slot_meta(cfg))):
        for tier in ("hbm", "host"):
            t_new = new.kv_with_sink[f"state_{tier}"][li]
            t_old = old.kv_with_sink[f"state_{tier}"][li]
            t_fresh = fresh.kv_with_sink[f"state_{tier}"][li]
            assert torch.equal(t_new[:, :-1], t_old[:, :-1]), (li, tier)
            # pages moved only where a live row wrote
            moved = (t_new[:, :-1] != t_fresh[:, :-1]).flatten(2).any(2) \
                .any(0).nonzero().flatten().tolist()
            cols = tables[:, N_ROW] if tier == "hbm" else gids[:, N_ROW]
            assert moved == sorted(int(c) for c in cols[live.numpy()])


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------


def test_route_rule(monkeypatch):
    """Without autograd (no grad mode, or nothing requiring grad) the
    sequence form goes through the wrapper; under autograd through the
    autograd Function with its backward (on the CPU the plain forward,
    the backward's plain version), with the same bits; and the wrapper
    takes only CPU and CUDA tensors."""
    _, _, cfg, params = _models()
    cell = params.segments[0][0].cell
    calls, grad_calls = [], []
    real = TR.mlstm_scan
    monkeypatch.setattr(TR, "mlstm_scan",
                        lambda *a: calls.append(1) or real(*a))
    real_grad = TR.mlstm_scan_grad
    monkeypatch.setattr(TR, "mlstm_scan_grad",
                        lambda *a: grad_calls.append(1) or real_grad(*a))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 4, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y, st = TR.mlstm_apply(cell, 0, cfg, x)
    assert calls == [1]
    TR.mlstm_apply(cell, 0, cfg, x)
    assert calls == [1, 1]
    xg = x.clone().requires_grad_(True)
    assert TR.plain_route(xg)
    assert not TR.plain_route(x)
    with torch.no_grad():
        assert not TR.plain_route(xg)
    yg, stg = TR.mlstm_apply(cell, 0, cfg, xg)
    assert calls == [1, 1] and grad_calls == [1]
    assert torch.equal(yg.detach(), y)
    assert all(torch.equal(stg[k].detach(), st[k]) for k in st)
    yg.square().sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
    assert float(xg.grad.abs().sum()) > 0
    q = torch.empty((1, 1, 1, 32), device="meta")
    g = torch.empty((1, 1, 1), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        MS.mlstm_scan(q, q, q, g, g, q[:, 0], g[:, 0], q[0, 0], g[0, 0],
                      [(q[0, 0], g[0, 0])])
