"""The sLSTM recurrence kernel's CPU side (``kernels/slstm_scan.py``).

On the CPU ``slstm_scan`` takes its plain version, so these tests hold
what the CUDA kernel is compared with on the card, and what surrounds it:

  * ``slstm_scan_plain`` against the reference's ``slstm_apply`` (from the
    zero state and from a carried one) and ``slstm_step`` on the cell of
    reduced xlstm-1.3b (4 heads of 16) with conv taps drawn
    from N(0, 0.5) (the reference's zero taps make the cell an identity),
    within the 1e-5 bar of ``tests/test_torch_recurrent.py``;
  * ``recurrent.slstm_apply`` / ``slstm_step`` bit-equal to the loop the
    port ran before this kernel (``_old_apply`` / ``_old_step`` below);
  * the kernel's decomposition emulated in torch -- blocks of 16 units of
    a head, each gate's dot product summed over 16 slices of the hd rows
    and the slices added in order, h_{t-1} read from the output at
    t - 1, the cell's functions in the kernel's forms -- against the
    plain version within ``tolerance``: one step from a seeded state,
    every position teacher-forced, and the whole sequence within the
    carried bound; an emulation that reads a stale h or drops a slice
    fails; the plain version in float32 against itself in float64 lies
    within the same bounds;
  * the route rule: under autograd the autograd Function with its
    backward (``recurrent.grad_route``; its own tests are
    ``tests/test_torch_slstm_grad.py``), on the meta device the loop
    (``recurrent.plain_route``); otherwise the wrapper;
  * the wrapper's refusals (``_check``, and a device it does not run on).

Inputs are drawn with numpy from seeds."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.models import recurrent as RR

import repro_torch.configs as TC
from repro_torch.kernels import slstm_scan as SS
from repro_torch.models import recurrent as TR
from repro_torch.models.config import parse_kind

TOL = 1e-5
F32_RTOL = 4e-6
CONV_STD = 0.5
_CACHE = {}


def _cell():
    """(ref cfg, ref sLSTM cell, port cfg, port Cell of one repeat) of
    reduced xlstm-1.3b from the reference's ``slstm_init``, conv taps
    drawn from N(0, 0.5), the leaves copied into the port's ``Cell``."""
    if not _CACHE:
        rcfg = dataclasses.replace(RC.reduced("xlstm-1.3b"), dtype="float32")
        tcfg = dataclasses.replace(TC.reduced("xlstm-1.3b"), dtype="float32")
        ref = jax.tree.map(np.asarray,
                           RR.slstm_init(jax.random.PRNGKey(0), rcfg)[0])
        ref["conv"] = np.random.default_rng(7).normal(
            0.0, CONV_STD, ref["conv"].shape).astype(np.float32)
        cell = TR.Cell(tcfg, parse_kind("slstm"), 1, "cpu")
        for name, leaf in ref.items():
            getattr(cell, name).data.copy_(torch.tensor(leaf)[None])
        _CACHE["m"] = (rcfg, jax.tree.map(jnp.asarray, ref), tcfg, cell)
    return _CACHE["m"]


def _close(t, r):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(r), atol=TOL,
                               rtol=F32_RTOL)


def _plain_from_x(cell, cfg, x, state, seq: bool):
    """The sLSTM slot's output and state with the recurrence through
    ``slstm_scan_plain``."""
    b, s, d = x.shape
    if state is None:
        state = TR.slstm_zero_state(cfg, b)
    if seq:
        xc, conv = TR._conv_seq(state["conv"], x, cell.conv[0])
    else:
        conv, xc = TR.conv_step(state["conv"], x[:, 0], cell.conv[0])
        xc = xc[:, None]
    nh = cell.r_gates.shape[1]
    wx = (F.silu(xc) @ cell.w_gates[0]).reshape(b, s, nh, 4 * d // nh)
    hs, c, n, m, h = SS.slstm_scan_plain(
        wx, cell.r_gates[0], *(state[k] for k in ("c", "n", "m", "h")))
    y = TR._slstm_out(cell, 0, hs.reshape(b, s, d))
    return y, {"c": c, "n": n, "m": m, "h": h, "conv": conv}


def test_plain_matches_the_reference_apply_and_step():
    """From the zero state over 5 tokens, from the carried state over 4
    more, then two decode steps: the slot's output and c, n, m, h, conv
    against the reference's ``slstm_apply`` / ``slstm_step``."""
    rcfg, ref, tcfg, cell = _cell()
    x = np.random.default_rng(2).standard_normal(
        (2, 11, rcfg.d_model)).astype(np.float32)
    ry, rst = RR.slstm_apply(ref, rcfg, jnp.asarray(x[:, :5]))
    ty, tst = _plain_from_x(cell, tcfg, torch.from_numpy(x[:, :5]), None,
                            True)
    _close(ty, ry)
    for key in rst:
        _close(tst[key], rst[key])
    ry, rst = RR.slstm_apply(ref, rcfg, jnp.asarray(x[:, 5:9]), rst)
    ty, tst = _plain_from_x(cell, tcfg, torch.from_numpy(x[:, 5:9]), tst,
                            True)
    _close(ty, ry)
    for t in (9, 10):
        ry, rst = RR.slstm_step(ref, rcfg, jnp.asarray(x[:, t:t + 1]), rst)
        ty, tst = _plain_from_x(cell, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                tst, False)
        _close(ty, ry)
        for key in rst:
            _close(tst[key], rst[key])


# ---------------------------------------------------------------------------
# the cell as the port ran it before the kernel
# ---------------------------------------------------------------------------


def _old_cell(st, wx, r_gates):
    c, n, m, h = st["c"], st["n"], st["m"], st["h"]
    b, nh, hd = h.shape
    gates = TR.reshape(wx, b, nh, 4 * hd) \
        + torch.einsum("bhk,hkg->bhg", h, r_gates)
    z, i, f, o = gates.split(hd, dim=-1)
    z, o, f = torch.tanh(z), torch.sigmoid(o), F.logsigmoid(f)
    m_new = torch.maximum(f + m, i)
    i_p = torch.exp(i - m_new)
    f_p = torch.exp(f + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = o * c_new / torch.clamp_min(n_new, 1e-6)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def _old_apply(p, r, cfg, x, state):
    b, s, d = x.shape
    xc, conv = TR._conv_seq(state["conv"], x, p.conv[r])
    wx = F.silu(xc) @ p.w_gates[r]
    st = {k: state[k] for k in ("c", "n", "m", "h")}
    hs = []
    for t in range(s):
        st = _old_cell(st, wx[:, t], p.r_gates[r])
        hs.append(st["h"])
    h = TR.reshape(torch.stack(hs, dim=1), b, s, d)
    return TR._slstm_out(p, r, h), dict(st, conv=conv)


def _old_step(p, r, cfg, x, state):
    conv, xc = TR.conv_step(state["conv"], x[:, 0], p.conv[r])
    st = _old_cell({k: state[k] for k in ("c", "n", "m", "h")},
                   F.silu(xc) @ p.w_gates[r], p.r_gates[r])
    y = TR._slstm_out(p, r, TR.reshape(st["h"], x.shape[0], -1))
    return y[:, None], dict(st, conv=conv)


def test_apply_and_step_are_bit_equal_to_the_old_loop():
    _, _, cfg, cell = _cell()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 6, cfg.d_model)).astype(np.float32))
    bits = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32))
    with torch.no_grad():
        zero = TR.slstm_zero_state(cfg, 3)
        y, st = TR.slstm_apply(cell, 0, cfg, x)
        y0, st0 = _old_apply(cell, 0, cfg, x, zero)
        assert bits(y, y0) and all(bits(st[k], st0[k]) for k in st0)
        y, st = TR.slstm_step(cell, 0, cfg, x[:, :1], st)
        y0, st0 = _old_step(cell, 0, cfg, x[:, :1], st0)
        assert bits(y, y0) and all(bits(st[k], st0[k]) for k in st0)
        y, st = TR.slstm_apply(cell, 0, cfg, x[:, 1:], st)
        y0, st0 = _old_apply(cell, 0, cfg, x[:, 1:], st0)
        assert bits(y, y0) and all(bits(st[k], st0[k]) for k in st0)


# ---------------------------------------------------------------------------
# the kernel's decomposition, and the bound it is held to
# ---------------------------------------------------------------------------


def _inputs(b, s, nh, hd, seed, carried=True):
    """Seeded wx [B, S, nh, 4 hd] ~ N(0, 1), r_gates ~ N(0, 1/nh) (the
    model's init), and a starting state: the zero state, or the state
    the plain version reaches from it over 5 positions of other data."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, scale=1.0: torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32))
    wx, r = t(b, s, nh, 4 * hd), t(nh, hd, 4 * hd, scale=nh ** -0.5)
    full = lambda v: torch.full((b, nh, hd), v)
    st = (full(0.0), full(1e-6), full(-1e30), full(0.0))
    if carried:
        st = SS.slstm_scan_plain(t(b, 5, nh, 4 * hd), r, *st)[1:]
    return (wx, r) + tuple(st)


def _emulated_kernel(wx, r, c, n, m, h, units=SS.UNITS, slices=SS.SLICES,
                     stale=False, drop_slice=False):
    """The CUDA kernel's decomposition in torch: each block of ``units``
    hidden units of a head sums its gate columns' dot products over
    ``slices`` slices of the hd rows, adds the slices in order and then
    wx, and runs the cell with the kernel's forms of its functions;
    h_{t-1} is read from the output at t - 1 (``stale``: at t - 2, a
    barrier that let a block run ahead); ``drop_slice`` leaves slice 1
    out.  Returns (h [B, S, nh, hd], c, n, m, h_last)."""
    b, s = wx.shape[:2]
    nh, hd, _ = r.shape
    out = torch.empty((b, s, nh, hd))
    c, n, m = c.clone(), n.clone(), m.clone()
    span = hd // slices
    for t in range(s):
        back = 2 if stale and t >= 2 else 1
        h_prev = h if t - back < 0 else out[:, t - back]
        for head in range(nh):
            for u0 in range(0, hd, units):
                cols = torch.cat([torch.arange(q * hd + u0, q * hd + u0 + units)
                                  for q in range(4)])
                w = r[head][:, cols]
                dot = None
                for sl in range(slices):
                    if drop_slice and sl == 1:
                        continue
                    ks = slice(sl * span, (sl + 1) * span)
                    part = h_prev[:, head, ks] @ w[ks]
                    dot = part if dot is None else dot + part
                g = wx[:, t, head][:, cols] + dot
                gz, gi, gf, go = g.split(units, dim=-1)
                us = slice(u0, u0 + units)
                z = torch.tanh(gz)
                o = 1.0 / (1.0 + torch.exp(-go))
                fl = torch.clamp_max(gf, 0.0) - torch.log1p(
                    torch.exp(-gf.abs()))
                fm = fl + m[:, head, us]
                m_new = torch.maximum(fm, gi)
                i_p, f_p = torch.exp(gi - m_new), torch.exp(fm - m_new)
                c_new = f_p * c[:, head, us] + i_p * z
                n_new = f_p * n[:, head, us] + i_p
                out[:, t, head, us] = o * c_new / torch.clamp_min(n_new,
                                                                  1e-6)
                c[:, head, us], n[:, head, us], m[:, head, us] = \
                    c_new, n_new, m_new
    return out, c, n, m, out[:, -1]


def _teacher_forced(fn, wx, r, c, n, m, h):
    """Every position of the sequence run as one position from the plain
    version's state at the position before, all at once (B S rows):
    returns h [B, S, nh, hd]."""
    b, s = wx.shape[:2]
    hs, states = [], []
    st = (c, n, m, h)
    for t in range(s):
        states.append(st)
        st = SS.slstm_scan_plain(wx[:, t:t + 1], r, *st)[1:]
    rows = lambda i: torch.cat([x[i] for x in states])
    got = fn(torch.cat([wx[:, t:t + 1] for t in range(s)]), r,
             *(rows(i) for i in range(4)))[0]
    return got.reshape(s, b, *got.shape[2:]).transpose(0, 1)


def _within(got, want, tol):
    return bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("b,s,nh,hd", [(2, 9, 4, 16), (1, 6, 2, 64)])
def test_emulated_decomposition_within_the_bounds(b, s, nh, hd):
    """One step from a seeded carried state, every position
    teacher-forced, and the whole sequence (carried bound): the
    emulation within ``tolerance`` of the plain version, and so is the
    plain version run in float64.  A stale h or a dropped slice fails."""
    wx, r, c, n, m, h = _inputs(b, s, nh, hd, seed=hd + s)
    hs, cp, np_, mp, hp = SS.slstm_scan_plain(wx, r, c, n, m, h)
    one, state_tol = SS.tolerance(wx[:, :1], r, c, n, m, h)
    got = _emulated_kernel(wx[:, :1], r, c, n, m, h)
    want = SS.slstm_scan_plain(wx[:, :1], r, c, n, m, h)
    assert _within(got[0], want[0], one)
    for k, i in (("c", 1), ("n", 2), ("m", 3)):
        assert _within(got[i], want[i], state_tol[k])
    assert not _within(_emulated_kernel(wx[:, :1], r, c, n, m, h,
                                        drop_slice=True)[0], want[0], one)
    forced = SS.tolerance(wx, r, c, n, m, h)[0]
    assert _within(_teacher_forced(_emulated_kernel, wx, r, c, n, m, h), hs,
                   forced)
    carried, _ = SS.tolerance(wx, r, c, n, m, h, carry=True)
    assert _within(_emulated_kernel(wx, r, c, n, m, h)[0], hs, carried)
    assert not _within(_emulated_kernel(wx, r, c, n, m, h, stale=True)[0],
                       hs, carried)
    d = lambda t: t.double()
    exact = lambda *a: SS.slstm_scan_plain(*(d(x) for x in a))
    assert _within(d(hs), _teacher_forced(exact, wx, r, c, n, m, h), forced)
    assert _within(d(hs), exact(wx, r, c, n, m, h)[0], carried)


def test_one_step_bound_is_tight_enough_to_see_a_row():
    """The one-step bound at xlstm-1.3b's head dim (4 heads of 512) from a
    carried state: float64 lies within it, and a dot product that leaves
    one row of r out does not."""
    wx, r, c, n, m, h = _inputs(1, 1, 4, 512, seed=11)
    want = SS.slstm_scan_plain(wx, r, c, n, m, h)[0]
    tol = SS.tolerance(wx, r, c, n, m, h)[0]
    d = lambda t: t.double()
    exact = SS.slstm_scan_plain(*(d(x) for x in (wx, r, c, n, m, h)))[0]
    assert _within(d(want), exact, tol)
    r_bad = r.clone()
    r_bad[:, 7] = 0.0
    assert not _within(SS.slstm_scan_plain(wx, r_bad, c, n, m, h)[0], want,
                       tol)


# ---------------------------------------------------------------------------
# the route rule and the refusals
# ---------------------------------------------------------------------------


def test_route_rule(monkeypatch):
    """Without autograd the cell goes through the wrapper; under autograd
    through the autograd Function with its backward, with the same bits
    and a gradient; a meta tensor takes the plain route, and the wrapper
    takes only CPU and CUDA tensors."""
    _, _, cfg, cell = _cell()
    calls, grad_calls = [], []
    real = TR.slstm_scan
    monkeypatch.setattr(TR, "slstm_scan",
                        lambda *a: calls.append(1) or real(*a))
    real_grad = TR.slstm_scan_grad
    monkeypatch.setattr(TR, "slstm_scan_grad",
                        lambda *a: grad_calls.append(1) or real_grad(*a))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 4, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y, st = TR.slstm_apply(cell, 0, cfg, x)
        TR.slstm_step(cell, 0, cfg, x[:, :1], st)
    assert calls == [1, 1]
    xg = x.clone().requires_grad_(True)
    yg, stg = TR.slstm_apply(cell, 0, cfg, xg)
    assert calls == [1, 1] and grad_calls == [1]
    assert torch.equal(yg.detach(), y)
    assert all(torch.equal(stg[k].detach(), st[k]) for k in st)
    yg.square().sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
    assert float(xg.grad.abs().sum()) > 0
    assert TR.plain_route(torch.empty(1, device="meta"))
    meta = torch.empty((1, 1, 1, 4 * 16), device="meta")
    st = torch.empty((1, 1, 16), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        SS.slstm_scan(meta, torch.empty((1, 16, 64), device="meta"), st, st,
                      st, st)


def test_check_refuses_what_the_kernel_does_not_take():
    wx, r, c, n, m, h = _inputs(2, 3, 4, 16, seed=1, carried=False)
    SS._check(wx, r, c, n, m, h)
    with pytest.raises(TypeError):
        SS._check(wx.double(), r, c, n, m, h)
    with pytest.raises(ValueError, match="shape"):
        SS._check(wx[..., :-16].contiguous(), r, c, n, m, h)
    with pytest.raises(ValueError, match="shape"):
        SS._check(wx, r, c[:1], n, m, h)
    with pytest.raises(ValueError, match="contiguous"):
        SS._check(wx, r, c.transpose(1, 2).contiguous().transpose(1, 2), n,
                  m, h)
    with pytest.raises(ValueError, match="at least one position"):
        SS._check(wx[:, :0], r, c, n, m, h)
    for hd in (24, 1024):
        args = _inputs(1, 1, 1, hd, seed=2, carried=False)
        with pytest.raises(ValueError, match="multiples of 16"):
            SS._check(*args)
