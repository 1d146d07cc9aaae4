"""The sLSTM backward's CPU side (``kernels/slstm_scan.py``).

On the CPU ``SlstmScanFunction`` runs ``slstm_save_plain`` forward and
``slstm_backward_plain`` backward -- the positions in reverse, a cell's
backward from its saved pre-activations and state, the recurrent
gradient one product with r_gates a position, as the CUDA backward kernel
runs them -- so these tests hold what the kernel is compared with on the
card:

  * one position's backward (``_cell_backward``) against autograd of the
    cell (``_cell_update``) from the same seeded states and incoming
    gradients: float64 to 1e-12 of the largest element, and the float32
    gate gradients within ``SS.grad_check``'s bar (``GRAD_MULT`` times
    float32 autograd's own largest distance from float64's);
  * the plain backward over a sequence against autograd of
    ``slstm_scan_plain`` (float64: 1e-9 of the largest element; float32:
    the bar) and against ``jax.vjp`` of a ``lax.scan`` over the
    reference's own ``_slstm_cell`` (the bar), from the zero and a
    carried state, with the final state's gradients too.  The sLSTM at
    the reference's init (r_gates fan-in nh) is chaotic at width, so a
    sequence is held at the reduced width (4 heads of 16) over 24
    positions at that init, and at 4 heads of 64 over 64 positions with
    r_gates at fan-in hd;
  * the CUDA kernel's summation order on the CPU: each recurrent gradient
    formed as hd / 16 partials, one a block of 16 units' 64 gate columns,
    summed in source order as the kernel's fixed tree, within the bar
    against float64 (a sum that drops one partial misses it);
  * the Function refusing a starting state that asks for a gradient, and
    a non-float32 input;
  * the route rule under autograd: through the Function (its outputs
    bit-equal to the wrapper's without autograd), the meta device
    through the plain loop.

The m stabiliser's gradient matters here only where max(n, 1e-6) takes
the 1e-6, which the recurrence does not reach (n >= min(n_0, 1) after a
position): a backward without it is no mutant these inputs can see (the
mLSTM's is, in ``tests/test_torch_mlstm_grad.py``)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.models import recurrent as RR

from repro_torch.kernels import slstm_scan as SS
from repro_torch.models import recurrent as TR

EXACT = 1e-9


def _inputs(b, s, nh, hd, fan_in, carried, seed):
    """numpy float32: wx ~ N(0, 1) [B, S, nh, 4 hd], r_gates ~ N(0,
    1 / fan_in), the zero state (c 0, n 1e-6, m -1e30, h 0) or a carried
    one (the plain recurrence's after 8 positions of other data), the
    output gradient ~ N(0, 1) and the final c, n, m, h's."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    out = dict(wx=n(b, s, nh, 4 * hd), r=n(nh, hd, 4 * hd) / fan_in ** 0.5)
    st = (np.zeros((b, nh, hd), np.float32),
          np.full((b, nh, hd), 1e-6, np.float32),
          np.full((b, nh, hd), -1e30, np.float32),
          np.zeros((b, nh, hd), np.float32))
    if carried:
        st = tuple(x.numpy() for x in SS.slstm_scan_plain(
            torch.from_numpy(n(b, 8, nh, 4 * hd)), torch.from_numpy(out["r"]),
            *(torch.from_numpy(x) for x in st))[1:])
    out.update(zip(("c", "n", "m", "h"), st))
    out.update(dh=n(b, s, nh, hd), wc=n(b, nh, hd), wn=n(b, nh, hd),
               wm=n(b, nh, hd), wh=n(b, nh, hd))
    return out


def _t(a, key, dt):
    return torch.from_numpy(a[key]).to(dt)


def _loss(a, out, dt):
    hs, c, n, m, h = out
    w = lambda k: _t(a, k, dt)
    return (hs * w("dh")).sum() + (c * w("wc")).sum() + (n * w("wn")).sum() \
        + (m * w("wm")).sum() + (h * w("wh")).sum()


def _grads(a, dt, fn):
    wx, r = _t(a, "wx", dt).requires_grad_(), _t(a, "r", dt).requires_grad_()
    out = fn(wx, r, *(_t(a, k, dt) for k in "cnmh"))
    _loss(a, out, dt).backward()
    return wx.grad, r.grad


def _plain(a, dt):
    """The plain backward after the plain forward, in ``dt``."""
    x = [_t(a, k, dt) for k in ("wx", "r", "c", "n", "m", "h")]
    hs, *_, saves = SS.slstm_save_plain(*x)
    dhs = _t(a, "dh", dt).clone()
    dhs[:, -1] += _t(a, "wh", dt)
    carries = tuple(_t(a, k, dt) for k in ("wc", "wn", "wm"))
    return SS.slstm_backward_plain(*x, hs, saves, dhs, carries)[:2]


def _jax(a):
    """``jax.vjp`` of a ``lax.scan`` over the reference's ``_slstm_cell``
    (float32), with the final state's cotangents."""
    st = {k: jnp.asarray(a[k]) for k in "cnmh"}

    def run(wx, r):
        b, s = wx.shape[:2]
        seq = jnp.swapaxes(wx.reshape(b, s, -1), 0, 1)
        final, hs = jax.lax.scan(lambda c, x: RR._slstm_cell(c, x, r), st,
                                 seq)
        return jnp.swapaxes(hs, 0, 1), final

    _, vjp = jax.vjp(run, jnp.asarray(a["wx"]), jnp.asarray(a["r"]))
    final = {"c": a["wc"], "n": a["wn"], "m": a["wm"], "h": a["wh"]}
    g = vjp((jnp.asarray(a["dh"]), {k: jnp.asarray(v)
                                    for k, v in final.items()}))
    return [torch.from_numpy(np.array(x)) for x in g]


def _assert_within(chk):
    for name, (dist, bar) in chk.items():
        assert dist <= bar, (name, dist, bar)


@pytest.mark.parametrize("hd,s,fan_in", [(16, 24, "nh"), (64, 64, "hd")])
@pytest.mark.parametrize("carried", [False, True])
def test_plain_backward_matches_autograd_and_the_reference(hd, s, fan_in,
                                                           carried):
    nh = 4
    a = _inputs(2, s, nh, hd, nh if fan_in == "nh" else hd, carried,
                seed=hd + s + carried)
    auto64 = _grads(a, torch.float64, SS.slstm_scan_plain)
    auto32 = _grads(a, torch.float32, SS.slstm_scan_plain)
    plain64, plain32 = _plain(a, torch.float64), _plain(a, torch.float32)
    for p, w in zip(plain64, auto64):
        assert float((p - w).abs().max()) <= EXACT * float(w.abs().max())
    _assert_within(SS.grad_check(plain32, auto32, auto64))
    _assert_within(SS.grad_check(_jax(a), auto32, auto64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_position_backward_matches_autograd_of_the_cell(seed):
    """One position at the reference's init and width (4 heads of 512 at
    fan-in nh: chaotic over a sequence, not over one position) from a
    seeded state and seeded incoming gradients."""
    rng = np.random.default_rng(seed)
    b, nh, hd = 2, 4, 512
    n = lambda *shape: rng.standard_normal(shape)
    g = n(b, nh, 4 * hd) * 3
    prev = (n(b, nh, hd), np.abs(n(b, nh, hd)) + 0.5, n(b, nh, hd))
    inc = (n(b, nh, hd), n(b, nh, hd), n(b, nh, hd), n(b, nh, hd))

    def autograd(dt):
        gt = torch.from_numpy(g).to(dt).requires_grad_()
        st = {k: torch.from_numpy(x).to(dt) for k, x in zip("cnm", prev)}
        out = SS._cell_update(st, gt)
        dh, dc, dn, dm = (torch.from_numpy(x).to(dt) for x in inc)
        ((out["h"] * dh).sum() + (out["c"] * dc).sum()
         + (out["n"] * dn).sum() + (out["m"] * dm).sum()).backward()
        return gt.grad, out

    def plain(dt):
        _, out = autograd(dt)
        x = [t.detach() for t in (out["c"], out["n"], out["m"])]
        p = [torch.from_numpy(v).to(dt) for v in prev]
        i = [torch.from_numpy(v).to(dt) for v in inc]
        return SS._cell_backward(torch.from_numpy(g).to(dt), *x, *p, *i)[0]

    a64, a32 = autograd(torch.float64)[0], autograd(torch.float32)[0]
    p64 = plain(torch.float64)
    assert float((p64 - a64).abs().max()) <= 1e-12 * float(a64.abs().max())
    _assert_within(SS.grad_check((plain(torch.float32),), (a32,), (a64,)))


def _blocked_rec(dg, r, drop=None):
    """The recurrent gradient sum_j r[h, k, j] dg[b, h, j] as the CUDA
    backward forms it: a partial a source block s (its units 16 s ..
    16 s + 15, their four gate columns each), the hd / 16 partials summed
    in four lanes of consecutive sources, each in order, then
    (l0 + l1) + (l2 + l3).  ``drop``: a source left out (a mutant)."""
    b, nh, g = dg.shape
    hd = g // 4
    src = hd // SS.UNITS
    part = torch.einsum("hkqsu,bhqsu->bhsk",
                        r.reshape(nh, hd, 4, src, SS.UNITS),
                        dg.reshape(b, nh, 4, src, SS.UNITS))
    per = -(-src // 4)
    lanes = []
    for lane in range(4):
        acc = torch.zeros_like(part[:, :, 0])
        for s in range(lane * per, min(lane * per + per, src)):
            if s != drop:
                acc = acc + part[:, :, s]
        lanes.append(acc)
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def _blocked_backward(a, drop=None):
    """float32: ``slstm_backward_plain``'s positions in reverse with each
    recurrent gradient from ``_blocked_rec``: (dwx, dr)."""
    x = [_t(a, k, torch.float32) for k in ("wx", "r", "c", "n", "m", "h")]
    wx, r, c0, n0, m0, h0 = x
    hs, *_, (gs, cs, ns, ms) = SS.slstm_save_plain(*x)
    dhs = _t(a, "dh", torch.float32).clone()
    dhs[:, -1] += _t(a, "wh", torch.float32)
    dc, dn, dm = (_t(a, k, torch.float32) for k in ("wc", "wn", "wm"))
    dwx = torch.empty_like(wx)
    rec = torch.zeros_like(h0)
    for t in range(wx.shape[1] - 1, -1, -1):
        prev = (cs[:, t - 1], ns[:, t - 1], ms[:, t - 1]) if t > 0 \
            else (c0, n0, m0)
        dwx[:, t], dc, dn, dm = SS._cell_backward(
            gs[:, t], cs[:, t], ns[:, t], ms[:, t], *prev, dhs[:, t] + rec,
            dc, dn, dm)
        rec = _blocked_rec(dwx[:, t], r, drop)
    return dwx, SS._dr(h0, hs, dwx)


@pytest.mark.parametrize("carried", [False, True])
def test_blocked_summation_order_within_the_bar(carried):
    """The kernel's partials and their fixed tree over 64 positions at 4
    heads of 64 (4 partials a sum), r_gates at fan-in hd: dwx and dr
    within ``grad_check``'s bar against float64 ``slstm_backward_plain``;
    dropping one partial misses it."""
    a = _inputs(2, 64, 4, 64, 64, carried, seed=11 + carried)
    plain32, plain64 = _plain(a, torch.float32), _plain(a, torch.float64)
    _assert_within(SS.grad_check(_blocked_backward(a), plain32, plain64))
    bad = SS.grad_check(_blocked_backward(a, drop=3), plain32, plain64)
    assert all(dist > bar for dist, bar in bad.values()), bad


def test_function_refuses_a_starting_state_with_a_gradient():
    a = _inputs(2, 5, 4, 16, 4, True, seed=3)
    wx = _t(a, "wx", torch.float32).requires_grad_()
    r = _t(a, "r", torch.float32)
    for j in range(4):
        st = [_t(a, k, torch.float32) for k in "cnmh"]
        st[j].requires_grad_()
        with pytest.raises(ValueError, match="starting state"):
            SS.slstm_scan_grad(wx, r, *st)
    st = [_t(a, k, torch.float32) for k in "cnmh"]
    with pytest.raises(TypeError, match="float32"):
        SS.slstm_scan_grad(wx.double(), r, *st)


def test_route_rule_under_autograd(monkeypatch):
    """Under autograd the recurrence goes through the Function, with the
    wrapper's bits; the meta device through the plain loop."""
    a = _inputs(2, 6, 4, 16, 4, True, seed=4)
    calls = []
    for name in ("slstm_scan", "slstm_scan_grad", "slstm_scan_plain"):
        real = getattr(TR, name)
        monkeypatch.setattr(TR, name, lambda *x, _n=name, _f=real:
                            calls.append(_n) or _f(*x))
    wx = _t(a, "wx", torch.float32).reshape(2, 6, -1)
    r = _t(a, "r", torch.float32)
    state = {k: _t(a, k, torch.float32) for k in "cnmh"}
    with torch.no_grad():
        h0, st0 = TR._slstm_scan(wx, r, state)
    assert calls == ["slstm_scan"]
    wg = wx.clone().requires_grad_()
    h1, st1 = TR._slstm_scan(wg, r, state)
    assert calls[1:] == ["slstm_scan_grad"]
    assert torch.equal(h1.detach(), h0)
    assert all(torch.equal(st1[k].detach(), st0[k]) for k in st0)
    h1.sum().backward()
    assert bool(torch.isfinite(wg.grad).all())
    meta = lambda t: torch.empty(t.shape, device="meta")
    TR._slstm_scan(meta(wx).requires_grad_(), meta(r),
                   {k: meta(v) for k, v in state.items()})
    assert calls[2:] == ["slstm_scan_plain"]
