"""The RG-LRU recurrence kernel's CPU side (``kernels/rglru_scan.py``).

On the CPU ``rglru_scan`` takes its plain version, so these tests hold
what the CUDA kernel is compared with on the card, and what surrounds it:

  * ``rglru_scan_plain`` against the reference's ``rglru_apply`` (from the
    zero state and from a carried one) and ``rglru_step`` on the cell of
    reduced recurrentgemma-2b (lru_width 64) with conv taps drawn from
    N(0, 0.5) (the reference's zero taps make the cell an identity),
    within the 1e-5 bar of ``tests/test_torch_recurrent.py``;
  * ``recurrent.rglru_apply`` / ``rglru_step`` bit-equal to the gates and
    scan the port ran before this kernel (``_old_apply`` / ``_old_step``
    below);
  * the kernel's one pass emulated in torch -- each chunk of ``CHUNK``
    positions' (prod a, local h) from h = 0, the carry into a chunk from
    h0 through every chunk before it in order, the chunk's scan from it
    over the same a and b, the gates in the kernel's forms -- within
    ``h_tolerance`` of the plain version, one chunk and several, at S = 1
    and on both sides of a chunk's edge, with forget gates near 1; a carry
    that skips a chunk fails; the plain version in float64 lies within
    the same bound;
  * the launch's host side (``launch_plan``): chunks, tiles (the
    ticket's range), published words and scratch at S = 1, 64, 65 and
    2600, B = 1 and 4;
  * the route rule: under autograd ``RglruScanFunction`` (the wrapper's
    bits, the backward through ``rglru_scan_backward``), on the meta
    device the plain version (``recurrent.plain_route``); otherwise the
    wrapper;
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
from repro_torch.kernels import rglru_scan as RS
from repro_torch.models import recurrent as TR
from repro_torch.models.config import parse_kind

TOL = 1e-5
F32_RTOL = 4e-6
CONV_STD = 0.5
_CACHE = {}


def _cell():
    """(ref cfg, ref RG-LRU cell, port cfg, port Cell of one repeat) of
    reduced recurrentgemma-2b from the reference's ``rglru_init``, conv
    taps drawn from N(0, 0.5), the leaves copied into the port's
    ``Cell``."""
    if not _CACHE:
        rcfg = dataclasses.replace(RC.reduced("recurrentgemma-2b"),
                                   dtype="float32")
        tcfg = dataclasses.replace(TC.reduced("recurrentgemma-2b"),
                                   dtype="float32")
        ref = jax.tree.map(np.asarray,
                           RR.rglru_init(jax.random.PRNGKey(0), rcfg)[0])
        ref["conv"] = np.random.default_rng(7).normal(
            0.0, CONV_STD, ref["conv"].shape).astype(np.float32)
        cell = TR.Cell(tcfg, parse_kind("rglru"), 1, "cpu")
        for name, leaf in ref.items():
            getattr(cell, name).data.copy_(torch.tensor(leaf)[None])
        _CACHE["m"] = (rcfg, jax.tree.map(jnp.asarray, ref), tcfg, cell)
    return _CACHE["m"]


def _close(t, r):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(r), atol=TOL,
                               rtol=F32_RTOL)


def _plain_from_x(cell, cfg, x, state, seq: bool):
    """The RG-LRU slot's output and state with the recurrence through
    ``rglru_scan_plain``."""
    if state is None:
        state = TR.rglru_zero_state(cfg, x.shape[0])
    gate = F.gelu(x @ cell.w_gate[0], approximate="tanh")
    if seq:
        xc, conv = TR._conv_seq(state["conv"], x @ cell.w_x[0], cell.conv[0])
    else:
        conv, xc = TR.conv_step(state["conv"], x[:, 0] @ cell.w_x[0],
                                cell.conv[0])
        xc, gate = xc[:, None], gate
    ra = (xc @ cell.w_a[0]) @ cell.w_a2[0]
    ia = (xc @ cell.w_i[0]) @ cell.w_i2[0]
    h = RS.rglru_scan_plain(ra, ia, xc, cell.lam[0], state["h"])
    return (h * gate) @ cell.w_out[0], {"h": h[:, -1], "conv": conv}


def test_plain_matches_the_reference_apply_and_step():
    """From the zero state over 5 tokens, from the carried state over 4
    more, then two decode steps: the slot's output and h, conv against
    the reference's ``rglru_apply`` / ``rglru_step``."""
    rcfg, ref, tcfg, cell = _cell()
    x = np.random.default_rng(2).standard_normal(
        (2, 11, rcfg.d_model)).astype(np.float32)
    ry, rst = RR.rglru_apply(ref, rcfg, jnp.asarray(x[:, :5]))
    ty, tst = _plain_from_x(cell, tcfg, torch.from_numpy(x[:, :5]), None,
                            True)
    _close(ty, ry)
    for key in rst:
        _close(tst[key], rst[key])
    ry, rst = RR.rglru_apply(ref, rcfg, jnp.asarray(x[:, 5:9]), rst)
    ty, tst = _plain_from_x(cell, tcfg, torch.from_numpy(x[:, 5:9]), tst,
                            True)
    _close(ty, ry)
    for t in (9, 10):
        ry, rst = RR.rglru_step(ref, rcfg, jnp.asarray(x[:, t:t + 1]), rst)
        ty, tst = _plain_from_x(cell, tcfg, torch.from_numpy(x[:, t:t + 1]),
                                tst, False)
        _close(ty, ry)
        for key in rst:
            _close(tst[key], rst[key])


# ---------------------------------------------------------------------------
# the cell as the port ran it before the kernel
# ---------------------------------------------------------------------------


def _old_gates(p, r, xc):
    rg = torch.sigmoid((xc @ p.w_a[r]) @ p.w_a2[r])
    ig = torch.sigmoid((xc @ p.w_i[r]) @ p.w_i2[r])
    log_a = -TR.RGLRU_C * F.softplus(p.lam[r]) * rg
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    return torch.exp(log_a), beta * (ig * xc)


def _old_scan(a, b):
    off = 1
    while off < a.shape[1]:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def _old_apply(p, r, cfg, x, state):
    gate = F.gelu(x @ p.w_gate[r], approximate="tanh")
    xc, conv = TR._conv_seq(state["conv"], x @ p.w_x[r], p.conv[r])
    a, b = _old_gates(p, r, xc)
    b = torch.cat([b[:, :1] + a[:, :1] * state["h"][:, None], b[:, 1:]],
                  dim=1)
    h = _old_scan(a, b)
    return (h * gate) @ p.w_out[r], {"h": h[:, -1], "conv": conv}


def _old_step(p, r, cfg, x, state):
    gate = F.gelu(x[:, 0] @ p.w_gate[r], approximate="tanh")
    conv, xc = TR.conv_step(state["conv"], x[:, 0] @ p.w_x[r], p.conv[r])
    a, b = _old_gates(p, r, xc)
    h = a * state["h"] + b
    return ((h * gate) @ p.w_out[r])[:, None], {"h": h, "conv": conv}


def test_apply_and_step_are_bit_equal_to_the_old_scan():
    _, _, cfg, cell = _cell()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 13, cfg.d_model)).astype(np.float32))
    bits = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32))
    with torch.no_grad():
        zero = TR.rglru_zero_state(cfg, 3)
        y, st = TR.rglru_apply(cell, 0, cfg, x)
        y0, st0 = _old_apply(cell, 0, cfg, x, zero)
        assert bits(y, y0) and all(bits(st[k], st0[k]) for k in st0)
        y, st = TR.rglru_step(cell, 0, cfg, x[:, :1], st)
        y0, st0 = _old_step(cell, 0, cfg, x[:, :1], st0)
        assert bits(y, y0) and all(bits(st[k], st0[k]) for k in st0)
        y, st = TR.rglru_apply(cell, 0, cfg, x[:, 1:], st)
        y0, st0 = _old_apply(cell, 0, cfg, x[:, 1:], st0)
        assert bits(y, y0) and all(bits(st[k], st0[k]) for k in st0)


# ---------------------------------------------------------------------------
# the kernel's pass, and the bound it is held to
# ---------------------------------------------------------------------------


def _inputs(b, s, w, seed, near_one=False):
    """Seeded gate products ra, ia ~ N(0, 1) (``near_one``: ra ~ N(-4, 1),
    so sigmoid(ra) is small and a close to 1), xc ~ N(0, 1), lam as the
    model's init (a = exp(-8 softplus(lam)) in [0.9, 0.999]) and h0 ~
    N(0, 1)."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    ra, ia, xc = t(b, s, w), t(b, s, w), t(b, s, w)
    if near_one:
        ra = ra - 4.0
    u = rng.uniform(0.9, 0.999, w)
    lam = torch.from_numpy(np.log(np.expm1(-np.log(u) / RS.RGLRU_C))
                           .astype(np.float32))
    return ra, ia, xc, lam, t(b, w)


def _emulated_kernel(ra, ia, xc, lam, h0, skip=None):
    """The CUDA kernel in torch, over every (row, channel) at once: the
    gates in the kernel's forms, computed once; each chunk but the last's
    (prod a, local h) from h = 0, as a tile publishes it; a chunk's carry
    from h0 through the pairs of every earlier chunk in order (``skip``:
    leaving chunk ``skip``'s out), then its scan from it over the same a
    and b.  Returns h [B, S, w]."""
    sig = lambda x: 1.0 / (1.0 + torch.exp(-x))
    sp = torch.where(lam > 20.0, lam, torch.log1p(torch.exp(lam)))
    log_a = (-8.0 * sp) * sig(ra)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) \
        * (sig(ia) * xc)
    s = ra.shape[1]
    starts = list(range(0, s, RS.CHUNK))
    summary = []
    for t0 in starts[:-1]:
        prod, h = torch.ones_like(h0), torch.zeros_like(h0)
        for t in range(t0, t0 + RS.CHUNK):
            h = a[:, t] * h + b[:, t]
            prod = prod * a[:, t]
        summary.append((prod, h))
    out = torch.empty_like(ra)
    for c, t0 in enumerate(starts):
        h = h0
        for j in range(c):
            if j != skip:
                h = summary[j][0] * h + summary[j][1]
        for t in range(t0, min(s, t0 + RS.CHUNK)):
            h = a[:, t] * h + b[:, t]
            out[:, t] = h
    return out


def _within(got, want, tol):
    return bool(((got.double() - want.double()).abs() <= tol).all())


@pytest.mark.parametrize("b,s,w,near_one", [(3, 1, 32, False),
                                            (1, 64, 16, False),
                                            (1, 65, 16, False),
                                            (2, 150, 64, False),
                                            (2, 150, 64, True)])
def test_emulated_passes_within_the_bound(b, s, w, near_one):
    """The emulated passes and the plain version in float64 within
    ``h_tolerance`` of the plain version; past one chunk, a carry that
    skips a chunk fails."""
    args = _inputs(b, s, w, seed=s + w, near_one=near_one)
    want = RS.rglru_scan_plain(*args)
    tol = RS.h_tolerance(*args)
    assert _within(_emulated_kernel(*args), want, tol)
    exact = RS.rglru_scan_plain(*(x.double() for x in args))
    assert _within(exact, want, tol)
    if s > RS.CHUNK:
        assert not _within(_emulated_kernel(*args, skip=0), want, tol)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("s", [1, 64, 65, 2600])
def test_launch_plan(b, s):
    """One chunk takes the plain scan and no scratch; past it a tile a
    (row, ``STRIP`` channels, chunk), a pair of words a (row, chunk but
    the last, channel), four control floats before them."""
    w = 2560
    plan = RS.launch_plan(b, s, w)
    chunks = {1: 1, 64: 1, 65: 2, 2600: 41}[s]
    assert plan["chunks"] == chunks
    if chunks == 1:
        assert plan == dict(chunks=1, tiles=0, words=0, scratch=0)
        return
    assert plan["tiles"] == b * (w // RS.STRIP) * chunks
    assert plan["words"] == 2 * b * (chunks - 1) * w
    # the 64-bit words start 16 bytes in: each pair is 16-byte aligned
    assert plan["scratch"] == 4 + 2 * plan["words"]


def test_launch_plan_refuses_a_ticket_past_the_grid():
    assert RS.launch_plan(1, 65, 2560)["tiles"] == 2 * 2560 // RS.STRIP
    with pytest.raises(ValueError, match="2\\^31"):
        RS.launch_plan(2 ** 14, 2 ** 20, 2 ** 12)


# ---------------------------------------------------------------------------
# the route rule and the refusals
# ---------------------------------------------------------------------------


def test_route_rule(monkeypatch):
    """Without autograd the cell goes through the wrapper; under autograd
    through ``RglruScanFunction`` (``rglru_scan_grad``), with the
    wrapper's bits and a gradient from ``rglru_scan_backward``; a meta
    tensor takes the plain route, under autograd too, and the wrapper
    takes only CPU and CUDA tensors."""
    _, _, cfg, cell = _cell()
    calls = []
    for name in ("rglru_scan", "rglru_scan_grad", "rglru_scan_plain"):
        real = getattr(TR, name)
        monkeypatch.setattr(TR, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    real_bwd = RS.rglru_scan_backward
    monkeypatch.setattr(RS, "rglru_scan_backward", lambda *a:
                        calls.append("backward") or real_bwd(*a))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 4, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y, st = TR.rglru_apply(cell, 0, cfg, x)
        TR.rglru_step(cell, 0, cfg, x[:, :1], st)
    assert calls == ["rglru_scan"] * 2
    xg = x.clone().requires_grad_(True)
    yg, stg = TR.rglru_apply(cell, 0, cfg, xg)
    assert calls[2:] == ["rglru_scan_grad"]
    assert torch.equal(yg.detach(), y)
    assert all(torch.equal(stg[k].detach(), st[k]) for k in st)
    yg.square().sum().backward()
    assert calls[3:] == ["backward"]
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
    assert float(xg.grad.abs().sum()) > 0
    meta = torch.empty((1, 2, 8), device="meta")
    assert TR.plain_route(meta)
    p = type("P", (), {})()
    p.w_a = p.w_i = [torch.empty((8, 1), device="meta")]
    p.w_a2 = p.w_i2 = [torch.empty((1, 8), device="meta")]
    p.lam = [torch.empty(8, device="meta")]
    TR._rglru_scan(p, 0, meta.requires_grad_(),
                   torch.empty((1, 8), device="meta"))
    assert calls[4:] == ["rglru_scan_plain"]
    with pytest.raises(ValueError, match="cpu or cuda"):
        RS.rglru_scan(meta, meta, meta, torch.empty(8, device="meta"),
                      torch.empty((1, 8), device="meta"))


def test_check_refuses_what_the_kernel_does_not_take():
    ra, ia, xc, lam, h0 = _inputs(2, 3, 16, seed=1)
    RS._check(ra, ia, xc, lam, h0)
    with pytest.raises(TypeError):
        RS._check(ra, ia, xc.double(), lam, h0)
    with pytest.raises(ValueError, match="shape"):
        RS._check(ra, ia[:, :2].contiguous(), xc, lam, h0)
    with pytest.raises(ValueError, match="shape"):
        RS._check(ra, ia, xc, lam[:8], h0)
    with pytest.raises(ValueError, match="shape"):
        RS._check(ra, ia, xc, lam, h0[:1])
    with pytest.raises(ValueError, match="contiguous"):
        RS._check(ra.transpose(0, 1).contiguous().transpose(0, 1), ia, xc,
                  lam, h0)
    with pytest.raises(ValueError, match="at least one position"):
        RS._check(ra[:, :0], ia[:, :0], xc[:, :0], lam, h0)
