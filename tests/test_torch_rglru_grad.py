"""The RG-LRU backward's CPU side (``kernels/rglru_scan.py``).

On the CPU ``RglruScanFunction`` runs ``rglru_scan_plain`` forward and
``rglru_backward_plain`` backward -- the gates recomputed, the reverse
recurrence g_t = dh_t + a_{t+1} g_{t+1}, every gradient g_t times a
factor of the position -- so these tests hold what the CUDA backward
kernel is compared with on the card:

  * ``rglru_backward_plain`` against autograd of ``rglru_scan_plain``:
    float64 to 1e-12 of the largest element, float32 within
    ``grad_check``'s bar (``GRAD_MULT`` times float32 autograd's own
    largest distance from float64's), from the zero and a carried h0, at
    S = 1, 5, 64 and 130;
  * ``recurrent.rglru_apply`` under autograd (through the Function)
    against ``jax.vjp`` of the reference's ``rglru_apply`` on the cell of
    reduced recurrentgemma-2b (``tests/test_torch_rglru.py``'s: the
    reference's ``rglru_init``, conv taps drawn from N(0, 0.5)),
    from the zero state and from a carried one: the gradients of x, every
    leaf of the cell and the carried h, within ``VJP_RTOL`` of each one's
    largest element;
  * the CUDA kernel's order emulated in torch (float32): each chunk's
    (prod a, local u) from u = 0 in reverse, the carry into a chunk from
    the last chunk down through every later chunk's pair, the chunk in
    reverse from it; dlam as per-tile partials summed in (row, chunk)
    order -- within the bar against float64; a carry that drops one
    chunk's pair misses it; the kernel's present order (g scanned over dh
    first, the factors and products after, dlam's column of g kl summed
    in reverse) ``torch.equal`` to the six-array order it replaced, and
    a column summed in position order not;
  * the host side of the launch (``backward_plan``), the Function's
    refusal of a non-float32 input, and ``launch.train`` on reduced
    recurrentgemma-2b going through the backward.

At the reference's lam init and seeded gate products the clamp in
beta = sqrt(max(1 - a^2, 1e-6)) never takes (1 - a^2 >= 1e-4 here), so
the tie's gradient (``torch.clamp_min`` gives it to 1 - a^2,
``jnp.maximum`` splits it in halves) is not exercised by these inputs;
the inputs are not chosen around it.  Inputs are drawn with numpy from
seeds."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.models import recurrent as RR

import repro_torch.configs as TC
from repro_torch.kernels import rglru_scan as RS
from repro_torch.models import recurrent as TR

from test_torch_rglru import _cell

EXACT = 1e-12
# the port's gradients against the reference's, both float32: each within
# this share of the leaf's largest element (sums over rows and positions
# in other orders; the two scans' float32 roundings: the largest distance
# seen is 7e-7 of it, on lam)
VJP_RTOL = 5e-6


def _inputs(b, s, w, seed, carried=True):
    """numpy-seeded float32 ra, ia, xc ~ N(0, 1), lam as the model's init
    (a = exp(-8 softplus(lam)) in [0.9, 0.999]), h0 ~ N(0, 1) (zero if
    not ``carried``) and dh ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    ra, ia, xc = t(b, s, w), t(b, s, w), t(b, s, w)
    u = rng.uniform(0.9, 0.999, w)
    lam = torch.from_numpy(np.log(np.expm1(-np.log(u) / RS.RGLRU_C))
                           .astype(np.float32))
    h0 = t(b, w) if carried else torch.zeros((b, w))
    return (ra, ia, xc, lam, h0), t(b, s, w)


def _assert_within(chk):
    for name, (dist, bar) in chk.items():
        assert dist <= bar, (name, dist, bar)


@pytest.mark.parametrize("s", [1, 5, 64, 130])
@pytest.mark.parametrize("carried", [False, True])
def test_plain_backward_matches_autograd(s, carried):
    args, dh = _inputs(2, s, 32, seed=s + 7 * carried, carried=carried)
    a64 = [t.double() for t in args]
    want = RS._autograd_plain(a64, dh.double())
    got = RS.rglru_backward_plain(*a64, RS.rglru_scan_plain(*a64),
                                  dh.double())
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= EXACT * float(w.abs().max())
    got32 = RS.rglru_backward_plain(*args, RS.rglru_scan_plain(*args), dh)
    _assert_within(RS.grad_check(got32, *args, dh))


# ---------------------------------------------------------------------------
# the cell against the reference's jax.vjp
# ---------------------------------------------------------------------------

_LEAVES = ("w_a", "w_a2", "w_i", "w_i2", "lam", "conv", "w_x", "w_gate",
           "w_out")


@pytest.mark.parametrize("carried", [False, True])
def test_function_matches_the_reference_vjp(carried, monkeypatch):
    """The slot's output y and new h under a seeded cotangent each: the
    gradients of x, the cell's leaves and (carried) the state's h from
    ``rglru_apply`` through ``RglruScanFunction`` against ``jax.vjp`` of
    the reference's ``rglru_apply``."""
    rcfg, ref, tcfg, cell = _cell()
    rng = np.random.default_rng(11 + carried)
    b, s, d = 2, 70, rcfg.d_model
    w = tcfg.lru_width or d
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = (rng.standard_normal((b, w)) if carried
          else np.zeros((b, w))).astype(np.float32)
    conv = (rng.standard_normal((b, 3, w)) if carried
            else np.zeros((b, 3, w))).astype(np.float32)
    wy = rng.standard_normal((b, s, d)).astype(np.float32)
    wh = rng.standard_normal((b, w)).astype(np.float32)

    def ref_fn(p, xx, hh):
        y, st = RR.rglru_apply(p, rcfg, xx, {"h": hh, "conv": conv})
        return y, st["h"]

    _, vjp = jax.vjp(jax.jit(ref_fn), ref, jnp.asarray(x), jnp.asarray(h0))
    rp, rx, rh = vjp((jnp.asarray(wy), jnp.asarray(wh)))

    calls = []
    real = RS.rglru_scan_backward
    monkeypatch.setattr(RS, "rglru_scan_backward",
                        lambda *a: calls.append(1) or real(*a))
    for name in _LEAVES:
        getattr(cell, name).grad = None
        getattr(cell, name).requires_grad_(True)
    try:
        xt = torch.from_numpy(x).requires_grad_()
        ht = torch.from_numpy(h0).requires_grad_()
        y, st = TR.rglru_apply(cell, 0, tcfg, xt,
                               {"h": ht, "conv": torch.from_numpy(conv)})
        ((y * torch.from_numpy(wy)).sum()
         + (st["h"] * torch.from_numpy(wh)).sum()).backward()
        got = {name: getattr(cell, name).grad[0] for name in _LEAVES}
    finally:
        for name in _LEAVES:
            getattr(cell, name).requires_grad_(False)
    assert calls == [1]
    got.update(x=xt.grad, h=ht.grad)
    want = {name: np.asarray(rp[name]) for name in _LEAVES}
    want.update(x=np.asarray(rx), h=np.asarray(rh))
    for name, g in got.items():
        ref_g = want[name]
        bar = VJP_RTOL * float(np.abs(ref_g).max())
        dist = float(np.abs(g.numpy() - ref_g).max())
        assert dist <= bar, (name, dist, bar)


# ---------------------------------------------------------------------------
# the CUDA kernel's order
# ---------------------------------------------------------------------------


def _chunk_carries(a, dh, drop=None):
    """The kernel's chunks: [(t0, t1, carry)] a chunk, the carry into it
    from u = 0 through the (prod a, local u) pairs of every later chunk,
    the last first (``drop``: leaving chunk ``drop``'s out); each chunk
    but the first's pair from u = 0 in reverse (u_t = a_t (dh_t +
    u_{t+1})), as a tile publishes it."""
    s = a.shape[1]
    starts = list(range(0, s, RS.CHUNK))
    pairs = {}
    for c in range(1, len(starts)):
        t0, t1 = starts[c], min(s, starts[c] + RS.CHUNK)
        prod, u = torch.ones_like(a[:, 0]), torch.zeros_like(a[:, 0])
        for t in range(t1 - 1, t0 - 1, -1):
            u = a[:, t] * (dh[:, t] + u)
            prod = prod * a[:, t]
        pairs[c] = (prod, u)
    out = []
    for c, t0 in enumerate(starts):
        u = torch.zeros_like(a[:, 0])
        for j in range(len(starts) - 1, c, -1):
            if j != drop:
                u = pairs[j][0] * u + pairs[j][1]
        out.append((t0, min(s, t0 + RS.CHUNK), u))
    return out


def _emulated_kernel(ra, ia, xc, lam, h0, h, dh, drop=None):
    """The CUDA backward in torch as its six-array form ran it, over
    every (row, channel) at once, in float32: the factors once
    (``_grad_factors``, the kernel's order of operations); the chunks'
    carries (``_chunk_carries``); each chunk in reverse from its carry,
    every gradient g_t times its factor, dlam's partial a (row, chunk)
    summed in reverse position order; the partials summed in (row,
    chunk) order."""
    a, kr, ki, kx, kl, dsp = RS._grad_factors(ra, ia, xc, lam, h0, h)
    b, s, w = a.shape
    dra, dia, dxc = (torch.empty_like(a) for _ in range(3))
    carries = _chunk_carries(a, dh, drop)
    parts = torch.empty((b, len(carries), w))
    for c, (t0, t1, u) in enumerate(carries):
        acc = torch.zeros_like(h0)
        for t in range(t1 - 1, t0 - 1, -1):
            g = dh[:, t] + u
            dra[:, t], dia[:, t], dxc[:, t] = g * kr[:, t], g * ki[:, t], \
                g * kx[:, t]
            acc = acc + g * kl[:, t]
            u = a[:, t] * g
        parts[:, c] = acc
        if c == 0:
            dh0 = u
    total = torch.zeros_like(lam)
    for p in parts.reshape(-1, w):
        total = total + p
    return dra, dia, dxc, dsp * total, dh0


def _emulated_two_pass(ra, ia, xc, lam, h0, h, dh, forward_sum=False):
    """The CUDA backward as it runs now, in torch: a alone before the scan
    (the decay, ``_gate_parts``'s); each chunk in reverse from its carry
    (``_chunk_carries``), g_t kept over dh_t; then every element's factors
    (``_grad_factors``) and products, g_t kl_t kept over g_t; dlam's
    partial a (row, chunk) the column of g kl summed in reverse position
    order (``forward_sum``: in position order), the partials in (row,
    chunk) order."""
    a = RS._gate_parts(ra, ia, lam)[5]
    b, s, w = a.shape
    g = torch.empty_like(a)
    carries = _chunk_carries(a, dh)
    for c, (t0, t1, u) in enumerate(carries):
        for t in range(t1 - 1, t0 - 1, -1):
            g[:, t] = dh[:, t] + u
            u = a[:, t] * g[:, t]
        if c == 0:
            dh0 = u
    _, kr, ki, kx, kl, dsp = RS._grad_factors(ra, ia, xc, lam, h0, h)
    gl = g * kl
    parts = torch.empty((b, len(carries), w))
    for c, (t0, t1, _) in enumerate(carries):
        acc = torch.zeros_like(h0)
        for t in (range(t0, t1) if forward_sum
                  else range(t1 - 1, t0 - 1, -1)):
            acc = acc + gl[:, t]
        parts[:, c] = acc
    total = torch.zeros_like(lam)
    for p in parts.reshape(-1, w):
        total = total + p
    return g * kr, g * ki, g * kx, dsp * total, dh0


@pytest.mark.parametrize("b,s,w", [(2, 5, 16), (2, 130, 64), (1, 300, 32)])
def test_two_pass_order_is_bit_identical(b, s, w):
    """The kernel's order (a and dh in shared memory, the scan writing g,
    the factors after it, dlam's column of g kl summed in reverse) gives
    the six-array form's bits in all five gradients; summing dlam's
    column in position order does not."""
    args, dh = _inputs(b, s, w, seed=b + s + w)
    h = RS.rglru_scan_plain(*args)
    want = _emulated_kernel(*args, h, dh)
    got = _emulated_two_pass(*args, h, dh)
    for name, x, y in zip(RS.GRAD_NAMES, got, want):
        assert torch.equal(x, y), name
    if s > RS.CHUNK:
        other = _emulated_two_pass(*args, h, dh, forward_sum=True)
        assert not torch.equal(other[3], want[3])


@pytest.mark.parametrize("b,s,w", [(2, 5, 16), (2, 130, 64), (1, 300, 32)])
def test_emulated_kernel_within_the_bar(b, s, w):
    """The kernel's order within ``grad_check``'s bar at one chunk, a
    ragged last chunk and five chunks; past one chunk, a carry that drops
    a chunk's pair misses it on every gradient."""
    args, dh = _inputs(b, s, w, seed=b + s + w)
    h = RS.rglru_scan_plain(*args)
    _assert_within(RS.grad_check(_emulated_kernel(*args, h, dh), *args, dh))
    if s > RS.CHUNK:
        bad = RS.grad_check(_emulated_kernel(*args, h, dh, drop=1), *args,
                            dh)
        assert all(dist > bar for dist, bar in bad.values()), bad


@pytest.mark.parametrize("b,s,w", [(4, 256, 2560), (1, 64, 2560),
                                   (3, 65, 100), (2, 1, 64)])
def test_backward_plan(b, s, w):
    """A block a (row, strip) at S <= ``CHUNK``, a tile a (row, strip,
    chunk) above; a pair of words a (row, chunk but the first, channel)
    and a counter a strip after four control floats; a partial a (row,
    chunk, channel); above ``CHUNK`` a tile's shared memory (a and g),
    the tiles an SM and the waves on an H100.  At phase 50's shape the
    640 tiles hold at most 45 KB of shared memory each, at least five
    fit an SM, and they run in one wave."""
    plan = RS.backward_plan(b, s, w)
    chunks, strips = -(-s // RS.CHUNK), -(-w // RS.STRIP)
    blocks = b * strips * chunks
    tiles = chunks > 1
    assert plan == dict(chunks=chunks, blocks=blocks,
                        words=2 * b * (chunks - 1) * w + strips,
                        scratch=4 + 2 * (2 * b * (chunks - 1) * w + strips),
                        partials=b * chunks * w,
                        smem=2 * RS.CHUNK * RS.STRIP * 4 if tiles else 0,
                        per_sm=232448 // (2 * RS.CHUNK * RS.STRIP * 4 + 1024)
                        if tiles else None,
                        waves=-(-blocks // (plan["per_sm"] * 132)) if tiles
                        else None)
    if (b, s, w) == (4, 256, 2560):
        assert plan["blocks"] == 640 and plan["partials"] == 40960
        assert plan["smem"] <= 45 * 1024 and plan["per_sm"] >= 5
        assert plan["waves"] == 1


def test_backward_plan_refuses_grids_past_the_limits():
    with pytest.raises(ValueError, match="2\\^31"):
        RS.backward_plan(2 ** 14, 2 ** 20, 2 ** 12)
    with pytest.raises(ValueError, match="65535"):
        RS.backward_plan(65536, 3, 64)


def test_function_refuses_a_non_float32_input():
    args, _ = _inputs(2, 3, 16, seed=1)
    for j in range(5):
        bad = list(args)
        bad[j] = bad[j].double()
        with pytest.raises(TypeError, match="float32"):
            RS.rglru_scan_grad(*bad)


def test_train_launcher_runs_through_the_backward(monkeypatch, tmp_path):
    """``python -m repro_torch.launch.train --arch recurrentgemma-2b
    --reduced --device cpu`` reaches the backward once a RG-LRU layer and
    step (its heartbeat file in a temporary directory)."""
    from repro_torch.launch import train as launch_train
    monkeypatch.chdir(tmp_path)
    calls = []
    real = RS.rglru_scan_backward
    monkeypatch.setattr(RS, "rglru_scan_backward",
                        lambda *a: calls.append(1) or real(*a))
    launch_train.main(["--arch", "recurrentgemma-2b", "--reduced",
                       "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "8", "--log-every", "1"])
    cfg = TC.reduced("recurrentgemma-2b")
    layers = sum(rep * sum(k.startswith("rglru") for k in pat)
                 for pat, rep in cfg.segments)
    assert layers > 0 and len(calls) == 2 * layers
