"""The sLSTM recurrence over a sequence.

No Pallas kernel stands behind this one: the reference runs the sLSTM
recurrence as a ``lax.scan`` (``repro/models/recurrent.py::slstm_apply``,
:237, over ``_slstm_cell``, :204) and one cell a decode token
(``::slstm_step``, :245-251), which XLA compiles to one loop on the chip.
The port's plain loop over positions launches some fifteen small ops a
position and reads the recurrent weights [nh, hd, 4 hd] (16.8 MB a layer
at xlstm-1.3b's 4 heads of 512) from device memory at every one.  So the
port has a hand-written CUDA kernel for Hopper (``csrc/slstm_scan.cu``,
built for ``sm_90a`` with ``nvcc`` at first use and bound through
``ctypes``) that keeps its share of the weights in shared memory across
all positions, and beside it ``slstm_scan_plain``, the plain PyTorch
version: the per-position cell loop the port ran before.

``slstm_scan`` dispatches on the device of its inputs: a CPU tensor goes
to the plain version, a CUDA tensor goes to the kernel, and anything the
kernel does not take raises -- there is no fallback.  Every kernel
launch adds one to ``slstm_scan.launches`` (under CUDA graph capture to
``.captured``: ``_build.count_launch``).  The wrapper reads nothing back
to the host, so a CUDA graph captures the one-position launch.

Semantics.  ``wx`` f32 [B, S, nh, 4 hd] is the input part of the gates
(``silu(conv) @ w_gates`` split into heads: ``[z | i | f | o]``, each hd
wide),
``r_gates`` f32 [nh, hd, 4 hd] one repeat's recurrent weights, and ``c``,
``n``, ``m``, ``h`` f32 [B, nh, hd] the starting state (d = nh hd).  Each
position runs ``slstm_cell``: gates = wx_t + h_{t-1} @ r_gates[head],
z = tanh, o = sigmoid, f = log-sigmoid, m' = max(f + m, i),
i' = exp(i - m'), f' = exp(f + m - m'), c' = f' c + i' z, n' = f' n + i',
h' = o c' / max(n', 1e-6).  Returns h [B, S, nh, hd] and the final c, n,
m, h.

Numerics.  The kernel sums each gate's dot product h_{t-1} . r[:, g] in
another order than the plain version's einsum (fused multiply-adds over
each of ``SLICES`` slices of the hd rows, then the slices in order) and takes the
cell's functions from CUDA's math library (``tanhf``, ``expf``,
``log1pf``; the products and sums of c and n rounded on their own, as the
plain version rounds them).  ``tolerance`` bounds the difference of one
position from the same state by interval arithmetic in float64, with
u = 2^-24:

* each gate's pre-activation g differs by at most
  E_g = 2 gamma_hd sum_k |h_k| |r_kg| + (1 + gamma_hd) sum_k dh_k |r_kg|
  + 2 u |g| (gamma_hd = hd u / (1 - hd u): any order of hd products, fused
  or not, lies within gamma_hd of the exact sum times the sum of the
  terms' magnitudes, on each side; dh is the move carried in h, 0 for one
  step; 2 u |g| the two sides' rounding of wx + dot);
* a monotone function f (tanh, sigmoid, log-sigmoid, exp) of arguments
  within dx of x gives values at most |f(x + dx) - f(x - dx)| apart, plus
  16 u |f(x)| for the two sides' libraries (a few ulps each);
* a product moves by |x| dy + |y| dx + dx dy, a sum by the sum of the
  moves, each rounded result by 2 u of its magnitude on the two sides;
  m' = max(f + m, i) moves with the branch that wins when the two are
  further apart than their moves, else with the larger move;
* h' = o c' / N (N = max(n', 1e-6), which moves at most as n' does)
  moves by (d(o c') N + |o c'| dN) / (N max(N - dN, 1e-6)) + 4 u |h'|.

The bound is taken around the plain version's float32 trajectory, and a
move that overflows is infinite.
``tolerance(..., carry=True)`` carries the moves of c, n, m and h from
position to position: the bound on a whole sequence.  At the model's
initialisation (r_gates ~ N(0, 1/nh)) the recurrence is chaotic -- a
difference of one ulp grows to O(1) within some 30 positions, the plain
version in float32 against itself in float64 included -- and the carried
bound grows with it; it stays rigorous, and past its first positions it
says no more than |h| <= 1.  So a sequence is held on the card in three
ways: one step from a seeded state, every position teacher-forced (run
as one position from the plain version's state, each within the one-step
bound), and the whole sequence within the carried bound, its deviation
printed, beside the kernel's own sequence launch bit-identical to its
one-position launches chained on its own state.

The backward.  The reference trains through ``jax.grad`` of its
``lax.scan``; under autograd ``models.recurrent`` takes the autograd
Function ``SlstmScanFunction`` (``slstm_scan_grad``).  Its forward is the
kernel with the save option (``_launch(..., save=)``: each position's
pre-activations [B, S, nh, 4 hd] and c, n, m [B, S, nh, hd], 58.7 MB at
B = 4, S = 256, 4 heads of 512; every other output bit-identical with the
option on or off), its backward the backward kernel
(``slstm_scan_backward``, in ``csrc/slstm_scan.cu``: the positions in
reverse, a cooperative launch whose blocks own the forward's share of
r_gates, 16 units' 64 gate columns; at each position a block runs its
units' cell backward, forms its partial of the head's recurrent gradient
(its 64 columns' share of r_gates dg_t for every row of the head) and
publishes it as tagged words, and each block sums the hd / 16 partials
of its units in source order, a fixed tree, one round of reads a
position; one launch, counted in ``slstm_scan_backward.launches``), then
d r_gates = sum_{b,t} h_{t-1} (x) dg_t as one plain product.  On the
CPU the Function runs ``slstm_save_plain`` (``slstm_scan_plain``'s ops
with the same saves) and ``slstm_backward_plain``, the same
decomposition in torch (exact in float64 against autograd of
``slstm_scan_plain``).  The starting state
carries no gradient: the Function raises if c, n, m or h asks for one.
Head dims as the forward's (multiples of 16 up to ``MAX_HD``).

Its bar (``grad_check``): ``mlstm_scan.grad_check``'s, each gradient's
largest distance from a float64 run of the plain backward at most
``mlstm_scan.GRAD_MULT`` times the float32 plain run's own.  The
recurrence at the reference's init (r_gates fan-in nh) is chaotic at
width, and so is its backward: over a sequence the float32 gradients
leave float64's (and, at 4 heads of 512 over some 100 positions,
float32's range), so at that init the backward is held one position
at a time from the same saved state (two positions a row, the second's
gradients seeded), and over a sequence only at a reduced width and S,
or with r_gates at fan-in hd.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, mlstm_scan

__all__ = ["SlstmScanFunction", "grad_check", "slstm_cell",
           "slstm_backward_plain", "slstm_save_plain", "slstm_scan",
           "slstm_scan_backward", "slstm_scan_grad", "slstm_scan_plain",
           "tolerance"]

NAME = "slstm_scan"
NVCC_FLAGS = _build.BASE_FLAGS
#: hidden units a block owns (its 4 x UNITS gate columns of r_gates stay
#: in its shared memory); the head dim must be a multiple
UNITS = 16
#: slices of the hd rows a gate's dot product is summed over (a block's
#: 256 threads each take 4 of its 4 UNITS columns)
SLICES = 16
#: the largest head dim: the block's weights, 4 UNITS hd floats, then fill
#: 128 KB of shared memory
MAX_HD = 512
_lib = None
_RINGS: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(NAME, NVCC_FLAGS)
        fn = lib.slstm_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.slstm_scan_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def slstm_cell(st, wx, r_gates):
    """One timestep.  ``st`` {c, n, m, h: [B, nh, hd]}, wx [B, nh, 4 hd],
    the input part of the gates; the recurrent part comes from st["h"]."""
    return _cell_update(st, wx + torch.einsum("bhk,hkg->bhg", st["h"],
                                              r_gates))


def _cell_update(st, gates):
    """``slstm_cell`` from its pre-activations ``gates`` [B, nh, 4 hd]."""
    c, n, m = st["c"], st["n"], st["m"]
    hd = c.shape[-1]
    z, i, f, o = gates.split(hd, dim=-1)
    z, o, f = torch.tanh(z), torch.sigmoid(o), F.logsigmoid(f)
    m_new = torch.maximum(f + m, i)
    i_p = torch.exp(i - m_new)
    f_p = torch.exp(f + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = o * c_new / torch.clamp_min(n_new, 1e-6)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def slstm_scan_plain(wx, r_gates, c, n, m, h):
    """Plain PyTorch version of the kernel's function (module docstring):
    ``slstm_cell`` a position, as the reference's ``lax.scan``.  The CPU
    tests use it, the smoke run compares the kernel with it on the card,
    and autograd differentiates it."""
    st, hs = {"c": c, "n": n, "m": m, "h": h}, []
    for t in range(wx.shape[1]):
        st = slstm_cell(st, wx[:, t], r_gates)
        hs.append(st["h"])
    return torch.stack(hs, dim=1), st["c"], st["n"], st["m"], st["h"]


def _check(wx, r_gates, c, n, m, h) -> None:
    """Raise on what the kernel does not take."""
    ts = (wx, r_gates, c, n, m, h)
    if any(t.device != wx.device for t in ts):
        raise ValueError("all inputs must be on one device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("slstm_scan takes float32 inputs and state (got "
                        f"{[str(t.dtype) for t in ts]})")
    if r_gates.dim() != 3 or wx.dim() != 4:
        raise ValueError("shape mismatch: wx [B, S, nh, 4 hd], r_gates "
                         f"[nh, hd, 4 hd] (got {tuple(wx.shape)}, "
                         f"{tuple(r_gates.shape)})")
    nh, hd, g = r_gates.shape
    b = wx.shape[0]
    if g != 4 * hd or tuple(wx.shape[2:]) != (nh, g) or any(
            tuple(t.shape) != (b, nh, hd) for t in (c, n, m, h)):
        raise ValueError("shape mismatch: wx [B, S, nh, 4 hd], r_gates "
                         "[nh, hd, 4 hd], c / n / m / h [B, nh, hd] (got "
                         f"{[tuple(t.shape) for t in ts]})")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("slstm_scan needs contiguous inputs and state")
    if hd % UNITS or hd > MAX_HD:
        raise ValueError(f"the kernel takes head dims that are multiples of "
                         f"{UNITS} up to {MAX_HD} (got {hd})")
    if r_gates.data_ptr() % 16:
        raise ValueError("r_gates must start on a 16-byte boundary (the "
                         "kernel loads it four floats at a time)")
    if wx.shape[1] == 0:
        raise ValueError("slstm_scan needs at least one position")


def slstm_scan(wx, r_gates, c, n, m, h):
    """h [B, S, nh, hd] and the final c, n, m, h (module docstring).  CPU
    tensors take ``slstm_scan_plain``; CUDA tensors launch the kernel (a
    cooperative launch for S > 1, whose blocks wait on each other's
    tagged h words a position: it raises if they cannot all be
    resident)."""
    if wx.device.type == "cpu":
        return slstm_scan_plain(wx, r_gates, c, n, m, h)
    if wx.device.type != "cuda":
        raise ValueError(f"slstm_scan runs on cpu or cuda, not {wx.device}")
    return _launch(wx, r_gates, c, n, m, h)


def _launch(wx, r_gates, c, n, m, h, save=None):
    """The kernel on checked inputs, its launch counted: (h, c, n, m,
    h).  ``save``: the backward's saves (``_saves``), which the kernel
    fills and which change no other output."""
    _check(wx, r_gates, c, n, m, h)
    b, s, nh, _ = wx.shape
    hd = r_gates.shape[1]
    hs = torch.empty((b, s, nh, hd), device=wx.device)
    outs = [torch.empty_like(c) for _ in range(4)]
    if b == 0:
        return (hs, *outs)
    # the ring of tagged h words between positions: 2 B nh hd 64-bit
    # words, as float32 scratch (four floats a (row, unit))
    ring = _build.scratch(_RINGS, 4 * b * nh * hd, wx.device) \
        if s > 1 else None
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _load().slstm_scan_launch(
        wx.data_ptr(), r_gates.data_ptr(), c.data_ptr(), n.data_ptr(),
        m.data_ptr(), h.data_ptr(), hs.data_ptr(),
        *(t.data_ptr() for t in outs), ptr(ring),
        *((None,) * 4 if save is None else (t.data_ptr() for t in save)),
        b, s, nh, hd, torch.cuda.current_stream(wx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(slstm_scan)
    return (hs, *outs)


slstm_scan.launches = 0
slstm_scan.captured = 0


# ---------------------------------------------------------------------------
# the bound (module docstring)
# ---------------------------------------------------------------------------

_U = 2.0 ** -24
_FN = 16 * _U          # the two sides' libraries, relative
_RND = 2 * _U          # one rounded operation on both sides, relative


def _span(fn, x, dx):
    """|fn(x + dx) - fn(x - dx)| of a monotone ``fn``: how far apart two
    values of ``fn`` at arguments within dx of x can lie."""
    return (fn(x + dx) - fn(x - dx)).abs()


def _step_bound(st, wx, r, dev):
    """The moves of the next state's c, n, m, h (module docstring), the
    plain cell's in float64 from the state ``st``, whose c, n, m, h move
    by ``dev``."""
    c, n, m, h = (st[k] for k in "cnmh")
    hd = h.shape[-1]
    gamma = hd * _U / (1 - hd * _U)
    g = wx + torch.einsum("bhk,hkg->bhg", h, r)
    ra = r.abs()
    e = 2 * gamma * torch.einsum("bhk,hkg->bhg", h.abs(), ra) \
        + (1 + gamma) * torch.einsum("bhk,hkg->bhg", dev["h"], ra) \
        + _RND * g.abs()
    (gz, gi, gf, go), (ez, ei, ef, eo) = g.split(hd, -1), e.split(hd, -1)
    z, o, fl = torch.tanh(gz), torch.sigmoid(go), F.logsigmoid(gf)
    dz = _span(torch.tanh, gz, ez) + _FN * z.abs()
    do = _span(torch.sigmoid, go, eo) + _FN * o
    dfl = _span(F.logsigmoid, gf, ef) + _FN * fl.abs()
    a = fl + m
    da = dfl + dev["m"] + _RND * a.abs()
    m_new = torch.maximum(a, gi)
    dm = torch.where(a - gi > da + ei, da,
                     torch.where(gi - a > da + ei, ei,
                                 torch.maximum(da, ei)))
    xi, xf = gi - m_new, a - m_new
    i_p, f_p = torch.exp(xi), torch.exp(xf)
    di = _span(torch.exp, xi, ei + dm + _RND * xi.abs()) + _FN * i_p
    df = _span(torch.exp, xf, da + dm + _RND * xf.abs()) + _FN * f_p
    prod = lambda x, y, dx, dy: x.abs() * dy + y.abs() * dx + dx * dy
    c_new = f_p * c + i_p * z
    dc = prod(f_p, c, df, dev["c"]) + prod(i_p, z, di, dz) \
        + 2 * _RND * ((f_p * c).abs() + (i_p * z).abs())
    n_new = f_p * n + i_p
    dn = prod(f_p, n, df, dev["n"]) + di \
        + 2 * _RND * ((f_p * n).abs() + i_p)
    big_n = torch.clamp_min(n_new, 1e-6)
    oc = o * c_new
    dh = (prod(o, c_new, do, dc) * big_n + oc.abs() * dn) / (
        big_n * torch.clamp_min(big_n - dn, 1e-6)) \
        + 2 * _RND * (oc / big_n).abs()
    # a move that overflowed bounds nothing: infinite, not NaN
    inf = lambda t: torch.nan_to_num(t, nan=float("inf"))
    return {"c": inf(dc), "n": inf(dn), "m": inf(dm), "h": inf(dh)}


def tolerance(wx, r_gates, c, n, m, h, carry=False):
    """The bound on |h_kernel - h_plain| a position, [B, S, nh, hd], and on
    the final c, n, m (module docstring), from the starting state:
    returns (h bound, {c, n, m: bound}).  The bound is taken around the
    plain version's trajectory (``slstm_cell`` on the inputs' device), in
    float64.  ``carry=False``: each position from the plain version's
    state at the position before (one step, and teacher-forced);
    ``carry=True``: the moves carried along the whole sequence."""
    st = {"c": c, "n": n, "m": m, "h": h}
    zero = {k: torch.zeros_like(v, dtype=torch.float64)
            for k, v in st.items()}
    dev, r, out = zero, r_gates.double(), []
    for t in range(wx.shape[1]):
        dev = _step_bound({k: v.double() for k, v in st.items()},
                          wx[:, t].double(), r, dev if carry else zero)
        st = slstm_cell(st, wx[:, t], r_gates)
        out.append(dev["h"])
    return torch.stack(out, dim=1), {k: dev[k] for k in "cnm"}


# ---------------------------------------------------------------------------
# the backward (module docstring)
# ---------------------------------------------------------------------------

#: the backward's gradients, in ``slstm_scan_backward``'s order
GRAD_NAMES = ("dwx", "dr")
#: the gradients' bar: ``mlstm_scan.grad_check``'s, over these names
grad_check = functools.partial(mlstm_scan.grad_check, names=GRAD_NAMES)


def _saves(wx):
    """Empty saves of a call on wx: the pre-activations [B, S, nh, 4 hd]
    and c, n, m [B, S, nh, hd] a position."""
    b, s, nh, g = wx.shape
    return (torch.empty_like(wx),) + tuple(
        wx.new_empty((b, s, nh, g // 4)) for _ in range(3))


def slstm_save_plain(wx, r_gates, c, n, m, h):
    """``slstm_scan_plain`` (the same ops, the same bits) that also
    returns the backward's saves (``_saves``'s): (h [B, S, nh, hd], c, n,
    m, h, saves)."""
    st, hs = {"c": c, "n": n, "m": m, "h": h}, []
    saves = _saves(wx)
    for t in range(wx.shape[1]):
        gates = wx[:, t] + torch.einsum("bhk,hkg->bhg", st["h"], r_gates)
        st = _cell_update(st, gates)
        saves[0][:, t] = gates
        for j, key in enumerate("cnm"):
            saves[j + 1][:, t] = st[key]
        hs.append(st["h"])
    return (torch.stack(hs, dim=1), st["c"], st["n"], st["m"], st["h"],
            saves)


def _cell_backward(g, c, n, m, cp, np_, mp, dh, dc, dn, dm):
    """One position's backward (the module docstring's): the gate
    gradients [B, nh, 4 hd] and the carried dc, dn, dm, from the
    pre-activations g, the state after (c, n, m) and before (cp, np_, mp)
    the position, the h gradient dh and the carried gradients."""
    hd = c.shape[-1]
    gz, gi, gf, go = g.split(hd, dim=-1)
    z, o, fl = torch.tanh(gz), torch.sigmoid(go), F.logsigmoid(gf)
    fm = fl + mp
    i_p, f_p = torch.exp(gi - m), torch.exp(fm - m)
    big_n = torch.clamp_min(n, 1e-6)
    doc = dh / big_n
    dct = dc + doc * o
    dnt = dn + torch.where(n >= 1e-6, -(doc * (o * c)) / big_n,
                           torch.zeros_like(n))
    d_o = doc * c
    da = f_p * (dct * cp + dnt * np_)
    db = i_p * (dct * z + dnt)
    dmm = dm - da - db
    to_f = torch.where(fm > gi, 1.0, torch.where(fm < gi, 0.0, 0.5)) \
        .to(g.dtype)
    dfm = da + to_f * dmm
    dg = torch.cat([dct * i_p * (1 - z * z), db + (1 - to_f) * dmm,
                    dfm * torch.sigmoid(-gf), d_o * o * (1 - o)], dim=-1)
    return dg, dct * f_p, dnt * f_p, dfm


def _carries(c0, carries):
    """The final c, n, m gradients (``carries``, each None for zero, or
    None for all three) as three tensors."""
    return tuple(torch.zeros_like(c0) if x is None else x
                 for x in (carries or (None,) * 3))


def slstm_backward_plain(wx, r_gates, c0, n0, m0, h0, hs, saves, dhs,
                         carries=None):
    """Plain PyTorch version of the backward kernel: the positions in
    reverse from the forward's ``saves`` (module docstring), in the
    inputs' dtype.  ``dhs`` [B, S, nh, hd]: the outputs' h gradient (the
    final h's added at the last position); ``carries``: the final c, n, m
    gradients (None: zero).  Returns (dwx [B, S, nh, 4 hd], dr_gates
    [nh, hd, 4 hd], (dc, dn, dm) at the starting state)."""
    gs, cs, ns, ms = saves
    dc, dn, dm = _carries(c0, carries)
    dwx = torch.empty_like(wx)
    rec = torch.zeros_like(h0)
    for t in range(wx.shape[1] - 1, -1, -1):
        dh = dhs[:, t] + rec
        prev = (cs[:, t - 1], ns[:, t - 1], ms[:, t - 1]) if t > 0 \
            else (c0, n0, m0)
        dg, dc, dn, dm = _cell_backward(gs[:, t], cs[:, t], ns[:, t],
                                        ms[:, t], *prev, dh, dc, dn, dm)
        dwx[:, t] = dg
        rec = torch.einsum("bhg,hkg->bhk", dg, r_gates)
    return dwx, _dr(h0, hs, dwx), (dc, dn, dm)


def _dr(h0, hs, dwx):
    """d r_gates = sum over rows and positions of h_{t-1} (x) dg_t: one
    plain product."""
    hp = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    return torch.einsum("bshk,bshg->hkg", hp, dwx)


def slstm_scan_backward(wx, r_gates, c0, n0, m0, h0, hs, saves, dhs,
                        carries=None):
    """(dwx, dr_gates, (dc, dn, dm) at the starting state) of the
    recurrence (the module docstring's backward).  CPU tensors take
    ``slstm_backward_plain``; CUDA tensors launch the backward kernel (one
    launch, counted in ``slstm_scan_backward.launches``; d r_gates is one
    plain product after it) or raise."""
    if wx.device.type == "cpu":
        return slstm_backward_plain(wx, r_gates, c0, n0, m0, h0, hs, saves,
                                    dhs, carries)
    if wx.device.type != "cuda":
        raise ValueError(f"the backward runs on cpu or cuda, not "
                         f"{wx.device}")
    _check(wx, r_gates, c0, n0, m0, h0)
    dhs = dhs.contiguous()
    ts = (hs, dhs) + tuple(saves)
    if any(t.dtype != torch.float32 or t.device != wx.device
           or not t.is_contiguous() for t in ts):
        raise ValueError("the backward takes contiguous float32 h, dh and "
                         "saves on the inputs' device")
    b, s, nh, _ = wx.shape
    hd = r_gates.shape[1]
    dwx = torch.empty_like(wx)
    # the kernel carries them in place: copies
    dc, dn, dm = (x.clone().contiguous() for x in _carries(c0, carries))
    if b == 0:
        return dwx, torch.zeros_like(r_gates), (dc, dn, dm)
    # the ring of tagged partial recurrent gradients: 2 B nh (hd / UNITS)
    # hd 64-bit words, a partial a source block (4 MB at B = 4, 4 heads of
    # 512).  Its own allocation a call, not a cached scratch: it grows as
    # B hd^2 (1.07 GB at B = 1020), and a cache would hold the largest
    # call's for the process's life.
    ring = torch.empty(4 * b * nh * (hd // UNITS) * hd, dtype=torch.float32,
                       device=wx.device) if s > 1 else None
    err = _load().slstm_scan_bwd_launch(
        r_gates.data_ptr(), dhs.data_ptr(),
        *(t.data_ptr() for t in saves), c0.data_ptr(), n0.data_ptr(),
        m0.data_ptr(), dc.data_ptr(), dn.data_ptr(), dm.data_ptr(),
        dwx.data_ptr(), None if ring is None else ring.data_ptr(), b, s, nh,
        hd, torch.cuda.current_stream(wx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slstm_scan backward launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(slstm_scan_backward)
    return dwx, _dr(h0, hs, dwx), (dc, dn, dm)


slstm_scan_backward.launches = 0
slstm_scan_backward.captured = 0


class SlstmScanFunction(torch.autograd.Function):
    """The recurrence under autograd: wx, r_gates and the starting c, n,
    m, h -> (h [B, S, nh, hd], c, n, m, h).  On a card the forward is the
    kernel with its saves and the backward the backward kernel; on the
    CPU ``slstm_save_plain`` and ``slstm_backward_plain``.  The starting
    state carries no gradient: it raises if c, n, m or h asks for one."""

    @staticmethod
    def forward(ctx, wx, r_gates, c, n, m, h):
        if any(ctx.needs_input_grad[2:]):
            raise ValueError("the sLSTM backward gives no gradient to the "
                             "starting state (c, n, m, h)")
        if any(t.dtype != torch.float32 for t in (wx, r_gates, c, n, m, h)):
            raise TypeError("the sLSTM recurrence takes float32 inputs")
        if wx.device.type == "cuda":
            saves = _saves(wx)
            hs, *outs = _launch(wx, r_gates, c, n, m, h, save=saves)
        elif wx.device.type == "cpu":
            hs, *outs, saves = slstm_save_plain(wx, r_gates, c, n, m, h)
        else:
            raise ValueError(f"the sLSTM backward runs on cpu or cuda, not "
                             f"{wx.device}")
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(wx, r_gates, c, n, m, h, hs, *saves)
        return (hs, *outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dhs, dc, dn, dm, dh):
        wx, r_gates, c0, n0, m0, h0, hs, *saves = ctx.saved_tensors
        dhs = torch.zeros_like(hs) if dhs is None else dhs.clone()
        if dh is not None:
            dhs[:, -1] += dh
        dwx, dr, _ = slstm_scan_backward(wx, r_gates, c0, n0, m0, h0, hs,
                                         saves, dhs, (dc, dn, dm))
        return dwx, dr, None, None, None, None


def slstm_scan_grad(wx, r_gates, c, n, m, h):
    """(h [B, S, nh, hd], c, n, m, h) through ``SlstmScanFunction`` (the
    route under autograd)."""
    return SlstmScanFunction.apply(wx, r_gates, c, n, m, h)
