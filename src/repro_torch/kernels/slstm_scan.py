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
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["slstm_cell", "slstm_scan", "slstm_scan_plain", "tolerance"]

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
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def slstm_cell(st, wx, r_gates):
    """One timestep.  ``st`` {c, n, m, h: [B, nh, hd]}, wx [B, nh, 4 hd],
    the input part of the gates; the recurrent part comes from st["h"]."""
    c, n, m, h = st["c"], st["n"], st["m"], st["h"]
    hd = h.shape[-1]
    gates = wx + torch.einsum("bhk,hkg->bhg", h, r_gates)
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
        *(t.data_ptr() for t in outs), ptr(ring), b, s, nh, hd,
        torch.cuda.current_stream(wx.device).cuda_stream)
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
