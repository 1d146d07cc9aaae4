"""The RG-LRU's gates and linear recurrence over a sequence.

No Pallas kernel stands behind this one: the reference runs the RG-LRU's
recurrence h_t = a_t h_{t-1} + b_t as a log-depth
``lax.associative_scan`` (``repro/models/recurrent.py::rglru_apply``,
:326; "the TPU-native formulation", its docstring says, where the GPU
reference uses a linear-scan kernel) and one update a decode token
(``::rglru_step``, :337-338).  The port's plain version is that scan as
log2(S) rounds of ``torch.cat`` over [B, S, w] after some eight full
passes of elementwise gates.  So the port has a hand-written CUDA kernel
for Hopper (``csrc/rglru_scan.cu``, built for ``sm_90a`` with ``nvcc`` at
first use and bound through ``ctypes``) that fuses the gates into a
chunked linear scan in one pass over its inputs, and beside it
``rglru_scan_plain``, the plain PyTorch version: the gates the port
computed before (``rglru_gates``), the state's h folded into the first
step as the reference folds it (``repro/models/recurrent.py:321``), then
``linear_scan``.

``rglru_scan`` dispatches on the device of its inputs: a CPU tensor goes
to the plain version, a CUDA tensor goes to the kernel, and anything the
kernel does not take raises -- there is no fallback.  Every call is one
kernel launch and adds one to ``rglru_scan.launches`` (under CUDA graph
capture to ``.captured``: ``_build.count_launch``): for S <= ``CHUNK``
(every decode step) a plain scan from h0, above it the one-pass kernel,
whose blocks hand each chunk's (prod a, local h) on through tagged words
in a scratch the wrapper sizes (``launch_plan``) and keeps per stream.
The wrapper reads nothing back to the host, so a CUDA graph captures
it.

Semantics.  ``ra`` and ``ia`` f32 [B, S, w] are the two low-rank gate
products before their sigmoid, ``(xc @ w_a) @ w_a2`` and
``(xc @ w_i) @ w_i2``; ``xc`` f32 [B, S, w] the conv output, ``lam`` f32
[w] and ``h0`` f32 [B, w] the starting state.  With
log a = (-8 softplus(lam)) sigmoid(ra), a = exp(log a),
b = sqrt(max(1 - exp(2 log a), 1e-6)) (sigmoid(ia) xc): h_t = a_t h_{t-1}
+ b_t from h_{-1} = h0.  Returns h [B, S, w].

Numerics (``h_tolerance``).  The kernel scans each chunk of ``CHUNK``
positions in order and carries into a chunk from h0 through every earlier
chunk's (prod a, local h) in order; the plain version runs a
Hillis-Steele scan.  Both compute h_t = sum_j (prod_{j<k<=t} a_k) b_j
(the term j = -1 being h0, with its product from 0) as products and
sums, so each term carries a relative error of at most gamma_n = n u /
(1 - n u) (u = 2^-24) on each side, n the roundings on its path: the kernel's (t - j) multiplies and at most
(t - j + 1) + ceil(S / CHUNK) adds (the carry's multiply by a chunk's
product counts among the former: the product of L factors takes L - 1);
the plain version's (t - j) multiplies and ceil(log2 S) + 1 adds.  With
M_t = a_t M_{t-1} + |b_t| (M_{-1} = |h0|) and T_t = a_t T_{t-1} + M_t
(T_t = sum_j (t - j + 1) (prod a) |b_j|), the two differ by at most
1.01 u (3 T_t + (ceil(S / CHUNK) + ceil(log2 S) + 3) M_t): 1.01 covers
gamma_n / (n u) up to n = 10^5.  The gates differ too (the two sides'
libraries, a few ulps each: 16 u relative on sigmoid, softplus and exp;
1 - exp(2 log a) loses what the exp's error is of the difference, and
the square root halves it): with da_t and db_t those moves, the
deviations they cause obey P_t = (a_t + da_t) P_{t-1} + da_t |h_{t-1}| +
db_t, and the bound is their sum plus 4 u |h_t|.  Since every a_t < 1, M,
T and P do not grow with S: the error does not either.

The backward (training).  With g_t the gradient of the loss in h_t
through every later position, g_t = dh_t + a_{t+1} g_{t+1} (g_S = 0), and
log a = ncs sigmoid(ra) (ncs = -8 softplus(lam)), 1 - a^2 = 1 -
exp(2 log a), beta = sqrt(max(1 - a^2, 1e-6)), b = beta sigmoid(ia) xc:

  db_t = g_t,  da_t = g_t h_{t-1} (h_{-1} = h0),  dh0 = a_0 g_0,
  d log a_t = a_t da_t + db_t (sigmoid(ia) xc) (-a^2 / beta), the second
      term only where 1 - a^2 >= 1e-6 (at the tie the gradient goes
      through 1 - a^2, as ``torch.clamp_min``'s does; ``jnp.maximum``,
      the reference's, splits a tie in halves),
  dra = d log a ncs sigmoid'(ra),  dia = db beta xc sigmoid'(ia),
  dxc = db beta sigmoid(ia),
  dlam = sum over rows and positions of d log a sigmoid(ra) times -8
      softplus'(lam) (1 above softplus's threshold of 20).

Each is g_t times a factor of the position's inputs and h_{t-1}
(``_grad_factors``: kr, ki, kx and kl, dlam's summand).
``rglru_backward_plain`` recomputes the gates, runs the reverse
recurrence as ``linear_scan`` over the flipped sequence and forms the
factors; ``rglru_scan_backward`` launches the hand-written backward in
``csrc/rglru_scan.cu`` on a card (one launch a call, counted in
``rglru_scan_backward.launches``: the forward's one-pass design turned
round, a tile publishing its chunk's (prod a, local u) for the earlier
chunks; dlam per-tile partials reduced in a fixed order by the last tile
of each strip of channels).  A tile keeps only a and dh in shared memory
(``BWD_SMEM``, 32 KB: ``BWD_PER_SM`` tiles an SM, so recurrentgemma-2b's
640 training tiles at B = 4, S = 256 run in one wave,
``backward_plan``'s ``waves``); its scan writes g over dh, then all its
warps form the factors from the inputs read again and write every
gradient, and dlam's partial is the column of g kl summed in reverse.
Bound: bytes, ra, ia, xc, h and dh read and dra, dia, dxc written once
(83.9 MB there: 25 us at 3.35 TB/s).  ``RglruScanFunction`` (``rglru_scan_grad``)
is the recurrence under autograd: ``rglru_scan`` forward, saving its
inputs and h (the backward recomputes the gates), the backward through
``rglru_scan_backward``; it gives all five inputs their gradients.

The backward's bar (``grad_tolerance``, ``grad_check``):
``mlstm_scan.grad_check``'s, as the sLSTM's -- each gradient's largest
distance from float64's at most ``GRAD_MULT`` times the largest distance
of float32 autograd of ``rglru_scan_plain`` (the route training took
before the backward kernel) from the same float64 gradients.  Both the
kernel's order and the log-depth scan's sit at 1-2.4 times that distance
over the shapes of ``tests/test_torch_rglru_grad.py``: the gates' and
h's float32 rounding, common to every order, set it.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, mlstm_scan

__all__ = ["BWD_PER_SM", "BWD_SMEM", "CHUNK", "GRAD_MULT", "GRAD_NAMES",
           "H100_SMS", "RGLRU_C", "STRIP", "RglruScanFunction",
           "backward_blocks_per_sm", "backward_plan", "grad_check",
           "grad_tolerance", "h_tolerance", "launch_plan", "linear_scan",
           "rglru_backward_plain", "rglru_gates", "rglru_scan",
           "rglru_scan_backward", "rglru_scan_grad", "rglru_scan_plain"]

NAME = "rglru_scan"
NVCC_FLAGS = _build.BASE_FLAGS
#: RG-LRU's gate constant c in a = exp(-c softplus(lambda) r)
RGLRU_C = 8.0
#: positions a chunk of the kernel's scan (csrc/rglru_scan.cu's kChunk)
CHUNK = 64
#: channels a tile of the one-pass kernel (csrc/rglru_scan.cu's kStrip)
STRIP = 64
#: the scratch's control words (ticket, blocks that took one, epoch, pad)
_CTRL = 4
#: the S > CHUNK backward's shared memory a tile (csrc/rglru_scan.cu's
#: kBwdSmem: a and g, float32) and the tiles an SM it is built for
#: (kBwdBlocksPerSm: an SM's 232448 bytes over a tile's and the 1 KB the
#: card reserves a block)
BWD_SMEM = 2 * CHUNK * STRIP * 4
BWD_PER_SM = 232448 // (BWD_SMEM + 1024)
#: an H100 SXM's streaming multiprocessors
H100_SMS = 132
#: the backward's gradients, in the order it returns them
GRAD_NAMES = ("ra", "ia", "xc", "lam", "h0")
#: the backward's bar: this many times float32 autograd's own distance
GRAD_MULT = mlstm_scan.GRAD_MULT
_lib = None
_SCRATCH: dict = {}
# the backward's: the control words, tagged pairs and strip counters
# (zeroed), and dlam's per-tile partials (overwritten each call)
_BWD_SCRATCH: dict = {}
_BWD_PARTS: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(NAME, NVCC_FLAGS)
        fn = lib.rglru_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.rglru_scan_bwd_launch
        bwd.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        lib.rglru_scan_bwd_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.rglru_scan_bwd_blocks_per_sm.restype = ctypes.c_int
        _lib = lib
    return _lib


def _gate_parts(ra, ia, lam):
    """sigmoid(ra), sigmoid(ia), -8 softplus(lam), exp(2 log a), beta and a
    of each position (the forward's gates, and the backward's factors)."""
    rg, ig = torch.sigmoid(ra), torch.sigmoid(ia)
    ncs = -RGLRU_C * F.softplus(lam)
    log_a = ncs * rg
    e2 = torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - e2, 1e-6))
    return rg, ig, ncs, e2, beta, torch.exp(log_a)


def rglru_gates(ra, ia, xc, lam):
    """a and the gated input b of each position [..., w] from the gate
    products before their sigmoid."""
    _, ig, _, _, beta, a = _gate_parts(ra, ia, lam)
    return a, beta * (ig * xc)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over dim 1 (h_{-1} = 0) in log2(S) steps:
    each step folds in the prefix ``off`` positions back with the
    reference's combine (a_l, b_l), (a_r, b_r) -> (a_r a_l, a_r b_l +
    b_r)."""
    off = 1
    while off < a.shape[1]:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def rglru_scan_plain(ra, ia, xc, lam, h0):
    """Plain PyTorch version of the kernel's function (module docstring):
    ``rglru_gates``, h0 folded into the first step, ``linear_scan``.  The
    CPU tests use it, and the smoke run compares the kernel with it on the
    card."""
    a, b = rglru_gates(ra, ia, xc, lam)
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return linear_scan(a, b)


def _check(ra, ia, xc, lam, h0) -> None:
    """Raise on what the kernel does not take."""
    ts = (ra, ia, xc, lam, h0)
    if any(t.device != ra.device for t in ts):
        raise ValueError("all inputs must be on one device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("rglru_scan takes float32 inputs and state (got "
                        f"{[str(t.dtype) for t in ts]})")
    if (ra.dim() != 3 or ia.shape != ra.shape or xc.shape != ra.shape
            or tuple(lam.shape) != (ra.shape[2],)
            or tuple(h0.shape) != (ra.shape[0], ra.shape[2])):
        raise ValueError("shape mismatch: ra / ia / xc [B, S, w], lam [w], "
                         "h0 [B, w] (got "
                         f"{[tuple(t.shape) for t in ts]})")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("rglru_scan needs contiguous inputs and state")
    if ra.shape[1] == 0:
        raise ValueError("rglru_scan needs at least one position")


def launch_plan(b: int, s: int, w: int) -> dict:
    """What the wrapper computes on the host for a launch at [B, S, w]:
    ``chunks`` of ``CHUNK`` positions; ``tiles``, the one-pass kernel's
    blocks, each of which takes the next value of its ticket (0 for S <=
    ``CHUNK``: the plain scan, which takes no scratch); ``words``, the
    tagged 64-bit words the blocks publish, a (prod a, local h) pair a
    (row, chunk but the last, channel); ``scratch``, the float32 elements
    of the scratch: the four control words, then the words.  A word's tag
    is 32 bits, odd, from a 32-bit epoch the kernel advances each call:
    2^31 calls on a scratch before a tag recurs.  Raises where the ticket
    would pass the grid's 2^31 - 1 blocks."""
    chunks = -(-s // CHUNK)
    if chunks <= 1:
        return dict(chunks=chunks, tiles=0, words=0, scratch=0)
    tiles = b * -(-w // STRIP) * chunks
    if tiles >= 2 ** 31:
        raise ValueError(f"rglru_scan takes fewer than 2^31 tiles of "
                         f"({STRIP} channels, {CHUNK} positions) (got "
                         f"{tiles})")
    words = 2 * b * (chunks - 1) * w
    return dict(chunks=chunks, tiles=tiles, words=words,
                scratch=_CTRL + 2 * words)


def rglru_scan(ra, ia, xc, lam, h0):
    """h [B, S, w] (module docstring).  CPU tensors take
    ``rglru_scan_plain``; CUDA tensors launch the kernel."""
    if ra.device.type == "cpu":
        return rglru_scan_plain(ra, ia, xc, lam, h0)
    if ra.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cpu or cuda, not {ra.device}")
    _check(ra, ia, xc, lam, h0)
    b, s, w = ra.shape
    h = torch.empty_like(ra)
    if b == 0 or w == 0:
        return h
    need = launch_plan(b, s, w)["scratch"]
    # zeroed when allocated; the kernel leaves it ready for the next call
    scratch = (_build.scratch(_SCRATCH, need, ra.device, zero=True)
               if need else None)
    err = _load().rglru_scan_launch(
        ra.data_ptr(), ia.data_ptr(), xc.data_ptr(), lam.data_ptr(),
        h0.data_ptr(), h.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, s, w,
        torch.cuda.current_stream(ra.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(rglru_scan)
    return h


rglru_scan.launches = 0
rglru_scan.captured = 0


def h_tolerance(ra, ia, xc, lam, h0):
    """The bound ``rglru_scan``'s h is held to against the plain
    version's, [B, S, w] (module docstring), computed in float64 on the
    inputs' device from the plain version's gates and h."""
    u = 2.0 ** -24
    fn = 16 * u
    s = ra.shape[1]
    a32, b32 = rglru_gates(ra, ia, xc, lam)
    h = rglru_scan_plain(ra, ia, xc, lam, h0).double()
    a, b = a32.double(), b32.double()
    log_a = torch.log(a)
    # a = exp(log a), log a from two library values and two products
    da = a * (torch.expm1(log_a.abs() * (2 * fn + 4 * u)) + fn)
    # 1 - exp(2 log a) moves by what exp(2 log a) moves
    e2 = a * a
    de2 = e2 * (torch.expm1(2 * log_a.abs() * (2 * fn + 4 * u)) + fn)
    one_m = torch.clamp_min(1.0 - e2, 1e-6)
    de2 = de2 + 2 * u * one_m
    beta = one_m.sqrt()
    dbeta = (one_m + de2).sqrt() - torch.clamp_min(one_m - de2, 1e-6).sqrt()
    gated = (b / beta).abs()                 # |sigmoid(ia) xc|
    db = dbeta * gated + beta * gated * (fn + 4 * u) + dbeta * gated * fn
    h_prev = torch.cat([h0.double()[:, None].abs(), h[:, :-1].abs()], dim=1)
    # the deviation the gates' moves cause: P_t = (a + da) P + da |h| + db
    p = linear_scan(a + da, torch.cat([db[:, :1] + da[:, :1] * h_prev[:, :1],
                                       (da * h_prev + db)[:, 1:]], dim=1))
    mag = linear_scan(a, torch.cat([b[:, :1].abs() + a[:, :1]
                                    * h0.double()[:, None].abs(),
                                    b[:, 1:].abs()], dim=1))
    tri = linear_scan(a, mag)
    adds = -(-s // CHUNK) + math.ceil(math.log2(max(s, 1))) + 3
    return p + 1.01 * u * (3 * tri + adds * mag) + 4 * u * h.abs()


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------


def _grad_factors(ra, ia, xc, lam, h0, h):
    """a [B, S, w], the factors kr, ki, kx, kl [B, S, w] that g_t
    multiplies into dra, dia, dxc and dlam's summand (the module
    docstring's backward), and -8 softplus'(lam) [w], in the CUDA
    kernel's order of operations."""
    rg, ig, ncs, e2, beta, a = _gate_parts(ra, ia, lam)
    one_m = 1.0 - e2
    gx = ig * xc
    h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
    # d log a per unit of g: through a, and through beta where the clamp
    # passes it (its tie included)
    k1 = a * h_prev - torch.where(one_m >= 1e-6, gx * e2 / beta,
                                  torch.zeros_like(a))
    kl = k1 * rg
    kr = (kl * ncs) * (1.0 - rg)
    kx = beta * ig
    ki = (kx * xc) * (1.0 - ig)
    dsp = torch.where(lam > 20.0, torch.ones_like(lam), torch.sigmoid(lam))
    return a, kr, ki, kx, kl, -RGLRU_C * dsp


def rglru_backward_plain(ra, ia, xc, lam, h0, h, dh):
    """Plain PyTorch version of the backward kernel: (dra, dia, dxc
    [B, S, w], dlam [w], dh0 [B, w]) from the forward's inputs, its h
    and the gradient dh [B, S, w] of h (the module docstring's
    backward), in the inputs' dtype.  The gates are recomputed; g_t =
    dh_t + a_{t+1} g_{t+1} runs as ``linear_scan`` over the flipped
    sequence."""
    a, kr, ki, kx, kl, dsp = _grad_factors(ra, ia, xc, lam, h0, h)
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    g = linear_scan(a_next.flip(1), dh.flip(1)).flip(1)
    return (g * kr, g * ki, g * kx, dsp * (g * kl).sum((0, 1)),
            a[:, 0] * g[:, 0])


def _autograd_plain(args, dh):
    """The five gradients by autograd of ``rglru_scan_plain``."""
    x = [t.detach().clone().requires_grad_() for t in args]
    rglru_scan_plain(*x).backward(dh)
    return tuple(t.grad for t in x)


def grad_tolerance(ra, ia, xc, lam, h0, dh) -> dict:
    """{name: (float64 gradient, bar)} of the five gradients (the module
    docstring's bar): ``rglru_backward_plain`` on the inputs and dh in
    float64 (h from the float64 forward), and each one's bar, ``GRAD_MULT``
    times float32 autograd of ``rglru_scan_plain``'s largest distance from
    it, at least one float32 ulp of its largest element."""
    args = (ra, ia, xc, lam, h0)
    a64 = [t.double() for t in args]
    want = rglru_backward_plain(*a64, rglru_scan_plain(*a64), dh.double())
    own = _autograd_plain(args, dh)
    chk = mlstm_scan.grad_check(own, own, want, names=GRAD_NAMES,
                                mult=GRAD_MULT)
    return {name: (w, chk[name][1]) for name, w in zip(GRAD_NAMES, want)}


def grad_check(got, ra, ia, xc, lam, h0, dh) -> dict:
    """{name: (distance, bar)} of the gradients ``got`` (dra, dia, dxc,
    dlam, dh0) against ``grad_tolerance``'s; a gradient passes where
    distance <= bar."""
    tol = grad_tolerance(ra, ia, xc, lam, h0, dh)
    return {name: (float((g.double() - w.to(g.device)).abs().max()), bar)
            for g, (name, (w, bar)) in zip(got, tol.items())}


def backward_plan(b: int, s: int, w: int) -> dict:
    """What the backward's wrapper computes on the host at [B, S, w]:
    ``chunks`` of ``CHUNK`` positions; ``blocks``, the launch's blocks,
    each of which takes a ticket (S <= ``CHUNK``: a block a (row, strip of
    ``STRIP`` channels); above, a tile a (row, strip, chunk)); ``words``,
    the tagged 64-bit words: a (prod a, local g) pair a (row, chunk but the
    first, channel), then a counter a strip; ``scratch``, the zeroed
    float32 scratch: the four control words, then the words; ``partials``,
    the float32 elements of dlam's per-tile partials, one a (row, chunk,
    channel); above ``CHUNK``, ``smem``, a tile's shared bytes
    (``BWD_SMEM``), ``per_sm``, the tiles an SM the kernel is built for
    (``BWD_PER_SM``), and ``waves``, the rounds of tiles an H100's
    ``H100_SMS`` SMs take (0, None, None at S <= ``CHUNK``: the short
    kernel keeps nothing in shared memory).  Raises where the blocks
    would pass the grid's limits."""
    chunks = -(-s // CHUNK)
    strips = -(-w // STRIP)
    blocks = b * strips * chunks
    if chunks > 1 and blocks >= 2 ** 31:
        raise ValueError(f"the rglru_scan backward takes fewer than 2^31 "
                         f"tiles of ({STRIP} channels, {CHUNK} positions) "
                         f"(got {blocks})")
    if chunks <= 1 and b > 65535:
        raise ValueError(f"the rglru_scan backward takes at most 65535 rows "
                         f"at S <= {CHUNK} (got {b})")
    words = 2 * b * (chunks - 1) * w + strips
    tiles = chunks > 1
    return dict(chunks=chunks, blocks=blocks, words=words,
                scratch=_CTRL + 2 * words, partials=b * chunks * w,
                smem=BWD_SMEM if tiles else 0,
                per_sm=BWD_PER_SM if tiles else None,
                waves=-(-blocks // (BWD_PER_SM * H100_SMS)) if tiles
                else None)


def backward_blocks_per_sm(vec: bool = True) -> int:
    """The tiles of the S > ``CHUNK`` backward (``vec``: its 16-byte form)
    that one SM of the current card holds at once, as the card computes
    them from the built kernel's registers and shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = _load().rglru_scan_bwd_blocks_per_sm(int(vec))
    if n < 0:
        raise RuntimeError("the rglru_scan backward's occupancy query "
                           "failed")
    return n


def rglru_scan_backward(ra, ia, xc, lam, h0, h, dh):
    """(dra, dia, dxc, dlam, dh0) of the recurrence (the module
    docstring's backward) from its inputs, its output h and dh.  CPU
    tensors take ``rglru_backward_plain``; CUDA tensors launch the
    backward kernel (one launch, counted in
    ``rglru_scan_backward.launches``) or raise."""
    if ra.device.type == "cpu":
        return rglru_backward_plain(ra, ia, xc, lam, h0, h, dh)
    if ra.device.type != "cuda":
        raise ValueError(f"the rglru_scan backward runs on cpu or cuda, not "
                         f"{ra.device}")
    _check(ra, ia, xc, lam, h0)
    dh = dh.contiguous()
    if any(t.dtype != torch.float32 or t.device != ra.device
           or t.shape != ra.shape or not t.is_contiguous() for t in (h, dh)):
        raise ValueError("the rglru_scan backward takes contiguous float32 "
                         "h and dh [B, S, w] on the inputs' device")
    b, s, w = ra.shape
    dra, dia, dxc = (torch.empty_like(ra) for _ in range(3))
    dlam, dh0 = torch.empty_like(lam), torch.empty_like(h0)
    if b == 0 or w == 0:
        return dra, dia, dxc, dlam.zero_(), dh0
    plan = backward_plan(b, s, w)
    # zeroed when allocated; the kernel leaves it ready for the next call
    scratch = _build.scratch(_BWD_SCRATCH, plan["scratch"], ra.device,
                             zero=True)
    parts = _build.scratch(_BWD_PARTS, plan["partials"], ra.device)
    err = _load().rglru_scan_bwd_launch(
        ra.data_ptr(), ia.data_ptr(), xc.data_ptr(), lam.data_ptr(),
        h0.data_ptr(), h.data_ptr(), dh.data_ptr(), dra.data_ptr(),
        dia.data_ptr(), dxc.data_ptr(), dlam.data_ptr(), dh0.data_ptr(),
        scratch.data_ptr(), parts.data_ptr(), b, s, w,
        torch.cuda.current_stream(ra.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan backward launch failed: CUDA error "
                           f"{err}")
    _build.count_launch(rglru_scan_backward)
    return dra, dia, dxc, dlam, dh0


rglru_scan_backward.launches = 0
rglru_scan_backward.captured = 0


class RglruScanFunction(torch.autograd.Function):
    """The recurrence under autograd: (ra, ia, xc, lam, h0) -> h
    [B, S, w].  The forward is ``rglru_scan`` (the kernel on a card, the
    plain version on the CPU), saving its five inputs and h; the backward
    is ``rglru_scan_backward``, which recomputes the gates and gives every
    input its gradient, h0's included."""

    @staticmethod
    def forward(ctx, ra, ia, xc, lam, h0):
        ts = (ra, ia, xc, lam, h0)
        if any(t.dtype != torch.float32 for t in ts):
            raise TypeError("the RG-LRU recurrence takes float32 inputs "
                            f"(got {[str(t.dtype) for t in ts]})")
        h = rglru_scan(*ts)
        ctx.save_for_backward(*ts, h)
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh):
        return rglru_scan_backward(*ctx.saved_tensors, dh)


def rglru_scan_grad(ra, ia, xc, lam, h0):
    """h [B, S, w] through ``RglruScanFunction`` (the route under
    autograd)."""
    return RglruScanFunction.apply(ra, ia, xc, lam, h0)
