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
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["CHUNK", "RGLRU_C", "STRIP", "h_tolerance", "launch_plan",
           "linear_scan", "rglru_gates", "rglru_scan", "rglru_scan_plain"]

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
_lib = None
_SCRATCH: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(NAME, NVCC_FLAGS)
        fn = lib.rglru_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def rglru_gates(ra, ia, xc, lam):
    """a and the gated input b of each position [..., w] from the gate
    products before their sigmoid."""
    rg, ig = torch.sigmoid(ra), torch.sigmoid(ia)
    log_a = -RGLRU_C * F.softplus(lam) * rg
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    return torch.exp(log_a), beta * (ig * xc)


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
