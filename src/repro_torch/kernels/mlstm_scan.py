"""The mLSTM recurrence over a sequence, on the state rows where it lives.

No Pallas kernel stands behind this one: the reference runs the mLSTM
recurrence as a ``lax.scan`` (``repro/models/recurrent.py::mlstm_apply``,
:116-140) and one cell a decode token (``::mlstm_step``, :149), which XLA
compiles to one loop on the chip.  The port's plain loop over positions
rewrites the whole matrix state C with every op (16.8 MB a row at
xlstm-1.3b's 4 heads of 1024), so the port needs a kernel that keeps C on
the chip across positions and reads and writes it in place: two
hand-written CUDA kernels for Hopper in ``csrc/mlstm_scan.cu`` (a strip
kernel for one position, a chunkwise kernel on the tensor cores for a
sequence; built for ``sm_90a`` with ``nvcc`` at first use and bound
through ``ctypes``), and
beside it ``mlstm_scan_plain``, the plain PyTorch version: the per-
position cell loop the port ran before (``mlstm_loop``) between a gather
of the source rows and a write of the destination rows.

``mlstm_scan`` dispatches on the device of its inputs: a CPU tensor goes
to the plain version, a CUDA tensor goes to a kernel (by the route rule
below), and anything the kernels do not take raises -- there is no
fallback.  Every kernel launch adds one to ``mlstm_scan.launches``
(under CUDA graph capture to ``.captured``: ``_build.count_launch``).  The
wrapper reads nothing back to the host, so a CUDA graph captures it.

Semantics.  q, k, v f32 [B, S, nh, hd] and the gates i, log f f32
[B, S, nh] (as ``recurrent._mlstm_inputs`` returns them, contiguous); the
starting n f32 [B, nh, hd] and m f32 [B, nh]; the starting C of row b is
columns ``[0, nh*hd*hd)`` of row ``src_rows[b]`` of the 2-D float32
buffer ``src`` [P, state_dim] (its leading leaf: a packed state page
holds C first, its leaves in sorted key order), or zero where
``src_rows[b]`` is -1.  The final C of row b is written to row
``rows[b]`` of each ``(buf, rows)`` in ``dsts`` (one or two), the same
columns; rows must lie in ``[0, P)``.  Returns h f32 [B, S, nh, hd] and
the final n and m.  A dense state [B, nh, hd, hd] is the case where the
buffer is the state viewed [B, nh*hd*hd] and the rows are ``arange(B)``.

In place: ``src`` may be a destination buffer.  Each row's C is read
once and written at the end, so a launch is safe as long as no row it
writes is another row's source; a row the paged step drops reads no page
(source -1) and writes only the sink.

The route rule.  S = 1 (every decode step) launches the strip kernel;
S > 1 (a prefill) the chunkwise form (chunks of ``CHUNK`` positions, on
the tensor cores): a pre-pass of every chunk's q . k, then the chunkwise
kernel, two launches, each counted.  The rule depends on S alone.

Numerics, S = 1.  C, n and m come out bit-equal to the plain version on
the same device: the strip kernel rounds every product and sum of the
state on its own (``__fmul_rn`` / ``__fadd_rn``, so no multiply-add
contraction), in the plain version's order (``f_p*C``, ``k*v``,
``i_p*(k*v)``, then the sum), divides k by sqrt(hd) (the plain version
divides by a tensor of sqrt(hd), so the card's PyTorch does not turn it
into a multiply by the reciprocal, as it does for a Python scalar; on
the CPU that is the same division as before), and takes ``expf``.
h = (C^T q) / max(|n . q|, 1) sums both dot products in another order
(fused multiply-adds a thread, then across warps), so it is held to
``h_tolerance``: twice the float32 summation bound gamma_hd = hd u /
(1 - hd u) (u = 2^-24; any order of hd terms, fused or not, lies within
gamma_hd of the exact sum times the sum of the terms' magnitudes) on both
dot products, carried through the division, plus four ulps of h.

Numerics, S > 1.  m is bit-equal (the chunkwise kernel runs the plain
version's serial chain ``fm = f + m; m = max(fm, i)``); C, n and h are
held to bounds derived from the magnitudes the plain replay gives
(``tolerances``, which returns all three).
Both versions approximate one exact recurrence X: real arithmetic on the
same float inputs, with the plain version's own float arguments a_p =
fl(fl(f_p + m) - m_new) and b_p = fl(i_p - m_new) (bit-equal in both),
so X's C_t = sum_j D_tj k~_j v_j^T + G_t C_0 with D_tj = exp(b_j +
a_{j+1} + .. + a_t), G_t = exp(a_1 + .. + a_t).  With A_t = sum_j D_tj
|k~_j| |v_j|^T + G_t |C_0| (and N_t likewise for n) and the arg-weighted
Ab_t = sum_j D_tj |arg_tj| |k~_j| |v_j|^T + ... (|arg| = -(b_j + sum a),
every a_p <= 0), each replayed as a recurrence beside the plain one, and
u = 2^-24:

* the plain version rounds each term at most (7 + 6 t) times over t
  positions (an exp within 2 ulps = 4 u, a product, a sum each step; a
  new term's exp, k v, i_p (k v), the sum): |C^P - C^X| <= (7 + 6 t) u
  A_t, |n^P - n^X| <= (6 + 6 t) u N_t, and each of its dot products over
  hd adds gamma_hd;
* the kernel's exp of a double sum rounded once to float is within 5 u
  + u |arg| of its D or g; a 3xTF32 product drops at most 12 u |x y|
  (|x - hi - lo| <= 2^-22 |x|); a tensor-core m16n8k8 step is taken to
  add its 8 products and its accumulator within 24 u of the sum of their
  magnitudes (each addend truncated to the largest one's precision, no
  guard bits, in halves of 4, then rounded: a model of the hardware's
  unspecified accumulation that holds for either rounding), so a sum of
  K products over 3 K / 8 steps is within 12 u + 9 K u of the
  magnitudes.  The chunk's update gives a new term 20 u + 9.02 L u and
  every later chunk 6 u + 9.02 L u more (the carry's exp and product,
  then the chunk's products accumulated onto it); C^T q over a warp's 8
  nks rows (nks = ceil(hd / 64)) adds 12 u + 72.2 nks u and its 7 sums
  across warps; q . k~ (the pre-pass's) the same, D q . k~ and its
  product with v over L positions 12 u + 9.02 L u more; n . q (fused
  multiply-adds, then across lanes and warps) at most 16 u; the n
  update's L fused multiply-adds L u.  So, with n_S = ceil(S / L)
  chunks, and at position t (1-based) n_c = (t - 1) // L chunks before
  t's:

  |C^K - C^P| <= 1.01 u ((14 + (6 + 9.02 L) n_S + 7 + 6 S) A_S + Ab_S),
  |n^K - n^P| <= 1.01 u ((8 + L + 7 n_S + 6 + 6 S) N_S + Nb_S),
  |num^K - num^P| <= u ((40 + 9.02 L + 72.2 nks + (6 + 9.02 L) n_c + 7
      + 6 t + 1.001 hd) |q_t|^T A_t + |q_t|^T Ab_t),
  |den^K - den^P| <= u ((31 + L + 72.2 nks + 7 n_c + 6 + 6 t
      + 1.001 hd) |q_t| . N_t + |q_t| . Nb_t),

  and h = num / max(|den|, 1) moves by 1.01 (dnum + |h| dden) /
  max(|den^P| - dden, 1) + 3 u |h| (max(|x|, 1) is 1-Lipschitz; each
  side's division rounds once).  The 1.01 covers the second-order terms
  and the replayed magnitudes being float32 sums themselves.  A step
  whose argument a_p is below -1e4 (a zero state's m = -1e30) zeroes
  every term it carries in both versions (exp underflows), and the
  kernel clamps it there so its double sums keep their precision.

The backward.  The reference trains through ``jax.grad`` of its
``lax.scan``; the kernels above have no gradient of their own, so the
dense sequence form has an autograd Function, ``MlstmScanFunction``
(``mlstm_scan_grad``), which ``models.recurrent`` takes under autograd.
Its forward is the chunkwise kernel with the save option (``_launch(...,
save=)``: C and n before each chunk of 16 positions, [B, nh, nch, hd,
hd] -- 1.07 GB at B = 4, S = 256, 4 heads of 1024 -- and n . q a
position; h, C, n and m bit-identical with the option on or off), its
backward the backward kernel (``mlstm_scan_backward``, in
``csrc/mlstm_scan.cu``: the chunkwise form in reverse, four launches
each counted in ``mlstm_scan_backward.launches``).  On the CPU the
Function runs ``mlstm_save_plain`` (``mlstm_loop``'s ops with the same
saves) and ``mlstm_backward_plain``, the same decomposition in torch,
which gives autograd of ``mlstm_loop``'s gradients exactly in float64: the
m chain and the clamp max(|n . q|, 1) included (h depends on the
stabiliser m only where the clamp binds, and there its gradient runs
through exp(i - m), exp(f + m - m_new) and max(f + m, i), a tie split
evenly as PyTorch's and JAX's maximum).  The starting state carries no
gradient: the Function raises if C, n or m asks for one.  Head dims as
the forward's (multiples of 32 up to ``MAX_HD``).

Its bar (``grad_check``): each gradient's largest distance from a
float64 run of the plain forward and backward is at most ``GRAD_MULT``
times the float32 plain run's own (or than one float32 ulp of the
largest element).  A measured bar, not a derived one: the backward's sums
(products over hd, the reverse chains over positions, the gate
gradients' cancelling sums da_t = Q_t - K_t + da_{t+1}) are many and
long, and a summation bound over them says little; the float32 plain run
makes the same sums in another order, so its distance from float64 is
the scale of float32's error on these inputs, and a dropped term or a
wrong chain (the m chain dropped: ``tests/test_torch_mlstm_grad.py``)
misses it by orders of magnitude.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

__all__ = ["CHUNK", "GRAD_MULT", "MlstmScanFunction", "grad_check",
           "h_tolerance", "mlstm_backward_plain", "mlstm_cell",
           "mlstm_loop", "mlstm_save_plain", "mlstm_scan",
           "mlstm_scan_backward", "mlstm_scan_grad", "mlstm_scan_plain",
           "tolerances"]

NAME = "mlstm_scan"
NVCC_FLAGS = _build.BASE_FLAGS
# both kernels keep a thread's rows of its 32-column strip in registers:
# at most 128
MAX_HD = 1024
#: positions a chunk of the chunkwise kernel (S > 1)
CHUNK = 16
_lib = None
_QK: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(NAME, NVCC_FLAGS)
        args = ([ctypes.c_void_p] * 9 + [ctypes.c_int64]
                + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_float])
        lib.mlstm_scan_launch.argtypes = args + [ctypes.c_void_p]
        lib.mlstm_scan_chunk_launch.argtypes = args + [ctypes.c_void_p] * 5
        lib.mlstm_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 26 \
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        for fn in (lib.mlstm_scan_launch, lib.mlstm_scan_chunk_launch,
                   lib.mlstm_scan_bwd_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def mlstm_cell(C, n, m, q, k, v, i, f):
    """One timestep.  C [B, nh, hd, hd], n / q / k / v [B, nh, hd], m / i /
    f [B, nh].  Returns (C, n, m, h [B, nh, hd])."""
    k = k / torch.full_like(k, math.sqrt(q.shape[-1]))
    m_new = torch.maximum(f + m, i)
    i_p = torch.exp(i - m_new)[..., None]
    f_p = torch.exp(f + m - m_new)[..., None]
    n_new = f_p * n + i_p * k
    C_new = f_p[..., None] * C + i_p[..., None] * (k[..., :, None]
                                                   * v[..., None, :])
    num = torch.einsum("bhkv,bhk->bhv", C_new, q)
    den = torch.clamp_min(torch.einsum("bhk,bhk->bh", n_new, q).abs(), 1.0)
    return C_new, n_new, m_new, num / den[..., None]


def mlstm_loop(C, n, m, q, k, v, i, f):
    """The recurrence over dense tensors, a cell a position (the
    reference's ``lax.scan``): q, k, v [B, S, nh, hd], i, f [B, S, nh].
    Returns (C, n, m, h [B, S, nh, hd]).  Differentiable."""
    hs = []
    for t in range(q.shape[1]):
        C, n, m, h = mlstm_cell(C, n, m, q[:, t], k[:, t], v[:, t], i[:, t],
                                f[:, t])
        hs.append(h)
    return C, n, m, torch.stack(hs, dim=1)


def _c_cols(q) -> int:
    return q.shape[2] * q.shape[3] * q.shape[3]


def mlstm_scan_plain(q, k, v, i, f, n, m, src, src_rows, dsts):
    """Plain PyTorch version of the kernel's function (module docstring):
    gather each row's C (zero for source -1), ``mlstm_loop``, write the
    final C to every destination.  The CPU tests use it, and the smoke run
    compares the kernel with it on the card."""
    b, _, nh, hd = q.shape
    cols = _c_cols(q)
    C = src[src_rows.clamp_min(0), :cols]
    C = torch.where((src_rows >= 0)[:, None], C, torch.zeros_like(C))
    C, n, m, h = mlstm_loop(C.reshape(b, nh, hd, hd), n, m, q, k, v, i, f)
    for buf, rows in dsts:
        buf[:, :cols].index_put_((rows,), C.reshape(b, cols))
    return h, n, m


def _check(q, k, v, i, f, n, m, src, src_rows, dsts) -> None:
    """Raise on what the kernel does not take."""
    rows_all = [src_rows] + [r for _, r in dsts]
    bufs = [src] + [buf for buf, _ in dsts]
    floats = (q, k, v, i, f, n, m, *bufs)
    if any(t.device != q.device for t in floats + tuple(rows_all)):
        raise ValueError("all inputs must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("mlstm_scan takes float32 inputs and state buffers "
                        f"(got {[str(t.dtype) for t in floats]})")
    if any(r.dtype != torch.int64 for r in rows_all):
        raise TypeError("the row indices must be int64")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, nh, hd], not {tuple(q.shape)}")
    b, s, nh, hd = q.shape
    if (k.shape != q.shape or v.shape != q.shape
            or tuple(i.shape) != (b, s, nh) or i.shape != f.shape
            or tuple(n.shape) != (b, nh, hd) or tuple(m.shape) != (b, nh)):
        raise ValueError("shape mismatch: q / k / v [B, S, nh, hd], i / f "
                         "[B, S, nh], n [B, nh, hd], m [B, nh] (got "
                         f"{[tuple(t.shape) for t in (q, k, v, i, f, n, m)]}"
                         ")")
    if not all(t.is_contiguous() for t in (q, k, v, i, f, n, m, *rows_all)):
        raise ValueError("mlstm_scan needs contiguous inputs and rows")
    if any(buf.dim() != 2 or buf.stride(1) != 1 or buf.shape[1] < nh * hd
           * hd for buf in bufs):
        raise ValueError("state buffers must be 2-D [P, >= nh*hd*hd] with "
                         "unit column stride (got "
                         f"{[(tuple(t.shape), t.stride()) for t in bufs]})")
    if any(tuple(r.shape) != (b,) for r in rows_all):
        raise ValueError("each row index must be [B]")
    if hd % 32 or hd > MAX_HD:
        raise ValueError(f"the kernel takes head dims that are multiples of "
                         f"32 up to {MAX_HD} (got {hd})")
    if s == 0:
        raise ValueError("mlstm_scan needs at least one position")


def _launch(q, k, v, i, f, n, m, src, src_rows, dsts, chunked: bool,
            save=None):
    """The chunkwise form (``chunked``: the pre-pass, then the chunkwise
    kernel) or the strip kernel on checked inputs, each kernel launch
    counted: (h, n, m).  ``mlstm_scan`` picks the form by the route rule;
    the strip kernel over S > 1 is reachable only here, for a same-run
    comparison.  ``save`` (the chunkwise form only): the backward's saves
    (``_saves``), which the kernel fills and which change no other
    output."""
    if not 1 <= len(dsts) <= 2:
        raise ValueError(f"one or two destinations, not {len(dsts)}")
    _check(q, k, v, i, f, n, m, src, src_rows, dsts)
    b, s, nh, hd = q.shape
    h = torch.empty_like(q)
    n_out, m_out = torch.empty_like(n), torch.empty_like(m)
    if b == 0:
        return h, n_out, m_out
    (d1, r1), (d2, r2) = dsts[0], (dsts[1] if len(dsts) == 2
                                   else (None, None))
    ptr = lambda t: None if t is None else t.data_ptr()
    stride = lambda t: 0 if t is None else t.stride(0)
    lib = _load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), i.data_ptr(),
            f.data_ptr(), n.data_ptr(), m.data_ptr(), src.data_ptr(),
            src_rows.data_ptr(), src.stride(0), d1.data_ptr(),
            r1.data_ptr(), d1.stride(0), ptr(d2), ptr(r2), stride(d2),
            h.data_ptr(), n_out.data_ptr(), m_out.data_ptr(), b, s, nh, hd,
            math.sqrt(hd))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if chunked:
        # each chunk's q . k [CHUNK, CHUNK], from the first of two launches
        qk = _build.scratch(_QK, b * nh * -(-s // CHUNK) * CHUNK * CHUNK,
                            q.device)
        saves = (None,) * 3 if save is None else \
            tuple(t.data_ptr() for t in save)
        err = lib.mlstm_scan_chunk_launch(*args, qk.data_ptr(), *saves,
                                          stream)
    else:
        if save is not None:
            raise ValueError("the strip kernel saves nothing")
        err = lib.mlstm_scan_launch(*args, stream)
    if err != 0:
        raise RuntimeError(f"mlstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    for _ in range(2 if chunked else 1):     # the pre-pass, then the chunks
        _build.count_launch(mlstm_scan)
    return h, n_out, m_out


def mlstm_scan(q, k, v, i, f, n, m, src, src_rows, dsts):
    """h [B, S, nh, hd] and the final n, m; the final C written to every
    ``(buf, rows)`` of ``dsts`` (module docstring).  CPU tensors take
    ``mlstm_scan_plain``; CUDA tensors launch the strip kernel for S = 1
    and the chunkwise kernel for S > 1 (the route rule)."""
    if q.device.type == "cpu":
        return mlstm_scan_plain(q, k, v, i, f, n, m, src, src_rows, dsts)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan runs on cpu or cuda, not {q.device}")
    return _launch(q, k, v, i, f, n, m, src, src_rows, dsts,
                   chunked=q.dim() == 4 and q.shape[1] > 1)


mlstm_scan.launches = 0
mlstm_scan.captured = 0


def _gather(q, src, src_rows):
    """Each row's starting C [B, nh, hd, hd] (zero for source -1)."""
    b, _, nh, hd = q.shape
    C = src[src_rows.clamp_min(0), :_c_cols(q)]
    return torch.where((src_rows >= 0)[:, None], C, torch.zeros_like(C)) \
        .reshape(b, nh, hd, hd)


def tolerances(q, k, v, i, f, n, m, src, src_rows, chunk=CHUNK):
    """The chunkwise kernel's bounds against the plain version (module
    docstring, S > 1): (h [B, S, nh, hd], final C [B, nh, hd, hd], final
    n [B, nh, hd]).  Replays the plain cell beside the magnitudes A, N and
    their arg-weighted Ab, Nb, in float32 on the inputs' device."""
    b, s, nh, hd = q.shape
    u = 2.0 ** -24
    nks = -(-hd // 64)
    C = _gather(q, src, src_rows)
    A, Ab = C.abs(), torch.zeros_like(C)
    N, Nb = n.abs(), torch.zeros_like(n)
    sq = torch.full_like(k[:, 0], math.sqrt(hd))
    hs = []
    for t in range(s):
        ka, va = (k[:, t] / sq).abs(), v[:, t].abs()
        fm = f[:, t] + m
        m_new = torch.maximum(fm, i[:, t])
        a, bb = fm - m_new, i[:, t] - m_new
        f_p, i_p = torch.exp(a)[..., None], torch.exp(bb)[..., None]
        a, bb = a.abs()[..., None], bb.abs()[..., None]
        kv = ka[..., :, None] * va[..., None, :]
        # a step that zeroes its carry (f_p = 0) carries no |a| weight
        carry = torch.where(f_p > 0, a, torch.zeros_like(a))
        Ab = f_p[..., None] * (Ab + carry[..., None] * A) \
            + (i_p * bb)[..., None] * kv
        A = f_p[..., None] * A + i_p[..., None] * kv
        Nb = f_p * (Nb + carry * N) + i_p * bb * ka
        N = f_p * N + i_p * ka
        C, n, m, h = mlstm_cell(C, n, m, q[:, t], k[:, t], v[:, t], i[:, t],
                                f[:, t])
        qa = q[:, t].abs()
        n_c = t // chunk
        kap_h = 40 + 9.02 * chunk + 72.2 * nks + (6 + 9.02 * chunk) * n_c \
            + 7 + 6 * (t + 1) + 1.001 * hd
        kap_d = 31 + chunk + 72.2 * nks + 7 * n_c + 6 + 6 * (t + 1) \
            + 1.001 * hd
        dnum = u * (kap_h * torch.einsum("bhkv,bhk->bhv", A, qa)
                    + torch.einsum("bhkv,bhk->bhv", Ab, qa))
        dden = u * (kap_d * (N * qa).sum(-1) + (Nb * qa).sum(-1))[..., None]
        den = torch.einsum("bhk,bhk->bh", n, q[:, t]).abs()[..., None]
        lower = torch.clamp_min(den - dden, 1.0)
        hs.append(1.01 * (dnum + h.abs() * dden) / lower + 3 * u * h.abs())
    n_s = -(-s // chunk)
    c_tol = 1.01 * u * ((14 + (6 + 9.02 * chunk) * n_s + 7 + 6 * s) * A
                        + Ab)
    n_tol = 1.01 * u * ((8 + chunk + 7 * n_s + 6 + 6 * s) * N + Nb)
    return torch.stack(hs, dim=1), c_tol, n_tol


def h_tolerance(q, k, v, i, f, n, m, src, src_rows):
    """The bound the strip kernel's h (S = 1) is held to against the plain
    version's (module docstring), [B, S, nh, hd]: replays the recurrence
    with the plain cell and takes, a position, A = sum_k |C[k, :]| |q[k]|
    and B = sum_k |n[k] q[k]|; then 2.02 gamma_hd (A + |h| B) / den + 4 u
    |h| (the 1.01 covers the second-order terms and A, B being float32
    sums themselves)."""
    b, s, nh, hd = q.shape
    u = 2.0 ** -24
    gamma = hd * u / (1 - hd * u)
    C = _gather(q, src, src_rows)
    out = []
    for t in range(s):
        C, n, m, h = mlstm_cell(C, n, m, q[:, t], k[:, t], v[:, t], i[:, t],
                                f[:, t])
        qa = q[:, t].abs()
        big_a = torch.einsum("bhkv,bhk->bhv", C.abs(), qa)
        big_b = torch.einsum("bhk,bhk->bh", n.abs(), qa)[..., None]
        den = torch.clamp_min(torch.einsum("bhk,bhk->bh", n, q[:, t]).abs(),
                              1.0)[..., None]
        out.append(2.02 * gamma * (big_a + h.abs() * big_b) / den
                   + 4 * u * h.abs())
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# the backward (module docstring)
# ---------------------------------------------------------------------------

#: the gradients' bar (``grad_check``): each gradient's largest distance
#: from a float64 run of the plain backward at most this many times the
#: float32 plain backward's own (or than one float32 ulp of the largest
#: element, where the float32 run is closer still)
GRAD_MULT = 8.0
#: the backward's gradients, in ``mlstm_scan_backward``'s order
GRAD_NAMES = ("dq", "dk", "dv", "di", "df")
#: floats of the backward's record a chunk (``csrc/mlstm_scan.cu``: D q .
#: k~, g, D_L, dd, a spare and D P)
_BWD_RECORD = 2 * CHUNK * CHUNK + 4 * CHUNK


def _n_chunks(s: int, chunk: int = CHUNK) -> int:
    return -(-s // chunk)


def mlstm_save_plain(q, k, v, i, f, C, n, m, chunk=CHUNK):
    """``mlstm_loop`` (the same ops, the same bits) that also returns the
    backward's saves: (C, n, m, h, (csave [B, nh, nch, hd, hd], nsave
    [B, nh, nch, hd], dsave [B, S, nh])) -- C and n before each chunk of
    ``chunk`` positions and n . q a position, signed."""
    b, s, nh, hd = q.shape
    nch = _n_chunks(s, chunk)
    csave = q.new_empty((b, nh, nch, hd, hd))
    nsave = q.new_empty((b, nh, nch, hd))
    dsave = q.new_empty((b, s, nh))
    hs = []
    for t in range(s):
        if t % chunk == 0:
            csave[:, :, t // chunk] = C
            nsave[:, :, t // chunk] = n
        C, n, m, h = mlstm_cell(C, n, m, q[:, t], k[:, t], v[:, t], i[:, t],
                                f[:, t])
        dsave[:, t] = torch.einsum("bhk,bhk->bh", n, q[:, t])
        hs.append(h)
    return C, n, m, torch.stack(hs, dim=1), (csave, nsave, dsave)


def _saves(q):
    """Empty saves of a call on q (``mlstm_save_plain``'s shapes)."""
    b, s, nh, hd = q.shape
    nch = _n_chunks(s)
    return (q.new_empty((b, nh, nch, hd, hd)), q.new_empty((b, nh, nch, hd)),
            q.new_empty((b, s, nh)))


def _chain(i, f, m0):
    """The forward's m chain (its rounding: m bit-equal) a position: a =
    (f + m) - m_new and b = i - m_new, the arguments of f_p and i_p, and
    fm = f + m, each [B, S, nh]."""
    m = m0
    a, b, fm = [], [], []
    for t in range(i.shape[1]):
        x = f[:, t] + m
        m_new = torch.maximum(x, i[:, t])
        a.append(x - m_new)
        b.append(i[:, t] - m_new)
        fm.append(x)
        m = m_new
    return (torch.stack(a, dim=1), torch.stack(b, dim=1),
            torch.stack(fm, dim=1))


def _gate_grads(i, fm, a, K, Q, e_end, dm_end):
    """di, df [B, S, nh] from K_t (the gradient of b_t) and Q_t (the
    module docstring): da_t = Q_t - K_t + da_{t+1} (from the final state's
    share ``e_end``), zero where f_p = exp(a_t) is 0; then the m chain in
    reverse, m_t's gradient to the larger of f_t + m_{t-1} and i_t (half
    each at a tie), in float64."""
    dd = torch.float64
    da = e_end.to(dd) if e_end is not None else \
        torch.zeros(i.shape[0], i.shape[2], dtype=dd, device=i.device)
    dmf = dm_end.to(dd) if dm_end is not None else torch.zeros_like(da)
    cut = torch.exp(a) == 0
    di, df = [], []
    for t in range(i.shape[1] - 1, -1, -1):
        db = K[:, t].to(dd)
        da = torch.where(cut[:, t], torch.zeros_like(da),
                         Q[:, t].to(dd) - db + da)
        dm = dmf - da - db
        x, it = fm[:, t], i[:, t]
        to_f = torch.where(x > it, 1.0, torch.where(x < it, 0.0, 0.5)) \
            .to(dd)
        dfm = da + to_f * dm
        di.append(db + (1 - to_f) * dm)
        df.append(dfm)
        dmf = dfm
    return (torch.stack(di[::-1], dim=1).to(i.dtype),
            torch.stack(df[::-1], dim=1).to(i.dtype))


def _end_share(dC, dn, C_end, n_end):
    """<dC, C_end> + dn . n_end [B, nh]: the final state's gradients'
    share of da at the last position (None where neither is given)."""
    if dC is None and dn is None:
        return None
    out = 0.0
    if dC is not None:
        out = out + (dC * C_end).sum((-1, -2))
    if dn is not None:
        out = out + (dn * n_end).sum(-1)
    return out


def _pos_scalars(h, dh, d):
    """den, dd (the gradient of n . q, zero where the clamp binds) and Q
    (dh . h where it binds, else 0), each [B, S, nh]."""
    den = torch.clamp_min(d.abs(), 1.0)
    hh = (dh * h).sum(-1)
    open_ = d.abs() >= 1.0
    dd = torch.where(open_, -(hh / den) * torch.sign(d),
                     torch.zeros_like(hh))
    return den, dd, torch.where(open_, torch.zeros_like(hh), hh)


def mlstm_backward_plain(q, k, v, i, f, m0, h, dh, saves, dC=None, dn=None,
                         dm=None, C_end=None, n_end=None, chunk=CHUNK):
    """Plain PyTorch version of the backward kernel: the chunkwise form
    in reverse (module docstring) from the forward's ``saves``, in the
    inputs' dtype (float64 for the reference run).  ``dC``, ``dn``,
    ``dm``: the final state's gradients (None: none), with the final
    ``C_end``, ``n_end``.  Returns (dq, dk, dv, di, df).  The CPU route
    runs it under autograd, and the smoke run compares the kernel with it
    on the card."""
    csave, nsave, dsave = saves
    b, s, nh, hd = q.shape
    sq = torch.full_like(k, math.sqrt(hd))
    kt = k / sq
    a, bg, fm = _chain(i, f, m0)
    den, dd, Q = _pos_scalars(h, dh, dsave)
    dnum = dh / den[..., None]
    T = lambda x: x.transpose(1, 2)          # [B, L, nh, ..] -> [B, nh, L]
    dq, dkt, dv = (torch.empty_like(q) for _ in range(3))
    K = torch.empty_like(i)
    dCe = dC if dC is not None else q.new_zeros((b, nh, hd, hd))
    dne = dn if dn is not None else q.new_zeros((b, nh, hd))
    for ch in range(_n_chunks(s, chunk) - 1, -1, -1):
        P = slice(ch * chunk, min(s, (ch + 1) * chunk))
        qc, kc, vc, dnc = T(q[:, P]), T(kt[:, P]), T(v[:, P]), T(dnum[:, P])
        ddc = T(dd[:, P])
        A = torch.cumsum(torch.clamp_min(T(a[:, P]).double(), -1e4), -1)
        g = torch.exp(A.to(q.dtype))
        D = torch.exp((T(bg[:, P]).double()[..., None, :]
                       + (A[..., :, None] - A[..., None, :])).to(q.dtype))
        D = torch.tril(D)
        dl, gl = D[..., -1, :], g[..., -1]
        W = D * (dnc @ vc.transpose(-1, -2) + ddc[..., :, None])
        dv[:, P] = T(dl[..., None] * (kc @ dCe)
                     + (D * (qc @ kc.transpose(-1, -2))).transpose(-1, -2)
                     @ dnc)
        x1 = (csave[:, :, ch] @ dnc.transpose(-1, -2)).transpose(-1, -2)
        x2 = (dCe @ vc.transpose(-1, -2)).transpose(-1, -2)
        dq[:, P] = T(g[..., None] * (x1 + ddc[..., None]
                                     * nsave[:, :, ch][..., None, :])
                     + W @ kc)
        dk_c = dl[..., None] * (x2 + dne[..., None, :]) \
            + W.transpose(-1, -2) @ qc
        dkt[:, P] = T(dk_c)
        K[:, P] = T((kc * dk_c).sum(-1))
        dCe = gl[..., None, None] * dCe \
            + (g[..., None] * qc).transpose(-1, -2) @ dnc
        dne = gl[..., None] * dne + ((g * ddc)[..., None] * qc).sum(-2)
    di, df = _gate_grads(i, fm, a, K, Q, _end_share(dC, dn, C_end, n_end),
                         dm)
    return dq, dkt / sq, dv, di, df


def _bwd_check(q, k, v, i, f, m0, h, dh, saves):
    ts = (q, k, v, i, f, m0, h, dh) + tuple(saves)
    if any(t.device != q.device for t in ts):
        raise ValueError("all inputs must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("the backward takes float32 inputs")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the backward needs contiguous inputs")
    b, s, nh, hd = q.shape
    if hd % 32 or hd > MAX_HD:
        raise ValueError(f"the backward kernel takes head dims that are "
                         f"multiples of 32 up to {MAX_HD} (got {hd})")
    if tuple(h.shape) != (b, s, nh, hd) or h.shape != dh.shape:
        raise ValueError("h and dh must be [B, S, nh, hd] as q")


def mlstm_scan_backward(q, k, v, i, f, m0, h, dh, saves, dC=None, dn=None,
                        dm=None, C_end=None, n_end=None):
    """(dq, dk, dv, di, df) of the chunkwise form (the module docstring's
    backward).  CPU tensors take ``mlstm_backward_plain``; CUDA tensors
    launch the backward kernel (four launches, each counted in
    ``mlstm_scan_backward.launches``) or raise."""
    if q.device.type == "cpu":
        return mlstm_backward_plain(q, k, v, i, f, m0, h, dh, saves, dC, dn,
                                    dm, C_end, n_end)
    if q.device.type != "cuda":
        raise ValueError(f"the backward runs on cpu or cuda, not {q.device}")
    dh = dh.contiguous()
    _bwd_check(q, k, v, i, f, m0, h, dh, saves)
    b, s, nh, hd = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di, df = torch.empty_like(i), torch.empty_like(i)
    if b == 0:
        return dq, dk, dv, di, df
    nch = _n_chunks(s)
    dev = q.device
    sc = torch.empty((b, nh, s, 3), device=dev)
    rec = torch.empty((b, nh, nch, _BWD_RECORD), device=dev)
    dnum = torch.empty_like(q)
    dce = torch.empty((b, nh, nch, hd, hd), device=dev)
    dne = torch.empty((b, nh, nch, hd), device=dev)
    kpart = torch.empty((b, nh, hd // 32, s), device=dev)
    e_end = _end_share(dC, dn, C_end, n_end)
    opt = lambda t: None if t is None else t.contiguous()
    dC, dn, dm, e_end = opt(dC), opt(dn), opt(dm), opt(e_end)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _load().mlstm_scan_bwd_launch(
        *(t.data_ptr() for t in (q, k, v, i, f, m0, h, dh, *saves)),
        ptr(dC), ptr(dn), ptr(e_end), ptr(dm),
        *(t.data_ptr() for t in (sc, rec, dnum, dce, dne, kpart, dq, dk,
                                 dv, di, df)),
        b, s, nh, hd, math.sqrt(hd), torch.cuda.current_stream(dev)
        .cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlstm_scan backward launch failed: CUDA error "
                           f"{err}")
    for _ in range(4):     # the prep, the dv pass, the dq / dk pass, gates
        _build.count_launch(mlstm_scan_backward)
    return dq, dk, dv, di, df


mlstm_scan_backward.launches = 0
mlstm_scan_backward.captured = 0


class MlstmScanFunction(torch.autograd.Function):
    """The dense sequence form under autograd: q, k, v, i, f and the
    starting C [B, nh, hd, hd], n, m -> (h, C, n, m).  On a card the
    forward is the chunkwise kernel with its saves and the backward the
    backward kernel; on the CPU ``mlstm_save_plain`` and
    ``mlstm_backward_plain``.  The starting state carries no gradient:
    it raises if C, n or m asks for one."""

    @staticmethod
    def forward(ctx, q, k, v, i, f, C, n, m):
        if any(ctx.needs_input_grad[5:]):
            raise ValueError("the mLSTM backward gives no gradient to the "
                             "starting state (C, n, m)")
        if any(t.dtype != torch.float32 for t in (q, k, v, i, f, C, n, m)):
            raise TypeError("the mLSTM recurrence takes float32 inputs")
        if q.device.type == "cuda":
            b, _, nh, hd = q.shape
            rows = torch.arange(b, device=q.device)
            out = torch.empty((b, nh * hd * hd), device=q.device)
            saves = _saves(q)
            h, n_out, m_out = _launch(
                q, k, v, i, f, n, m, C.reshape(b, -1).contiguous(), rows,
                [(out, rows)], chunked=True, save=saves)
            C_out = out.view(b, nh, hd, hd)
        elif q.device.type == "cpu":
            C_out, n_out, m_out, h, saves = mlstm_save_plain(
                q, k, v, i, f, C, n, m)
        else:
            raise ValueError(f"the mLSTM backward runs on cpu or cuda, not "
                             f"{q.device}")
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, i, f, m, h, C_out, n_out, *saves)
        return h, C_out, n_out, m_out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh, dC, dn, dm):
        q, k, v, i, f, m0, h, C_end, n_end, *saves = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        dq, dk, dv, di, df = mlstm_scan_backward(
            q, k, v, i, f, m0, h, dh, saves, dC, dn, dm, C_end, n_end)
        return dq, dk, dv, di, df, None, None, None


def mlstm_scan_grad(q, k, v, i, f, C, n, m):
    """(h, C, n, m) of the dense sequence form through
    ``MlstmScanFunction`` (the route under autograd)."""
    return MlstmScanFunction.apply(q, k, v, i, f, C, n, m)


def grad_check(got, plain32, plain64, names=GRAD_NAMES,
               mult=GRAD_MULT) -> dict:
    """{name: (distance, bar)} of each gradient ``got`` from the float64
    plain run, against ``mult`` times the float32 plain run's own distance
    (at least one float32 ulp of the largest element): the backward's
    bar (``slstm_scan`` holds its backward to it too).  A gradient passes
    where distance <= bar."""
    out = {}
    for name, g, p32, p64 in zip(names, got, plain32, plain64):
        ref = p64.to(g.device, torch.float64)
        own = float((p32.double().to(g.device) - ref).abs().max())
        ulp = float(ref.abs().max()) * 2.0 ** -24
        out[name] = (float((g.double() - ref).abs().max()),
                     mult * max(own, ulp))
    return out
