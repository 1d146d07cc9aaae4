"""The hybrid-memory simulator's period scan over a candidate stack.

The port of the TPU kernel ``repro/kernels/sim_step.py::sim_scan``
(Pallas body ``_kernel``): a hand-written CUDA kernel for Hopper
(``csrc/sim_scan.cu``: one CTA per candidate, the scan carry in shared
memory, top-``capacity`` placement by a shared-memory radix select; built
for ``sm_90a`` with ``nvcc -fmad=false`` at first use and bound through
``ctypes``), and beside it ``sim_scan_plain``, a plain PyTorch version of
the same function.

``sim_scan`` dispatches on the device of its inputs: a CPU tensor goes to
the plain version, a CUDA tensor goes to the kernel, and anything the
kernel does not take raises -- there is no fallback.  Every kernel launch
adds one to ``sim_scan.launches``.

Semantics (``repro/core/sim.py::_scan_one``, vmapped): period_hists
float32 [C, P, n] (candidate c's per-period page counts, zero-padded past
its ``num_reals[c]`` real periods), num_reals int32 [C], init_fast bool
[n].  Per real period i, with float32 arithmetic in the reference's order:

    score    = rank * 1e6 + (last + 1) / (i + 2) + 0.5 * in_fast
               (rank = this period's counts if predictive, else hotness)
    new_fast = the top-``capacity`` scores, ties to the lower page index
               (``lax.top_k``'s membership)
    runtime += n_fast*lat_fast + n_slow*lat_slow
               + max(0, n_slow - bw_slow*total)*bw_penalty
               + swaps*mig_cost + period_overhead
    hotness  = alpha*counts + (1 - alpha)*hotness;  last = i where counts > 0

Returns (runtime, swaps, fast_hits), float32 [C] each, summed one period
after another.  The cost constants are float32 values (``1 - alpha`` is
taken in float32, as the reference's traced scalars are).

Where XLA contracts a multiply and an add into one fused multiply-add
when it compiles the reference for the CPU (it always allows contraction:
``x*y + z`` and ``x*y + z*w`` become ``fma(x, y, z)`` and
``fma(x, y, z*w)``), both versions here round once too: the score's
``rank*1e6 + recency``, the bandwidth term's ``n_slow - bw_slow*total``,
the latency, the adds of the bandwidth and migration terms to it, and the
EMA.  Everywhere else they round
after every operation (the kernel is built with ``-fmad=false``).  That is
what makes the plain version bit-equal to the reference's scan on the CPU
and the kernel bit-equal to the plain version on the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["sim_scan", "sim_scan_plain", "MAX_PAGES"]

NAME = "sim_scan"
# -fmad=false: no multiply-add contraction, the bits must match the plain
# version's separate multiplies and adds (the source also uses __f*_rn).
NVCC_FLAGS = _build.BASE_FLAGS + ("-fmad=false",)
# 13 bytes of shared memory per page (placement, hotness, last access,
# selection key): 208 KB of the 227 KB a block may use.
MAX_PAGES = 16 * 1024
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(NAME, NVCC_FLAGS)
        fn = lib.sim_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _costs(lat_fast, lat_slow, bw_slow, bw_penalty, mig_cost,
           period_overhead, ema_alpha):
    """The cost constants as float32 values (held in Python floats, which
    represent them exactly), with ``1 - alpha`` taken in float32."""
    f = np.float32
    return tuple(float(f(x)) for x in (
        lat_fast, lat_slow, bw_slow, bw_penalty, mig_cost, period_overhead,
        ema_alpha, f(1.0) - f(ema_alpha)))


def _fma32(a, b, c):
    """``a*b + c`` for float32 tensors with a single rounding to float32, as
    a fused multiply-add gives it: the product is exact in float64, the sum
    is rounded to odd in float64 (TwoSum for its error), and that rounds to
    float32 correctly (53 >= 24 + 2 bits)."""
    p = a.double() * b
    c = c.double() if torch.is_tensor(c) else torch.full_like(p, c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)            # s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _fast_set(score, capacity: int):
    """Per row of ``score`` [C, n], the top-``capacity`` members, ties to
    the lower page index: ``lax.top_k``'s membership (a stable descending
    sort; ``torch.topk`` breaks ties otherwise)."""
    top = torch.sort(score, dim=1, descending=True,
                     stable=True).indices[:, :capacity]
    return torch.zeros(score.shape, dtype=torch.bool,
                       device=score.device).scatter_(1, top, True)


def sim_scan_plain(period_hists, num_reals, init_fast, *, predictive: bool,
                   capacity: int, lat_fast, lat_slow, bw_slow, bw_penalty,
                   mig_cost, period_overhead, ema_alpha):
    """Plain PyTorch version of the kernel's function (module docstring): a
    loop over periods on [C, n] tensors, the fast set by a stable
    descending sort (never ``torch.topk``, whose tie order differs from
    ``lax.top_k``'s), and the same running float32 sums."""
    (lat_fast, lat_slow, bw_slow, bw_penalty, mig_cost, period_overhead,
     alpha, beta) = _costs(lat_fast, lat_slow, bw_slow, bw_penalty, mig_cost,
                           period_overhead, ema_alpha)
    c, p, n = period_hists.shape
    dev = period_hists.device
    f32 = dict(dtype=torch.float32, device=dev)
    nr = num_reals.to(dev).long()
    in_fast = init_fast.to(dev).bool().expand(c, n).clone()
    hotness = torch.zeros((c, n), **f32)
    last = torch.full((c, n), -1.0, **f32)
    acc = torch.zeros((3, c), **f32)
    steps = min(p, int(nr.max())) if c else 0
    for i in range(steps):
        counts = period_hists[:, i]
        valid = i < nr
        rank = counts if predictive else hotness
        # a tensor divisor: a Python-scalar one may become a multiply by
        # its reciprocal on the card, which is not the IEEE division
        recency = (last + 1.0) / torch.full((), i + 2.0, **f32)
        score = _fma32(rank, 1e6, recency) + 0.5 * in_fast.float()
        new_fast = torch.where(valid[:, None], _fast_set(score, capacity),
                               in_fast)
        swaps = (new_fast & ~in_fast).float().sum(dim=1)
        total = counts.sum(dim=1)
        n_fast = (counts * new_fast.float()).sum(dim=1)
        n_slow = total - n_fast
        latency = _fma32(n_fast, lat_fast, n_slow * lat_slow)
        over = torch.clamp_min(_fma32(total, -bw_slow, n_slow), 0.0)
        # latency + over*bw_penalty + swaps*mig_cost + period_overhead
        period_rt = _fma32(swaps, mig_cost, _fma32(over, bw_penalty,
                                                   latency)) + period_overhead
        acc = acc + torch.where(valid, torch.stack([period_rt, swaps,
                                                    n_fast]), 0.0)
        hotness = torch.where(valid[:, None],
                              _fma32(counts, alpha, beta * hotness),
                              hotness)
        last = torch.where(valid[:, None] & (counts > 0), float(i), last)
        in_fast = new_fast
    return acc[0], acc[1], acc[2]


def sim_scan(period_hists, num_reals, init_fast, *, predictive: bool,
             capacity: int, lat_fast, lat_slow, bw_slow, bw_penalty,
             mig_cost, period_overhead, ema_alpha):
    """Fused candidate sweep (module docstring); returns (runtime, swaps,
    fast_hits) float32 [C].  CPU tensors take ``sim_scan_plain``; CUDA
    tensors launch the kernel, one CTA per candidate."""
    kw = dict(predictive=predictive, capacity=capacity, lat_fast=lat_fast,
              lat_slow=lat_slow, bw_slow=bw_slow, bw_penalty=bw_penalty,
              mig_cost=mig_cost, period_overhead=period_overhead,
              ema_alpha=ema_alpha)
    if period_hists.device.type == "cpu":
        return sim_scan_plain(period_hists, num_reals, init_fast, **kw)
    if period_hists.device.type != "cuda":
        raise ValueError(f"sim_scan runs on cpu or cuda, not "
                         f"{period_hists.device}")
    if period_hists.dim() != 3:
        raise ValueError("period_hists must be [C, P, n]: "
                         f"{tuple(period_hists.shape)}")
    c, p, n = period_hists.shape
    if tuple(num_reals.shape) != (c,) or tuple(init_fast.shape) != (n,):
        raise ValueError("num_reals must be [C] and init_fast [n]")
    if period_hists.dtype != torch.float32 or num_reals.dtype != torch.int32 \
            or init_fast.dtype != torch.bool:
        raise TypeError("period_hists float32, num_reals int32 and init_fast "
                        f"bool (got {period_hists.dtype}, {num_reals.dtype}, "
                        f"{init_fast.dtype})")
    tensors = (period_hists, num_reals, init_fast)
    if any(t.device != period_hists.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sim_scan needs contiguous inputs")
    if n > MAX_PAGES:
        raise ValueError(f"sim_scan holds at most {MAX_PAGES} pages in "
                         f"shared memory, got {n}")
    if not 1 <= capacity <= n:
        raise ValueError(f"capacity must be in [1, {n}], got {capacity}")
    if p >= 2 ** 24:
        raise ValueError(f"{p} periods overflow the float32 period index")
    out = torch.zeros((3, c), dtype=torch.float32, device=period_hists.device)
    if c and p:
        err = _load().sim_scan_launch(
            period_hists.data_ptr(), num_reals.data_ptr(),
            init_fast.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), c, p, n, int(capacity), int(bool(predictive)),
            *_costs(lat_fast, lat_slow, bw_slow, bw_penalty, mig_cost,
                    period_overhead, ema_alpha),
            torch.cuda.current_stream(period_hists.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"sim_scan kernel launch failed: CUDA error "
                               f"{err}")
        sim_scan.launches += 1
    return out[0], out[1], out[2]


sim_scan.launches = 0
