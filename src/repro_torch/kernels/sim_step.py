"""The hybrid-memory simulator's period scan over a candidate set.

The port of the TPU kernel ``repro/kernels/sim_step.py::sim_scan``
(Pallas body ``_kernel``): a hand-written CUDA kernel for Hopper
(``csrc/sim_scan.cu``: one CTA per candidate, each thread holding a run
of pages' carry and the next period's counts in registers, top-
``capacity`` placement by a radix select with one barrier a pass that
usually needs two passes; built for ``sm_90a`` with ``nvcc -fmad=false``
at first use and bound through ``ctypes``), and beside it
``sim_scan_plain``, a plain PyTorch version of the same function.

Two entry points launch the kernel.  ``sim_scan`` scans a stack [C, P, n]
(candidate c's rows zero-padded past ``num_reals[c]``); ``sim_scan_rows``
scans candidates of different lengths in one launch, candidate c taking
rows ``[starts[c], starts[c] + num_reals[c])`` of one [R, n] array (how
``core.sim.sweep`` hands a whole sweep to one launch).  Both dispatch on
the device of their inputs: a CPU tensor goes to the plain version, a
CUDA tensor goes to the kernel, and anything the kernel does not take
raises -- there is no fallback.  Every kernel launch adds one to
``sim_scan.launches``.

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

__all__ = ["sim_scan", "sim_scan_plain", "sim_scan_rows",
           "sim_scan_rows_plain", "MAX_PAGES"]

NAME = "sim_scan"
# -fmad=false: no multiply-add contraction, the bits must match the plain
# version's separate multiplies and adds (the source also uses __f*_rn).
NVCC_FLAGS = _build.BASE_FLAGS + ("-fmad=false",)
# 512 threads x runs of at most 32 pages (the kernel's largest instance
# keeps hotness, last access and keys in 192 KB of shared memory).
MAX_PAGES = 16 * 1024
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(NAME, NVCC_FLAGS)
        fn = lib.sim_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
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


def sim_scan_rows_plain(rows, starts, num_reals, init_fast, **kw):
    """Plain version of ``sim_scan_rows``: each candidate's rows gathered
    into a zero-padded [C, max(num_reals), n] stack for
    ``sim_scan_plain``."""
    c, n = len(starts), rows.shape[1]
    p = max(num_reals, default=0)
    stack = rows.new_zeros((c, p, n))
    for j, (s, r) in enumerate(zip(starts, num_reals)):
        stack[j, :r] = rows[s: s + r]
    return sim_scan_plain(stack, torch.tensor(list(num_reals),
                                              dtype=torch.int32),
                          init_fast, **kw)


def _check(hists, init_fast, n, capacity):
    """The checks both entry points make before a launch."""
    if hists.dtype != torch.float32 or init_fast.dtype != torch.bool:
        raise TypeError(f"period rows float32 and init_fast bool (got "
                        f"{hists.dtype}, {init_fast.dtype})")
    if tuple(init_fast.shape) != (n,):
        raise ValueError(f"init_fast must be [{n}]")
    if init_fast.device != hists.device:
        raise ValueError("all inputs must be on one CUDA device")
    if not (hists.is_contiguous() and init_fast.is_contiguous()):
        raise ValueError("sim_scan needs contiguous inputs")
    if n > MAX_PAGES:
        raise ValueError(f"sim_scan holds at most {MAX_PAGES} pages a "
                         f"candidate, got {n}")
    if not 1 <= capacity <= n:
        raise ValueError(f"capacity must be in [1, {n}], got {capacity}")


def _launch(hists, row_start, num_reals, max_periods, init_fast, c, n, kw):
    """One kernel launch over ``c`` candidates; returns (runtime, swaps,
    fast_hits)."""
    out = torch.zeros((3, c), dtype=torch.float32, device=hists.device)
    err = _load().sim_scan_launch(
        hists.data_ptr(), row_start, num_reals.data_ptr(), max_periods,
        init_fast.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), c, n, int(kw["capacity"]),
        int(bool(kw["predictive"])),
        *_costs(kw["lat_fast"], kw["lat_slow"], kw["bw_slow"],
                kw["bw_penalty"], kw["mig_cost"], kw["period_overhead"],
                kw["ema_alpha"]),
        torch.cuda.current_stream(hists.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sim_scan kernel launch failed: CUDA error {err}")
    sim_scan.launches += 1
    return out[0], out[1], out[2]


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
    if tuple(num_reals.shape) != (c,):
        raise ValueError("num_reals must be [C] and init_fast [n]")
    if num_reals.dtype != torch.int32:
        raise TypeError(f"num_reals must be int32, got {num_reals.dtype}")
    if num_reals.device != period_hists.device \
            or not num_reals.is_contiguous():
        raise ValueError("all inputs must be contiguous, on one CUDA device")
    _check(period_hists, init_fast, n, capacity)
    if p >= 2 ** 24:
        raise ValueError(f"{p} periods overflow the float32 period index")
    if not (c and p):
        return tuple(torch.zeros((3, c), dtype=torch.float32,
                                 device=period_hists.device))
    return _launch(period_hists, None, num_reals, p, init_fast, c, n, kw)


def sim_scan_rows(rows, starts, num_reals, init_fast, *, predictive: bool,
                  capacity: int, lat_fast, lat_slow, bw_slow, bw_penalty,
                  mig_cost, period_overhead, ema_alpha):
    """Candidates of different lengths in one launch: candidate c scans
    ``rows[starts[c]: starts[c] + num_reals[c]]`` of ``rows`` float32
    [R, n] (``starts`` and ``num_reals`` are sequences of ints).  Returns
    (runtime, swaps, fast_hits) float32 [C].  CPU tensors take
    ``sim_scan_rows_plain``; CUDA tensors launch the kernel once."""
    kw = dict(predictive=predictive, capacity=capacity, lat_fast=lat_fast,
              lat_slow=lat_slow, bw_slow=bw_slow, bw_penalty=bw_penalty,
              mig_cost=mig_cost, period_overhead=period_overhead,
              ema_alpha=ema_alpha)
    starts, num_reals = [int(s) for s in starts], [int(r) for r in num_reals]
    if len(starts) != len(num_reals):
        raise ValueError("starts and num_reals must have one entry a "
                         "candidate")
    if rows.dim() != 2:
        raise ValueError(f"rows must be [R, n]: {tuple(rows.shape)}")
    r_all, n = rows.shape
    if any(s < 0 or r < 0 or s + r > r_all for s, r in zip(starts,
                                                            num_reals)):
        raise ValueError(f"candidate rows outside the {r_all} rows given")
    if any(r >= 2 ** 24 for r in num_reals):
        raise ValueError("2**24 periods overflow the float32 period index")
    if rows.device.type == "cpu":
        return sim_scan_rows_plain(rows, starts, num_reals, init_fast, **kw)
    if rows.device.type != "cuda":
        raise ValueError(f"sim_scan runs on cpu or cuda, not {rows.device}")
    _check(rows, init_fast, n, capacity)
    c = len(starts)
    if not (c and max(num_reals)):
        return tuple(torch.zeros((3, c), dtype=torch.float32,
                                 device=rows.device))
    meta = torch.tensor(starts + num_reals, dtype=torch.int64) \
        .to(rows.device, non_blocking=True)
    nreals = meta[c:].to(torch.int32)
    return _launch(rows, meta.data_ptr(), nreals, 2 ** 31 - 1, init_fast, c,
                   n, kw)


sim_scan.launches = 0
