"""The routed experts of a MoE layer's decode step, grouped by expert on
the device.

No TPU kernel stands behind this one: the reference computes the MoE with
einsums over every expert (``repro/models/moe.py::moe_apply_dense``).  The
port needs it so that a MoE decode step reads nothing back to the host
and a CUDA graph can capture it: a hand-written CUDA kernel for Hopper
(``csrc/routed_experts.cu``, built for ``sm_90a`` with ``nvcc`` at first
use and bound through ``ctypes``), and beside it ``routed_experts_plain``,
a plain PyTorch version of the same function over the same grouping.

``routed_experts`` dispatches on the device of its inputs: a CPU tensor
goes to the plain version, a CUDA tensor goes to the kernel, and anything
the kernel does not take raises -- there is no fallback.  Every kernel
call (its four launches: group, gate/up, down, combine) adds one to
``routed_experts.launches`` (under CUDA graph capture to ``.captured``:
``_build.count_launch``).

Semantics: x f32 [T, d] (the normed tokens); idx int64 [T, k] and w f32
[T, k], the route (``models.moe.route``: a token's k experts are
distinct); one repeat's experts ``wi_gate``/``wi_up`` f32 [E, d, f] and
``wo`` f32 [E, f, d].  Returns y f32 [T, d] with

    y[t] = sum_j w[t, j] * (silu(x_t Wg[e]) * (x_t Wu[e])) Wo[e],
    e = idx[t, j],

summed over j in top-k order (the reference's ``take_along_axis`` and
``sum``).  The (token, expert) pairs are grouped by expert with fixed
shapes (``group_pairs``), so each chosen expert's weights are read once a
call and nothing depends on the host knowing the counts.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["group_pairs", "routed_experts", "routed_experts_plain"]

NAME = "routed_experts"
NVCC_FLAGS = _build.BASE_FLAGS
# the most (token, expert) pairs a call takes: the group launch holds
# every pair's expert in one block's shared memory
MAX_PAIRS = 8192
_lib = None
# the kernel's float32 scratch between eager calls, one buffer per (device,
# stream); a graph capture allocates its own (``_build.scratch``)
_scratch = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(NAME, NVCC_FLAGS)
        fn = lib.routed_experts_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def group_pairs(idx):
    """The T*k (token, expert) pairs of ``idx`` [T, k] grouped by expert,
    in arrays of fixed shape [T*k] (int64), as the kernel's group launch
    writes them: ``pair`` holds the flat pair index t*k + j at each sorted
    position (a stable sort by expert), and at a position that leads a
    group (its expert differs from the position before) ``expert``,
    ``first`` (the position itself) and ``count`` (the group's size);
    every other position holds -1 in those three.  Reads nothing back to
    the host."""
    sorted_e, pair = torch.sort(idx.reshape(-1), stable=True)
    start = torch.searchsorted(sorted_e, sorted_e)
    end = torch.searchsorted(sorted_e, sorted_e, right=True)
    pos = torch.arange(pair.numel(), device=idx.device)
    lead = start == pos
    none = torch.full_like(pos, -1)
    return (torch.where(lead, sorted_e, none), torch.where(lead, pos, none),
            torch.where(lead, end - pos, none), pair)


def routed_experts_plain(x, idx, w, wi_gate, wi_up, wo):
    """Plain PyTorch version of the kernel's function (module docstring)
    over the same grouping: the group that leads at position s serves the
    tokens at positions s .. s + count - 1 (at most T), here as T rows a
    group masked by its count, with its expert's weights; each pair's
    output is gathered back to its (token, rank) and the k outputs of a
    token are summed in top-k order.  Fixed shapes and no host read, so
    the CPU decode step that a CUDA graph would capture is this one; the
    CPU tests use it, and the smoke run compares the kernel with it on
    the card."""
    t, k = idx.shape
    d = x.shape[1]
    p = t * k
    expert, first, count, pair = group_pairs(idx)
    lead = count > 0
    pos = torch.arange(p, device=x.device)
    i = torch.arange(t, device=x.device)
    at = (pos[:, None] + i).clamp(max=p - 1)                      # [P, T]
    served = lead[:, None] & (i < count[:, None])
    e = expert.clamp(min=0)
    xs = x[pair[at] // k] * served[..., None]                     # [P, T, d]
    h = F.silu(torch.bmm(xs, wi_gate[e])) * torch.bmm(xs, wi_up[e])
    out = torch.bmm(h, wo[e])                                     # [P, T, d]
    # each pair's output: row (its group's leader, its offset in the group)
    start = torch.cummax(first, 0).values
    rank = torch.empty_like(pair)
    rank[pair] = pos
    y_pair = out[start[rank], rank - start[rank]].reshape(t, k, d)
    y = torch.zeros_like(x)
    for j in range(k):
        y = y + w[:, j, None] * y_pair[:, j]
    return y


def routed_experts(x, idx, w, wi_gate, wi_up, wo):
    """The routed experts' output y [T, d] (module docstring).  CPU
    tensors take ``routed_experts_plain``; CUDA tensors launch the
    kernel."""
    if x.device.type == "cpu":
        return routed_experts_plain(x, idx, w, wi_gate, wi_up, wo)
    if x.device.type != "cuda":
        raise ValueError(f"routed_experts runs on cpu or cuda, not "
                         f"{x.device}")
    tensors = (x, idx, w, wi_gate, wi_up, wo)
    if any(a.device != x.device for a in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if any(a.dtype != torch.float32 for a in (x, w, wi_gate, wi_up, wo)):
        raise TypeError("routed_experts takes float32 tokens, weights and "
                        "route weights (got "
                        f"{[str(a.dtype) for a in (x, w, wi_gate, wi_up, wo)]}"
                        ")")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, not {idx.dtype}")
    if x.dim() != 2 or idx.dim() != 2 or wi_gate.dim() != 3:
        raise ValueError("x [T, d], idx / w [T, k], experts [E, d, f]")
    t, d = x.shape
    k = idx.shape[1]
    n_exp, _, f = wi_gate.shape
    if (idx.shape[0] != t or tuple(w.shape) != tuple(idx.shape)
            or tuple(wi_gate.shape) != (n_exp, d, f)
            or wi_up.shape != wi_gate.shape
            or tuple(wo.shape) != (n_exp, f, d)):
        raise ValueError("shape mismatch: x [T, d], idx / w [T, k], "
                         "wi_gate / wi_up [E, d, f], wo [E, f, d] (got "
                         f"{[tuple(a.shape) for a in tensors]})")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("routed_experts needs contiguous inputs")
    if d % 4 or f % 4 or any(a.data_ptr() % 16 for a in
                             (x, wi_gate, wi_up, wo)):
        raise ValueError("the kernel reads 16-byte pieces: d and f must be "
                         f"multiples of 4 (got d={d}, f={f}) and the tokens "
                         "and experts 16-byte aligned")
    if t * k > MAX_PAIRS:
        raise ValueError(f"{t * k} (token, expert) pairs: the kernel takes "
                         f"at most {MAX_PAIRS}")
    if t == 0 or k == 0:
        return torch.zeros_like(x)
    y = torch.empty_like(x)
    p = t * k
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # scratch: h [P, f], y_pair [P, d], then the groups (int32 [3, P])
    buf = _build.scratch(_scratch, p * (f + d + 3), x.device)
    at = buf.data_ptr()
    err = _load().routed_experts_launch(
        x.data_ptr(), idx.data_ptr(), w.data_ptr(), wi_gate.data_ptr(),
        wi_up.data_ptr(), wo.data_ptr(), y.data_ptr(), at,
        at + 4 * p * f, at + 4 * p * (f + d), t, k, d, f, n_exp, stream)
    if err != 0:
        raise RuntimeError(f"routed_experts kernel launch failed: CUDA "
                           f"error {err}")
    _build.count_launch(routed_experts)
    return y


routed_experts.launches = 0
routed_experts.captured = 0
