"""Per-period page-access histogram fused with the EMA hotness update.

The port of the TPU kernel ``repro/kernels/page_hist.py::page_hist``
(Pallas body ``_kernel``): a hand-written CUDA kernel for Hopper
(``csrc/page_hist.cu``, a shared-memory ``atomicAdd`` histogram per row,
built for ``sm_90a`` with ``nvcc`` at first use and bound through
``ctypes``), and beside it ``page_hist_plain``, a plain PyTorch version of
the same function.

``page_hist`` dispatches on the device of its inputs: a CPU tensor goes to
the plain version, a CUDA tensor goes to the kernel, and anything the
kernel does not take raises -- there is no fallback.  Every kernel launch
adds one to ``page_hist.launches``.

Semantics (shared by the kernel and the plain version): ids int32 [P] or
[R, P] (one row per period, padded with -1), hotness float32 [n].  For
each row,

    counts[p]  = #(ids == p)          ids < 0 or >= n are ignored
    new_hot    = alpha * counts + (1 - alpha) * hotness
    mask       = new_hot >= threshold

Returns (counts, new_hot, mask) of shape [n] for 1-D ids, [R, n] for 2-D.
The reference's oracle ``page_hist_ref`` clips ids >= n into page n-1
instead (``ref.page_hist_ref`` mirrors it); the Pallas kernel and this one
ignore them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["page_hist", "page_hist_plain", "MAX_PAGES"]

NAME = "page_hist"
NVCC_FLAGS = _build.BASE_FLAGS
# One unsigned counter per page in shared memory (224 KB of the 227 KB).
MAX_PAGES = 56 * 1024
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(NAME, NVCC_FLAGS)
        fn = lib.page_hist_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def page_hist_plain(ids, hotness, *, alpha: float = 0.5,
                    threshold: float = 1.0):
    """Plain PyTorch version of the kernel's function (module docstring):
    one ``torch.bincount`` over ``row * n + id`` of the in-range ids, then
    the EMA and the threshold."""
    rows = ids.reshape(-1, ids.shape[-1]).long()
    r = rows.shape[0]
    n = hotness.shape[0]
    keep = (rows >= 0) & (rows < n)
    flat = (torch.arange(r, device=ids.device)[:, None] * n + rows)[keep]
    counts = torch.bincount(flat, minlength=r * n).reshape(r, n).float()
    new_hot = alpha * counts + (1.0 - alpha) * hotness
    mask = new_hot >= threshold
    if ids.dim() == 1:
        return counts[0], new_hot[0], mask[0]
    return counts, new_hot, mask


def page_hist(ids, hotness, *, alpha: float = 0.5, threshold: float = 1.0):
    """Page-access histogram + EMA hotness + hot mask (module docstring).
    CPU tensors take ``page_hist_plain``; CUDA tensors launch the kernel,
    one CTA per row."""
    if ids.device.type == "cpu":
        return page_hist_plain(ids, hotness, alpha=alpha,
                               threshold=threshold)
    if ids.device.type != "cuda":
        raise ValueError(f"page_hist runs on cpu or cuda, not {ids.device}")
    if ids.dim() not in (1, 2) or hotness.dim() != 1:
        raise ValueError("ids must be [P] or [R, P] and hotness [n]: "
                         f"{tuple(ids.shape)} / {tuple(hotness.shape)}")
    if ids.dtype != torch.int32 or hotness.dtype != torch.float32:
        raise TypeError(f"ids must be int32 and hotness float32 (got "
                        f"{ids.dtype}, {hotness.dtype})")
    if hotness.device != ids.device:
        raise ValueError("ids and hotness must be on one CUDA device")
    if not (ids.is_contiguous() and hotness.is_contiguous()):
        raise ValueError("page_hist needs contiguous inputs")
    n = hotness.shape[0]
    if n > MAX_PAGES:
        raise ValueError(f"page_hist holds at most {MAX_PAGES} pages in "
                         f"shared memory, got {n}")
    rows = ids.reshape(-1, ids.shape[-1])
    r, p = rows.shape
    if p >= 2 ** 24:
        raise ValueError(f"a row of {p} ids overflows exact float32 counts")
    counts = torch.empty((r, n), dtype=torch.float32, device=ids.device)
    new_hot = torch.empty((r, n), dtype=torch.float32, device=ids.device)
    mask = torch.empty((r, n), dtype=torch.bool, device=ids.device)
    if r and n:
        err = _load().page_hist_launch(
            rows.data_ptr(), hotness.data_ptr(), counts.data_ptr(),
            new_hot.data_ptr(), mask.data_ptr(), r, p, n, float(alpha),
            float(1.0 - alpha), float(threshold),
            torch.cuda.current_stream(ids.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"page_hist kernel launch failed: CUDA "
                               f"error {err}")
        page_hist.launches += 1
    if ids.dim() == 1:
        return counts[0], new_hot[0], mask[0]
    return counts, new_hot, mask


page_hist.launches = 0
