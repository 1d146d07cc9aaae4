"""Decode attention over a paged KV pool with the per-page mass fused in.

The port of the TPU kernel ``repro/kernels/paged_attention.py::
paged_attention`` (Pallas body ``_kernel``): a hand-written CUDA kernel
for Hopper (``csrc/paged_attention.cu``, built for ``sm_90a`` with
``nvcc`` at first use and bound through ``ctypes``), and beside it
``paged_attention_plain``, a plain PyTorch version of the same function.

``paged_attention`` dispatches on the device of its inputs: a CPU tensor
goes to the plain version, a CUDA tensor goes to the kernel, and anything
the kernel does not take raises -- there is no fallback.  Every kernel
launch adds one to ``paged_attention.launches``.

Semantics (shared by the kernel and the plain version): q [B, H, D];
k_pages/v_pages [P, page, KV, D] (float32 or bfloat16, one dtype with q);
page_table int32 [B, n] of physical pages (entries < 0 or >= P are never
read); lengths int32 [B].  Row b attends positions
[max(0, len - window), len) (all of [0, len) when ``window == 0``).
Returns (out [B, H, D] in q's dtype, mass f32 [B, n]): a row with
``len == 0`` gets zeros in both, and pages outside the attended span get
zero mass, so every active row's mass sums to 1.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

__all__ = ["paged_attention", "paged_attention_plain"]

NAME = "paged_attention"
NVCC_FLAGS = _build.BASE_FLAGS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(NAME, NVCC_FLAGS)
        fn = lib.paged_attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                       + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def paged_attention_plain(q, k_pages, v_pages, page_table, lengths, *,
                          window: int = 0, softcap: float = 0.0):
    """Plain PyTorch version of the kernel's function (module docstring):
    gather the table's pages, mask to the attended span, softmax in
    float32.  The CPU tests use it, and the smoke run compares the kernel
    with it on the card."""
    b, h, d = q.shape
    n_phys, page, kvh, _ = k_pages.shape
    n = page_table.shape[1]
    rep = h // kvh
    table = page_table.long()
    mapped = (table >= 0) & (table < n_phys)
    idx = table.clamp(0, n_phys - 1)
    k = k_pages[idx].reshape(b, n * page, kvh, d).float()
    v = v_pages[idx].reshape(b, n * page, kvh, d).float()
    qg = q.float().reshape(b, kvh, rep, d)
    logits = torch.einsum("bgrd,btgd->bgrt", qg, k) * (1.0 / math.sqrt(d))
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    pos = torch.arange(n * page, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    valid = (pos < ln) & mapped.repeat_interleave(page, dim=1)
    if window > 0:
        valid &= pos >= ln - window
    logits = logits.masked_fill(~valid[:, None, None, :], -math.inf)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    w = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgrt,btgd->bgrd", w, v).reshape(b, h, d)
    mass = w.sum(dim=(1, 2)).reshape(b, n, page).sum(dim=-1) / h
    return out.to(q.dtype), mass


def paged_attention(q, k_pages, v_pages, page_table, lengths, *,
                    window: int = 0, softcap: float = 0.0):
    """Decode attention over paged KV; returns (out [B, H, D], mass f32
    [B, n]).  CPU tensors take ``paged_attention_plain``; CUDA tensors
    launch the kernel (module docstring)."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     lengths, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not "
                         f"{q.device}")
    b, h, d = q.shape
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("k_pages/v_pages must both be [P, page, KV, D]: "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    n_phys, page, kvh, dk = k_pages.shape
    n = page_table.shape[1]
    if dk != d or h % kvh or page_table.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError("shape mismatch: q [B,H,D], pages [P,page,KV,D] with "
                         "H % KV == 0, page_table [B,n], lengths [B]")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError("q, k_pages and v_pages must share one dtype, "
                        f"float32 or bfloat16 (got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype})")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    tensors = (q, k_pages, v_pages, page_table, lengths)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention needs contiguous inputs")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    mass = torch.empty((b, n), dtype=torch.float32, device=q.device)
    if b == 0 or n == 0:
        mass.zero_()
        return out, mass
    f32 = dict(dtype=torch.float32, device=q.device)
    m_page = torch.empty((b, h, n), **f32)
    s_page = torch.empty((b, h, n), **f32)
    m_final = torch.empty((b, h), **f32)
    l_final = torch.empty((b, h), **f32)
    err = _load().paged_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), mass.data_ptr(), m_page.data_ptr(),
        s_page.data_ptr(), m_final.data_ptr(), l_final.data_ptr(),
        b, h, kvh, d, page, n, n_phys, 1.0 / math.sqrt(d), int(window),
        float(softcap), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out, mass


paged_attention.launches = 0
