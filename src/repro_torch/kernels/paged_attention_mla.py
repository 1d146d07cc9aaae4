"""Absorbed-matrix MLA decode over compressed KV pages with the per-page
mass fused in.

The port of the TPU kernel ``repro/kernels/paged_attention.py::
paged_attention_mla`` (Pallas body ``_mla_kernel``): a hand-written CUDA
kernel for Hopper (``csrc/paged_attention_mla.cu``, built for ``sm_90a``
with ``nvcc`` at first use and bound through ``ctypes``), and beside it
``paged_attention_mla_plain``, a plain PyTorch version of the same
function.

``paged_attention_mla`` dispatches on the device of its inputs: a CPU
tensor goes to the plain version, a CUDA tensor goes to the kernel, and
anything the kernel does not take raises -- there is no fallback.  Every
kernel call (a split launch and its combine) adds one to
``paged_attention_mla.launches`` (under CUDA graph capture to
``.captured``: ``_build.count_launch``).  ``mla_split_plan`` is the
host's choice of how the kernel splits a row's pages over blocks, each
block taking ``HEADS_PER_BLOCK`` heads.

Semantics (shared by the kernel and the plain version): q_abs [B, H, R]
(the no-pe queries with W_uk absorbed), q_rope [B, H, K]; ckv_pages
[P, page, R] (one compressed row per token, shared by every head) and
krope_pages [P, page, K] (roped positional keys), float32 or bfloat16,
one dtype for all four; page_table int32 [B, n] of physical pages
(entries < 0 or >= P are never read); lengths int32 [B].  Row b attends
positions [0, len) with logits (q_abs . ckv + q_rope . krope) * scale,
and the values are the ckv rows themselves (the caller up-projects with
W_uv).  Returns (ctx [B, H, R] in q_abs's dtype, as the Pallas kernel,
mass f32 [B, n]): a row with ``len == 0`` gets zeros in both, and pages
outside [0, len) get zero mass, so every active row's mass sums to 1.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

__all__ = ["HEADS_PER_BLOCK", "mla_split_plan", "paged_attention_mla",
           "paged_attention_mla_plain"]

NAME = "paged_attention_mla"
NVCC_FLAGS = _build.BASE_FLAGS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# blocks the split aims for: one an SM of an H100 (a block's shared memory
# leaves room for no second); the heads a block; the longest run of pages
# one block takes (its slots sit in shared memory); the tokens of one tile
# of the kernel
TARGET_BLOCKS = 132
HEADS_PER_BLOCK = 32
MAX_PAGES_PER_SPLIT = 32
TILE = 32
# the widths the kernel takes: value columns in 4 warps' quarters of at
# most 128, and (q_abs ++ q_rope) rows that fit shared memory beside the
# tile ring at 32 heads a block in float32
MAX_R = 512
MAX_R_PLUS_K = 576
_lib = None
# the kernel's float32 scratch between eager calls, one buffer per (device,
# stream); a graph capture allocates its own (``_build.scratch``)
_scratch = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(NAME, NVCC_FLAGS)
        fn = lib.paged_attention_mla_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13
                       + [ctypes.c_int] * 7 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def mla_split_plan(n: int, page: int, b: int, h: int):
    """(pages a split, splits) of the kernel's grid for ``b`` rows of ``h``
    heads over a page table of ``n`` pages of ``page`` tokens, from the
    shapes alone (never from the lengths, whose read would sync the
    device).  A block takes ``HEADS_PER_BLOCK`` heads and split s of a row
    its logical pages [s * pps, (s + 1) * pps); the runs are as short as
    keeps the grid (splits, head groups, rows) near ``TARGET_BLOCKS``
    blocks, and hold at least one tile of tokens where the table does."""
    groups = -(-h // HEADS_PER_BLOCK)
    want = max(1, TARGET_BLOCKS // max(1, b * groups))
    pps = -(-n // want)
    pps = max(pps, min(n, -(-TILE // page)))
    pps = max(1, min(pps, MAX_PAGES_PER_SPLIT))
    return pps, -(-n // pps)


def paged_attention_mla_plain(q_abs, q_rope, ckv_pages, krope_pages,
                              page_table, lengths, *, scale: float):
    """Plain PyTorch version of the kernel's function (module docstring):
    gather the table's pages, mask to [0, len), softmax in float32.  The
    CPU tests use it, and the smoke run compares the kernel with it on
    the card."""
    b, h, rdim = q_abs.shape
    n_phys, page, _ = ckv_pages.shape
    n = page_table.shape[1]
    if n == 0:        # nothing to attend to: zeros, as the k/v kernel
        return (torch.zeros_like(q_abs),
                torch.zeros((b, 0), dtype=torch.float32,
                            device=q_abs.device))
    table = page_table.long()
    mapped = (table >= 0) & (table < n_phys)
    idx = table.clamp(0, n_phys - 1)
    ckv = ckv_pages[idx].reshape(b, n * page, rdim).float()
    krope = krope_pages[idx].reshape(b, n * page, -1).float()
    logits = (torch.einsum("bhr,btr->bht", q_abs.float(), ckv)
              + torch.einsum("bhk,btk->bht", q_rope.float(), krope)) * scale
    pos = torch.arange(n * page, device=q_abs.device)[None, :]
    valid = (pos < lengths.long()[:, None]) \
        & mapped.repeat_interleave(page, dim=1)
    logits = logits.masked_fill(~valid[:, None, :], -math.inf)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    w = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bht,btr->bhr", w, ckv)
    mass = w.sum(dim=1).reshape(b, n, page).sum(dim=-1) / h
    return out.to(q_abs.dtype), mass


def paged_attention_mla(q_abs, q_rope, ckv_pages, krope_pages, page_table,
                        lengths, *, scale: float):
    """MLA decode over compressed paged rows; returns (ctx [B, H, R], mass
    f32 [B, n]).  CPU tensors take ``paged_attention_mla_plain``; CUDA
    tensors launch the kernel (module docstring)."""
    if q_abs.device.type == "cpu":
        return paged_attention_mla_plain(q_abs, q_rope, ckv_pages,
                                         krope_pages, page_table, lengths,
                                         scale=scale)
    if q_abs.device.type != "cuda":
        raise ValueError(f"paged_attention_mla runs on cpu or cuda, not "
                         f"{q_abs.device}")
    if q_abs.dim() != 3 or q_rope.dim() != 3 or ckv_pages.dim() != 3 \
            or krope_pages.dim() != 3:
        raise ValueError("q_abs [B,H,R], q_rope [B,H,K], ckv_pages "
                         "[P,page,R] and krope_pages [P,page,K] must be 3-D")
    b, h, rdim = q_abs.shape
    kdim = q_rope.shape[2]
    n_phys, page, _ = ckv_pages.shape
    n = page_table.shape[1]
    if tuple(q_rope.shape[:2]) != (b, h) \
            or tuple(ckv_pages.shape) != (n_phys, page, rdim) \
            or tuple(krope_pages.shape) != (n_phys, page, kdim) \
            or tuple(page_table.shape) != (b, n) \
            or tuple(lengths.shape) != (b,):
        raise ValueError("shape mismatch: q_abs [B,H,R], q_rope [B,H,K], "
                         "ckv_pages [P,page,R], krope_pages [P,page,K], "
                         "page_table [B,n], lengths [B]")
    tensors = (q_abs, q_rope, ckv_pages, krope_pages)
    if q_abs.dtype not in _DTYPES \
            or any(t.dtype != q_abs.dtype for t in tensors):
        raise TypeError("q_abs, q_rope, ckv_pages and krope_pages must share "
                        "one dtype, float32 or bfloat16 (got "
                        f"{[str(t.dtype) for t in tensors]})")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    tensors += (page_table, lengths)
    if any(t.device != q_abs.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_mla needs contiguous inputs")
    # the kernel copies each token's ckv and krope rows, and each query's,
    # as whole-row bulk copies: 16-byte aligned, a multiple of 16 bytes
    size = q_abs.element_size()
    if (rdim * size) % 16 or (kdim * size) % 16 \
            or any(t.data_ptr() % 16 for t in tensors[:4]):
        raise ValueError("paged_attention_mla needs 16-byte aligned inputs "
                         "whose rows span a multiple of 16 bytes (R and K "
                         f"elements; got R={rdim}, K={kdim} in "
                         f"{q_abs.dtype})")
    if rdim > MAX_R or rdim + kdim > MAX_R_PLUS_K:
        raise ValueError(f"paged_attention_mla takes R <= {MAX_R} and R + K "
                         f"<= {MAX_R_PLUS_K} (got R={rdim}, K={kdim})")
    if b == 0 or n == 0 or h == 0:
        return (torch.zeros((b, h, rdim), dtype=q_abs.dtype,
                            device=q_abs.device),
                torch.zeros((b, n), dtype=torch.float32,
                            device=q_abs.device))
    out = torch.empty((b, h, rdim), dtype=q_abs.dtype, device=q_abs.device)
    mass = torch.empty((b, n), dtype=torch.float32, device=q_abs.device)
    pps, splits = mla_split_plan(n, page, b, h)
    # scratch: part_acc [B, H, splits, R], part_m and part_l [B, H,
    # splits], m_page and s_page [B, H, n]
    parts = b * h * splits
    stream = torch.cuda.current_stream(q_abs.device).cuda_stream
    buf = _build.scratch(_scratch, parts * (rdim + 2) + 2 * b * h * n,
                         q_abs.device)
    at = buf.data_ptr()
    part_m = at + 4 * parts * rdim
    m_page = part_m + 8 * parts
    err = _load().paged_attention_mla_launch(
        _DTYPES[q_abs.dtype], q_abs.data_ptr(), q_rope.data_ptr(),
        ckv_pages.data_ptr(), krope_pages.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), mass.data_ptr(), at, part_m,
        part_m + 4 * parts, m_page, m_page + 4 * b * h * n, b, h, rdim,
        kdim, page, n, n_phys, float(scale), pps, splits, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_mla kernel launch failed: CUDA "
                           f"error {err}")
    _build.count_launch(paged_attention_mla)
    return out, mass


paged_attention_mla.launches = 0
paged_attention_mla.captured = 0
