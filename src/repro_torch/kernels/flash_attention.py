"""Blockwise (flash) attention forward for prefill.

The port of the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (Pallas body ``_kernel``): a hand-written CUDA kernel for
Hopper (``csrc/flash_attention.cu``, built for ``sm_90a`` with ``nvcc`` at
first use and bound through ``ctypes``), and beside it
``flash_attention_plain``, a plain PyTorch version of the same function.

``flash_attention`` dispatches on the device of its inputs: a CPU tensor
goes to the plain version, a CUDA tensor goes to the kernel, and anything
the kernel does not take raises -- there is no fallback.  Every kernel
launch adds one to ``flash_attention.launches``.  ``block_plan`` mirrors
the kernel's grid: which query rows each block owns and which kv tiles it
visits.  The kernel runs both products on the tensor cores: float32 as
3xTF32 (each operand split as hi = x rounded to TF32, lo = x - hi rounded
to TF32; lo*hi + hi*lo + hi*hi), bfloat16 in one pass.

Semantics (shared by the kernel and the plain version, those of the TPU
kernel with its query positions shifted by ``q_offset``): q [B, S, H, D];
k/v [B, T, KV, D] with KV dividing H (query head h reads KV head
h // (H // KV)) and ``q_offset + S <= T``; D in {16, 32, 64, 128, 256}.
Query i sits at position ``q_offset + i`` and key j at j: query i attends
key j when ``j <= q_offset + i`` (``causal``) and ``j > q_offset + i -
window`` (``window > 0``).  ``q_offset`` is a prefill chunk's start (its
keys are the earlier chunks' and its own, ``model.prefill_chunk``); with
``q_offset = 0`` the kernel is the TPU kernel's, positions counted from 0
for both.  Logits are (q . k) * (1 / sqrt(D)), masked ones -1e30; p =
exp(logit - row max) is cast to v's dtype before the PV product, and the
sum is divided by max(sum p, 1e-30).  Returns [B, S, H, D] in q's dtype.
No logit soft-capping (no ``softcap`` argument): the TPU kernel has
none.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_plain"]

NAME = "flash_attention"
NVCC_FLAGS = _build.BASE_FLAGS
HEAD_DIMS = (16, 32, 64, 128, 256)
NEG = -1e30     # masked logits, as the TPU kernel
BLOCK_ROWS = 128    # query rows a block owns: 8 warps x 16
KV_TILE = 32        # keys a kv tile holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(NAME, NVCC_FLAGS)
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def block_plan(b: int, s: int, t: int, h: int, kv: int, *,
               causal: bool = True, window: int = 0, q_offset: int = 0):
    """The kernel's blocks in launch order, as
    ``(batch row, query positions, query heads, kv tiles)`` ranges.  A
    block owns ``BLOCK_ROWS`` query rows that share one KV head: where rep
    = h // kv divides ``BLOCK_ROWS``, ``BLOCK_ROWS // rep`` positions x the
    group's rep heads (each k/v tile is staged once for all of them),
    otherwise ``BLOCK_ROWS`` positions of one head.  It visits the kv tiles
    of ``KV_TILE`` keys from the first key its first query (at position
    ``q_offset + q0``) attends to the last key its last query attends.
    Query tiles run heaviest first
    over every head group and batch row."""
    rep = h // kv
    hb = rep if BLOCK_ROWS % rep == 0 else 1
    p = BLOCK_ROWS // hb
    blocks = []
    for q0 in reversed(range(0, s, p)):
        q_end = min(q0 + p, s)
        k_lo = max(0, q_offset + q0 - window + 1) if window > 0 else 0
        k_end = min(t, q_offset + q_end) if causal else t
        tiles = range(k_lo // KV_TILE, -(-k_end // KV_TILE))
        blocks += [(row, range(q0, q_end), range(h0, h0 + hb), tiles)
                   for row in range(b) for h0 in range(0, h, hb)]
    return blocks


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0):
    """Plain PyTorch version of the kernel's function (module docstring):
    a masked softmax in float32 over the whole [S, T] logits of each head
    group.  The CPU tests use it, and the smoke run compares the kernel
    with it on the card."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, kvh, h // kvh, d)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, k.float()) \
        * (1.0 / math.sqrt(d))
    q_pos = q_offset + torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    logits = logits.masked_fill(~mask, NEG)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1).clamp_min(1e-30)                  # [B, KV, rep, S]
    out = torch.einsum("bgrst,btgd->bsgrd", p.to(v.dtype).float(), v.float())
    out = out / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, h, d).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """Flash attention forward; returns [B, S, H, D] in q's dtype.  CPU
    tensors take ``flash_attention_plain``; CUDA tensors launch the kernel
    (module docstring).  Raises on every device for what the kernel does
    not take (a head dim outside ``HEAD_DIMS``, a negative ``q_offset``,
    ``q_offset + S > T``)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be [B, S, H, D] and k/v both [B, T, KV, D]: "
                         f"{tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kvh == 0 or h % kvh:
        raise ValueError("shape mismatch: q [B,S,H,D], k/v [B,T,KV,D] with "
                         "H % KV == 0")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, not "
                         f"{d}")
    if q_offset < 0 or q_offset + s > t:
        raise ValueError(f"flash_attention needs 0 <= q_offset and q_offset "
                         f"+ S <= T (got q_offset={q_offset}, S={s}, T={t}): "
                         "query i sits at position q_offset + i, key j at j")
    if window < 0:
        raise ValueError(f"window must be >= 0, not {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype, float32 or "
                        f"bfloat16 (got {q.dtype}, {k.dtype}, {v.dtype})")
    if any(x.device != q.device for x in (k, v)):
        raise ValueError("q, k and v must be on one CUDA device")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention needs 16-byte aligned q, k and v")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _load().flash_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, s, t, h, kvh, d, 1.0 / math.sqrt(d), int(causal),
        int(window), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
