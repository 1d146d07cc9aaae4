"""Torch oracles for the port's kernels, mirroring ``repro/kernels/ref.py``
operation for operation (the allclose targets the CPU tests hold against
the JAX oracles)."""
from __future__ import annotations

import math

import torch

__all__ = ["page_hist_ref", "paged_attention_ref"]


def page_hist_ref(ids, hotness, *, alpha: float = 0.5, threshold: float = 1.0):
    """ids: int32[P] (pad -1); hotness: f32[num_pages].

    As in the reference oracle, ids >= num_pages are clipped into the last
    page and counted (the kernels ignore them; ROADMAP Queue 3)."""
    num_pages = hotness.shape[0]
    counts = torch.zeros((num_pages,), dtype=torch.float32,
                         device=hotness.device).index_add_(
        0, ids.clamp(0, num_pages - 1).long(),
        torch.where(ids >= 0, 1.0, 0.0).float())
    new_hot = alpha * counts + (1 - alpha) * hotness
    return counts, new_hot, new_hot >= threshold


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                        window: int = 0, softcap: float = 0.0,
                        return_mass: bool = False):
    """q: [B,H,D]; pages: [P,page,KV,D]; page_table: [B,n]; lengths: [B].

    ``window > 0`` restricts attention to positions [length-window, length)
    (sliding-window layers); ``softcap > 0`` applies tanh logit capping.
    With ``return_mass`` also returns the per-page attention-probability
    mass f32[B, n], *head-normalised* (each row sums to ~1).

    As in the reference oracle, masked logits are -1e30 (not -inf), so a
    row with ``length == 0`` gets uniform weights over its table, and the
    output has the pool's dtype.  ``page_table`` must hold valid physical
    pages (``ops.paged_attention`` clamps the -1 padding first).
    """
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    n = page_table.shape[1]
    idx = page_table.long()
    k = k_pages[idx].reshape(b, n * page, kvh, d)       # [B, T, KV, D]
    v = v_pages[idx].reshape(b, n * page, kvh, d)
    kr = k.repeat_interleave(h // kvh, dim=2)
    vr = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bhd,bthd->bht", q.float(), kr.float()) \
        / math.sqrt(d)
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    pos = torch.arange(n * page, device=q.device)[None, :]
    ln = lengths.to(q.device).long()[:, None]
    valid = pos < ln
    if window > 0:
        valid &= pos >= ln - window
    logits = torch.where(valid[:, None, :], logits,
                         torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bht,bthd->bhd", w.to(vr.dtype), vr)
    if not return_mass:
        return out
    mass = w.sum(dim=1).reshape(b, n, page).sum(dim=-1) / h   # [B, n]
    return out, mass
