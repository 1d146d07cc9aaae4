"""Torch oracles for the port's kernels, mirroring ``repro/kernels/ref.py``
operation for operation (the allclose targets the CPU tests hold against
the JAX oracles)."""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref", "page_hist_ref", "paged_attention_mla_ref",
           "paged_attention_ref"]


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


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,S,H,D]; k/v: [B,T,KV,D].  Returns [B,S,H,D] in v's dtype, as
    the reference oracle (the kernel returns q's dtype)."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(h // kv, dim=2)
    vr = v.repeat_interleave(h // kv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) \
        / math.sqrt(d)
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), vr)


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


def paged_attention_mla_ref(q_abs, q_rope, ckv_pages, krope_pages,
                            page_table, lengths, *, scale: float,
                            return_mass: bool = False):
    """MLA compressed-row paged decode (absorbed-matrix form).

    q_abs: [B,H,R] (W_uk-absorbed no-pe queries); q_rope: [B,H,K];
    ckv_pages: [P,page,R] (shared across heads, not roped); krope_pages:
    [P,page,K]; page_table: [B,n] (valid physical pages); lengths: [B].
    ``scale`` is 1/sqrt(qk_nope_dim + qk_rope_dim).

    Returns the compressed-space context [B,H,R] in the ckv dtype, as
    the reference oracle does (the Pallas kernel returns q_abs's dtype;
    ROADMAP Queue 3), plus the head-normalised per-page mass f32[B,n]
    with ``return_mass``.  Masked logits are -1e30, as in the reference
    oracle, so a ``length == 0`` row gets uniform weights.
    """
    b, h, rdim = q_abs.shape
    _, page, _ = ckv_pages.shape
    n = page_table.shape[1]
    idx = page_table.long()
    ckv = ckv_pages[idx].reshape(b, n * page, rdim)
    krope = krope_pages[idx].reshape(b, n * page, -1)
    logits = (torch.einsum("bhr,btr->bht", q_abs.float(), ckv.float())
              + torch.einsum("bhk,btk->bht", q_rope.float(),
                             krope.float())) * scale
    pos = torch.arange(n * page, device=q_abs.device)[None, :]
    valid = pos < lengths.to(q_abs.device).long()[:, None]
    logits = torch.where(valid[:, None, :], logits,
                         torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bht,btr->bhr", w.to(ckv.dtype), ckv)
    if not return_mass:
        return out
    mass = w.sum(dim=1).reshape(b, n, page).sum(dim=-1) / h   # [B, n]
    return out, mass
