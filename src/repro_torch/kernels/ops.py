"""Public wrappers over the port's kernels (the counterpart of
``repro/kernels/ops.py``).  Each kernel module dispatches on the device
of its inputs; this layer keeps the reference's calling contract."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import page_hist as _ph
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_attention_mla as _pam

__all__ = ["flash_attention", "page_hist", "paged_attention",
           "paged_attention_mla"]


def page_hist(ids, hotness, *, alpha: float = 0.5, threshold: float = 1.0):
    """Per-period page-access counts, EMA hotness and hot mask
    (``kernels.page_hist``): ids int32 [P] (pad -1), or [R, P] for R
    periods in one call; hotness f32 [num_pages].  Returns (counts,
    new_hotness, hot_mask)."""
    return _ph.page_hist(ids, hotness, alpha=alpha, threshold=threshold)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """Blockwise attention forward (``kernels.flash_attention``): q
    [B, S, H, D], k/v [B, T, KV, D] with KV dividing H, ``q_offset + S <=
    T``; causal and/or sliding-window (``window > 0``) masks with query i
    at position ``q_offset + i`` and key j at j (``q_offset`` 0: the
    reference's kernel, positions counted from 0 for both).  Returns
    [B, S, H, D] in q's dtype."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def paged_attention(q, k_pages, v_pages, page_table, lengths, *,
                    window: int = 0, softcap: float = 0.0,
                    return_mass: bool = False):
    """Decode attention over paged KV (``kernels.paged_attention``).

    Ragged multi-request tables pad short rows with -1; those entries are
    already masked out by ``lengths``, so they are clamped to physical page
    0 first, as the reference does.  Precondition: a -1 *inside* the
    ``lengths`` range means a non-resident page leaked into the table --
    callers must ``ensure_resident`` first; the clamp cannot tell that
    from padding."""
    out, mass = _pa.paged_attention(q, k_pages, v_pages,
                                    page_table.clamp_min(0), lengths,
                                    window=window, softcap=softcap)
    if not return_mass:
        return out
    return out, mass


def paged_attention_mla(q_abs, q_rope, ckv_pages, krope_pages, page_table,
                        lengths, *, scale: float, return_mass: bool = False):
    """MLA absorbed-matrix decode over compressed paged rows
    (``kernels.paged_attention_mla``): ckv shared across heads plus roped
    krope.  Same ragged-table clamp contract as ``paged_attention``;
    ``scale`` = 1/sqrt(qk_nope_dim + qk_rope_dim), the uncompressed head
    dim.  Returns the compressed-space context [B, H, R] (callers
    up-project with W_uv) and, with ``return_mass``, the per-page mass
    f32[B, n]."""
    out, mass = _pam.paged_attention_mla(q_abs, q_rope, ckv_pages,
                                         krope_pages, page_table.clamp_min(0),
                                         lengths, scale=scale)
    if not return_mass:
        return out
    return out, mass
