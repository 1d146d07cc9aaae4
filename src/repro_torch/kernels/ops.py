"""Public wrappers over the port's kernels (the counterpart of
``repro/kernels/ops.py``).  Each kernel module dispatches on the device
of its inputs; this layer keeps the reference's calling contract."""
from __future__ import annotations

from repro_torch.kernels import page_hist as _ph
from repro_torch.kernels import paged_attention as _pa

__all__ = ["page_hist", "paged_attention"]


def page_hist(ids, hotness, *, alpha: float = 0.5, threshold: float = 1.0):
    """Per-period page-access counts, EMA hotness and hot mask
    (``kernels.page_hist``): ids int32 [P] (pad -1), or [R, P] for R
    periods in one call; hotness f32 [num_pages].  Returns (counts,
    new_hotness, hot_mask)."""
    return _ph.page_hist(ids, hotness, alpha=alpha, threshold=threshold)


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
