"""The one piece of the reference simulator (``repro/core/sim.py``) the
serving loop needs: the paper's initial interleaved placement.  The
offline sweep itself (``bin_trace``, ``sweep``, the ``page_hist`` and
``sim_scan`` kernels) is a later slice of the port."""
from __future__ import annotations

import numpy as np

__all__ = ["interleaved_indices"]


def interleaved_indices(num_pages: int, capacity: int) -> np.ndarray:
    """The paper's SII-B initial placement: `capacity` page indices evenly
    interleaved over the footprint.  Single source of truth shared by the
    symbolic tiering replay and the physical page pools."""
    return (np.arange(capacity, dtype=np.int64) * num_pages) // max(1,
                                                                    capacity)
