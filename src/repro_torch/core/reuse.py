"""Reuse Collector (paper §IV-A).

Two collection modes, exactly as the paper uses them:

  * ``reuse_distance_histogram`` -- page reuse distances from a full access
    trace (simulation mode).  Reuse distance of a pair of consecutive
    accesses to the same page = number of accesses to *other* pages in
    between (paper §III-C).  Distances are binned at a coarse granularity
    ("1000s of data accesses", §IV-D) and sub-bin distances (intra-burst
    re-touches of the page just accessed) are dropped -- they are invisible
    at page-scheduling timescales and would otherwise dominate the weighted
    average.

  * ``loop_duration_histogram`` -- the practical system-level proxy: the
    durations of (dynamic executions of) the application's primary loops.
    Our trace generators emit these alongside the trace; on a real system
    they come from compiler/binary instrumentation (§IV-A).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional, Tuple

import numpy as np

__all__ = [
    "ReuseHistogram",
    "StreamingReuseCollector",
    "reuse_distances",
    "reuse_distance_histogram",
    "loop_duration_histogram",
    "prune_insignificant",
]


@dataclasses.dataclass(frozen=True)
class ReuseHistogram:
    """Histogram of observed reuses.

    values:  representative reuse (bin centre), ascending, unit = accesses
             (trace mode) or loop-duration unit (proxy mode).
    counts:  appearance count per bin ("repeat_i" in Eq. 1).
    """

    values: np.ndarray
    counts: np.ndarray
    bin_width: int

    def __post_init__(self):
        assert self.values.shape == self.counts.shape

    @property
    def num_bins(self) -> int:
        return int(self.values.shape[0])


def reuse_distances(pages: np.ndarray) -> np.ndarray:
    """Per-access reuse distance (accesses to other pages since the previous
    access to the same page).  First touches are excluded.

    Vectorized: stable-sort accesses by page id; consecutive entries with the
    same page are consecutive accesses of that page.
    """
    pages = np.asarray(pages, dtype=np.int64)
    n = pages.shape[0]
    if n < 2:
        return np.empty(0, dtype=np.int64)
    order = np.argsort(pages, kind="stable")
    sp = pages[order]
    si = order.astype(np.int64)
    same = sp[1:] == sp[:-1]
    d = si[1:] - si[:-1] - 1
    return d[same]


def _bin(values: np.ndarray, bin_width: int, drop_sub_bin: bool
         ) -> Tuple[np.ndarray, np.ndarray]:
    if values.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    bins = values // bin_width
    if drop_sub_bin:
        bins = bins[bins > 0]
    if bins.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    uniq, counts = np.unique(bins, return_counts=True)
    centres = uniq * bin_width + bin_width // 2
    return centres, counts


def reuse_distance_histogram(pages: np.ndarray, bin_width: int = 1000,
                             drop_sub_bin: bool = True) -> ReuseHistogram:
    """Histogram of page reuse distances at `bin_width`-access granularity."""
    d = reuse_distances(pages)
    values, counts = _bin(d, bin_width, drop_sub_bin)
    return ReuseHistogram(values.astype(np.float64), counts.astype(np.float64),
                          bin_width)


def loop_duration_histogram(loop_durations: np.ndarray, bin_width: int = 1000,
                            drop_sub_bin: bool = False) -> ReuseHistogram:
    """Histogram of loop durations (the Reuse Collector's practical proxy)."""
    d = np.asarray(loop_durations, dtype=np.int64)
    values, counts = _bin(d, bin_width, drop_sub_bin)
    return ReuseHistogram(values.astype(np.float64), counts.astype(np.float64),
                          bin_width)


class StreamingReuseCollector:
    """Online Reuse Collector: sliding-window reuse gaps in the step domain.

    Feed one decode step at a time (``observe`` with the accessed page ids,
    or ``observe_mass`` with the raw per-page attention masses from the
    serving monitor).  A reuse gap is recorded whenever a page is re-accessed
    -- the step-domain analogue of the paper's reuse distance -- and gaps
    older than ``window`` steps are evicted, so the histogram always reflects
    the recent workload phase.  With ``window=None`` (or a window spanning
    the whole run) the histogram is identical to the batch computation over
    the full access log, which is the invariant the tests pin down.
    """

    def __init__(self, n_pages: int, window: Optional[int] = None,
                 bin_width: int = 4):
        self.n_pages = n_pages
        self.window = window
        self.bin_width = bin_width
        self.last_access = np.full(n_pages, -1, np.int64)
        self.step = 0
        self._gaps: Deque[Tuple[int, int]] = collections.deque()  # (t, gap)

    def observe(self, accessed_ids: np.ndarray, dt: int = 1) -> None:
        """Record one observation of accessed page ids.

        ``dt`` is the number of token-steps this observation covers
        (1 on the per-token path; the macro length when the serving loop
        samples accessed bits once per movement period).  The clock
        advances by ``dt``, so reuse gaps stay denominated in TOKEN
        steps either way -- the macro path quantises a gap to macro
        boundaries (the paper's accessed-bit scan has the same
        period-granularity quantisation), but the unit matches the one
        the derived period is applied in."""
        ids = np.asarray(accessed_ids, np.int64)
        prev = self.last_access[ids]
        t = self.step
        for g in (t - prev[prev >= 0]).tolist():
            self._gaps.append((t, g))
        self.last_access[ids] = t
        self.step += max(1, int(dt))
        if self.window is not None:
            horizon = self.step - self.window
            while self._gaps and self._gaps[0][0] < horizon:
                self._gaps.popleft()

    def observe_mass(self, page_mass: np.ndarray, threshold: float = 0.05,
                     relative: bool = False, dt: int = 1) -> None:
        """Record a step from raw per-page attention masses (the serving
        monitor's output): mass >= threshold counts as an access.

        With ``relative=True`` the threshold is a fraction of the step's
        maximum page mass instead of an absolute level.  The fully-paged
        serving path aggregates masses over ALL attention layers
        (head-normalised, layer-averaged, so each request's row sums to
        ~1 regardless of head count or depth); a relative threshold keeps
        the accessed-set size stable when the number of in-flight
        requests -- and hence the absolute mass a single page can draw --
        shifts."""
        mass = np.asarray(page_mass)
        if relative:
            threshold = threshold * float(mass.max(initial=0.0))
            threshold = max(threshold, np.finfo(np.float32).tiny)
        self.observe(np.nonzero(mass >= threshold)[0], dt=dt)

    @property
    def num_samples(self) -> int:
        return len(self._gaps)

    def histogram(self, significance: float = 0.05) -> ReuseHistogram:
        """Histogram of the windowed gaps (pruned, ready for Eq. 1)."""
        gaps = np.fromiter((g for _, g in self._gaps), np.int64,
                           count=len(self._gaps))
        h = loop_duration_histogram(gaps, bin_width=self.bin_width)
        return prune_insignificant(h, significance)

    def forget(self, ids: np.ndarray) -> None:
        """Invalidate specific pages (used when a logical page ID is freed
        and may be recycled for a different request: a later access by the
        new owner must not pair with the old owner's last access into a
        bogus reuse gap).  Gaps already recorded stay -- they were real."""
        self.last_access[np.asarray(ids, np.int64)] = -1

    def reset(self) -> None:
        """Forget all state (used when a phase change is detected)."""
        self.last_access.fill(-1)
        self.step = 0
        self._gaps.clear()


def prune_insignificant(hist: ReuseHistogram, frac: float = 0.05
                        ) -> ReuseHistogram:
    """Keep only reuse bins with *significant* appearances (>= frac of the
    largest bin).  The paper keys the insight on "page reuse distances with
    significant appearances" (SIII-C); sampling-noise tails (e.g. the
    geometric tail of hot-page re-touch gaps) would otherwise skew Eq. 1.
    Falls back to the unpruned histogram if everything would be pruned."""
    if hist.num_bins == 0:
        return hist
    thresh = float(hist.counts.max()) * frac
    keep = hist.counts >= thresh
    if not keep.any():
        return hist
    return ReuseHistogram(hist.values[keep], hist.counts[keep], hist.bin_width)
