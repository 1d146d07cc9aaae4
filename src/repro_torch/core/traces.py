"""Synthetic memory-access trace generators for the nine paper applications.

The paper (Table II / Fig. 2) evaluates on Rodinia, Coral-2 and ParTI!
benchmarks, collecting last-level-cache-miss page traces with Intel Pin.
This container cannot run those x86 binaries, so each generator below
reproduces the *published* access-pattern family and its reuse-distance
structure (Fig. 2 / Fig. 3):

  backprop     strided array traversal; 16 strides; dominant reuse distance
               ~20 000 requests appearing 15x (one per stride boundary).
  quicksilver  strided traversal (Monte-Carlo particle sweep), fewer/longer
               strides than backprop.
  lud          triangular traversal: sweep i only revisits the trailing part
               of the footprint -> reuse-distance histogram with decreasing
               appearance counts.
  cpd          sparse-tensor (MTTKRP) traversal: streaming nonzeros with
               zipf-hot factor-matrix pages -> bimodal reuse.
  pennant      irregular accesses over a fixed number of repetitive cycles.
  kmeans       repeated full sweeps over points + very hot centroid pages.
  hotspot      2-D stencil sweeps: short intra-row reuse + long inter-iteration
               reuse.
  bfs          frontier-random traversal (near-random page reuse).
  bptree       random lookups through a tree: zipf-hot upper levels, random
               leaves.

Every generator is deterministic given ``seed`` and returns a ``Trace``.

A copy of ``repro/core/traces.py`` (numpy only), kept identical so the
port imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np

__all__ = [
    "Trace",
    "TRACE_GENERATORS",
    "generate",
    "available_traces",
]


@dataclasses.dataclass(frozen=True)
class Trace:
    """A page-granularity memory access trace.

    Attributes:
      name:       application name (paper Table II abbreviation).
      pages:      int32[num_accesses] page id of each access, in issue order.
      num_pages:  memory footprint in pages.
      loop_durations: list of per-loop lengths in *accesses* -- the practical
        reuse proxy collected by Cori's Reuse Collector on the real system
        (paper SIV-A).  One entry per dynamic loop execution.
    """

    name: str
    pages: np.ndarray
    num_pages: int
    loop_durations: np.ndarray

    @property
    def num_accesses(self) -> int:
        return int(self.pages.shape[0])


def _sequential_sweep(
    rng: np.random.Generator,
    num_pages: int,
    accesses_per_page: int,
    jitter: float = 0.0,
) -> np.ndarray:
    """One sequential pass over [0, num_pages) with `accesses_per_page`
    consecutive accesses per page and optional local jitter."""
    base = np.repeat(np.arange(num_pages, dtype=np.int64), accesses_per_page)
    if jitter > 0:
        noise = rng.integers(-int(jitter), int(jitter) + 1, size=base.shape[0])
        base = np.clip(base + noise, 0, num_pages - 1)
    return base


def backprop(seed: int = 0, num_pages: int = 4096, sweeps: int = 16,
             accesses_per_page: int = 5) -> Trace:
    """Strided traversal: `sweeps` full passes; reuse distance == sweep length
    (~20k requests at the default sizing), appearing (sweeps-1) times."""
    rng = np.random.default_rng(seed)
    sweep = _sequential_sweep(rng, num_pages, accesses_per_page)
    pages = np.tile(sweep, sweeps)
    loops = np.full(sweeps, sweep.shape[0], dtype=np.int64)
    return Trace("backprop", pages.astype(np.int32), num_pages, loops)


def quicksilver(seed: int = 0, num_pages: int = 4096, sweeps: int = 8,
                accesses_per_page: int = 10) -> Trace:
    """Strided particle sweep: fewer, longer strides; mild jitter from
    particle scattering."""
    rng = np.random.default_rng(seed + 1)
    parts = [_sequential_sweep(rng, num_pages, accesses_per_page, jitter=2)
             for _ in range(sweeps)]
    pages = np.concatenate(parts)
    loops = np.array([p.shape[0] for p in parts], dtype=np.int64)
    return Trace("quicksilver", pages.astype(np.int32), num_pages, loops)


def lud(seed: int = 0, num_pages: int = 4096, sweeps: int = 24,
        accesses_per_page: int = 4, row_pages: int = 256) -> Trace:
    """Triangular traversal (LU): sweep i eliminates the trailing submatrix
    [i*num_pages/sweeps, end).  The inner update loop re-reads the pivot row
    before every trailing row, so short pivot reuses dominate the histogram
    and their count decays across sweeps -- the paper's "gradual
    degradation ... decreasing appearances" shape, with a dominant reuse
    much shorter than the sweep length (cf. Fig. 6b: lud's DR "much less")."""
    rng = np.random.default_rng(seed + 2)
    parts: List[np.ndarray] = []
    for i in range(sweeps):
        start = (i * num_pages) // sweeps
        width = num_pages - start
        if width <= 0:
            break
        piv_hi = min(start + row_pages, num_pages)
        pivot = np.repeat(np.arange(start, piv_hi, dtype=np.int64),
                          accesses_per_page)
        rows = []
        for r0 in range(start, num_pages, row_pages):
            r1 = min(r0 + row_pages, num_pages)
            row = _sequential_sweep(rng, r1 - r0, accesses_per_page) + r0
            rows.append(pivot)
            rows.append(row)
        parts.append(np.concatenate(rows))
    pages = np.concatenate(parts)
    loops = np.array([p.shape[0] for p in parts], dtype=np.int64)
    return Trace("lud", pages.astype(np.int32), num_pages, loops)


def cpd(seed: int = 0, num_pages: int = 4096, passes: int = 10,
        nnz_per_pass: int = 24000, factor_frac: float = 0.15) -> Trace:
    """Sparse CP decomposition (MTTKRP): each pass streams nonzero pages
    (uniform over the tensor region) interleaved with zipf-hot factor-matrix
    pages -> short reuse for factors, pass-length reuse for the tensor."""
    rng = np.random.default_rng(seed + 3)
    n_factor = max(1, int(num_pages * factor_frac))
    tensor_lo = n_factor
    parts = []
    # Zipf-like weights for factor rows.
    ranks = np.arange(1, n_factor + 1, dtype=np.float64)
    w = 1.0 / ranks
    w /= w.sum()
    for _ in range(passes):
        nnz = np.sort(rng.integers(tensor_lo, num_pages, size=nnz_per_pass))
        factors = rng.choice(n_factor, size=nnz_per_pass, p=w)
        inter = np.empty(2 * nnz_per_pass, dtype=np.int64)
        inter[0::2] = nnz
        inter[1::2] = factors
        parts.append(inter)
    pages = np.concatenate(parts)
    loops = np.array([p.shape[0] for p in parts], dtype=np.int64)
    return Trace("cpd", pages.astype(np.int32), num_pages, loops)


def pennant(seed: int = 0, num_pages: int = 4096, cycles: int = 12,
            accesses_per_cycle: int = 26000) -> Trace:
    """Irregular (unstructured-mesh) accesses over fixed repetitive cycles:
    random permutation walk within the footprint each cycle."""
    rng = np.random.default_rng(seed + 4)
    parts = []
    for _ in range(cycles):
        # Random but full-coverage: permutation plus extra random accesses.
        perm = rng.permutation(num_pages)
        extra = rng.integers(0, num_pages, size=accesses_per_cycle - num_pages)
        cyc = np.concatenate([perm, extra])
        rng.shuffle(cyc)
        parts.append(cyc)
    pages = np.concatenate(parts)
    loops = np.array([p.shape[0] for p in parts], dtype=np.int64)
    return Trace("pennant", pages.astype(np.int32), num_pages, loops)


def kmeans(seed: int = 0, num_pages: int = 4096, iters: int = 12,
           accesses_per_page: int = 4, centroid_pages: int = 64) -> Trace:
    """Repeated full sweeps over point pages; centroid pages interleaved
    every few accesses (very hot, short reuse)."""
    rng = np.random.default_rng(seed + 5)
    n_pts = num_pages - centroid_pages
    parts = []
    for _ in range(iters):
        sweep = _sequential_sweep(rng, n_pts, accesses_per_page) + centroid_pages
        cent = rng.integers(0, centroid_pages, size=sweep.shape[0] // 4)
        merged = np.empty(sweep.shape[0] + cent.shape[0], dtype=np.int64)
        merged[::5] = cent[: merged[::5].shape[0]]
        mask = np.ones(merged.shape[0], dtype=bool)
        mask[::5] = False
        merged[mask] = sweep[: mask.sum()]
        parts.append(merged)
    pages = np.concatenate(parts)
    loops = np.array([p.shape[0] for p in parts], dtype=np.int64)
    return Trace("kmeans", pages.astype(np.int32), num_pages, loops)


def hotspot(seed: int = 0, grid: int = 64, iters: int = 20,
            accesses_per_page: int = 4) -> Trace:
    """2-D stencil: row-major sweeps; each page touched with its row
    neighbours (short reuse) and revisited every iteration (long reuse)."""
    rng = np.random.default_rng(seed + 6)
    num_pages = grid * grid
    rows = np.arange(num_pages, dtype=np.int64).reshape(grid, grid)
    parts = []
    for _ in range(iters):
        sweep = []
        for r in range(grid):
            row = np.repeat(rows[r], accesses_per_page)
            # neighbour touches: previous row (stencil dependence)
            if r > 0:
                nb = rows[r - 1]
                row = np.stack([row[: grid * accesses_per_page],
                                np.repeat(nb, accesses_per_page)], axis=1
                               ).reshape(-1)[: row.shape[0]]
            sweep.append(row)
        parts.append(np.concatenate(sweep))
    pages = np.concatenate(parts)
    loops = np.array([p.shape[0] for p in parts], dtype=np.int64)
    return Trace("hotspot", pages.astype(np.int32), num_pages, loops)


def bfs(seed: int = 0, num_pages: int = 4096, num_accesses: int = 320000,
        frontier_frac: float = 0.1) -> Trace:
    """Frontier-random graph traversal: accesses nearly random over the
    footprint with a slowly drifting frontier window."""
    rng = np.random.default_rng(seed + 7)
    n_levels = 16
    per = num_accesses // n_levels
    parts = []
    for lvl in range(n_levels):
        centre = rng.integers(0, num_pages)
        width = max(64, int(num_pages * frontier_frac * (1 + lvl / 4)))
        local = (centre + rng.integers(0, width, size=per // 2)) % num_pages
        rand = rng.integers(0, num_pages, size=per - local.shape[0])
        mix = np.concatenate([local, rand])
        rng.shuffle(mix)
        parts.append(mix)
    pages = np.concatenate(parts)
    loops = np.array([p.shape[0] for p in parts], dtype=np.int64)
    return Trace("bfs", pages.astype(np.int32), num_pages, loops)


def bptree(seed: int = 0, num_pages: int = 4096, lookups: int = 40000,
           levels: int = 4) -> Trace:
    """B+tree lookups: each lookup touches one page per level; level-l page
    chosen from an exponentially growing region (root hot, leaves random)."""
    rng = np.random.default_rng(seed + 8)
    bounds = np.cumsum([max(1, num_pages // (16 ** (levels - l)))
                        for l in range(levels)])
    bounds = np.clip(bounds, 1, num_pages)
    cols = []
    lo = 0
    for l in range(levels):
        hi = int(bounds[l])
        cols.append(rng.integers(lo, max(lo + 1, hi), size=lookups))
        lo = hi
    pages = np.stack(cols, axis=1).reshape(-1)
    loops = np.full(8, pages.shape[0] // 8, dtype=np.int64)
    return Trace("bptree", pages.astype(np.int32), num_pages, loops)


TRACE_GENERATORS: Dict[str, Callable[..., Trace]] = {
    "backprop": backprop,
    "quicksilver": quicksilver,
    "lud": lud,
    "cpd": cpd,
    "pennant": pennant,
    "kmeans": kmeans,
    "hotspot": hotspot,
    "bfs": bfs,
    "bptree": bptree,
}


def available_traces() -> List[str]:
    return sorted(TRACE_GENERATORS)


def generate(name: str, seed: int = 0, **kw) -> Trace:
    """Generate the named application trace deterministically."""
    try:
        gen = TRACE_GENERATORS[name]
    except KeyError as e:
        raise ValueError(
            f"unknown trace {name!r}; available: {available_traces()}") from e
    return gen(seed=seed, **kw)
