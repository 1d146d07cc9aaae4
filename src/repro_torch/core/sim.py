"""Trace-driven hybrid-memory simulator (paper §II-B), PyTorch port of
``repro/core/sim.py``.

Models a flat DRAM+PMEM system in the *request domain*: a period is a fixed
number of memory requests.  Runtime is the aggregate access latency under
the current placement, plus bandwidth-pressure delays, plus constant
per-migration and per-period scheduler overheads.  Defaults follow the
paper: fast:slow latency 1:3, bandwidth 1:0.37, fast capacity 20% of the
footprint, interleaved initial placement, per-period swaps of hot pages in
and LRU pages out.  Two page schedulers: *reactive* (EMA over past periods)
and *predictive* (oracular counts of the coming period).

The trace is binned once into fixed-size blocks (``bin_trace``, one
``page_hist`` kernel launch on the card) and the block histogram stays on
the device.  ``simulate`` and ``sweep`` run on the device of
``bins.block_hist``: each candidate period's histogram is aggregated there
and scanned by the ``sim_scan`` kernel (its plain version on the CPU) --
``simulate`` is one launch with one candidate; ``sweep`` hands all its
candidates' period rows to one launch (``sweep_groups``: more only where
they exceed ``SWEEP_CHUNK_ELEMS``) and reads the results back once.
"""
from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.traces import Trace
from repro_torch.kernels import ops
from repro_torch.kernels.sim_step import sim_scan, sim_scan_rows

__all__ = [
    "SimConfig",
    "TraceBins",
    "SimResult",
    "bin_trace",
    "simulate",
    "sweep",
    "sweep_loop",
    "sweep_plan",
    "sweep_stacks",
    "sweep_launches",
    "sweep_groups",
    "exhaustive_periods",
    "simulate_reference",
    "interleaved_indices",
    "SCHEDULERS",
]

SCHEDULERS = ("reactive", "predictive")

# Default monitoring block: 100 requests == the finest period in Table I
# (Kleio).  All candidate periods are multiples of this block.
DEFAULT_BLOCK = 100

# Float32 prefix sums of integer counts are exact while every cumulative
# count stays below 2**24; past this many accesses `_device_period_hists`
# aggregates each candidate by a reshape-sum instead.
EXACT_CUMSUM_LIMIT = 2 ** 24

# The period rows alive at once for one ``sweep`` launch (and one
# ``sweep_stacks`` chunk) stay within this many float32 elements (~256 MB),
# unless one candidate alone needs more.
SWEEP_CHUNK_ELEMS = 64 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Hybrid memory + page scheduler cost model.

    Time unit == one fast-memory access.
    """

    fast_frac: float = 0.20        # DRAM share of footprint (20%:80% paper split)
    lat_fast: float = 1.0
    lat_slow: float = 3.0          # 1:3 latency ratio (paper §II-B)
    bw_slow: float = 0.37          # slow tier serves 0.37 req/unit vs 1.0 fast
    bw_penalty: float = 3.0        # extra units per over-bandwidth slow request
    # Scheduler overheads ([22],[30]): one unit == one fast access (~100 ns
    # LLC miss).  A move_pages() swap is us-scale -> ~20 units; every period
    # the scheduler scans the whole footprint's PTE accessed bits -> cost
    # proportional to the footprint, plus a fixed wakeup.
    mig_cost: float = 20.0         # constant delay per page migration
    period_cost: float = 10.0      # fixed delay per period (wakeup)
    scan_cost_per_page: float = 0.25  # PTE-scan cost x footprint, per period
    ema_alpha: float = 0.5         # smoothing factor for the accessed-history EMA

    def fast_capacity(self, num_pages: int) -> int:
        return max(1, int(round(num_pages * self.fast_frac)))

    def period_overhead(self, num_pages: int) -> float:
        return self.period_cost + self.scan_cost_per_page * num_pages


@dataclasses.dataclass(frozen=True)
class TraceBins:
    """Per-block page-access histogram of a trace (computed once per trace,
    shared by every candidate period / scheduler).  ``block_hist`` is a
    float32 [num_blocks, num_pages] tensor on the device it was binned on."""

    name: str
    block_hist: torch.Tensor  # float32[num_blocks, num_pages]
    block: int                # requests per block
    num_accesses: int
    num_pages: int

    @property
    def num_blocks(self) -> int:
        return int(self.block_hist.shape[0])


@dataclasses.dataclass(frozen=True)
class SimResult:
    runtime: float           # simulated time units
    data_moved_pages: float  # pages migrated (both directions of each swap)
    migrations: float        # swap count
    fast_hits: float         # requests serviced from fast memory
    num_accesses: int
    period_requests: int
    scheduler: str

    @property
    def slowdown_vs_infinite_dram(self) -> float:
        return self.runtime / (self.num_accesses * 1.0)

    @property
    def fast_hitrate(self) -> float:
        return self.fast_hits / max(1, self.num_accesses)


def bin_trace(trace: Trace, block: int = DEFAULT_BLOCK,
              device=None) -> TraceBins:
    """Bin a trace into [num_blocks, num_pages] access counts, on ``device``
    (the card unless the caller asks for another): one ``page_hist`` call
    with one row of ``block`` ids per block, the tail padded with -1."""
    dev = resolve_device(device)
    pages = np.asarray(trace.pages, dtype=np.int64)
    n = pages.shape[0]
    num_blocks = (n + block - 1) // block
    ids = np.full(num_blocks * block, -1, np.int32)
    ids[:n] = pages
    ids = torch.from_numpy(ids).to(dev).reshape(num_blocks, block)
    zeros = torch.zeros((trace.num_pages,), dtype=torch.float32, device=dev)
    hist = ops.page_hist(ids, zeros)[0]
    return TraceBins(trace.name, hist, block, n, trace.num_pages)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def _aggregate_periods(bins: TraceBins, k_blocks: int
                       ) -> Tuple[torch.Tensor, int]:
    """Sum consecutive k blocks into periods; pad period count to pow2."""
    nb, npg = bins.block_hist.shape
    num_periods = (nb + k_blocks - 1) // k_blocks
    p2 = _next_pow2(num_periods)
    h = bins.block_hist
    pad_blocks = num_periods * k_blocks - nb
    if pad_blocks:
        h = torch.cat([h, h.new_zeros((pad_blocks, npg))])
    ph = h.reshape(num_periods, k_blocks, npg).sum(dim=1)
    if p2 > num_periods:
        ph = torch.cat([ph, ph.new_zeros((p2 - num_periods, npg))])
    return ph, num_periods


def interleaved_indices(num_pages: int, capacity: int) -> np.ndarray:
    """The paper's SII-B initial placement: `capacity` page indices evenly
    interleaved over the footprint.  Single source of truth shared by the
    simulator, the symbolic tiering replay and the physical page pools."""
    return (np.arange(capacity, dtype=np.int64) * num_pages) // max(1,
                                                                    capacity)


def _interleaved_init(num_pages: int, capacity: int) -> np.ndarray:
    """Initial interleaved placement as a residency mask."""
    init = np.zeros(num_pages, dtype=bool)
    init[interleaved_indices(num_pages, capacity)] = True
    return init


def _scan(bins: TraceBins, stack: torch.Tensor, nreals: List[int],
          scheduler: str, cfg: SimConfig, starts=None) -> List[List[float]]:
    """One ``sim_scan`` launch over a [C, P, n] stack, or with ``starts``
    one ``sim_scan_rows`` launch over [R, n] rows; returns the (runtimes,
    swaps, hits) lists, read back together."""
    dev = stack.device
    capacity = cfg.fast_capacity(bins.num_pages)
    init_fast = torch.from_numpy(_interleaved_init(bins.num_pages,
                                                   capacity)).to(dev)
    kw = dict(predictive=(scheduler == "predictive"), capacity=capacity,
              lat_fast=cfg.lat_fast, lat_slow=cfg.lat_slow,
              bw_slow=cfg.bw_slow, bw_penalty=cfg.bw_penalty,
              mig_cost=cfg.mig_cost,
              period_overhead=cfg.period_overhead(bins.num_pages),
              ema_alpha=cfg.ema_alpha)
    if starts is None:
        out = sim_scan(stack, torch.tensor(nreals, dtype=torch.int32,
                                           device=dev), init_fast, **kw)
    else:
        out = sim_scan_rows(stack, starts, nreals, init_fast, **kw)
    return torch.stack(out).tolist()


def simulate(bins: TraceBins, period_requests: int, scheduler: str = "reactive",
             cfg: SimConfig = SimConfig()) -> SimResult:
    """Simulate one (trace, period, scheduler) combination: one ``sim_scan``
    launch with one candidate."""
    if scheduler not in SCHEDULERS:
        raise ValueError(f"scheduler must be one of {SCHEDULERS}")
    k = max(1, int(round(period_requests / bins.block)))
    period_hist, num_periods = _aggregate_periods(bins, k)
    (rt,), (swaps,), (hits,) = _scan(bins, period_hist[None], [num_periods],
                                     scheduler, cfg)
    return SimResult(
        runtime=rt, data_moved_pages=swaps * 2.0, migrations=swaps,
        fast_hits=hits, num_accesses=bins.num_accesses,
        period_requests=k * bins.block, scheduler=scheduler)


def sweep_loop(bins: TraceBins, periods, scheduler: str = "reactive",
               cfg: SimConfig = SimConfig()) -> Dict[int, SimResult]:
    """Per-candidate `simulate` loop (the pre-batching reference path),
    kept as the equivalence oracle for the batched `sweep`."""
    out: Dict[int, SimResult] = {}
    for p in periods:
        r = simulate(bins, int(p), scheduler, cfg)
        out[r.period_requests] = r
    return out


def _agg_rows(h: torch.Tensor, m: int) -> torch.Tensor:
    """Sum every m consecutive rows (device-side period aggregation)."""
    p = h.shape[0]
    pp = -(-p // m) * m
    if pp > p:
        h = torch.cat([h, h.new_zeros((pp - p, h.shape[1]))])
    return h.reshape(pp // m, m, h.shape[1]).sum(dim=1)


# Device-resident prefix sums of each TraceBins' block histogram, keyed by
# object identity and evicted when the bins are collected: tuners call
# `sweep` many times on the same trace.
_CUM_CACHE: Dict[int, torch.Tensor] = {}


def _cum_hist(bins: TraceBins) -> torch.Tensor:
    key = id(bins)
    cum = _CUM_CACHE.get(key)
    if cum is None:
        cum = torch.cumsum(bins.block_hist, dim=0)
        _CUM_CACHE[key] = cum
        weakref.finalize(bins, _CUM_CACHE.pop, key, None)
    return cum


def _device_period_hists(bins: TraceBins, ks
                         ) -> Dict[int, Tuple[torch.Tensor, int]]:
    """Period histograms for every candidate, aggregated on the device.

    The block histogram is prefix-summed along the block axis once; each
    candidate's period rows are then differences of the cumulative sums at
    its own period boundaries.  Counts are integer-valued, so while the
    cumulative counts stay below 2**24 (``EXACT_CUMSUM_LIMIT`` accesses) the
    float32 prefix sums and their differences are exact and equal to
    `_aggregate_periods`; beyond that each candidate is reshape-summed."""
    ks = sorted(set(ks))
    if bins.num_accesses >= EXACT_CUMSUM_LIMIT:
        return {k: (_agg_rows(bins.block_hist, k), -(-bins.num_blocks // k))
                for k in ks}
    cum = _cum_hist(bins)
    zero = cum.new_zeros((1, bins.num_pages))
    out: Dict[int, Tuple[torch.Tensor, int]] = {}
    for k in ks:
        nr = -(-bins.num_blocks // k)
        ends = np.minimum(np.arange(1, nr + 1) * k, bins.num_blocks) - 1
        at_ends = cum[torch.from_numpy(ends).to(cum.device)]
        out[k] = (at_ends - torch.cat([zero, at_ends[:-1]]), nr)
    return out


def sweep_plan(bins: TraceBins, periods) -> List[Tuple[int, List[int]]]:
    """A batching of ``periods`` into stacks that ``sim_scan`` takes: a
    list of ``(p2, ks)`` chunks, one launch each.  Candidates (block counts
    ``ks``) whose pow2-padded period counts coincide share a stack; a stack
    holds at most ``SWEEP_CHUNK_ELEMS`` float32 elements.  ``sweep`` itself
    launches ``sweep_groups``; the chunks are the per-chunk route it is
    held to."""
    ks = sorted({max(1, int(round(int(p) / bins.block))) for p in periods})
    groups: Dict[int, List[int]] = {}
    for k in ks:
        groups.setdefault(_next_pow2(-(-bins.num_blocks // k)), []).append(k)
    plan = []
    for p2, group in groups.items():
        max_c = max(1, SWEEP_CHUNK_ELEMS // (p2 * bins.num_pages))
        for lo in range(0, len(group), max_c):
            plan.append((p2, group[lo: lo + max_c]))
    return plan


def sweep_stacks(bins: TraceBins, periods):
    """The candidate stacks of the ``sweep_plan`` chunks, one per chunk:
    yields ``(ks, stack, nreals)`` with ``stack`` a float32 [C, p2,
    num_pages] tensor on the bins' device (each candidate's period rows,
    aggregated there by `_device_period_hists`, zero-padded to the chunk's
    pow2 period count) and ``nreals`` its real period counts."""
    plan = sweep_plan(bins, periods)
    if not plan:
        return
    hists = _device_period_hists(bins, [k for _, ks in plan for k in ks])
    for p2, ks in plan:
        stack = bins.block_hist.new_zeros((len(ks), p2, bins.num_pages))
        for j, k in enumerate(ks):
            stack[j, : hists[k][1]] = hists[k][0]
        yield ks, stack, [hists[k][1] for k in ks]


def sweep_launches(bins: TraceBins, periods) -> List[List[int]]:
    """How ``sweep`` launches ``periods``: the candidates (block counts)
    of each ``sim_scan_rows`` launch, longest first.  One launch takes
    candidates while their real period rows stay within
    ``SWEEP_CHUNK_ELEMS`` elements, so a sweep at realistic sizes is one
    launch (a candidate that alone needs more gets a launch of its own)."""
    ks = sorted({max(1, int(round(int(p) / bins.block))) for p in periods})
    launches: List[List[int]] = []
    used = 0
    for k in ks:
        elems = -(-bins.num_blocks // k) * bins.num_pages
        if not launches or used + elems > SWEEP_CHUNK_ELEMS:
            launches.append([])
            used = 0
        launches[-1].append(k)
        used += elems
    return launches


def sweep_groups(bins: TraceBins, periods):
    """The rows ``sweep`` scans, one group per ``sweep_launches`` entry:
    yields ``(ks, rows, starts, nreals)`` with ``rows`` a float32 [R,
    num_pages] tensor on the bins' device holding each candidate's real
    period rows back to back (aggregated there by `_device_period_hists`;
    no padding), candidate j's at ``rows[starts[j]: starts[j] +
    nreals[j]]``."""
    for ks in sweep_launches(bins, periods):
        hists = _device_period_hists(bins, ks)
        nreals = [hists[k][1] for k in ks]
        starts = list(itertools.accumulate([0] + nreals[:-1]))
        rows = torch.cat([hists[k][0] for k in ks])
        del hists
        yield ks, rows, starts, nreals


def sweep(bins: TraceBins, periods, scheduler: str = "reactive",
          cfg: SimConfig = SimConfig()) -> Dict[int, SimResult]:
    """Simulate a set of candidate periods (requests) in one batched pass:
    each of ``sweep_groups``' groups -- at realistic sizes the whole set --
    is driven through one ``sim_scan_rows`` launch and read back once.
    Results match `sweep_loop` exactly -- same per-period math, each
    candidate scanning its own real periods."""
    if scheduler not in SCHEDULERS:
        raise ValueError(f"scheduler must be one of {SCHEDULERS}")
    out: Dict[int, SimResult] = {}
    for ks, rows, starts, nreals in sweep_groups(bins, periods):
        rts, swaps, hits = _scan(bins, rows, nreals, scheduler, cfg, starts)
        for i, k in enumerate(ks):
            out[k * bins.block] = SimResult(
                runtime=rts[i], data_moved_pages=swaps[i] * 2.0,
                migrations=swaps[i], fast_hits=hits[i],
                num_accesses=bins.num_accesses,
                period_requests=k * bins.block, scheduler=scheduler)
    return out


def exhaustive_periods(bins: TraceBins, max_candidates: int = 128) -> np.ndarray:
    """The O(N) candidate space at block granularity: every period in
    [block, N/2], geometrically subsampled to `max_candidates` values."""
    lo, hi = bins.block, max(bins.block, bins.num_accesses // 2)
    ks = np.unique(np.round(np.geomspace(lo, hi, max_candidates)
                            / bins.block).astype(np.int64))
    # Same snapping as `simulate` (round-to-block), endpoint included.
    ks = np.unique(np.concatenate(
        [ks[ks >= 1], [max(1, int(round(hi / bins.block)))]]))
    return ks * bins.block


# ----------------------------------------------------------------------------
# Pure-numpy reference (oracle for tests; mirrors the scan step for step).
# ----------------------------------------------------------------------------

def simulate_reference(bins: TraceBins, period_requests: int,
                       scheduler: str = "reactive",
                       cfg: SimConfig = SimConfig()) -> SimResult:
    k = max(1, int(round(period_requests / bins.block)))
    period_hist, num_periods = _aggregate_periods(bins, k)
    period_hist = period_hist.cpu().numpy()
    num_pages = bins.num_pages
    capacity = cfg.fast_capacity(num_pages)
    in_fast = _interleaved_init(num_pages, capacity)
    hotness = np.zeros(num_pages, np.float64)
    last_access = np.full(num_pages, -1.0)
    runtime = swaps_total = fast_hits = 0.0
    for i in range(num_periods):
        counts = period_hist[i].astype(np.float64)
        rank = counts if scheduler == "predictive" else hotness
        recency = (last_access + 1.0) / (i + 2.0)
        # float32 scoring to match the scan bit-for-bit on ties.
        score = (np.float32(1e6) * rank.astype(np.float32)
                 + recency.astype(np.float32)
                 + np.float32(0.5) * in_fast.astype(np.float32))
        top = np.argsort(-score, kind="stable")[:capacity]
        new_fast = np.zeros(num_pages, bool)
        new_fast[top] = True
        swaps = float(np.sum(new_fast & ~in_fast))
        total = counts.sum()
        n_fast = float(counts[new_fast].sum())
        n_slow = total - n_fast
        runtime += (n_fast * cfg.lat_fast + n_slow * cfg.lat_slow
                    + max(0.0, n_slow - cfg.bw_slow * total) * cfg.bw_penalty
                    + swaps * cfg.mig_cost + cfg.period_overhead(num_pages))
        swaps_total += swaps
        fast_hits += n_fast
        hotness = cfg.ema_alpha * counts + (1 - cfg.ema_alpha) * hotness
        last_access = np.where(counts > 0, float(i), last_access)
        in_fast = new_fast
    return SimResult(runtime=runtime, data_moved_pages=swaps_total * 2,
                     migrations=swaps_total, fast_hits=fast_hits,
                     num_accesses=bins.num_accesses,
                     period_requests=k * bins.block, scheduler=scheduler)
