"""Cori-tuned HBM <-> host KV-page tiering for the k/v geometry (the
counterpart of ``repro/memtier/tiering.py``).

Mapping (the paper's hybrid memory onto the serving engine):
    DRAM            -> HBM working set      (hbm_pages physical slots)
    PMEM            -> host backing store   (all logical pages)
    page scheduler  -> ``TieringManager.maybe_tier`` every ``period`` steps
    accessed bits   -> per-page attention mass from the decode step
    move_pages()    -> ``SharedPagedPools.migrate_slots``
    Cori            -> ``core.cori.OnlineTuner`` tuning ``period``

The bookkeeping (slot tables, allocator, EMA ranking, swap plans, modeled
costs) is the reference's numpy code unchanged, so the same mass stream
gives the same histories.  The device data path differs in idiom only:
the reference returned new, donated pytrees from jitted scatters; here
the pool tensors are updated in place (``index_put_``), and the
reference's out-of-range "drop" sentinel becomes an explicit mask.  The
"host" tier is a device tensor, as in the reference.  The fault ladder
(migration retry, pin-to-host, capacity squeeze) is a later slice: the
pools carry the inert ``NULL_PLAN``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import cori, reuse
from repro_torch.ft.inject import MigrationError, NULL_PLAN
from repro_torch.obs import telemetry as _obs

__all__ = ["TierConfig", "TieringManager", "SharedPagedPools",
           "bucket_pages", "write_pages_batched", "PAGE_DROP"]


def bucket_pages(n_pages: int, cap: Optional[int] = None) -> int:
    """Shape-bucketed allocation size: round a page count up to the next
    power of two, capped at ``cap`` (the cache-row capacity in pages).
    A request never holds more than 2x its exact page need, and never more
    than one full row."""
    if n_pages <= 0:
        raise ValueError(f"cannot bucket {n_pages} pages")
    if cap is not None and n_pages > cap:
        raise ValueError(f"{n_pages} pages exceed the {cap}-page row cap")
    b = 1 << (n_pages - 1).bit_length()
    return min(b, cap) if cap is not None else b


@dataclasses.dataclass(frozen=True)
class TierConfig:
    page_size: int = 16            # tokens per KV page
    hbm_pages: int = 0             # working-set capacity (physical slots)
    period_steps: int = 8          # tiering period (what Cori tunes)
    ema_alpha: float = 0.5
    access_threshold: float = 0.05  # attention mass to count as "accessed"
    # modeled costs (units: one HBM page-read)
    miss_penalty: float = 32.0     # on-demand host fetch
    mig_cost: float = 16.0         # async page migration
    wakeup_cost: float = 4.0       # scheduler wakeup per period
    # a demand fetch through ``ensure_resident`` moves all its pages in one
    # gathered transfer: what TrafficMonitor charges per ``fetched`` page
    fetch_cost: float = 24.0


#: padding entry of a page-index matrix: rows holding it are not written
PAGE_DROP = np.int32(2 ** 30)


class SharedPagedPools:
    """One HBM slot pool shared by all in-flight requests' KV pages.

    Logical page IDs live in one global space of ``n_logical`` pages;
    requests allocate runs at admission (``alloc``) and return them at
    retirement (``free``).  ``slot_of[gid]`` maps a logical page to its
    HBM slot (-1 = host-only); ``table`` turns a request's page ids into
    the physical table the paged-attention kernel reads.

    Symbolic until ``attach_layered`` gives it storage: one (k, v) leaf
    pair per attention slot, host [R, n_logical, page, KV, D] and HBM
    [R, hbm_pages, page, KV, D], all indirected by the single ``slot_of``
    table -- a logical page is resident for every layer or for none."""

    def __init__(self, n_logical: int, hbm_pages: int):
        if hbm_pages > n_logical:
            raise ValueError("HBM slot pool larger than the logical space")
        self.n_logical = int(n_logical)
        self.hbm_pages = int(hbm_pages)
        self.kv_layers: Optional[Dict[str, List[torch.Tensor]]] = None
        self.layer_meta: Tuple = ()
        #: leaves moved per page migration (tier.move accounting)
        self.move_planes = 2
        self.slot_of = np.full((n_logical,), -1, np.int32)
        self.page_of_slot = np.full((hbm_pages,), -1, np.int32)
        self.owner_of = np.full((n_logical,), -1, np.int64)
        #: fault-injection plan; inert in this slice
        self.fault_plan = NULL_PLAN
        #: bumped on every ``slot_of`` mutation (page-table caches key on it)
        self.slot_epoch = 0
        # free logical ids, popped lowest-first so reuse is deterministic
        self._free_ids: List[int] = list(range(n_logical - 1, -1, -1))
        # per-slot touch tick for the demand-fetch victim choice
        self._slot_tick = np.zeros((hbm_pages,), np.int64)
        self._tick = 0
        self.allocated_pages = 0

    @classmethod
    def create(cls, n_logical: int, hbm_pages: int) -> "SharedPagedPools":
        """Symbolic pools (bookkeeping only); ``attach_layered`` adds the
        page storage."""
        return cls(n_logical, hbm_pages)

    def attach_layered(self, layer_specs: Sequence[Tuple[int, Dict[str,
                       Tuple[int, ...]]]], *, dtype=torch.float32,
                       device=None) -> None:
        """Allocate per-layer page storage from leaf specs: one
        ``(repeats, {leaf_name: trailing_shape})`` entry per layer slot
        (``model.slot_leaf_specs``), zero-filled on ``device`` (default
        cuda).  Host side [R, n_logical, *trailing], HBM side
        [R, hbm_pages, *trailing]."""
        dev = resolve_device(device)
        names: List[str] = []
        for _, leaves in layer_specs:
            for name in leaves:
                if name not in names:
                    names.append(name)
        if set(names) - {"k", "v"}:
            raise NotImplementedError(
                f"leaves {sorted(set(names) - {'k', 'v'})}: the torch port "
                "pages the k/v geometry only (Queue 1 item 8)")
        kv: Dict[str, List[torch.Tensor]] = {
            f"{name}_{tier}": [] for name in names for tier in ("hbm", "host")}
        for r, leaves in layer_specs:
            for name in names:
                trail = tuple(int(x) for x in leaves[name])
                kv[f"{name}_host"].append(torch.zeros(
                    (int(r), self.n_logical) + trail, dtype=dtype,
                    device=dev))
                kv[f"{name}_hbm"].append(torch.zeros(
                    (int(r), self.hbm_pages) + trail, dtype=dtype,
                    device=dev))
        self.kv_layers = kv
        self.layer_meta = tuple(int(r) for r, _ in layer_specs)
        self.move_planes = max((len(lv) for _, lv in layer_specs), default=2)
        if (r := _obs.RECORDER).enabled:
            r.emit("pool.attach", layers=len(self.layer_meta),
                   leaves=",".join(names), planes=self.move_planes)

    # -- views ---------------------------------------------------------------
    @property
    def resident_mask(self) -> np.ndarray:
        return self.slot_of >= 0

    @property
    def allocated_mask(self) -> np.ndarray:
        return self.owner_of >= 0

    @property
    def free_pages(self) -> int:
        return len(self._free_ids)

    def table(self, gids: np.ndarray) -> np.ndarray:
        """Physical HBM slot per global page ID (-1 = host-only)."""
        return self.slot_of[np.asarray(gids, np.int64)]

    # -- allocator -----------------------------------------------------------
    def alloc(self, n_pages: int, owner: int) -> Optional[np.ndarray]:
        """Allocate `n_pages` global page IDs for request `owner`; None when
        the logical space cannot fit the request (caller queues it)."""
        if n_pages > len(self._free_ids):
            return None
        gids = np.asarray([self._free_ids.pop() for _ in range(n_pages)],
                          np.int64)
        self.owner_of[gids] = owner
        self.allocated_pages += n_pages
        if (r := _obs.RECORDER).enabled:
            r.count("pool.alloc_pages", n_pages)
            r.gauge("pool.allocated_frac",
                    self.allocated_pages / self.n_logical)
        return gids

    def free(self, gids: np.ndarray) -> None:
        """Return a retired request's pages; their HBM slots become free."""
        gids = np.asarray(gids, np.int64)
        slots = self.slot_of[gids]
        held = slots[slots >= 0]
        self.page_of_slot[held] = -1
        self.slot_of[gids] = -1
        if held.size:
            self.slot_epoch += 1
        self.owner_of[gids] = -1
        self._free_ids.extend(sorted(gids.tolist(), reverse=True))
        self.allocated_pages -= int(gids.size)
        if (r := _obs.RECORDER).enabled:
            r.count("pool.free_pages", int(gids.size))
            r.gauge("pool.allocated_frac",
                    self.allocated_pages / self.n_logical)
            r.gauge("pool.hbm_resident_frac",
                    float((self.page_of_slot >= 0).sum()) / self.hbm_pages)

    def demote(self, gids: np.ndarray) -> int:
        """Release the HBM slots of ``gids`` without freeing the
        allocation.  The host copy is write-through, so this moves no data;
        the next ``ensure_resident`` fetches the pages back.  Returns the
        number of slots released."""
        gids = np.asarray(gids, np.int64)
        slots = self.slot_of[gids]
        held = slots[slots >= 0]
        self.page_of_slot[held] = -1
        self.slot_of[gids] = -1
        if held.size:
            self.slot_epoch += 1
        return int(held.size)

    # -- physical data path --------------------------------------------------
    def touch_slots(self, slots: np.ndarray) -> None:
        """Mark slots recently used for the demand-fetch victim choice."""
        self._tick += 1
        self._slot_tick[np.asarray(slots, np.int64)] = self._tick

    def migrate_slots(self, slots, logicals) -> None:
        """Copy host pages ``logicals`` into HBM ``slots`` for every leaf of
        every layer: the page, not the (page, layer) pair, is the
        migration unit."""
        if len(slots) == 0:
            return
        if (plan := self.fault_plan).enabled \
                and plan.fires("pool.migrate_fail") is not None:
            raise MigrationError(
                f"injected migrate_slots failure ({len(slots)} pages)")
        if self.kv_layers is None:
            return
        dev = self.kv_layers["k_hbm"][0].device
        sl = torch.as_tensor(np.asarray(slots, np.int64), device=dev)
        lg = torch.as_tensor(np.asarray(logicals, np.int64), device=dev)
        for name in [k for k in self.kv_layers if k.endswith("_hbm")]:
            hosts = self.kv_layers[name[:-4] + "_host"]
            for hbm, host in zip(self.kv_layers[name], hosts):
                hbm[:, sl] = host[:, lg]       # in place

    def _place(self, gids: np.ndarray) -> Tuple[List[int], np.ndarray]:
        """Give every non-resident page in ``gids`` an HBM slot (free slots
        first, then evict the least-recently-ensured resident outside
        ``gids``).  Returns (slots, missing)."""
        gids = np.asarray(gids, np.int64)
        if gids.size > self.hbm_pages:
            raise ValueError(f"{gids.size} pages cannot fit the "
                             f"{self.hbm_pages}-slot HBM pool")
        self._tick += 1
        missing = gids[self.slot_of[gids] < 0]
        slots: List[int] = []
        for gid in missing.tolist():
            free = np.nonzero(self.page_of_slot < 0)[0]
            if free.size:
                slot = int(free[0])
            else:
                prot = np.zeros(self.hbm_pages, bool)
                prot[self.slot_of[gids[self.slot_of[gids] >= 0]]] = True
                victims = np.nonzero(~prot & (self.page_of_slot >= 0))[0]
                slot = int(victims[np.argmin(self._slot_tick[victims])])
                self.slot_of[self.page_of_slot[slot]] = -1
            self.slot_of[gid] = slot
            self.page_of_slot[slot] = gid
            slots.append(slot)
        if missing.size:
            self.slot_epoch += 1
        self._slot_tick[self.slot_of[gids]] = self._tick
        return slots, missing

    def ensure_resident(self, gids: np.ndarray) -> int:
        """Demand-fetch: make every page in `gids` HBM-resident in one
        gathered copy.  Returns the number of pages fetched -- the caller
        charges them as misses."""
        slots, missing = self._place(gids)
        if missing.size:
            self.migrate_slots(slots, missing)
            if (r := _obs.RECORDER).enabled:
                r.count("pool.fetch_misses", int(missing.size))
                r.gauge("pool.hbm_resident_frac",
                        float((self.page_of_slot >= 0).sum())
                        / self.hbm_pages)
        return int(missing.size)

    def assign_slots(self, gids: np.ndarray) -> np.ndarray:
        """``ensure_resident`` without the byte copy: the caller is about
        to overwrite the pages on both tiers (``write_pages_batched``).
        Returns the HBM slot of every page in ``gids``."""
        self._place(gids)
        return self.slot_of[np.asarray(gids, np.int64)].copy()


def write_pages_batched(kv, new_leaves, gids: np.ndarray,
                        slots: np.ndarray) -> None:
    """Write a packed prefill's cache rows for every leaf, layer and joiner
    into the layered pools, host and HBM tiers together, in place.

    kv:         the pools' layered leaves (``SharedPagedPools.kv_layers``).
    new_leaves: {leaf_name: [per-slot arrays or None]}, each [R, J, smax,
                *rest]: the J joiners' cache rows, right-padded to smax.
    gids/slots: int32[J, n_max] logical page ids / HBM slots per joiner
                page; ``PAGE_DROP`` entries (ragged padding) are masked
                out -- the reference dropped them as out-of-range
                scatter indices.
    """
    j, n_max = gids.shape
    gidf, slotf = gids.reshape(-1), slots.reshape(-1)
    for name, layers in new_leaves.items():
        for li, new in enumerate(layers):
            if new is None:
                continue
            host, hbm = kv[f"{name}_host"][li], kv[f"{name}_hbm"][li]
            ps = host.shape[2]
            r, _, smax = new.shape[:3]
            rest = tuple(new.shape[3:])
            if n_max * ps > smax:
                pad = new.new_zeros((r, j, n_max * ps - smax) + rest)
                new = torch.cat([new, pad], dim=2)
            pages = new[:, :, : n_max * ps].reshape((r, j * n_max, ps) + rest)
            for pool, idx in ((host, gidf), (hbm, slotf)):
                keep = idx < pool.shape[1]
                at = torch.as_tensor(idx[keep].astype(np.int64),
                                     device=pool.device)
                pick = torch.as_tensor(np.nonzero(keep)[0],
                                       device=pool.device)
                pool[:, at] = pages[:, pick].to(pool.dtype)


class TieringManager:
    """Periodic page scheduler over a shared pool's working set (the
    reference's ``TieringManager``, numpy bookkeeping unchanged)."""

    _obs_count = 0          # process-wide id counter for telemetry streams

    def __init__(self, n_logical: int, cfg: TierConfig,
                 access_log_len: int = 65536):
        self.cfg = cfg
        self.n = n_logical
        self.hotness = np.zeros(n_logical, np.float64)
        self.last_access = np.full(n_logical, -1.0)
        self.step = 0
        # accessed page ids per step, bounded: it feeds the offline
        # `reuse_histogram`/`cori_candidates` flow (the online tuner keeps
        # its own StreamingReuseCollector)
        self.access_log: "collections.deque[np.ndarray]" = collections.deque(
            maxlen=access_log_len)
        self.counts_since_tier = np.zeros(n_logical, np.float64)
        # live tiering period (what online Cori drives)
        self.period = max(1, int(cfg.period_steps))
        self._since_tier = 0
        # accounting
        self.migrations = 0
        self.modeled_time = 0.0
        self.data_moved_pages = 0
        self.hits = 0
        self.misses = 0
        TieringManager._obs_count += 1
        #: short id tagging this instance's telemetry events ("m1", ...)
        self.obs_id = f"m{TieringManager._obs_count}"

    def set_period(self, period_steps: int) -> None:
        """Change the tiering period live (the online-Cori control knob)."""
        self.period = max(1, int(period_steps))

    def _tier_due(self) -> bool:
        if self._since_tier < self.period:
            return False
        self._since_tier = 0
        return True

    def on_step(self, page_mass: np.ndarray, resident: np.ndarray,
                weight: float = 1.0):
        """page_mass: f32[n_logical] attention mass this decode step;
        resident: bool[n_logical].  ``weight`` is the number of token-steps
        the sample spans (the macro length on the macro path): hotness
        counts and hit/miss costs scale by it."""
        accessed = page_mass >= self.cfg.access_threshold
        self.access_log.append(np.nonzero(accessed)[0].astype(np.int32))
        self.counts_since_tier[accessed] += weight
        self.last_access[accessed] = self.step
        hits = accessed & resident
        misses = accessed & ~resident
        self.hits += int(weight * hits.sum())
        self.misses += int(weight * misses.sum())
        self.modeled_time += weight * (hits.sum() * 1.0
                                       + misses.sum() * self.cfg.miss_penalty)
        self.step += 1
        self._since_tier += 1

    def release(self, ids: np.ndarray) -> None:
        """Forget retired pages: a recycled ID must start cold."""
        ids = np.asarray(ids, np.int64)
        self.hotness[ids] = 0.0
        self.counts_since_tier[ids] = 0.0
        self.last_access[ids] = -1.0

    def _rank_desired(self, resident: np.ndarray,
                      active: Optional[np.ndarray] = None) -> np.ndarray:
        """EMA-update hotness and rank the desired working set (the paper's
        swap rule): hotness primary, recency secondary, residency tertiary;
        with ``active`` only allocated pages are rankable."""
        a = self.cfg.ema_alpha
        self.hotness = a * self.counts_since_tier + (1 - a) * self.hotness
        self.counts_since_tier[:] = 0.0
        score = (self.hotness * 1e6
                 + (self.last_access + 1) / (self.step + 1)
                 + 0.5 * resident)
        desired_set = np.zeros(self.n, bool)
        if active is None:
            desired = np.argsort(-score, kind="stable")[: self.cfg.hbm_pages]
        else:
            ids = np.nonzero(active)[0]
            order = np.argsort(-score[ids], kind="stable")
            desired = ids[order[: self.cfg.hbm_pages]]
        desired_set[desired] = True
        return desired_set

    def _plan_swaps(self, resident: np.ndarray, desired_set: np.ndarray,
                    n_free: int) -> Tuple[np.ndarray, np.ndarray]:
        """(bring, evict) realising the desired set: fill free capacity
        first, then evict lazily."""
        bring = np.nonzero(desired_set & ~resident)[0]
        evict = np.nonzero(resident & ~desired_set)[0]
        n_bring = min(len(bring), n_free + len(evict))
        n_evict = max(0, n_bring - n_free)
        return bring[:n_bring], evict[:n_evict]

    def plan_tier(self, resident: np.ndarray, n_free: int,
                  active: Optional[np.ndarray] = None, *,
                  planes: int = 2, force: bool = False
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The decision half of ``maybe_tier``: gate on the period cadence,
        EMA-rank, plan the swaps and charge the period's modeled cost, from
        a residency snapshot.  Returns ``(bring, evict)`` or None."""
        if self.step == 0:
            return None
        if force:
            self._since_tier = 0
        elif not self._tier_due():
            return None
        cfg = self.cfg
        desired_set = self._rank_desired(resident, active)
        bring, evict = self._plan_swaps(resident, desired_set, int(n_free))
        n_mig = len(bring)
        self.migrations += int(n_mig)
        # evictions move no data: the host copy is write-through
        self.data_moved_pages += planes * int(n_mig)
        self.modeled_time += n_mig * cfg.mig_cost + cfg.wakeup_cost
        if (r := _obs.RECORDER).enabled:
            r.emit("tier.move", manager=self.obs_id, step=self.step,
                   period=self.period, promoted=int(n_mig),
                   evicted=int(len(evict)), pages_moved=planes * int(n_mig),
                   cost=float(n_mig * cfg.mig_cost + cfg.wakeup_cost))
            r.count("tier.pages_moved", planes * int(n_mig))
        return bring, evict

    def apply_plan(self, pools: SharedPagedPools, bring: np.ndarray,
                   evict: np.ndarray) -> None:
        """Actuate a ``plan_tier`` decision on the live pools: pages a
        demand fetch already made resident, or evictions already gone, are
        dropped, and the free-slot arithmetic is redone on the live pool.
        A failing migration rolls the slot bookkeeping back."""
        resident = pools.slot_of >= 0
        bring = np.asarray(bring, np.int64)
        evict = np.asarray(evict, np.int64)
        bring = bring[~resident[bring]]
        evict = evict[resident[evict]]
        free_slots = np.nonzero(pools.page_of_slot < 0)[0]
        n_free = len(free_slots)
        n_bring = min(len(bring), n_free + len(evict))
        n_evict = max(0, n_bring - n_free)
        bring, evict = bring[:n_bring], evict[:n_evict]
        n_mig = len(bring)
        if not n_mig:
            return
        evict_slots = pools.slot_of[evict].copy()
        slots = np.concatenate([
            free_slots[: n_mig - len(evict)],
            evict_slots]).astype(pools.slot_of.dtype)
        pools.slot_of[evict] = -1
        pools.slot_of[bring] = slots
        pools.page_of_slot[slots] = bring
        pools.slot_epoch += 1
        pools.touch_slots(slots)
        try:
            pools.migrate_slots(slots, bring)
        except MigrationError as e:
            pools.slot_of[bring] = -1
            pools.page_of_slot[slots] = -1
            pools.slot_of[evict] = evict_slots
            pools.page_of_slot[evict_slots] = evict
            pools.slot_epoch += 1
            if (r := _obs.RECORDER).enabled:
                r.emit("tier.move_failed", manager=self.obs_id,
                       step=self.step, pages=int(n_mig), attempts=1,
                       detail=str(e))
                r.count("tier.moves_failed")

    def maybe_tier(self, pools: SharedPagedPools,
                   active: Optional[np.ndarray] = None,
                   force: bool = False) -> SharedPagedPools:
        """Tier if a boundary is due (``force=True``: the macro loop wakes
        the host once per period, so every wakeup is a boundary)."""
        n_free = int((pools.page_of_slot < 0).sum())
        plan = self.plan_tier(pools.slot_of >= 0, n_free, active,
                              planes=int(pools.move_planes), force=force)
        if plan is not None:
            self.apply_plan(pools, *plan)
        return pools

    def maybe_tier_symbolic(self, resident: np.ndarray,
                            active: Optional[np.ndarray] = None) -> bool:
        """Tiering over symbolic residency (no pools): same swap rule and
        accounting as ``maybe_tier``.  Mutates ``resident`` in place;
        returns whether a tier happened."""
        if self.step == 0 or not self._tier_due():
            return False
        desired_set = self._rank_desired(resident, active)
        n_free = self.cfg.hbm_pages - int(resident.sum())
        bring, evict = self._plan_swaps(resident, desired_set, n_free)
        n_mig = len(bring)
        self.migrations += n_mig
        self.data_moved_pages += 2 * n_mig
        self.modeled_time += n_mig * self.cfg.mig_cost + self.cfg.wakeup_cost
        if (r := _obs.RECORDER).enabled:
            r.emit("tier.move", manager=self.obs_id, step=self.step,
                   period=self.period, promoted=int(n_mig),
                   evicted=int(len(evict)), pages_moved=2 * int(n_mig),
                   cost=float(n_mig * self.cfg.mig_cost
                              + self.cfg.wakeup_cost))
            r.count("tier.pages_moved", 2 * int(n_mig))
        resident[evict] = False
        resident[bring] = True
        return True

    # -- Cori integration ----------------------------------------------------
    def reuse_histogram(self, bin_width: int = 4) -> reuse.ReuseHistogram:
        """Reuse distances in the decode-step domain from the access log."""
        last = np.full(self.n, -1)
        gaps: List[int] = []
        for t, ids in enumerate(self.access_log):
            prev = last[ids]
            gaps.extend((t - prev[prev >= 0]).tolist())
            last[ids] = t
        h = reuse.loop_duration_histogram(np.asarray(gaps, np.int64),
                                          bin_width=bin_width)
        return reuse.prune_insignificant(h)

    def cori_candidates(self, horizon_steps: int) -> np.ndarray:
        hist = self.reuse_histogram()
        dr = cori.dominant_reuse(hist)
        return cori.candidate_periods(dr, float(horizon_steps),
                                      min_period=1.0)
