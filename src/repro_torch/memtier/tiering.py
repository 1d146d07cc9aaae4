"""Cori-tuned HBM <-> host page tiering for every served geometry -- k/v
token rows, MLA's compressed ckv/krope rows and recurrent cells' packed
state pages (the counterpart of ``repro/memtier/tiering.py``).

Mapping (the paper's hybrid memory onto the serving engine):
    DRAM            -> HBM working set      (hbm_pages physical slots)
    PMEM            -> host backing store   (all logical pages)
    page scheduler  -> ``TieringManager.maybe_tier`` every ``period`` steps
    accessed bits   -> per-page attention mass from the decode step
    move_pages()    -> ``SharedPagedPools.migrate_slots`` (the serving
                       pools) / ``PagedPools.migrate_slots`` (one layer's
                       k/v pages, the single-stream physical replay)
    Cori            -> ``core.cori.OnlineTuner`` tuning ``period``

The bookkeeping (slot tables, allocator, EMA ranking, swap plans, modeled
costs) is the reference's numpy code unchanged, so the same mass stream
gives the same histories.  The device data path differs in idiom only:
the reference returned new, donated pytrees from jitted scatters; here
the pool tensors are updated in place (``index_put_``), and the
reference's out-of-range "drop" sentinel becomes an explicit mask, and
the index arrays reach a card through pinned memory without the host
waiting (``_index``), so pool writes queue behind an in-flight decode
macro as the reference's lazy arrays do.  The "host" tier is a device
tensor, as in the reference.

The degradation ladder is the reference's (``docs/robustness.md``), run
under the pools' ``fault_plan`` (the inert ``NULL_PLAN`` unless a batcher
passes one): a failing migration is retried with backoff, then copied by
the degraded path that cannot fail, and its pages pin to the host for a
cooldown (``apply_plan`` skips them; their fetches are counted in
``degraded_fetches``, which the serving loop re-prices); a failed
promotion batch rolls the slot bookkeeping back; and a capacity squeeze
lowers ``effective_hbm``, against which placement, the tiering budget
and the batcher's admission gate and preemption all count.  An injected
failure raises before any copy is queued, and the rollback restores the
tables before a later upload reads them.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import ClassVar, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import cori, reuse
from repro_torch.core.sim import interleaved_indices
from repro_torch.ft.inject import MigrationError, NULL_PLAN
from repro_torch.obs import telemetry as _obs

__all__ = ["TierConfig", "TieringManager", "PagedPools", "SharedPagedPools",
           "bucket_pages", "write_pages_batched", "write_state_pages",
           "PAGE_DROP"]


def _index(a, device) -> torch.Tensor:
    """An int64 index tensor on ``device`` from array-like ``a``.  On a
    card the host does not wait for the stream: the array is staged in
    pinned memory and copied non-blocking (the caching host allocator
    keeps the staging buffer until its copy is done)."""
    a = np.ascontiguousarray(np.asarray(a, np.int64))
    if torch.device(device).type != "cuda":
        return torch.as_tensor(a, device=device)
    return torch.from_numpy(a).pin_memory().to(device, non_blocking=True)


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


@dataclasses.dataclass
class PagedPools:
    """Physical k/v page pools of one layer for a single stream: the host
    tier holds every logical page, the HBM tier the resident working set,
    both on the tensors' device.  ``slot_of[logical] == -1`` means
    host-only."""
    k_host: torch.Tensor           # [n_logical, page, kv, d]
    v_host: torch.Tensor
    k_hbm: torch.Tensor            # [hbm_pages, page, kv, d]
    v_hbm: torch.Tensor
    slot_of: np.ndarray            # int32[n_logical] -> hbm slot | -1
    page_of_slot: np.ndarray       # int32[hbm_pages] -> logical | -1
    #: bumped whenever slot_of changes (page-table caches key on it)
    slot_epoch: int = 0
    #: leaves moved per page migration (tier.move accounting): k and v
    move_planes: ClassVar[int] = 2

    @classmethod
    def create(cls, k_pages, v_pages, hbm_pages: int) -> "PagedPools":
        """Interleaved initial residency (paper SII-B initial placement):
        the HBM tier starts as copies of the interleaved pages."""
        n = k_pages.shape[0]
        init = interleaved_indices(n, hbm_pages).astype(np.int32)
        slot_of = np.full((n,), -1, np.int32)
        slot_of[init] = np.arange(hbm_pages)
        at = torch.as_tensor(init.astype(np.int64), device=k_pages.device)
        return cls(k_host=k_pages, v_host=v_pages, k_hbm=k_pages[at],
                   v_hbm=v_pages[at], slot_of=slot_of,
                   page_of_slot=init.copy())

    def touch_slots(self, slots: np.ndarray) -> None:
        """No-op: a single stream's pool has no demand-fetch path, so slot
        recency is not kept (``SharedPagedPools`` keeps it)."""

    def migrate_slots(self, slots, logicals) -> None:
        """Copy host pages ``logicals`` into HBM ``slots`` (k and v), in
        place."""
        if len(slots) == 0:
            return
        dev = self.k_hbm.device
        sl = torch.as_tensor(np.asarray(slots, np.int64), device=dev)
        lg = torch.as_tensor(np.asarray(logicals, np.int64), device=dev)
        self.k_hbm.index_copy_(0, sl, self.k_host.index_select(0, lg))
        self.v_hbm.index_copy_(0, sl, self.v_host.index_select(0, lg))


class SharedPagedPools:
    """One HBM slot pool shared by all in-flight requests' KV pages.

    Logical page IDs live in one global space of ``n_logical`` pages;
    requests allocate runs at admission (``alloc``) and return them at
    retirement (``free``).  ``slot_of[gid]`` maps a logical page to its
    HBM slot (-1 = host-only); ``table`` turns a request's page ids into
    the physical table the paged-attention kernel reads.

    Storage comes in two forms, both indirected by the single ``slot_of``
    table (a logical page is resident for every leaf or for none):

      * the *legacy single-layer* pair (``create`` with a page geometry):
        ``k_host``/``v_host`` [n_logical, page, KV, D] and
        ``k_hbm``/``v_hbm`` [hbm_pages, page, KV, D], which the dense
        batcher's ``mirror_pages`` fills page by page (``write_page``);
      * the *layered* leaves ``attach_layered`` adds for the fully-paged
        decode: one leaf set per slot -- (k, v) [.., page, KV, D], MLA
        (ckv, krope) [.., page, kv_lora|rope] or a recurrent cell's
        ``state`` [.., state_dim] --, host [R, n_logical, ...] and HBM
        [R, hbm_pages, ...].

    With neither the pools are symbolic: only the residency and
    allocation bookkeeping runs (the model-free ``TrafficScheduler``)."""

    def __init__(self, n_logical: int, hbm_pages: int, *, k_host=None,
                 v_host=None, k_hbm=None, v_hbm=None):
        if hbm_pages > n_logical:
            raise ValueError("HBM slot pool larger than the logical space")
        self.n_logical = int(n_logical)
        self.hbm_pages = int(hbm_pages)
        self.k_host, self.v_host = k_host, v_host
        self.k_hbm, self.v_hbm = k_hbm, v_hbm
        self.kv_layers: Optional[Dict[str, List[torch.Tensor]]] = None
        #: the same leaves with their sink page (``attach_layered``)
        self.kv_with_sink: Optional[Dict[str, List[torch.Tensor]]] = None
        self.layer_meta: Tuple = ()
        #: leaves moved per page migration (tier.move accounting)
        self.move_planes = 2
        self.slot_of = np.full((n_logical,), -1, np.int32)
        self.page_of_slot = np.full((hbm_pages,), -1, np.int32)
        self.owner_of = np.full((n_logical,), -1, np.int64)
        #: fault-injection plan (the chaos harness); inert by default
        self.fault_plan = NULL_PLAN
        #: live capacity in pages: ``hbm_pages``, lower under an injected
        #: ``pool.squeeze`` (placement, the tiering budget and the
        #: batcher's gate and preemption count against it)
        self.effective_hbm = int(hbm_pages)
        #: the ladder's first rung: migration retries with backoff
        self.migrate_retries = 2
        self.retry_backoff_s = 0.001
        #: pages whose migration exhausted its retries serve pinned to the
        #: host until this placement tick: ``apply_plan`` skips them and
        #: their fetches take the degraded path
        self._pin_until = np.zeros((n_logical,), np.int64)
        self.pin_cooldown = 64
        #: degraded fetches since the caller last drained this (the
        #: batcher charges them at ``miss_penalty`` in the tuner's window)
        self.degraded_fetches = 0
        #: bumped on every ``slot_of`` mutation (page-table caches key on it)
        self.slot_epoch = 0
        # free logical ids, popped lowest-first so reuse is deterministic
        self._free_ids: List[int] = list(range(n_logical - 1, -1, -1))
        # per-slot touch tick for the demand-fetch victim choice
        self._slot_tick = np.zeros((hbm_pages,), np.int64)
        self._tick = 0
        self.allocated_pages = 0
        #: the most pages ever allocated at once (bucket-rounded rows: what
        #: the traffic replay compares with the dense provisioning)
        self.peak_allocated = 0

    @classmethod
    def create(cls, n_logical: int, hbm_pages: int, *,
               page_size: Optional[int] = None, kv_heads: int = 0,
               head_dim: int = 0, device=None) -> "SharedPagedPools":
        """The legacy single-layer pair, float32 and zero-filled on
        ``device`` (default cuda), when a page geometry is given; symbolic
        pools otherwise (``attach_layered`` may add layered storage to
        either)."""
        if page_size is None:
            return cls(n_logical, hbm_pages)
        dev = resolve_device(device)
        zeros = lambda n: torch.zeros((n, page_size, kv_heads, head_dim),
                                      dtype=torch.float32, device=dev)
        return cls(n_logical, hbm_pages, k_host=zeros(n_logical),
                   v_host=zeros(n_logical), k_hbm=zeros(hbm_pages),
                   v_hbm=zeros(hbm_pages))

    def attach_layered(self, layer_specs: Sequence[Tuple[int, Dict[str,
                       Tuple[int, ...]]]], *, dtype=torch.float32,
                       device=None) -> None:
        """Allocate per-layer page storage from leaf specs: one
        ``(repeats, {leaf_name: trailing_shape})`` entry per layer slot
        (``model.slot_leaf_specs``: ``k``/``v`` for attention slots,
        compressed ``ckv``/``krope`` for MLA slots, ``state`` for
        recurrent cells: one page per request), zero-filled on
        ``device`` (default cuda).  Host side [R, n_logical, *trailing],
        HBM side [R, hbm_pages, *trailing].  A layer lacking a leaf holds
        ``None`` in that leaf's per-layer list, as the reference.

        Each leaf is allocated with one more page, the *sink*: no table
        ever names it, and the decode's write-through sends the rows that
        must not write (dead rows, unmapped write pages) there, where the
        reference dropped them as out-of-range scatter indices
        (``PAGE_DROP``).  ``kv_layers`` holds views without the sink;
        ``kv_with_sink`` the same storage with it, for the decode."""
        dev = resolve_device(device)
        names: List[str] = []
        for _, leaves in layer_specs:
            for name in leaves:
                if name not in names:
                    names.append(name)
        kv: Dict[str, List[Optional[torch.Tensor]]] = {
            f"{name}_{tier}": [] for name in names for tier in ("hbm", "host")}
        sunk = {key: [] for key in kv}
        for r, leaves in layer_specs:
            for name in names:
                for tier, n in (("host", self.n_logical),
                                ("hbm", self.hbm_pages)):
                    key = f"{name}_{tier}"
                    if name not in leaves:
                        kv[key].append(None)
                        sunk[key].append(None)
                        continue
                    trail = tuple(int(x) for x in leaves[name])
                    full = torch.zeros((int(r), n + 1) + trail, dtype=dtype,
                                       device=dev)
                    sunk[key].append(full)
                    kv[key].append(full[:, :n])
        self.kv_layers = kv
        self.kv_with_sink = sunk
        self.layer_meta = tuple(int(r) for r, _ in layer_specs)
        # pages_moved accounting: the planes (leaves) one logical-page
        # migration moves -- k + v, ckv + krope for MLA, 1 for state-only
        # pools
        self.move_planes = max((len(lv) for _, lv in layer_specs), default=2)
        if (r := _obs.RECORDER).enabled:
            r.emit("pool.attach", layers=len(self.layer_meta),
                   leaves=",".join(names), planes=self.move_planes)

    # -- views ---------------------------------------------------------------
    @property
    def physical(self) -> bool:
        return self.k_host is not None or self.kv_layers is not None

    @property
    def resident_mask(self) -> np.ndarray:
        return self.slot_of >= 0

    @property
    def allocated_mask(self) -> np.ndarray:
        return self.owner_of >= 0

    @property
    def free_pages(self) -> int:
        return len(self._free_ids)

    @property
    def hbm_occupied(self) -> int:
        return int((self.page_of_slot >= 0).sum())

    def host_pinned(self, gids: np.ndarray) -> np.ndarray:
        """bool per gid: pinned to the host by a retry-exhausted migration
        (the cooldown counts placement ticks)."""
        return self._pin_until[np.asarray(gids, np.int64)] > self._tick

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
        self.peak_allocated = max(self.peak_allocated, self.allocated_pages)
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
            if (r := _obs.RECORDER).enabled:
                r.gauge("pool.hbm_resident_frac",
                        float((self.page_of_slot >= 0).sum())
                        / self.hbm_pages)
        return int(held.size)

    # -- physical data path --------------------------------------------------
    def write_page(self, gid: int, k_page, v_page) -> None:
        """Write one logical page's k/v rows [page, KV, D] into the legacy
        pair in place: the host copy, and the HBM slot when the page is
        resident (the write-through of a dense decode step's append).  A
        no-op without the legacy pair; the layered leaves are written by
        the paged decode itself."""
        if self.k_host is None:
            return
        self.k_host[gid] = k_page
        self.v_host[gid] = v_page
        slot = int(self.slot_of[gid])
        if slot >= 0:
            self.k_hbm[slot] = k_page
            self.v_hbm[slot] = v_page

    def touch_slots(self, slots: np.ndarray) -> None:
        """Mark slots recently used for the demand-fetch victim choice."""
        self._tick += 1
        self._slot_tick[np.asarray(slots, np.int64)] = self._tick

    def migrate_slots(self, slots, logicals, *, degraded: bool = False
                      ) -> None:
        """Copy host pages ``logicals`` into HBM ``slots`` on every physical
        pool: the legacy pair and every leaf of every layer (the page, not
        the (page, layer) pair, is the migration unit).

        The plan's transport faults (``pool.migrate_slow`` sleeps,
        ``pool.migrate_fail`` raises ``MigrationError``) act before any
        index is uploaded or copy queued.  ``degraded=True`` is the
        retry-exhausted path: the same device copy, which the plan does
        not touch (only its modeled price differs, charged by the
        caller)."""
        if len(slots) == 0:
            return
        if not degraded and (plan := self.fault_plan).enabled:
            if (p := plan.fires("pool.migrate_slow")) is not None:
                time.sleep(float(p.value))
            if plan.fires("pool.migrate_fail") is not None:
                raise MigrationError(
                    f"injected migrate_slots failure ({len(slots)} pages)")
        if self.k_host is not None:
            dev = self.k_host.device
            sl, lg = _index(slots, dev), _index(logicals, dev)
            self.k_hbm[sl] = self.k_host[lg]       # in place
            self.v_hbm[sl] = self.v_host[lg]
        if self.kv_layers is None:
            return
        dev = next(t.device for leaves in self.kv_layers.values()
                   for t in leaves if t is not None)
        sl, lg = _index(slots, dev), _index(logicals, dev)
        for name in [k for k in self.kv_layers if k.endswith("_hbm")]:
            hosts = self.kv_layers[name[:-4] + "_host"]
            for hbm, host in zip(self.kv_layers[name], hosts):
                if hbm is not None:
                    hbm[:, sl] = host[:, lg]       # in place

    def _place(self, gids: np.ndarray) -> Tuple[List[int], np.ndarray]:
        """Give every non-resident page in ``gids`` an HBM slot: a free
        slot while the occupancy is under ``effective_hbm``, else the
        least-recently-ensured resident outside ``gids`` is evicted; when
        every occupied slot is protected (a squeeze below the working
        set), a free slot is taken all the same.  Returns (slots,
        missing)."""
        gids = np.asarray(gids, np.int64)
        if gids.size > self.hbm_pages:
            raise ValueError(f"{gids.size} pages cannot fit the "
                             f"{self.hbm_pages}-slot HBM pool")
        self._tick += 1
        missing = gids[self.slot_of[gids] < 0]
        slots: List[int] = []
        for gid in missing.tolist():
            free = np.nonzero(self.page_of_slot < 0)[0]
            occupied = self.hbm_pages - free.size
            if free.size and occupied < self.effective_hbm:
                slot = int(free[0])
            else:
                prot = np.zeros(self.hbm_pages, bool)
                prot[self.slot_of[gids[self.slot_of[gids] >= 0]]] = True
                victims = np.nonzero(~prot & (self.page_of_slot >= 0))[0]
                if victims.size:
                    slot = int(victims[np.argmin(self._slot_tick[victims])])
                    self.slot_of[self.page_of_slot[slot]] = -1
                else:
                    slot = int(free[0])
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
        charges them as misses.  A failing copy is retried with backoff;
        once the retries are spent the degraded path moves the same bytes
        (the streams never change), pins the pages to the host for
        ``pin_cooldown`` ticks and counts them in ``degraded_fetches``."""
        slots, missing = self._place(gids)
        if missing.size:
            self._migrate_with_retry(slots, missing)
            if (r := _obs.RECORDER).enabled:
                r.count("pool.fetch_misses", int(missing.size))
                r.gauge("pool.hbm_resident_frac",
                        float((self.page_of_slot >= 0).sum())
                        / self.hbm_pages)
        return int(missing.size)

    def _migrate_with_retry(self, slots, logicals) -> None:
        """``migrate_slots`` with ``migrate_retries`` retries, the backoff
        doubling from ``retry_backoff_s``, then the degraded copy and the
        pin to host (see ``ensure_resident``)."""
        delay = self.retry_backoff_s
        for attempt in range(self.migrate_retries + 1):
            try:
                self.migrate_slots(slots, logicals)
                return
            except MigrationError:
                if attempt < self.migrate_retries and delay > 0:
                    time.sleep(delay)
                    delay *= 2
        self.migrate_slots(slots, logicals, degraded=True)
        lg = np.asarray(logicals, np.int64)
        self._pin_until[lg] = self._tick + self.pin_cooldown
        self.degraded_fetches += int(lg.size)
        if (r := _obs.RECORDER).enabled:
            r.count("pool.degraded_fetches", int(lg.size))

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
                at = _index(idx[keep], pool.device)
                pick = _index(np.nonzero(keep)[0], pool.device)
                pool[:, at] = pages[:, pick].to(pool.dtype)


def write_state_pages(kv, states, gids: np.ndarray,
                      slots: np.ndarray) -> None:
    """Write recurrent state pages into the layered pools, host and HBM
    tiers together, in place.

    kv:         the pools' layered leaves (``SharedPagedPools.kv_layers``).
    states:     one [R, J, state_dim] tensor (or None) per layer slot: the
                J joiners' packed states (``model.pack_state``).
    gids/slots: int[J], each joiner's single state page on each tier;
                ``PAGE_DROP`` entries are masked out -- the reference
                dropped them as out-of-range scatter indices.
    """
    gids, slots = np.asarray(gids), np.asarray(slots)
    for li, st in enumerate(states):
        if st is None:
            continue
        for pool, idx in ((kv["state_host"][li], gids),
                          (kv["state_hbm"][li], slots)):
            keep = idx < pool.shape[1]
            at = _index(idx[keep], pool.device)
            pick = _index(np.nonzero(keep)[0], pool.device)
            pool[:, at] = st[:, pick].to(pool.dtype)


def squeezed_free(pools, n_free: int) -> int:
    """The free slots a tier may fill: ``n_free``, clamped to what a
    squeeze leaves of the capacity (``effective_hbm`` less the occupied
    slots) on shared pools."""
    if not hasattr(pools, "effective_hbm"):
        return n_free
    occupied = pools.page_of_slot.size - n_free
    return min(n_free, max(0, pools.effective_hbm - occupied))


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

    def apply_plan(self, pools: SharedPagedPools | PagedPools,
                   bring: np.ndarray,
                   evict: np.ndarray) -> None:
        """Actuate a ``plan_tier`` decision on the live pools: pages a
        demand fetch already made resident, evictions already gone and
        (shared pools) pages pinned to the host are dropped, and the
        free-slot arithmetic is redone on the live pool, clamped to the
        squeezed capacity (swaps against evictions stay allowed).  A
        failing migration rolls the slot bookkeeping back and emits
        ``tier.move_failed``: the promoted pages stay on the host (a later
        demand fetch retries them) and the evicted residents keep their
        slots."""
        resident = pools.slot_of >= 0
        bring = np.asarray(bring, np.int64)
        evict = np.asarray(evict, np.int64)
        bring = bring[~resident[bring]]
        evict = evict[resident[evict]]
        if hasattr(pools, "host_pinned"):
            bring = bring[~pools.host_pinned(bring)]
        free_slots = np.nonzero(pools.page_of_slot < 0)[0]
        n_free = squeezed_free(pools, len(free_slots))
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

    def maybe_tier(self, pools: SharedPagedPools | PagedPools,
                   active: Optional[np.ndarray] = None,
                   force: bool = False) -> SharedPagedPools | PagedPools:
        """Tier if a boundary is due (``force=True``: the macro loop wakes
        the host once per period, so every wakeup is a boundary)."""
        n_free = squeezed_free(pools, int((pools.page_of_slot < 0).sum()))
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
