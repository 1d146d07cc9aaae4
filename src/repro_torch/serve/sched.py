"""Continuous-batching serving scheduler over one shared KV page pool (the
counterpart of ``repro/serve/sched.py`` for the fully-paged, synchronous
loop).

  * ``TrafficMonitor`` merges per-request page masses into the global
    logical-page space and feeds one ``TieringManager`` + ``OnlineTuner``
    for the whole mix -- the aggregation point between the scheduler and
    Cori.
  * ``ContinuousBatcher`` admits requests between decode steps (a step's
    joiners prefill as one packed forward pass and write their pages
    straight into the pool; with recurrent cells, one prefill per request,
    its final cell states packed into the request's state page), decodes
    the request set with every attention layer reading the pool through
    the paged-attention kernel and every recurrent cell reading and
    writing its state page, and retires requests on EOS or length,
    returning their pages.  A ``prefix_len`` config's shared prefix
    (PaliGemma's image tokens) is prefilled once into read-only pages
    that every row's table maps ahead of its own pages.  By default
    it runs macro steps: one macro per movement period, with one monitor
    feed and one tiering boundary per macro, and the period the tuner
    derives is the length of the next macro.  A macro runs by one of two
    routes, chosen at construction from the device (``decode_route``):
    the *graph* route (on a card, for every config) replays one captured
    decode step ``n_steps`` times (``models.graphs.DecodeGraph``) and
    syncs with the host once per macro; the *eager* route (on the CPU,
    or when asked) runs the same step body from Python
    (``model.decode_macro_step``).

Invariants kept from the reference: page ids are released everywhere
(pool, manager, tuner) before they can recycle; tiering ranks only
allocated pages; every page a macro can touch is HBM-resident before it
launches; greedy streams equal ``engine.generate``'s.  The pipelined
loop, chunked admission, preemption, shedding, the dense path and the
model-free ``TrafficScheduler`` are later slices of the port.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import cori
from repro_torch.ft.monitor import StepTimer
from repro_torch.memtier.tiering import (PAGE_DROP, SharedPagedPools,
                                         TieringManager, bucket_pages,
                                         write_pages_batched,
                                         write_state_pages)
from repro_torch.models import graphs
from repro_torch.models import model as mdl
from repro_torch.obs import telemetry as _obs

__all__ = ["Request", "TrafficMonitor", "ContinuousBatcher", "decode_route",
           "pack_prompts"]


class TrafficMonitor:
    """Merges per-request page masses into the global page-ID space and
    feeds one ``TieringManager`` + optional ``OnlineTuner``."""

    def __init__(self, pools: SharedPagedPools, manager: TieringManager,
                 tuner: Optional[cori.OnlineTuner] = None):
        if manager.n != pools.n_logical:
            raise ValueError("manager and pools disagree on the logical "
                             f"page space ({manager.n} vs {pools.n_logical})")
        self.pools = pools
        self.manager = manager
        self.tuner = tuner

    def merge(self, contributions: Sequence[Tuple[np.ndarray, np.ndarray]]
              ) -> np.ndarray:
        """Scatter per-request (gids, local_mass) rows into one global
        f32[n_logical] mass vector (max-merge: a page is as hot as its
        hottest accessor)."""
        mass = np.zeros(self.pools.n_logical, np.float32)
        for gids, local in contributions:
            np.maximum.at(mass, np.asarray(gids, np.int64),
                          np.asarray(local, np.float32)[: len(gids)])
        return mass

    def on_step(self, global_mass: np.ndarray,
                n_active: Optional[float] = None, *,
                n_tokens: Optional[int] = None,
                force_tier: bool = False, fetched: int = 0) -> int:
        """Feed one scheduler step's merged masses: accounting, periodic
        tiering over the shared pool and the tuning loop.  Returns the
        tiering period now in force.

        ``n_active`` normalises the tuner's cost per in-flight request;
        ``n_tokens`` is how many token-steps the feed spans (the macro
        length); ``fetched`` demand-fetch misses are charged at
        ``fetch_cost`` inside the tuner's cost window; ``force_tier``
        tiers regardless of the step cadence.  A non-finite merged mass is
        clamped to zero first."""
        mgr = self.manager
        if not np.all(np.isfinite(global_mass)):
            global_mass = np.nan_to_num(global_mass, nan=0.0,
                                        posinf=0.0, neginf=0.0)
        before = mgr.modeled_time
        if fetched:
            mgr.misses += fetched
            mgr.modeled_time += fetched * mgr.cfg.fetch_cost
        mgr.on_step(global_mass, self.pools.resident_mask,
                    weight=float(n_tokens or 1))
        mgr.maybe_tier(self.pools, active=self.pools.allocated_mask,
                       force=force_tier)
        if self.tuner is not None:
            cost = mgr.modeled_time - before
            if n_active is not None:
                cost /= max(1, n_active)
            mgr.set_period(self.tuner.on_step(global_mass, cost=cost,
                                              dt=n_tokens or 1))
        return mgr.period

    def on_macro_step(self, global_mass: np.ndarray,
                      n_active: Optional[float] = None,
                      n_tokens: int = 1, fetched: int = 0) -> int:
        """Feed one macro step (one movement period): one accounting step,
        a forced tier, and one tuner update spanning ``n_tokens``
        token-steps."""
        return self.on_step(global_mass, n_active, n_tokens=n_tokens,
                            force_tier=True, fetched=fetched)

    def release(self, gids: np.ndarray) -> None:
        """Retire a request's pages everywhere: manager hotness cleared,
        reuse-collector entries invalidated, pool slots freed."""
        self.manager.release(gids)
        if self.tuner is not None:
            self.tuner.forget_pages(gids)
        self.pools.free(gids)


def _upload(device, *arrays) -> List[torch.Tensor]:
    """numpy arrays as tensors on ``device``.  On a card the host does
    not wait: each array is staged in pinned memory and copied
    non-blocking (the caching host allocator keeps a staging buffer until
    its copy is done)."""
    if device.type != "cuda":
        return [torch.as_tensor(a) for a in arrays]
    return [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            .to(device, non_blocking=True) for a in arrays]


def _read_back(*tensors) -> List[np.ndarray]:
    """Tensors as numpy arrays, with one host sync for all of them on a
    card: non-blocking copies into pinned buffers, then one event wait."""
    if all(t.device.type == "cpu" for t in tensors):
        return [t.numpy().copy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return [h.numpy() for h in host]


def pack_prompts(prompts: Sequence[np.ndarray], prefix: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """An admission's prompts packed for one ``prefill_batched`` call:
    (tokens int64[rows, width], lengths int64[rows]), a row's length
    counting the ``prefix`` positions its forward prepends.  Both dims are
    pow2-bucketed, as the reference: right-padding is inert under causal
    attention (a prefix opens only keys below it), and the dummy rows
    (length 1, inside the prefix when there is one) are never read."""
    plens = [len(p) for p in prompts]
    toks = np.zeros((bucket_pages(len(prompts)), bucket_pages(max(plens))),
                    np.int64)
    lens = np.ones((toks.shape[0],), np.int64)
    for i, p in enumerate(prompts):
        toks[i, : plens[i]] = p
        lens[i] = prefix + plens[i]
    return toks, lens


def decode_route(device, *, macro: bool, eager: bool) -> str:
    """The macro route of a batcher on ``device``: ``"graph"`` for macro
    steps on a CUDA device unless ``eager`` is asked, else ``"eager"``.
    Every config the port serves is captured, routed MoE included
    (``kernels.routed_experts`` groups its tokens on the device)."""
    return ("graph" if macro and not eager and torch.device(device).type
            == "cuda" else "eager")


@dataclasses.dataclass
class Request:
    """One serving request and its in-flight state.  ``seed`` seeds the
    request's sampling draws (``model.sample``), as ``generate``'s
    ``seed``."""

    rid: int
    prompt: np.ndarray                 # int32[plen]
    max_new_tokens: int
    eos_id: Optional[int] = None
    temperature: float = 0.0
    seed: int = 0
    # -- runtime state (owned by the batcher) --
    status: str = ""
    row: int = -1
    gids: Optional[np.ndarray] = None  # pages the request owns
    n_pages: int = 0                   # exact page footprint
    n_alloc: int = 0                   # bucket-rounded pages actually held
    # the pages the monitor merge reads and their columns in the row's
    # tables: the exact token pages, then the state page
    table_gids: Optional[np.ndarray] = None
    mass_cols: Optional[np.ndarray] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    _i: int = 0                        # decode iterations done
    _t_submit: float = 0.0

    @property
    def total_len(self) -> int:
        return len(self.prompt) + self.max_new_tokens


class ContinuousBatcher:
    """Continuous batching of ``max_active`` rows, fully paged.

    Each request's token pages occupy a bucket-rounded run of global pages
    (``bucket_pages``), and with recurrent cells one more page holds its
    packed cell states, at the last column of its tables, past every
    token position (pure-recurrent configs keep no token pages); every
    layer decodes through the pool's ``slot_of`` tables
    (``model.decode_step_paged`` per token, or a macro per movement
    period with ``macro=True``, the default), and the per-page masses the
    tuner reads come from every layer of the decode itself (a recurrent
    cell's is a unit touch on its state page).  Before each launch every
    page the decode can touch is demand-fetched into HBM (charged as
    misses); admission is gated so the in-flight exact footprint fits the
    HBM slot pool.  Runs
    on ``device`` (default cuda), where the parameters must already live.

    ``route`` is the macro's route, fixed at construction
    (``decode_route``): ``"graph"`` on a CUDA device unless
    ``eager=True``; ``"eager"`` otherwise (and for the per-token path,
    which syncs once a token and has no graph).

    ``cond`` ([T, d] or [1, T, d]) is the serving session's shared
    cross-attention conditioning (``.xattn`` configs, musicgen-style): it
    is broadcast to every prefill's rows, and its rows for the decode
    (``[max_active, T, d]``) are made on the device once, so a captured
    graph reads the same buffer on every replay.

    ``extra_embeds`` ([P, d] or [1, P, d]) is the shared prefix, required
    when ``cfg.prefix_len`` is P > 0 (a multiple of ``page_size``).  Its
    P / page_size pages are allocated (owner -1) and prefilled once here;
    every row's table maps them at its first columns, its own pages
    follow, and a request's positions count from P.  Each admission's
    packed forward still runs over the prefix (the reference's; its
    cache rows for the prefix are dropped), and the prefix pages, owned
    by no request, are never ranked into the tiering's desired set.
    """

    def __init__(self, params, cfg, *, monitor: TrafficMonitor,
                 max_active: int = 4, max_len: int = 128,
                 page_size: int = 16, macro: bool = True, eager: bool = False,
                 cond=None, extra_embeds=None, device=None):
        mdl.check_supported(cfg)
        self.device = resolve_device(device)
        if params.tok.device != self.device:
            raise ValueError(f"params live on {params.tok.device}, not "
                             f"{self.device}")
        self.params, self.cfg = params, cfg
        self.page_size = page_size
        self.max_len = -(-max_len // page_size) * page_size
        self.max_active = max_active
        self.monitor = monitor
        self.macro = bool(macro)
        self._has_state = mdl.has_state_pages(cfg)
        self._has_attn = mdl.has_attention(cfg)
        self._state_extra = 1 if self._has_state else 0
        # one more table column holds the state page, past every token
        # position (column x page_size >= any length), so the attention
        # kernels never gather it
        self.n_row_pages = self.max_len // page_size + self._state_extra
        # a recurrent cell would fold a short row's padding into its
        # state: such configs prefill one request at a time
        self._batched_prefill = mdl.batched_prefill_supported(cfg)
        self.prefix = cfg.prefix_len or 0
        if self.prefix % page_size:
            raise ValueError(f"prefix_len {self.prefix} must be page-"
                             f"aligned (page_size {page_size}) so request "
                             "pages start on a page boundary")
        if self.prefix and extra_embeds is None:
            raise ValueError(f"{cfg.name}: serving needs the shared prefix "
                             "embeddings (extra_embeds [prefix_len, "
                             "d_model])")
        self._prefix_pages = self.prefix // page_size
        self._ex = None
        if extra_embeds is not None:
            ex = torch.as_tensor(extra_embeds, dtype=torch.float32,
                                 device=self.device)
            self._ex = ex[None] if ex.dim() == 2 else ex
        self.macro_timer = StepTimer(name="serve.macro")
        self._cond = self._cond_rows = None
        if cond is not None:
            c = torch.as_tensor(cond, dtype=torch.float32,
                                device=self.device)
            self._cond = c[None] if c.dim() == 2 else c
            self._cond_rows = self._cond.expand(
                (max_active,) + self._cond.shape[1:]).contiguous()

        # the last sampled token per row lives on the device (the next
        # step's input); positions are host ints (the host plans fetches)
        self.tok = torch.zeros((max_active, 1), dtype=torch.int64,
                               device=self.device)
        self.pos = np.zeros((max_active,), np.int64)
        self.rows_free = list(range(max_active - 1, -1, -1))
        self.active: Dict[int, Request] = {}
        self.queue: "collections.deque[Request]" = collections.deque()
        self.step_idx = 0
        #: decode steps run (one pass of every layer over the request set
        #: with a live row)
        self.decode_steps = 0
        #: decode steps the device ran: ``n_steps`` per graphed macro (dead
        #: rows freeze inside the graph), ``decode_steps`` on the eager route
        self.device_steps = 0
        self.completed: List[Request] = []

        pools = monitor.pools
        if pools.kv_layers is None:
            pools.attach_layered(mdl.slot_leaf_specs(cfg, page_size),
                                 dtype=torch.float32, device=self.device)
        self._hbm_need = 0     # exact pages the in-flight set can touch
        self._gid_tables = np.full((max_active, self.n_row_pages), -1,
                                   np.int32)
        # the shared read-only prefix: allocated and prefilled once; every
        # row's table maps these pages
        self._prefix_gids: Optional[np.ndarray] = None
        if self._prefix_pages:
            g = pools.alloc(self._prefix_pages, -1)
            if g is None:
                raise ValueError(
                    f"the logical space ({pools.n_logical}) cannot hold "
                    f"the {self._prefix_pages} shared prefix pages")
            self._prefix_gids = g
            self._hbm_need += self._prefix_pages
            self._prefill_prefix_pages()
        # static device page tables (the graph is captured over them),
        # rewritten only when a page re-slotted (pools.slot_epoch) or the
        # row mapping changed (_rows_epoch)
        self._rows_epoch = 0
        self._tables_key = None
        self._tables_dev = tuple(
            torch.full((max_active, self.n_row_pages), -1, dtype=torch.int32,
                       device=self.device) for _ in range(2))
        # every row's state page sits at the fixed last table column
        self._state_cols = (torch.full((max_active,), self.n_row_pages - 1,
                                       dtype=torch.int64, device=self.device)
                            if self._has_state else None)
        self.route = decode_route(self.device, macro=self.macro,
                                  eager=eager)
        self._graph = None
        if self.route == "graph":
            self._graph = graphs.DecodeGraph(
                params, cfg, pools.kv_with_sink, *self._tables_dev,
                max_steps=bucket_pages(self.max_len), page_size=page_size,
                state_cols=self._state_cols, cond=self._cond_rows)

    # -- admission -----------------------------------------------------------
    def _pages_kv_exact(self, req: Request) -> int:
        """Exact token pages the request's positions span (none without
        attention layers)."""
        if not self._has_attn:
            return 0
        return -(-req.total_len // self.page_size)

    def _pages_exact(self, req: Request) -> int:
        """Exact own-page footprint: token pages plus the state page."""
        return self._pages_kv_exact(req) + self._state_extra

    def _pages_alloc(self, req: Request) -> int:
        """Bucket-rounded allocation size (power-of-two token pages, capped
        at one row less the shared prefix pages, plus the un-bucketed
        state page): what the request actually holds in the shared
        pool."""
        kv_exact = self._pages_kv_exact(req)
        cap = self.max_len // self.page_size - self._prefix_pages
        kv_alloc = bucket_pages(kv_exact, cap=cap) if kv_exact else 0
        return kv_alloc + self._state_extra

    def submit(self, req: Request) -> None:
        req._t_submit = time.monotonic()
        if self.prefix + req.total_len > self.max_len:
            raise ValueError(f"request {req.rid} needs "
                             f"{self.prefix + req.total_len} positions, "
                             f"cache rows hold {self.max_len}")
        pools = self.monitor.pools
        avail = pools.n_logical - self._prefix_pages
        if self._pages_alloc(req) > avail:
            raise ValueError(f"request {req.rid} needs "
                             f"{self._pages_alloc(req)} pages, the logical "
                             f"space holds {avail} beyond the shared prefix")
        touched = self._prefix_pages + self._pages_exact(req)
        if touched > pools.hbm_pages:
            raise ValueError(f"request {req.rid} touches {touched} pages, "
                             f"the HBM slot pool holds {pools.hbm_pages}")
        self.queue.append(req)

    def _admit(self) -> List[Tuple[int, int]]:
        batch: List[Request] = []
        pools = self.monitor.pools
        while self.queue and self.rows_free:
            req = self.queue[0]
            n_exact = self._pages_exact(req)
            if self._hbm_need + n_exact > pools.hbm_pages:
                break                  # head-of-line: keep arrival order
            gids = pools.alloc(self._pages_alloc(req), req.rid)
            if gids is None:
                break
            self.queue.popleft()
            req.row, req.gids, req.n_pages = self.rows_free.pop(), gids, \
                n_exact
            req.n_alloc = len(gids)
            self._hbm_need += n_exact
            self._map_row(req)
            batch.append(req)
        if not batch:
            return []
        t0 = time.monotonic()
        emitted = self._prefill(batch)
        if (r := _obs.RECORDER).enabled:
            r.emit("serve.admit", step=self.step_idx, joiners=len(batch),
                   pages=int(sum(b.n_alloc for b in batch)),
                   queue_depth=len(self.queue),
                   wall_ms=(time.monotonic() - t0) * 1e3)
            r.count("serve.admitted", len(batch))
            r.gauge("serve.queue_depth", len(self.queue))
        return emitted

    def _map_row(self, req: Request) -> None:
        """The request's logical page-table row: the shared prefix pages
        at columns [0, pp), its own token-page run from column pp (bucket
        tail included), and the state page at the last column.  Also
        records the (pages, columns) the monitor merge reads -- the prefix
        pages and the exact own pages, so bucket-tail slack never accrues
        mass."""
        pp = self._prefix_pages
        kv_alloc = req.n_alloc - self._state_extra
        kv_exact = self._pages_kv_exact(req)
        row = np.full(self.n_row_pages, -1, np.int32)
        row[pp: pp + kv_alloc] = req.gids[:kv_alloc]
        gids = [np.asarray(req.gids[:kv_exact], np.int64)]
        cols = [pp + np.arange(kv_exact)]
        if pp:
            row[:pp] = self._prefix_gids
            gids.insert(0, np.asarray(self._prefix_gids, np.int64))
            cols.insert(0, np.arange(pp))
        if self._state_extra:
            row[-1] = req.gids[-1]
            gids.append(np.asarray(req.gids[-1:], np.int64))
            cols.append(np.asarray([self.n_row_pages - 1]))
        self._gid_tables[req.row] = row
        req.table_gids = np.concatenate(gids)
        req.mass_cols = np.concatenate(cols).astype(np.int64)
        self._rows_epoch += 1

    def _tables_for(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The static device (slot table, gid table) for a decode launch,
        rewritten in place when a page re-slots or the row mapping
        changes."""
        pools = self.monitor.pools
        key = (pools.slot_epoch, self._rows_epoch)
        if self._tables_key != key:
            slots = np.full_like(self._gid_tables, -1)
            m = self._gid_tables >= 0
            slots[m] = pools.table(self._gid_tables[m])
            for dst, src in zip(self._tables_dev,
                                _upload(self.device, slots,
                                        self._gid_tables)):
                dst.copy_(src)
            self._tables_key = key
        return self._tables_dev

    def _need(self, horizon: Dict[int, int]) -> np.ndarray:
        """Every page the next decode steps can touch: the shared prefix
        pages, then each active row's own token pages through its
        ``horizon[row]`` steps (write pages included) and its state
        page."""
        need: List[np.ndarray] = []
        if self._prefix_gids is not None:
            need.append(np.asarray(self._prefix_gids, np.int64))
        for row, req in self.active.items():
            if self._has_attn:
                n_cols = -(-(int(self.pos[row]) + horizon[row])
                           // self.page_size)
                need.append(np.asarray(
                    req.gids[: max(0, n_cols - self._prefix_pages)],
                    np.int64))
            if self._state_extra:
                need.append(np.asarray(req.gids[-1:], np.int64))
        return np.concatenate(need) if need else np.asarray([], np.int64)

    def _prefill(self, batch: List[Request]) -> List[Tuple[int, int]]:
        """Prefill a step's joiners -- as one packed forward pass, or one
        request at a time for recurrent configs --, write their pages into
        the pool, and sample each first token."""
        plens = [len(r.prompt) for r in batch]
        if self._batched_prefill:
            toks, plens_p = pack_prompts([r.prompt for r in batch],
                                         self.prefix)
            rows = lambda t: None if t is None else t.expand(
                (toks.shape[0],) + t.shape[1:])
            logits_b, cache_b = mdl.prefill_batched(
                self.params, self.cfg,
                torch.as_tensor(toks, device=self.device),
                torch.as_tensor(plens_p, device=self.device),
                cond=rows(self._cond), extra_embeds=rows(self._ex))
            self._write_prefill_pages(cache_b, batch, plens)
        else:
            rows = []
            for req in batch:
                logits, cache1 = mdl.prefill(
                    self.params, self.cfg,
                    torch.as_tensor(req.prompt, dtype=torch.int64,
                                    device=self.device)[None],
                    cond=self._cond, extra_embeds=self._ex)
                self._write_prefill_pages_row(cache1, req)
                rows.append(logits)
            logits_b = torch.cat(rows)
        first = mdl.sample(logits_b[: len(batch), 0], *_upload(
            self.device, np.asarray([r.temperature for r in batch],
                                    np.float32),
            np.asarray([r.seed for r in batch], np.int64),
            np.zeros((len(batch),), np.int64)))
        emitted: List[Tuple[int, int]] = []
        for req, tok, plen in zip(batch, _read_back(first)[0].tolist(),
                                  plens):
            req.tokens.append(tok)
            emitted.append((req.rid, tok))
            self.tok[req.row, 0] = tok
            self.pos[req.row] = self.prefix + plen
            self.active[req.row] = req
            if req.max_new_tokens <= 1 or tok == req.eos_id:
                self._retire(req)
        return emitted

    def _write_prefill_pages(self, cache_b, batch: List[Request],
                             plens: List[int]) -> None:
        """Scatter an admission's prefilled cache (every joiner, every
        layer, host + HBM tiers) into the pool: each joiner's own pages,
        from cache position ``prefix`` (the prefix is page-aligned; its
        rows, already in the shared pages, are dropped).  Slots are
        assigned bookkeeping-only (initial placement, not charged as
        misses) since the scatter overwrites both tiers."""
        pools = self.monitor.pools
        ns = [-(-p // self.page_size) for p in plens]
        jp = cache_b["segments"][0][0]["pos"].shape[1]
        n_max = bucket_pages(max(ns))
        gids_m = np.full((jp, n_max), PAGE_DROP, np.int32)
        slots_m = np.full((jp, n_max), PAGE_DROP, np.int32)
        slots_flat = pools.assign_slots(
            np.concatenate([req.gids[:n] for req, n in zip(batch, ns)]))
        o = 0
        for i, (req, n) in enumerate(zip(batch, ns)):
            gids_m[i, :n] = req.gids[:n]
            slots_m[i, :n] = slots_flat[o: o + n]
            o += n
        write_pages_batched(pools.kv_layers,
                            self._cache_leaves(cache_b, self.prefix, None),
                            gids_m, slots_m)

    def _cache_leaves(self, cache, start: int, stop: Optional[int]):
        """{leaf name: per-slot cache rows [R, J, start:stop, ...]} for
        ``write_pages_batched``."""
        meta = mdl.state_slot_meta(self.cfg)
        leaves: Dict[str, List] = {}
        for li, (si, j, _, _, kind) in enumerate(meta):
            e = cache["segments"][si][j]
            for name in mdl.slot_leaf_names(kind):
                leaves.setdefault(name, [None] * len(meta))[li] = \
                    e[name][:, :, start:stop]
        return leaves

    def _prefill_prefix_pages(self) -> None:
        """Prefill the shared prefix once and write its rows into the
        shared pages: one forward of a dummy token after the prefix, whose
        first ``prefix`` cache positions are exact for every prompt (the
        prefix attends only itself; a text token is never a key below
        ``prefix_len``).  Slots are assigned bookkeeping-only, as an
        admission's."""
        pools = self.monitor.pools
        _, cache1 = mdl.prefill(
            self.params, self.cfg,
            torch.zeros((1, 1), dtype=torch.int64, device=self.device),
            extra_embeds=self._ex, cond=self._cond)
        slots = pools.assign_slots(self._prefix_gids)
        write_pages_batched(pools.kv_layers,
                            self._cache_leaves(cache1, 0, self.prefix),
                            np.asarray(self._prefix_gids, np.int32)[None],
                            np.asarray(slots, np.int32)[None])

    def _write_prefill_pages_row(self, cache1, req: Request) -> None:
        """Write one request's prefill into the pool, both tiers: the
        admission path of recurrent configs.  Token rows scatter by
        position (page = pos // page_size, offset = pos % page_size), which
        lands a window ring's rows -- each tagged with its absolute
        position -- where the paged kernel reads them; each recurrent slot
        packs its cells' final states into the request's state page.
        Slots are assigned bookkeeping-only, as ``_write_prefill_pages``."""
        pools = self.monitor.pools
        kv = pools.kv_layers
        ps = self.page_size
        kv_exact = self._pages_kv_exact(req)
        own = np.asarray(req.gids[: req.n_alloc - self._state_extra][
            :kv_exact], np.int64)
        slots = pools.assign_slots(np.concatenate(
            [own, np.asarray(req.gids[-1:], np.int64)]))
        meta = mdl.state_slot_meta(self.cfg)
        states: List = [None] * len(meta)
        for li, (si, j, r, _, kind) in enumerate(meta):
            e = cache1["segments"][si][j]
            if kind.is_recurrent:
                states[li] = torch.stack([mdl.pack_state(
                    {k: v[rr] for k, v in e.items()}) for rr in range(r)])
                continue
            pos = e["pos"][0, 0]                 # the same over repeats
            valid = pos >= 0
            pos = pos[valid]
            page = pos // ps
            at_slot = torch.as_tensor(slots[:kv_exact],
                                      device=pos.device)[page]
            at_gid = torch.as_tensor(own, device=pos.device)[page]
            for name in mdl.slot_leaf_names(kind):
                rows = e[name][:, 0][:, valid]
                kv[f"{name}_hbm"][li][:, at_slot, pos % ps] = rows
                kv[f"{name}_host"][li][:, at_gid, pos % ps] = rows
        write_state_pages(kv, states, req.gids[-1:], slots[-1:])

    # -- the scheduler loop --------------------------------------------------
    @torch.no_grad()
    def step(self) -> List[Tuple[int, int]]:
        """One scheduler step: admit (one packed prefill), then one decode
        launch (a macro step or a single token) over the request set.
        Returns the (rid, token) pairs emitted, prefill samples included."""
        track = (r := _obs.RECORDER).enabled
        t0 = time.monotonic() if track else 0.0
        emitted = self._admit()
        self.step_idx += 1
        if self.active:
            emitted += (self._step_paged_macro() if self.macro
                        else self._step_paged())
        if track:
            r.observe("serve.step_s", time.monotonic() - t0)
        return emitted

    def _row_inputs(self, rows) -> Dict[str, np.ndarray]:
        """The per-row inputs of a decode launch, rows without a request
        inert: position (-1), seed, decode iterations done, tokens
        emitted, budget, EOS (-1 = none) and temperature."""
        b = self.max_active
        cur = np.full((b,), -1, np.int64)
        seeds, iters, emitted, max_new = (np.zeros((b,), np.int64)
                                          for _ in range(4))
        eos = np.full((b,), -1, np.int64)
        temps = np.zeros((b,), np.float32)
        for row, req in rows:
            cur[row] = self.pos[row]
            seeds[row], iters[row] = req.seed, req._i
            emitted[row] = len(req.tokens)
            max_new[row] = req.max_new_tokens
            eos[row] = -1 if req.eos_id is None else req.eos_id
            temps[row] = req.temperature
        return dict(cur=cur, seeds=seeds, iters=iters, emitted=emitted,
                    max_new=max_new, eos=eos, temps=temps)

    def _step_paged(self) -> List[Tuple[int, int]]:
        """One paged decode step: demand-fetch the in-flight working set,
        decode every row off the pool, sample on the device, read the
        masses and tokens back once, feed the monitor, retire."""
        pools = self.monitor.pools
        fetched = pools.ensure_resident(
            self._need({row: 1 for row in self.active}))
        tables, gid_tables = self._tables_for()
        rows = list(self.active.items())
        inp = self._row_inputs(rows)
        cur, temps, seeds, iters = _upload(
            self.device, inp["cur"], inp["temps"], inp["seeds"],
            inp["iters"] + 1)
        logits, masses = mdl.decode_step_paged(
            self.params, self.cfg, pools.kv_with_sink, tables, gid_tables,
            self.tok, cur, page_size=self.page_size,
            state_cols=self._state_cols, cond=self._cond_rows)
        new_tok = mdl.sample(logits[:, 0], temps, seeds, iters)
        masses, toks = _read_back(masses, new_tok)
        self.decode_steps += 1
        self.device_steps += 1
        merged = self.monitor.merge(
            [(r.table_gids, masses[row, r.mass_cols]) for row, r in rows])
        self.monitor.on_step(merged, n_active=len(rows), fetched=fetched)

        toks = toks.tolist()
        emitted: List[Tuple[int, int]] = []
        for row, req in rows:
            self.pos[row] += 1
            req._i += 1
            self.tok[row, 0] = toks[row]
            req.tokens.append(toks[row])
            emitted.append((req.rid, toks[row]))
            if (len(req.tokens) >= req.max_new_tokens
                    or toks[row] == req.eos_id):
                self._retire(req)
        return emitted

    def _step_paged_macro(self) -> List[Tuple[int, int]]:
        """Macro-step decode: up to a movement period's worth of tokens for
        the whole request set by the batcher's route (a graph replayed
        ``n_steps`` times, or ``model.decode_macro_step``); the host hands
        over page tables once and reads back (tokens, summed mass,
        finished flags, positions, iterations) once, then runs one merged
        monitor feed -- one tiering boundary and one tuner update per
        period."""
        pools = self.monitor.pools
        rows = list(self.active.items())
        period = self.monitor.manager.period
        max_rem = max(req.max_new_tokens - len(req.tokens) for _, req in rows)
        # the reference's bucketing: the pow2 floor of the live period,
        # capped by the pow2 ceiling of the remaining work
        n_steps = max(1, min(1 << max(0, int(period).bit_length() - 1),
                             bucket_pages(max_rem)))
        horizons = {row: min(n_steps, req.max_new_tokens - len(req.tokens))
                    for row, req in rows}
        # every page the macro can touch is resident before it launches;
        # re-fetches are charged inside the tuner's cost window below
        fetched = pools.ensure_resident(self._need(horizons))
        tables, gid_tables = self._tables_for()
        inp = self._row_inputs(rows)
        dev_in = _upload(self.device, inp["cur"], inp["seeds"],
                         inp["iters"], inp["emitted"], inp["max_new"],
                         inp["eos"], inp["temps"])

        self.macro_timer.start()
        if self.route == "graph":
            toks, st = self._graph.launch(self.tok, *dev_in, n_steps=n_steps)
        else:
            toks, st = mdl.decode_macro_step(
                self.params, self.cfg, pools.kv_with_sink, tables,
                gid_tables, self.tok, *dev_in, n_steps=n_steps,
                page_size=self.page_size, state_cols=self._state_cols,
                cond=self._cond_rows)
        # the next macro's input token; a clone, since the graph's carry
        # is overwritten by the next replay
        self.tok = st["last_tok"].clone()
        toks_np, mass_sum, alive_steps, stopped, pos, iters = _read_back(
            toks, st["mass_sum"], st["alive_steps"], st["stopped"],
            st["pos"], st["iters"])
        macro_wall = self.macro_timer.stop(self.step_idx)

        # one merge + monitor feed per movement period: the mean mass over
        # the steps each row ran keeps the per-step scale the access
        # threshold expects; dt = the macro's span in token-steps
        merged = self.monitor.merge(
            [(r.table_gids,
              mass_sum[row, r.mass_cols] / max(1, int(alive_steps[row])))
             for row, r in rows])
        self.decode_steps += int(alive_steps.max())
        self.device_steps += st["steps"]
        dt = max(1, int(alive_steps.max()))
        n_active = float(alive_steps.sum()) / dt
        self.monitor.on_macro_step(merged, n_active=n_active, n_tokens=dt,
                                   fetched=fetched)

        self.pos = pos
        emitted: List[Tuple[int, int]] = []
        for t in range(toks_np.shape[0]):
            for row, req in rows:
                tk = int(toks_np[t, row])
                if tk >= 0:
                    req.tokens.append(tk)
                    emitted.append((req.rid, tk))
        for row, req in rows:
            req._i = int(iters[row])
            if stopped[row]:
                self._retire(req)
        if (r := _obs.RECORDER).enabled:
            r.emit("serve.macro", step=self.step_idx, n_steps=int(n_steps),
                   tokens=len(emitted), active=n_active,
                   fetched=int(fetched), wall_ms=macro_wall * 1e3,
                   straggler=bool(self.macro_timer.stragglers
                                  and self.macro_timer.stragglers[-1]
                                  == self.step_idx))
            r.count("serve.tokens", len(emitted))
        return emitted

    @property
    def idle(self) -> bool:
        return not (self.queue or self.active)

    def run(self, max_steps: int = 10 ** 6) -> Dict[int, List[int]]:
        """Step until every submitted request completed (or the step
        budget runs out).  Returns rid -> emitted tokens."""
        steps = 0
        while not self.idle and steps < max_steps:
            self.step()
            steps += 1
        return {r.rid: list(r.tokens) for r in self.completed}

    def _retire(self, req: Request) -> None:
        req.status = "completed"
        del self.active[req.row]
        self.rows_free.append(req.row)
        self.completed.append(req)
        self._hbm_need -= req.n_pages
        self._gid_tables[req.row, :] = -1
        self._rows_epoch += 1
        self.monitor.release(req.gids)
        if (r := _obs.RECORDER).enabled:
            r.emit("serve.retire", step=self.step_idx, rid=req.rid,
                   tokens=len(req.tokens), status=req.status,
                   deadline_ms=(time.monotonic() - req._t_submit) * 1e3)
            r.count("serve.retired")
