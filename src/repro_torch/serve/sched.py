"""Continuous-batching serving scheduler over one shared KV page pool (the
counterpart of ``repro/serve/sched.py``).

  * ``TrafficMonitor`` merges per-request page masses into the global
    logical-page space and feeds one ``TieringManager`` + ``OnlineTuner``
    for the whole mix -- the aggregation point between the scheduler and
    Cori.  ``on_macro_step`` feeds, tiers and tunes in one call;
    ``plan_step`` (host numpy only) and ``apply_decision`` split the same
    boundary into the pipelined loop's worker half and dispatch half.
  * ``ContinuousBatcher`` admits requests between decode steps (a step's
    joiners prefill as one packed forward pass; with recurrent cells, one
    prefill per request), decodes the request set and retires requests
    on EOS or length, returning their pages.  Two data paths:

      - *fully paged* (the default whenever a monitor is attached): the
        pool is the only state store.  A joiner's pages are written
        straight into it, every attention layer reads it through the
        paged-attention kernel and every recurrent cell reads and writes
        its state page; a ``prefix_len`` config's shared prefix
        (PaliGemma's image tokens) is prefilled once into read-only pages
        that every row's table maps ahead of its own pages.  By default
        it runs macro steps: one macro per movement period, with one
        monitor feed and one tiering boundary per macro, and the period
        the tuner derives is the length of the next macro.  A macro runs
        by one of two routes, chosen at construction from the device
        (``decode_route``): the *graph* route (on a card, for every
        config) replays one captured decode step ``n_steps`` times
        (``models.graphs.DecodeGraph``) and syncs with the host once per
        macro; the *eager* route (on the CPU, or when asked) runs the
        same step body from Python (``model.decode_macro_step``).  A
        macro is two halves, ``_macro_launch`` (demand fetch, tables,
        launch, the read-back queued into pinned buffers) and
        ``_macro_complete`` (one event wait, merge, tokens, retire): the
        synchronous loop runs them back to back; with ``pipeline=True``
        each step completes the previous macro, activates admissions
        lazily, launches the next macro and does the boundary's host work
        behind it -- the tiering decision from a background
        ``serve.pipeline.DecisionWorker`` (landing one boundary late), an
        admission chunk (``admit_chunk_tokens``, ``model.prefill_chunk``),
        the prefetch and the table staging.
      - *dense* (``paged=False``, the baseline the paged path is measured
        against): ``max_active`` rows share one packed cache of
        ``max_len`` positions (``model.init_cache``) and decode one token
        a step (``model.decode_step``), eagerly on every device.  With a
        monitor, the monitor layer's page masses are recomputed each step
        (``engine.make_monitor``) and feed the tiering; with
        ``mirror_pages`` that layer's pages are written through into the
        pools' legacy single-layer pair, so ``paged_context`` can check
        the paged-attention kernel's gather from the shared HBM pool.

  * ``TrafficScheduler``, the model-free twin: each request is a
    synthetic per-step page-mass pattern (``memtier.workload``, by the
    kind ``core.traffic`` draws), so thousands of scheduler steps replay
    without touching KV bytes, with the batcher's admission, bucket-
    rounded allocation, merge and retirement.

Invariants kept from the reference: page ids are released everywhere
(pool, manager, tuner) before they can recycle; tiering ranks only
allocated pages; every page a paged decode can touch is HBM-resident
before it launches; greedy and sampled streams equal
``engine.generate``'s on every path, pipelined and chunked included
(overlap changes when work runs, never what it computes).

The degradation ladder is the reference's (``docs/robustness.md``), run
under the batcher's ``fault_plan`` (inert by default, handed on to the
pools): a capacity squeeze lowers the pools' ``effective_hbm``, against
which admission is gated and the coldest active rows are preempted
(their pages demoted, their rows freed) and thawed FIFO when the budget
allows, resuming bit for bit with no second prefill; a bounded queue
(``max_queue``) sheds at submit and a request's ``ttl_steps`` expires it
while it queues, so every submission ends ``completed``, ``shed`` or
``expired``; retry-exhausted fetches are re-priced at ``miss_penalty``
inside the tuner's window; a non-finite merged mass is clamped; and the
pipelined loop's decision worker runs under a watchdog (``watchdog_s``):
a hang or a crash recomputes the boundary's decision synchronously,
reverts the tuner to its last good period and restarts the worker, and
after ``max_worker_restarts`` the loop decides synchronously for good.
Without a watchdog a worker exception re-raises from ``step()``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import cori
from repro_torch.core.traffic import RequestSpec
from repro_torch.ft.inject import NULL_PLAN
from repro_torch.ft.monitor import StepTimer
from repro_torch.kernels import ops
from repro_torch.memtier import workload as W
from repro_torch.memtier.tiering import (PAGE_DROP, SharedPagedPools,
                                         TieringManager, bucket_pages,
                                         squeezed_free, write_pages_batched,
                                         write_state_pages)
from repro_torch.models import graphs
from repro_torch.models import model as mdl
from repro_torch.obs import telemetry as _obs
from repro_torch.serve import engine
from repro_torch.serve.pipeline import DecisionWorker

__all__ = ["Request", "TrafficMonitor", "ContinuousBatcher",
           "TrafficScheduler", "WORKLOAD_KINDS", "DecisionWorker",
           "decode_route", "pack_prompts"]


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
                force_tier: bool = False, fetched: int = 0,
                degraded: int = 0) -> int:
        """Feed one scheduler step's merged masses: accounting, periodic
        tiering over the shared pool and the tuning loop.  Returns the
        tiering period now in force.

        ``n_active`` normalises the tuner's cost per in-flight request;
        ``n_tokens`` is how many token-steps the feed spans (the macro
        length); ``fetched`` demand-fetch misses are charged at
        ``fetch_cost`` inside the tuner's cost window, and ``degraded``
        (retry-exhausted) fetches are topped up to ``miss_penalty`` there;
        ``force_tier`` tiers regardless of the step cadence.  A non-finite
        merged mass is clamped to zero first."""
        mgr = self.manager
        global_mass, before = self._charge(global_mass, fetched, degraded)
        mgr.on_step(global_mass, self.pools.resident_mask,
                    weight=float(n_tokens or 1))
        mgr.maybe_tier(self.pools, active=self.pools.allocated_mask,
                       force=force_tier)
        self._tune(global_mass, before, n_active, n_tokens)
        return mgr.period

    def _charge(self, global_mass: np.ndarray, fetched: int,
                degraded: int):
        """A boundary's accounting before the manager's feed: a non-finite
        merged mass clamped to zero, the demand fetches charged as misses
        at ``fetch_cost``, and the degraded ones topped up from
        ``fetch_cost`` to ``miss_penalty`` (they lost the batched copy's
        discount), so the tuner re-plans around failing pages.  Returns
        (mass, the modeled time before)."""
        mgr = self.manager
        if not np.all(np.isfinite(global_mass)):
            global_mass = np.nan_to_num(global_mass, nan=0.0,
                                        posinf=0.0, neginf=0.0)
        before = mgr.modeled_time
        if fetched:
            mgr.misses += fetched
            mgr.modeled_time += fetched * mgr.cfg.fetch_cost
        if degraded:
            mgr.modeled_time += degraded * max(
                0.0, mgr.cfg.miss_penalty - mgr.cfg.fetch_cost)
        return global_mass, before

    def _tune(self, global_mass: np.ndarray, before: float,
              n_active: Optional[float], n_tokens: Optional[int]) -> None:
        """The tuner's update from the boundary's cost (per in-flight
        request with ``n_active``), which sets the manager's period."""
        if self.tuner is not None:
            mgr = self.manager
            cost = mgr.modeled_time - before
            if n_active is not None:
                cost /= max(1, n_active)
            mgr.set_period(self.tuner.on_step(global_mass, cost=cost,
                                              dt=n_tokens or 1))

    def on_macro_step(self, global_mass: np.ndarray,
                      n_active: Optional[float] = None,
                      n_tokens: int = 1, fetched: int = 0,
                      degraded: int = 0) -> int:
        """Feed one macro step (one movement period): one accounting step,
        a forced tier, and one tuner update spanning ``n_tokens``
        token-steps."""
        return self.on_step(global_mass, n_active, n_tokens=n_tokens,
                            force_tier=True, fetched=fetched,
                            degraded=degraded)

    def plan_step(self, global_mass: np.ndarray,
                  n_active: Optional[float] = None, *, n_tokens: int = 1,
                  fetched: int = 0, degraded: int = 0,
                  resident: Optional[np.ndarray] = None,
                  n_free: int = 0, active: Optional[np.ndarray] = None,
                  planes: int = 2):
        """The worker half of a pipelined macro boundary: the accounting of
        ``on_macro_step`` (clamp, fetch charges, manager feed, tuner update)
        with the tier stopped at ``plan_tier``, so no pool changes and the
        call can run on the ``DecisionWorker`` thread.  ``resident``,
        ``n_free`` and ``active`` are numpy snapshots the dispatch thread
        took at the boundary (``apply_decision`` revalidates the plan
        against the live pools); nothing here touches a tensor.  The
        worker's strict alternation, not a lock, keeps the manager and
        tuner to one thread at a time.  Returns (period, plan), plan the
        ``(bring, evict)`` pair or None."""
        mgr = self.manager
        global_mass, before = self._charge(global_mass, fetched, degraded)
        mgr.on_step(global_mass, resident, weight=float(n_tokens or 1))
        plan = mgr.plan_tier(resident, n_free, active=active,
                             planes=planes, force=True)
        self._tune(global_mass, before, n_active, n_tokens)
        return mgr.period, plan

    def apply_decision(self, plan) -> None:
        """The dispatch half: actuate a worker-planned tier on the live
        pools (``apply_plan`` revalidates each page first)."""
        if plan is not None:
            self.manager.apply_plan(self.pools, *plan)

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


def _copy_back(*tensors):
    """Queue the copy of ``tensors`` to the host without waiting: on a
    card, non-blocking copies into pinned buffers and one event recorded
    after them, so a later ``_wait_back`` waits for the work queued up to
    here and for nothing queued after.  Returns (buffers, event or
    None)."""
    if all(t.device.type == "cpu" for t in tensors):
        return [t.numpy().copy() for t in tensors], None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _wait_back(host, done) -> List[np.ndarray]:
    """The numpy arrays of a ``_copy_back``, after its one event wait."""
    if done is None:
        return host
    done.synchronize()
    return [h.numpy() for h in host]


def _read_back(*tensors) -> List[np.ndarray]:
    """Tensors as numpy arrays, with one host sync for all of them on a
    card: non-blocking copies into pinned buffers, then one event wait."""
    return _wait_back(*_copy_back(*tensors))


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
    #: deadline in scheduler steps from submission (None: none).  A request
    #: still queued when it passes expires; an admitted one always runs to
    #: completion (aborting it would break the streams' parity)
    ttl_steps: Optional[int] = None
    # -- runtime state (owned by the batcher) --
    #: the typed terminal status: "completed", "shed" or "expired"
    status: str = ""
    deadline_step: int = -1            # the absolute step the ttl resolves to
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
    # pipelined admission: the lazily sampled first token ([1], on the
    # device, behind the prefill); it is in the row's input of the macro
    # the request joins and reaches ``tokens`` when that macro completes
    _first_tok: Optional[torch.Tensor] = None
    _t_submit: float = 0.0
    # a preempted request's row state (position, next input token): its
    # pages stay allocated and ``seed``/``_i`` stay on it, so a thaw is a
    # row re-install
    _frozen_pos: int = 0
    _frozen_tok: int = 0

    @property
    def total_len(self) -> int:
        return len(self.prompt) + self.max_new_tokens


@dataclasses.dataclass
class _PendingAdmit:
    """A reserved admission of the pipelined loop: its row and pages are
    held (the HBM admission gate counts them) and its prefill is queued --
    packed at the boundary it was reserved, or one chunk an overlap window
    for a long prompt -- after which the row activates at a boundary, its
    first token sampled on the device behind the prefill."""

    req: Request
    plen: int
    chunked: bool = False
    past: object = None          # the earlier chunks' cache (chunked only)
    next_start: int = 0          # absolute position of the next chunk
    chunk_idx: int = 0
    logits: Optional[torch.Tensor] = None   # [1, 1, V] first-token logits
    ready: bool = False
    t_submit: float = 0.0


class ContinuousBatcher:
    """Continuous batching of ``max_active`` rows.

    *Fully paged* (``paged=True``, the default whenever a monitor is
    attached): each request's token pages occupy a bucket-rounded run of
    global pages (``bucket_pages``), and with recurrent cells one more
    page holds its packed cell states, at the last column of its tables,
    past every token position (pure-recurrent configs keep no token
    pages); every layer decodes through the pool's ``slot_of`` tables
    (``model.decode_step_paged`` per token, or a macro per movement
    period with ``macro=True``, the paged default), and the per-page
    masses the tuner reads come from every layer of the decode itself (a
    recurrent cell's is a unit touch on its state page).  Before each
    launch every page the decode can touch is demand-fetched into HBM
    (charged as misses); admission is gated so the in-flight exact
    footprint fits the HBM slot pool.

    *Dense* (``paged=False``, or no monitor): one packed float32 cache of
    ``max_active`` x ``max_len`` positions, one ``model.decode_step`` a
    step for the whole row set, run eagerly on every device (the graph
    route is the paged macro's).  A request holds
    ``bucket_pages(ceil((prefix + total_len) / page_size))`` pages of its
    own when a monitor is attached; each step the monitor layer's masses
    over the current cache (``engine.make_monitor``, one host read) are
    merged over each request's exact pages and fed to the monitor before
    the decode.  ``mirror_pages=True`` arms only on the dense path, with
    a monitor whose pools hold the legacy single-layer pair
    (``SharedPagedPools.create`` with a page geometry): the monitor
    layer's pages are then written through into that pair -- the prompt's
    pages at admission, the page just written after each step -- for
    ``paged_context``.

    Runs on ``device`` (default cuda), where the parameters must already
    live.  ``route`` is fixed at construction (``decode_route``):
    ``"graph"`` for paged macro steps on a CUDA device unless
    ``eager=True``; ``"eager"`` otherwise (the per-token paged path and
    the dense path).

    ``cond`` ([T, d] or [1, T, d]) is the serving session's shared
    cross-attention conditioning (``.xattn`` configs, musicgen-style): it
    is broadcast to every prefill's rows, and its rows for the decode
    (``[max_active, T, d]``) are made on the device once, so a captured
    graph reads the same buffer on every replay.

    ``extra_embeds`` ([P, d] or [1, P, d]) is the shared prefix, required
    when ``cfg.prefix_len`` is P > 0 (a multiple of ``page_size``).  On
    the paged path its P / page_size pages are allocated (owner -1) and
    prefilled once here; every row's table maps them at its first
    columns, its own pages follow, and a request's positions count from
    P.  Each admission's packed forward still runs over the prefix (the
    reference's; its cache rows for the prefix are dropped), and the
    prefix pages, owned by no request, are never ranked into the
    tiering's desired set.  On the dense path the prefix is part of every
    row's cache and of its own pages.

    ``pipeline=True`` (macro steps only; on a card, the graph route only)
    runs the pipelined loop: each scheduler step completes the *previous*
    macro, reserves admissions and activates the ready ones lazily (a
    joiner rides the macro launched at the boundary its reservation
    preceded; its first token is sampled on the device), launches the
    next macro, and then does the boundary's host work behind it -- the
    tiering and tuner decision, which a ``serve.pipeline.DecisionWorker``
    thread computes and which lands one boundary late, an admission
    chunk, the prefetch of the next horizon and the table staging.  On
    a card every stage queues on the one stream behind the macro in
    flight, and the host waits only for that macro's read-back (copied
    at its launch, one event).  Periods land a boundary later, so macro
    lengths differ from the synchronous loop's; the streams do not.
    ``admit_chunk_tokens`` (rounded up to whole pages) prefills a longer
    prompt of a batched-prefill, prefix-free config in chunks of that
    many positions, one an overlap window (``model.prefill_chunk``; on
    the flash route each chunk is one kernel launch a layer with the
    chunk's start as its query offset); ``None`` keeps whole-prompt
    packed admission.  ``close()`` stops the worker thread; the manager
    and tuner are safe to read between steps.

    Overload safety (the reference's ladder): ``fault_plan`` (a
    ``ft.inject.FaultPlan``; inert by default) ticks once a scheduler
    step and is handed on to the pools; a ``pool.squeeze`` lowers their
    ``effective_hbm`` while it fires.  At each boundary (``_rebalance``)
    frozen requests thaw FIFO while they fit, one regardless when nothing
    else is in flight, and while the in-flight footprint exceeds the
    capacity the coldest active row (least manager hotness; ties to the
    newest rid) is preempted, down to one row.  ``max_queue`` sheds a
    submission past that depth; ``ttl_steps`` expires a queued request.
    ``watchdog_s`` bounds the wait for the worker's decision: a timeout
    (hang) or an exception (crash) is recovered synchronously and the
    worker restarted, at most ``max_worker_restarts`` times, after which
    the loop decides synchronously; with no watchdog a worker exception
    re-raises from ``step()``.  Counters: ``shed``, ``expired``,
    ``preemptions``.
    """

    def __init__(self, params, cfg, *, monitor: Optional[TrafficMonitor]
                 = None, max_active: int = 4, max_len: int = 128,
                 page_size: int = 16, paged: Optional[bool] = None,
                 mirror_pages: bool = False, macro: Optional[bool] = None,
                 pipeline: bool = False,
                 admit_chunk_tokens: Optional[int] = None,
                 eager: bool = False, cond=None, extra_embeds=None,
                 fault_plan=None, max_queue: Optional[int] = None,
                 watchdog_s: Optional[float] = None,
                 max_worker_restarts: int = 3, device=None):
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
        self.paged = monitor is not None if paged is None else bool(paged)
        if self.paged and monitor is None:
            raise ValueError("fully-paged decode needs a TrafficMonitor "
                             f"({cfg.name})")
        self.macro = self.paged if macro is None else bool(macro)
        if self.macro and not self.paged:
            raise ValueError("macro-step decode runs on the fully-paged "
                             "path only")
        self.pipeline = bool(pipeline)
        if self.pipeline and not self.macro:
            raise ValueError("pipeline=True needs macro-step decode (the "
                             "overlap window is the macro's flight time)")
        self._chunk_width = None
        if admit_chunk_tokens is not None:
            if admit_chunk_tokens < 1:
                raise ValueError("admit_chunk_tokens must be >= 1")
            # page-aligned chunks: each page is written by one chunk
            self._chunk_width = -(-admit_chunk_tokens // page_size) \
                * page_size
        # the write-through mirror needs the legacy single-layer pair; a
        # layered-only pool is physical but has none
        self.mirror_pages = (not self.paged and mirror_pages
                             and monitor is not None
                             and monitor.pools.k_host is not None)
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
        self.route = decode_route(self.device, macro=self.macro,
                                  eager=eager)
        if (self.pipeline and self.device.type == "cuda"
                and self.route != "graph"):
            raise ValueError("the pipelined loop runs by the graph route "
                             "on a card (eager=True was asked)")
        # overload safety (docs/robustness.md in the reference)
        self.fault_plan = fault_plan if fault_plan is not None else NULL_PLAN
        if monitor is not None and fault_plan is not None:
            monitor.pools.fault_plan = self.fault_plan
        self.max_queue = max_queue
        self.watchdog_s = watchdog_s
        self.max_worker_restarts = max_worker_restarts
        self._worker_restarts = 0
        self._worker_degraded = False   # restarts spent: decide in line
        #: bumped on every worker restart: a zombie worker that wakes with
        #: an older epoch in its payload touches neither manager nor tuner
        self._live_epoch = 0
        self._last_payload: Optional[Dict] = None
        #: preempted requests, oldest first (they thaw FIFO)
        self._frozen: List[Request] = []
        self.preemptions = 0
        self.shed = 0                   # shed at submit (queue full)
        self.expired = 0                # deadline passed while queued
        # the pipelined loop's state (inert without pipeline)
        self._inflight: Optional[Dict] = None
        self._pending_admits: List[_PendingAdmit] = []
        self._prefetched_next = 0
        self._decision_gen: Optional[int] = None
        self._decision_worker = (DecisionWorker(self._plan_decision)
                                 if self.pipeline else None)
        self._graph = None
        self.cache = None
        if self.paged:
            self._init_paged()
        else:
            # prefill produces float32 caches: the packed cache matches
            self.cache = mdl.init_cache(cfg, max_active, self.max_len,
                                        dtype=torch.float32,
                                        device=self.device)
        self._mon_fn = (engine.make_monitor(params, cfg, page_size,
                                            self.n_row_pages)
                        if monitor is not None and not self.paged else None)
        # the monitor slot exists only for configs with a full-attention
        # layer; the paged path needs it only for ``paged_context``
        try:
            self._si, self._sj = engine.monitor_slot(cfg)
        except ValueError:
            self._si = self._sj = None
        if self.mirror_pages and self._si is None:
            raise ValueError(f"{cfg.name}: mirror_pages needs a "
                             "full-attention monitor layer")

    def _init_paged(self) -> None:
        """The paged path's state: layered pool leaves, the shared prefix
        pages, the static device page tables and, on the graph route, the
        captured decode step."""
        pools = self.monitor.pools
        if pools.kv_layers is None:
            pools.attach_layered(mdl.slot_leaf_specs(self.cfg,
                                                     self.page_size),
                                 dtype=torch.float32, device=self.device)
        self._hbm_need = 0     # exact pages the in-flight set can touch
        self._gid_tables = np.full((self.max_active, self.n_row_pages), -1,
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
            torch.full((self.max_active, self.n_row_pages), -1,
                       dtype=torch.int32, device=self.device)
            for _ in range(2))
        # every row's state page sits at the fixed last table column
        self._state_cols = (torch.full((self.max_active,),
                                       self.n_row_pages - 1,
                                       dtype=torch.int64, device=self.device)
                            if self._has_state else None)
        if self.route == "graph":
            self._graph = graphs.DecodeGraph(
                self.params, self.cfg, pools.kv_with_sink,
                *self._tables_dev, max_steps=bucket_pages(self.max_len),
                page_size=self.page_size, state_cols=self._state_cols,
                cond=self._cond_rows)

    # -- admission -----------------------------------------------------------
    def _pages_kv_exact(self, req: Request) -> int:
        """Exact token pages the request's own positions span: on the
        paged path none without attention layers, and the shared prefix
        pages are mapped, not owned; on the dense path the prefix counts
        (it is part of the row)."""
        if not self.paged:
            return -(-(self.prefix + req.total_len) // self.page_size)
        if not self._has_attn:
            return 0
        return -(-req.total_len // self.page_size)

    def _pages_exact(self, req: Request) -> int:
        """Exact own-page footprint: token pages plus, paged, the state
        page."""
        return self._pages_kv_exact(req) + (self._state_extra if self.paged
                                            else 0)

    def _pages_alloc(self, req: Request) -> int:
        """Bucket-rounded allocation size (power-of-two token pages, capped
        at one row less the shared prefix pages, plus the un-bucketed
        state page; dense, capped at one row): what the request actually
        holds in the shared pool (none without a monitor)."""
        if self.monitor is None:
            return 0
        if not self.paged:
            return bucket_pages(self._pages_exact(req), cap=self.n_row_pages)
        kv_exact = self._pages_kv_exact(req)
        cap = self.max_len // self.page_size - self._prefix_pages
        kv_alloc = bucket_pages(kv_exact, cap=cap) if kv_exact else 0
        return kv_alloc + self._state_extra

    def submit(self, req: Request) -> None:
        req._t_submit = time.monotonic()
        req.deadline_step = (self.step_idx + req.ttl_steps
                             if req.ttl_steps is not None else -1)
        if self.prefix + req.total_len > self.max_len:
            raise ValueError(f"request {req.rid} needs "
                             f"{self.prefix + req.total_len} positions, "
                             f"cache rows hold {self.max_len}")
        if self.monitor is not None:
            pools = self.monitor.pools
            avail = pools.n_logical - self._prefix_pages
            if self._pages_alloc(req) > avail:
                # it could never admit, not even with the pool drained
                raise ValueError(
                    f"request {req.rid} needs {self._pages_alloc(req)} "
                    f"pages, the logical space holds {avail} beyond the "
                    "shared prefix")
            touched = self._prefix_pages + self._pages_exact(req)
            if self.paged and touched > pools.hbm_pages:
                raise ValueError(f"request {req.rid} touches {touched} "
                                 "pages, the HBM slot pool holds "
                                 f"{pools.hbm_pages}")
        if (self.max_queue is not None and len(self.queue) >= self.max_queue
                and self.fault_plan.fires("admit.flood") is None):
            # the bounded queue sheds with a typed status; an armed
            # ``admit.flood`` forces the queue past its bound (the chaos
            # harness's test that later stages shed rather than stall)
            self._retire_unadmitted(req, "shed", "queue-full")
            return
        self.queue.append(req)

    def _retire_unadmitted(self, req: Request, status: str,
                           reason: str) -> None:
        """End a request that never reached a row -- shed at submit
        (``"shed"``) or expired while queued (``"expired"``) -- with an
        empty stream in ``completed``: every submission ends with a typed
        status."""
        req.status = status
        self.completed.append(req)
        if status == "shed":
            self.shed += 1
        else:
            self.expired += 1
        if (r := _obs.RECORDER).enabled:
            r.emit("serve.shed", step=self.step_idx, rid=req.rid,
                   reason=reason, queue_depth=len(self.queue))
            r.emit("serve.retire", step=self.step_idx, rid=req.rid,
                   tokens=0, status=status,
                   deadline_ms=(time.monotonic() - req._t_submit) * 1e3
                   if req._t_submit else 0.0)
            r.count("serve.shed_total")
            r.count("serve.retired")

    def _expire_queue(self) -> None:
        """Retire the queued requests whose deadline has passed (admitted
        ones are never aborted)."""
        if not any(req.deadline_step >= 0 for req in self.queue):
            return
        keep: List[Request] = []
        for req in self.queue:
            if 0 <= req.deadline_step < self.step_idx:
                self._retire_unadmitted(req, "expired", "deadline")
            else:
                keep.append(req)
        self.queue = collections.deque(keep)

    def _reserve(self) -> List[Request]:
        """Expire the queue's overdue requests, then take its head into
        free rows while it fits (head-of-line: arrival order kept): its
        row, its pages (with a monitor; on the paged path within the HBM
        gate, against the squeezed capacity) and, paged, its table row.
        Returns the requests taken."""
        self._expire_queue()
        batch: List[Request] = []
        while self.queue and self.rows_free:
            req = self.queue[0]
            n_exact = self._pages_exact(req)
            gids = None
            if self.monitor is not None:
                pools = self.monitor.pools
                if self.paged and (self._hbm_need + n_exact
                                   > pools.effective_hbm):
                    break              # head-of-line: keep arrival order
                gids = pools.alloc(self._pages_alloc(req), req.rid)
                if gids is None:
                    break
            self.queue.popleft()
            req.row, req.gids, req.n_pages = self.rows_free.pop(), gids, \
                n_exact
            req.n_alloc = 0 if gids is None else len(gids)
            if self.paged:
                self._hbm_need += n_exact
                self._map_row(req)
            batch.append(req)
        return batch

    def _admit(self) -> List[Tuple[int, int]]:
        batch = self._reserve()
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
        changes; the ``pool.table_upload.performed`` / ``.skipped``
        counters measure the split.  The rewrite is a stream-ordered copy,
        so in the pipelined loop it queues behind the macro in flight."""
        pools = self.monitor.pools
        key = (pools.slot_epoch, self._rows_epoch)
        track = (r := _obs.RECORDER).enabled
        if self._tables_key == key:
            if track:
                r.count("pool.table_upload.skipped")
            return self._tables_dev
        slots = np.full_like(self._gid_tables, -1)
        m = self._gid_tables >= 0
        slots[m] = pools.table(self._gid_tables[m])
        for dst, src in zip(self._tables_dev,
                            _upload(self.device, slots, self._gid_tables)):
            dst.copy_(src)
        self._tables_key = key
        if track:
            r.count("pool.table_upload.performed")
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
        the pool (paged) or their rows into the packed cache (dense), and
        sample each first token."""
        plens = [len(r.prompt) for r in batch]
        if self._batched_prefill:
            logits_b, cache_b = self._prefill_packed(batch)
            if self.paged:
                self._write_prefill_pages(cache_b, batch, plens)
            else:
                for bi, req in enumerate(batch):
                    self._write_row(req.row, mdl.row_cache_from_batched(
                        cache_b, self.cfg, bi, self.prefix + plens[bi],
                        self.max_len))
        else:
            rows = []
            for req in batch:
                logits, cache1 = self._prefill_one(req)
                if self.paged:
                    self._write_prefill_pages_row(cache1, req)
                else:
                    one = mdl.pad_cache(cache1, self.cfg, self.max_len)
                    self._write_row(req.row, {"segments": [
                        [{k: v[:, 0] for k, v in e.items()} for e in seg]
                        for seg in one["segments"]]})
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
            if self.mirror_pages:
                self._mirror(req, range(-(-(self.prefix + plen)
                                          // self.page_size)))
            if req.max_new_tokens <= 1 or tok == req.eos_id:
                self._retire(req)
        return emitted

    def _prefill_packed(self, batch: List[Request]):
        """One ``prefill_batched`` over ``batch``'s prompts, packed by
        ``pack_prompts``, the session's conditioning and prefix broadcast
        to its rows.  Returns (logits, cache)."""
        toks, lens = pack_prompts([r.prompt for r in batch], self.prefix)
        rows = lambda t: None if t is None else t.expand(
            (toks.shape[0],) + t.shape[1:])
        return mdl.prefill_batched(
            self.params, self.cfg, *_upload(self.device, toks, lens),
            cond=rows(self._cond), extra_embeds=rows(self._ex))

    def _prefill_one(self, req: Request):
        """``prefill`` of one request's prompt (the admission of recurrent
        configs).  Returns (logits, cache)."""
        prompt = np.asarray(req.prompt, np.int64)[None]
        return mdl.prefill(self.params, self.cfg,
                           _upload(self.device, prompt)[0], cond=self._cond,
                           extra_embeds=self._ex)

    def _write_row(self, row: int, one) -> None:
        """Install one request's cache (leaves [R, cap, ...], a recurrent
        slot's state [R, ...]) as row ``row`` of the packed dense cache."""
        for seg, seg1 in zip(self.cache["segments"], one["segments"]):
            for e, e1 in zip(seg, seg1):
                for name, a in e1.items():
                    e[name][:, row] = a.to(e[name].dtype)

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

    # -- overload safety: the fault clock, preemption, thaw -------------------
    def _fault_tick(self) -> None:
        """Advance the fault plan's clock once a scheduler step and actuate
        the squeeze: while ``pool.squeeze`` fires, the pools'
        ``effective_hbm`` is its value (at least 1); the full capacity
        returns when its window closes."""
        plan = self.fault_plan
        if not plan.enabled:
            return
        plan.tick()
        if self.monitor is not None and self.paged:
            pools = self.monitor.pools
            p = plan.fires("pool.squeeze")
            pools.effective_hbm = (max(1, int(p.value)) if p is not None
                                   else pools.hbm_pages)

    def _rebalance(self) -> None:
        """The pressure response at a boundary: first thaw frozen requests
        FIFO while their footprint fits the effective capacity (one thaws
        regardless when nothing else is active or pending, so a squeeze
        below every footprint still drains); then, while the in-flight
        footprint exceeds it, preempt the coldest active row -- the least
        manager hotness over its pages, ties to the newest rid -- among
        rows whose first token has been read, never the last one."""
        if not self.paged or self.monitor is None:
            return
        pools = self.monitor.pools
        while self._frozen and self.rows_free:
            req = self._frozen[0]
            fits = self._hbm_need + req.n_pages <= pools.effective_hbm
            if not fits and (self.active or self._pending_admits):
                break
            self._thaw(self._frozen.pop(0))
        while self._hbm_need > pools.effective_hbm and len(self.active) > 1:
            hot = self.monitor.manager.hotness
            victims = [req for req in self.active.values()
                       if req._first_tok is None]
            if len(victims) <= 1:
                break
            self._preempt(min(victims, key=lambda q: (
                float(hot[q.gids].sum()), -q.rid)))

    def _preempt(self, req: Request) -> None:
        """Freeze one active request: demote its pages (the host copy is
        written through, so no byte moves), free its row and park it with
        its position and next input token.  That token is the last one it
        emitted (``tokens[-1]``, equal to ``tok[row, 0]`` on the device),
        so the boundary reads nothing back.  Its pages stay allocated: a
        thaw re-installs the row, never prefills again."""
        pools = self.monitor.pools
        row = req.row
        req._frozen_pos = int(self.pos[row])
        req._frozen_tok = int(req.tokens[-1])
        hot = float(self.monitor.manager.hotness[req.gids].sum())
        released = pools.demote(req.gids)
        del self.active[row]
        self.rows_free.append(row)
        self._hbm_need -= req.n_pages
        self._gid_tables[row, :] = -1
        self._rows_epoch += 1
        req.row = -1
        self._frozen.append(req)
        self.preemptions += 1
        if (r := _obs.RECORDER).enabled:
            r.emit("serve.preempt", step=self.step_idx, rid=req.rid,
                   pages=int(released), mass=hot,
                   hbm_need=int(self._hbm_need),
                   hbm_cap=int(pools.effective_hbm))
            r.count("serve.preempted")

    def _thaw(self, req: Request) -> None:
        """Reactivate a frozen request into a free row: its table row, its
        position and its next input token (written on the device, no
        read).  ``seed`` and ``_i`` never left it, so its stream resumes
        bit for bit; its pages come back through the next launch's demand
        fetch (the preemption's price, charged to the tuner)."""
        row = self.rows_free.pop()
        req.row = row
        self._map_row(req)
        self._hbm_need += req.n_pages
        self.pos[row] = req._frozen_pos
        self.tok[row].fill_(req._frozen_tok)       # no host sync
        self.active[row] = req
        if (r := _obs.RECORDER).enabled:
            r.count("serve.thawed")

    # -- the scheduler loop --------------------------------------------------
    @torch.no_grad()
    def step(self) -> List[Tuple[int, int]]:
        """One scheduler step: the fault clock, the pressure response
        (``_rebalance``), admit (one packed prefill), then one decode
        launch (a macro step or a single token) over the request set.
        Returns the (rid, token) pairs emitted, prefill samples included.
        In the pipelined loop a step completes the previous macro,
        rebalances, launches the next and fills the window behind it
        (``_step_pipelined``): tokens surface one step after their macro
        launched."""
        track = (r := _obs.RECORDER).enabled
        t0 = time.monotonic() if track else 0.0
        self._fault_tick()
        if self.pipeline:
            emitted = self._step_pipelined()
        else:
            self._rebalance()
            emitted = self._admit()
            self.step_idx += 1
            if self.active:
                if not self.paged:
                    emitted += self._step_dense()
                elif self.macro:
                    emitted += self._step_paged_macro()
                else:
                    emitted += self._step_paged()
        if track:
            r.observe("serve.step_s", time.monotonic() - t0)
        return emitted

    def _row_inputs(self, rows) -> Dict[str, np.ndarray]:
        """The per-row inputs of a decode launch, rows without a request
        inert: position (-1), seed, decode iterations done, tokens
        emitted (a lazily admitted row's first token, still on the device,
        counted), budget, EOS (-1 = none) and temperature."""
        b = self.max_active
        cur = np.full((b,), -1, np.int64)
        seeds, iters, emitted, max_new = (np.zeros((b,), np.int64)
                                          for _ in range(4))
        eos = np.full((b,), -1, np.int64)
        temps = np.zeros((b,), np.float32)
        for row, req in rows:
            cur[row] = self.pos[row]
            seeds[row], iters[row] = req.seed, req._i
            emitted[row] = len(req.tokens) + (req._first_tok is not None)
            max_new[row] = req.max_new_tokens
            eos[row] = -1 if req.eos_id is None else req.eos_id
            temps[row] = req.temperature
        return dict(cur=cur, seeds=seeds, iters=iters, emitted=emitted,
                    max_new=max_new, eos=eos, temps=temps)

    def _step_dense(self) -> List[Tuple[int, int]]:
        """One dense decode step: with a monitor, the monitor layer's
        masses over the current cache (one host read), merged over each
        request's exact pages and fed to the monitor; then one
        ``decode_step`` for the whole row set, sampling on the device at
        each row's (seed, iteration), one host read of the tokens, the
        mirror of the page each row just wrote, retirement."""
        rows = list(self.active.items())
        track = (r := _obs.RECORDER).enabled
        pos = _upload(self.device, self.pos)[0]
        if self.monitor is not None:
            t0 = time.monotonic() if track else 0.0
            masses = _read_back(self._mon_fn(self.cache, self.tok, pos))[0]
            merged = self.monitor.merge(
                [(req.gids[: req.n_pages], masses[row, : req.n_pages])
                 for row, req in rows])
            self.monitor.on_step(merged, n_active=len(rows))
            if track:
                r.observe("serve.monitor_s", time.monotonic() - t0)
        inp = self._row_inputs(rows)
        temps, seeds, iters = _upload(self.device, inp["temps"],
                                      inp["seeds"], inp["iters"] + 1)
        logits, self.cache = mdl.decode_step(self.params, self.cfg,
                                             self.cache, self.tok, pos,
                                             cond=self._cond_rows)
        new_tok = mdl.sample(logits[:, 0], temps, seeds, iters)
        toks = _read_back(new_tok)[0].tolist()
        # rows without a request decode too (their rows are rewritten at
        # admission); their token is never read
        self.tok = new_tok[:, None]
        self.decode_steps += 1
        self.device_steps += 1
        emitted: List[Tuple[int, int]] = []
        for row, req in rows:
            written = int(self.pos[row])
            self.pos[row] += 1
            req._i += 1
            req.tokens.append(toks[row])
            emitted.append((req.rid, toks[row]))
            if self.mirror_pages:
                self._mirror(req, [written // self.page_size])
            if (len(req.tokens) >= req.max_new_tokens
                    or toks[row] == req.eos_id):
                self._retire(req)
        return emitted

    def _step_paged(self) -> List[Tuple[int, int]]:
        """One paged decode step: demand-fetch the in-flight working set,
        decode every row off the pool, sample on the device, read the
        masses and tokens back once, feed the monitor, retire."""
        pools = self.monitor.pools
        fetched = pools.ensure_resident(
            self._need({row: 1 for row in self.active}))
        degraded, pools.degraded_fetches = pools.degraded_fetches, 0
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
        self.monitor.on_step(merged, n_active=len(rows), fetched=fetched,
                             degraded=degraded)

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
        period.  The pipelined loop runs the same two halves a scheduler
        step apart."""
        emitted, _ = self._macro_complete(self._macro_launch(), sync=True)
        return emitted

    def _macro_launch(self) -> Dict:
        """Queue one macro over the current request set and its read-back,
        without waiting: the demand fetch of every page the macro can
        touch, the tables, the launch, the next input token (a clone: the
        graph's carry is overwritten by the next launch) and the
        non-blocking copies of the outputs into pinned buffers, with one
        event after them.  Work queued later (a pipelined overlap window)
        runs behind the macro on the stream, and ``_macro_complete`` waits
        for that event only.  Returns the in-flight record."""
        pools = self.monitor.pools
        rows = list(self.active.items())
        period = self.monitor.manager.period
        inp = self._row_inputs(rows)
        rem = {row: req.max_new_tokens - int(inp["emitted"][row])
               for row, req in rows}
        # the reference's bucketing: the pow2 floor of the live period,
        # capped by the pow2 ceiling of the remaining work
        n_steps = max(1, min(1 << max(0, int(period).bit_length() - 1),
                             bucket_pages(max(rem.values()))))
        horizons = {row: min(n_steps, rem[row]) for row, _ in rows}
        # every page the macro can touch is resident before it launches;
        # re-fetches (and those an overlap window prefetched for this
        # macro) are charged inside the tuner's cost window
        fetched = pools.ensure_resident(self._need(horizons))
        fetched += self._prefetched_next
        self._prefetched_next = 0
        # the degraded fetches since the last launch (the overlap window's
        # prefetch included) go on this macro's bill
        degraded, pools.degraded_fetches = pools.degraded_fetches, 0
        tables, gid_tables = self._tables_for()
        dev_in = _upload(self.device, inp["cur"], inp["seeds"],
                         inp["iters"], inp["emitted"], inp["max_new"],
                         inp["eos"], inp["temps"])

        self.macro_timer.start()
        tok_in = self.tok
        if self.route == "graph":
            toks, st = self._graph.launch(tok_in, *dev_in, n_steps=n_steps)
        else:
            toks, st = mdl.decode_macro_step(
                self.params, self.cfg, pools.kv_with_sink, tables,
                gid_tables, tok_in, *dev_in, n_steps=n_steps,
                page_size=self.page_size, state_cols=self._state_cols,
                cond=self._cond_rows)
        self.tok = st["last_tok"].clone()
        outs = [toks, st["mass_sum"], st["alive_steps"], st["stopped"],
                st["pos"], st["iters"]]
        if any(req._first_tok is not None for _, req in rows):
            outs.append(tok_in)       # the lazily admitted first tokens
        host, done = _copy_back(*outs)
        return dict(rows=rows, n_steps=n_steps, steps=st["steps"],
                    fetched=fetched, degraded=degraded, horizons=horizons,
                    host=host, done=done)

    def _macro_complete(self, fl: Dict, sync: bool
                        ) -> Tuple[List[Tuple[int, int]], Optional[Dict]]:
        """Wait for an in-flight macro's read-back and run its boundary:
        merge the masses, append and emit the tokens (a lazily admitted
        row's first token ahead of its macro tokens), retire.  ``sync``
        (the synchronous loop) feeds the monitor here -- tier and tune
        before the next launch; otherwise (the pipelined loop) the feed
        becomes a payload for the ``DecisionWorker``, with the numpy
        snapshots ``plan_step`` takes, built before the retirements as the
        reference's.  Returns (emitted, payload or None)."""
        rows, n_steps = fl["rows"], fl["n_steps"]
        toks_np, mass_sum, alive_steps, stopped, pos, iters, *first = \
            _wait_back(fl["host"], fl["done"])
        macro_wall = self.macro_timer.stop(self.step_idx)

        # one merge + monitor feed per movement period: the mean mass over
        # the steps each row ran keeps the per-step scale the access
        # threshold expects; dt = the macro's span in token-steps
        merged = self.monitor.merge(
            [(r.table_gids,
              mass_sum[row, r.mass_cols] / max(1, int(alive_steps[row])))
             for row, r in rows])
        self.decode_steps += int(alive_steps.max())
        self.device_steps += fl["steps"]
        dt = max(1, int(alive_steps.max()))
        n_active = float(alive_steps.sum()) / dt
        if (plan := self.fault_plan).enabled \
                and plan.fires("mass.nonfinite") is not None:
            # corrupt the merged telemetry: the monitor's clamp must
            # neutralise it before the tuner sees it
            merged[::3] = np.nan
            merged[1::5] = np.inf
        payload = None
        if sync:
            self.monitor.on_macro_step(merged, n_active=n_active,
                                       n_tokens=dt, fetched=fl["fetched"],
                                       degraded=fl["degraded"])
        else:
            # the worker's snapshots; the free slots are clamped to the
            # squeezed capacity, so a planned bring never overfills it
            pools = self.monitor.pools
            payload = dict(global_mass=merged, n_active=n_active,
                           n_tokens=dt, fetched=fl["fetched"],
                           degraded=fl["degraded"],
                           resident=pools.slot_of >= 0,
                           n_free=squeezed_free(
                               pools, int((pools.page_of_slot < 0).sum())),
                           active=pools.allocated_mask,
                           planes=int(pools.move_planes))

        self.pos = pos
        emitted: List[Tuple[int, int]] = []
        for row, req in rows:
            if req._first_tok is not None:
                req._first_tok = None
                tk = int(first[0][row, 0])
                req.tokens.append(tk)
                emitted.append((req.rid, tk))
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
                   fetched=int(fl["fetched"]), wall_ms=macro_wall * 1e3,
                   straggler=bool(self.macro_timer.stragglers
                                  and self.macro_timer.stragglers[-1]
                                  == self.step_idx))
            r.count("serve.tokens", len(emitted))
        return emitted, payload

    # -- the pipelined macro loop --------------------------------------------
    def _plan_decision(self, payload: Dict):
        """The worker's function: one boundary's plan (host numpy only).
        The worker faults (``worker.delay`` sleeps, ``worker.crash``
        raises) fire before the manager or tuner is touched, so a
        recovery can recompute the boundary without feeding the tuner
        twice; a payload from an older epoch (a zombie waking after a
        restart) returns an inert result."""
        plan = self.fault_plan
        if plan.enabled:
            if (p := plan.fires("worker.delay")) is not None:
                time.sleep(p.value)
            if plan.fires("worker.crash") is not None:
                raise RuntimeError("injected decision-worker crash")
        if payload.get("_epoch", self._live_epoch) != self._live_epoch:
            return self.monitor.manager.period, None
        return self.monitor.plan_step(
            **{k: v for k, v in payload.items() if k != "_epoch"})

    def _worker_recover(self, reason: str):
        """The watchdog's recovery from a hung (``"hang"``) or crashed
        (``"crash"``) worker: walk away from its thread (``abandon`` a
        hang, ``close`` a crash), bump the live epoch so the zombie
        touches nothing, restart the worker (none once
        ``max_worker_restarts`` is spent: the loop then decides in line
        for good), revert the tuner to its last good period, and
        recompute this boundary's decision from the stashed payload.
        Returns (period, plan)."""
        self._live_epoch += 1
        w = self._decision_worker
        if reason == "hang":
            w.abandon()
        else:
            w.close(timeout=1.0)
        self._worker_restarts += 1
        self._worker_degraded = (self._worker_restarts
                                 > self.max_worker_restarts)
        self._decision_worker = (None if self._worker_degraded
                                 else DecisionWorker(self._plan_decision))
        if self.monitor.tuner is not None:
            self.monitor.tuner.revert_last_good(
                reason=f"decision-worker-{reason}")
        period, plan = self.monitor.plan_step(
            **{k: v for k, v in self._last_payload.items() if k != "_epoch"})
        if (r := _obs.RECORDER).enabled:
            r.emit("serve.worker_restart", step=self.step_idx,
                   reason=reason, restarts=self._worker_restarts,
                   degraded=self._worker_degraded)
            r.count("serve.worker_restarts")
        return period, plan

    def _step_pipelined(self) -> List[Tuple[int, int]]:
        """One pipelined scheduler step, in the reference's fixed order:

        1. complete the previous macro (wait for its read-back, append the
           tokens, deferred first tokens included, retire) -- the worker
           is idle, so the retirements may touch the manager and tuner --
           and rebalance (thaw, preempt);
        2. reserve admissions off the queue (rows and pages held, the
           synchronous loop's HBM gate);
        3. queue the packed prefill of the fresh non-chunked reservations;
        4. activate every ready admission lazily: its first token is
           sampled on the device behind its prefill and written into the
           row's input, so the request rides the macro launched next;
        5. launch the next macro (placement and period from the decision
           applied at the last boundary: stale-by-one);
        6. submit the completed macro's payload to the worker (with the
           live epoch, and stashed for a recovery), or decide it in line
           once the restarts are spent;
        7. the overlap window behind the macro (``_pipeline_overlap``)."""
        fl, self._inflight = self._inflight, None
        emitted: List[Tuple[int, int]] = []
        payload = None
        if fl is not None:
            emitted, payload = self._macro_complete(fl, sync=False)
        self.step_idx += 1
        self._rebalance()
        self._admit_reserve()
        self._admit_prefill_fresh()
        emitted += self._admit_activate()
        if self.active:
            self._inflight = self._macro_launch()
        if payload is not None:
            if self._decision_worker is not None:
                payload["_epoch"] = self._live_epoch
                self._last_payload = payload
                self._decision_gen = self._decision_worker.submit(payload)
            else:
                _, plan = self.monitor.plan_step(**payload)
                self.monitor.apply_decision(plan)
        self._pipeline_overlap()
        return emitted

    def _pipeline_overlap(self) -> None:
        """The overlap window: the boundary's host work, queued behind the
        macro just launched.  Fixed stage order: wait for the decision and
        apply it (it moves placement), advance chunked admissions, prefetch
        the next horizon (it re-fetches what the earlier stages evicted),
        stage the tables.  Each stage emits ``serve.pipeline.stage``.  With
        a watchdog, a wait past ``watchdog_s`` is a hang and a decision
        that raised a crash (``_worker_recover``); without one the
        exception re-raises."""
        track = (r := _obs.RECORDER).enabled
        if self._decision_gen is not None:
            gen, self._decision_gen = self._decision_gen, None
            t0 = time.monotonic()
            try:
                (period, plan), waited = self._decision_worker.wait(
                    gen, timeout=self.watchdog_s)
            except TimeoutError:
                period, plan = self._worker_recover("hang")
                waited = time.monotonic() - t0
            except Exception:
                if self.watchdog_s is None:
                    raise
                period, plan = self._worker_recover("crash")
                waited = time.monotonic() - t0
            self.monitor.apply_decision(plan)
            if track:
                r.emit("serve.pipeline.decision", step=self.step_idx,
                       generation=gen, period=int(period),
                       bring=0 if plan is None else int(len(plan[0])),
                       evict=0 if plan is None else int(len(plan[1])),
                       wait_ms=waited * 1e3)
                r.emit("serve.pipeline.stage", step=self.step_idx,
                       stage="decision_wait",
                       wall_ms=(time.monotonic() - t0) * 1e3)
        if any(p.chunked and not p.ready for p in self._pending_admits):
            t0 = time.monotonic()
            for p in self._pending_admits:
                if p.chunked and not p.ready:
                    self._dispatch_chunk(p)
            if track:
                r.emit("serve.pipeline.stage", step=self.step_idx,
                       stage="admit",
                       wall_ms=(time.monotonic() - t0) * 1e3)
        fl = self._inflight
        if fl is None:
            return
        # opportunistic prefetch for the next macro: this macro's horizon
        # plus one more of its length, capped by each row's budget (the
        # next launch's demand fetch still backstops)
        t0 = time.monotonic()
        per_row = {row: min(fl["horizons"][row] + fl["n_steps"],
                            req.max_new_tokens - len(req.tokens))
                   for row, req in fl["rows"]}
        self._prefetched_next += self.monitor.pools.ensure_resident(
            self._need(per_row))
        if track:
            r.emit("serve.pipeline.stage", step=self.step_idx,
                   stage="prefetch", wall_ms=(time.monotonic() - t0) * 1e3)
        t0 = time.monotonic()
        self._tables_for()
        if track:
            r.emit("serve.pipeline.stage", step=self.step_idx,
                   stage="tables", wall_ms=(time.monotonic() - t0) * 1e3)

    def _admit_reserve(self) -> None:
        """Move admittable requests (``_reserve``: rows, pages and table
        rows held, the synchronous loop's gate) into the pending set; the
        prefill is queued later and the row activates at a boundary."""
        for req in self._reserve():
            plen = len(req.prompt)
            # chunks need prefill_chunk's contract: batched prefill, no
            # shared prefix (chunk positions are cache positions)
            chunked = (self._chunk_width is not None
                       and self._batched_prefill and self.prefix == 0
                       and plen > self._chunk_width)
            self._pending_admits.append(_PendingAdmit(
                req=req, plen=plen, chunked=chunked,
                t_submit=time.monotonic()))
        if (r := _obs.RECORDER).enabled:
            r.gauge("serve.queue_depth", len(self.queue))

    def _admit_prefill_fresh(self) -> None:
        """Queue the prefill of every fresh non-chunked reservation -- one
        packed forward, or one prefill a request for recurrent configs --
        and write their pages, without reading anything back; the logits
        wait for the lazy first-token sample."""
        fresh = [p for p in self._pending_admits
                 if not p.ready and not p.chunked and p.logits is None]
        if not fresh:
            return
        if self._batched_prefill:
            reqs = [p.req for p in fresh]
            logits_b, cache_b = self._prefill_packed(reqs)
            self._write_prefill_pages(cache_b, reqs, [p.plen for p in fresh])
            for i, p in enumerate(fresh):
                p.logits = logits_b[i: i + 1]
        else:
            for p in fresh:
                p.logits, cache1 = self._prefill_one(p.req)
                self._write_prefill_pages_row(cache1, p.req)
        for p in fresh:
            p.ready = True

    def _dispatch_chunk(self, p: _PendingAdmit) -> None:
        """Queue one chunk of a long prompt's admission: a
        ``_chunk_width`` slice of the prompt forward-passed over the
        earlier chunks' past (``model.prefill_chunk``), its pages written
        into the pool, the past extended.  The chunk holding the prompt's
        last position gives the first-token logits; the last chunk makes
        the admission ready."""
        t0 = time.monotonic()
        c = self._chunk_width
        lo = p.next_start
        w = min(c, p.plen - lo)
        toks = np.zeros((1, c), np.int64)
        toks[0, :w] = p.req.prompt[lo: lo + w]
        logits, cc = mdl.prefill_chunk(
            self.params, self.cfg,
            *_upload(self.device, toks, np.asarray([p.plen], np.int64)),
            p.past, start=lo, cond=self._cond)
        self._write_chunk_pages(p.req, cc, lo, p.plen)
        if lo <= p.plen - 1 < lo + c:
            p.logits = logits
        p.next_start = lo + c
        p.chunk_idx += 1
        done = p.next_start >= p.plen
        p.past = None if done else mdl.chunk_past_extend(p.past, cc)
        p.ready = done
        if (r := _obs.RECORDER).enabled:
            r.emit("serve.pipeline.admit_chunk", step=self.step_idx,
                   rid=p.req.rid, chunk=p.chunk_idx - 1, tokens=int(w),
                   total=p.plen, wall_ms=(time.monotonic() - t0) * 1e3,
                   done=done)

    def _write_chunk_pages(self, req: Request, cache_chunk, lo: int,
                           plen: int) -> None:
        """Scatter one admission chunk's cache rows into the request's
        pages, both tiers.  Chunk starts and widths are page-aligned, so
        every page is written by one chunk; the last page's tail past
        ``plen`` holds padding rows that attention never reads (as the
        packed scatter's).  Slots are assigned bookkeeping-only, as an
        admission's."""
        pools = self.monitor.pools
        ps = self.page_size
        npg = self._chunk_width // ps
        p0 = lo // ps
        n_valid = min(npg, -(-(plen - lo) // ps))
        gids_m = np.full((1, npg), PAGE_DROP, np.int32)
        slots_m = np.full((1, npg), PAGE_DROP, np.int32)
        gids_m[0, :n_valid] = req.gids[p0: p0 + n_valid]
        slots_m[0, :n_valid] = pools.assign_slots(
            req.gids[p0: p0 + n_valid])
        write_pages_batched(pools.kv_layers,
                            self._cache_leaves(cache_chunk, 0, None),
                            gids_m, slots_m)

    def _admit_activate(self) -> List[Tuple[int, int]]:
        """The boundary half of a pipelined admission: every ready
        reservation joins the active set.  Its first token is sampled on
        the device at iteration 0 (``_prefill``'s draw) behind its
        prefill and written into ``self.tok`` -- after
        ``_macro_complete`` replaced it, or it would be overwritten -- so
        the row rides the macro launched next; the token reaches the
        stream when that macro completes (``Request._first_tok``), and
        the macro's entry check freezes a row whose first token is its
        EOS.  A one-token request reads its token back here and retires,
        as the synchronous admission does."""
        ready = [p for p in self._pending_admits if p.ready]
        if not ready:
            return []
        self._pending_admits = [p for p in self._pending_admits
                                if not p.ready]
        t0 = time.monotonic()
        reqs = [p.req for p in ready]
        first = mdl.sample(
            torch.cat([p.logits for p in ready])[:, 0], *_upload(
                self.device,
                np.asarray([r.temperature for r in reqs], np.float32),
                np.asarray([r.seed for r in reqs], np.int64),
                np.zeros((len(reqs),), np.int64)))
        rows = _upload(self.device,
                       np.asarray([r.row for r in reqs], np.int64))[0]
        self.tok[rows, 0] = first
        emitted: List[Tuple[int, int]] = []
        for i, p in enumerate(ready):
            req = p.req
            p.logits = p.past = None
            self.pos[req.row] = self.prefix + p.plen
            self.active[req.row] = req
            self._rows_epoch += 1
            if req.max_new_tokens <= 1:
                req.tokens.append(int(first[i]))
                emitted.append((req.rid, req.tokens[-1]))
                self._retire(req)
            else:
                req._first_tok = first[i: i + 1]
        if (r := _obs.RECORDER).enabled:
            now = time.monotonic()
            r.emit("serve.admit", step=self.step_idx, joiners=len(ready),
                   pages=int(sum(q.n_alloc for q in reqs)),
                   queue_depth=len(self.queue), wall_ms=(now - t0) * 1e3,
                   # the batch's longest reservation-to-activation wait
                   stall_ms=(now - min(p.t_submit for p in ready)) * 1e3)
            r.count("serve.admitted", len(ready))
            r.gauge("serve.queue_depth", len(self.queue))
        return emitted

    @property
    def idle(self) -> bool:
        """No work left: nothing queued, active, frozen, reserved or in
        flight (the pipelined loop holds admissions and a macro past the
        last queue and active set)."""
        return not (self.queue or self.active or self._pending_admits
                    or self._frozen or self._inflight is not None)

    def run(self, max_steps: int = 10 ** 6) -> Dict[int, List[int]]:
        """Step until every submitted request completed (or the step
        budget runs out).  Returns rid -> emitted tokens.  The pipelined
        loop drains its macro in flight and its reservations too, and
        every step ends with the decision worker idle."""
        steps = 0
        while not self.idle and steps < max_steps:
            self.step()
            steps += 1
        return {r.rid: list(r.tokens) for r in self.completed}

    def close(self) -> None:
        """Stop the pipelined loop's decision worker (a no-op for the
        synchronous loop and once the restarts are spent).  Safe mid-macro
        and after a worker error: a pending decision is dropped, never
        waited on, and the error stays with the dead worker."""
        self._decision_gen = None
        if self._decision_worker is not None:
            self._decision_worker.close()
            self._decision_worker = None

    def _retire(self, req: Request) -> None:
        req.status = "completed"
        del self.active[req.row]
        self.rows_free.append(req.row)
        self.completed.append(req)
        if self.paged:
            self._hbm_need -= req.n_pages
            self._gid_tables[req.row, :] = -1
            self._rows_epoch += 1
        if self.monitor is not None:
            self.monitor.release(req.gids)
        if (r := _obs.RECORDER).enabled:
            r.emit("serve.retire", step=self.step_idx, rid=req.rid,
                   tokens=len(req.tokens), status=req.status,
                   deadline_ms=(time.monotonic() - req._t_submit) * 1e3)
            r.count("serve.retired")

    # -- the shared pool's data path -----------------------------------------
    def _mirror(self, req: Request, pages) -> None:
        """Write the monitor layer's k/v rows of the request's ``pages``
        (indices into its own pages; those past its exact footprint are
        skipped) from the packed cache through into the pools' legacy
        pair: only the touched pages cross, on the device."""
        c = self.cache["segments"][self._si][self._sj]
        ps = self.page_size
        for p in pages:
            if 0 <= p < req.n_pages:
                rows = slice(p * ps, (p + 1) * ps)
                self.monitor.pools.write_page(
                    int(req.gids[p]), c["k"][-1, req.row, rows],
                    c["v"][-1, req.row, rows])

    @torch.no_grad()
    def paged_context(self, rid: int, q) -> Tuple[torch.Tensor, int]:
        """The monitor layer's attention context for in-flight request
        ``rid`` and query ``q`` [1, H, D], gathered by
        ``ops.paged_attention`` from the shared HBM pool through the
        request's pages' ``slot_of`` slots.  The pages covering its
        positions are demand-fetched first and charged to the manager as
        misses at ``miss_penalty``.  On the paged path it reads the
        monitor slot's layered HBM leaf (last repeat); on the dense path
        the legacy pair ``mirror_pages`` fills.  On a CUDA pool this
        launches the paged-attention kernel, on the CPU its plain version.
        Returns (context [1, H, D], pages fetched)."""
        if not (self.paged or self.mirror_pages):
            raise ValueError("paged_context needs fully-paged decode or "
                             "mirror_pages=True over physical pools: "
                             "otherwise the shared pool holds no KV data")
        if self._si is None:
            raise ValueError(f"{self.cfg.name}: no full-attention layer "
                             "to probe with paged_context")
        req = next((r for r in self.active.values() if r.rid == rid), None)
        if req is None:
            raise KeyError(f"request {rid} is not in flight")
        length = int(self.pos[req.row])
        n = -(-length // self.page_size)
        # paged: the pages covering [0, length) in table order (shared
        # prefix first); dense: the request's own run
        gids = req.table_gids[:n] if self.paged else req.gids[:n]
        pools = self.monitor.pools
        fetched = pools.ensure_resident(gids)
        mgr = self.monitor.manager
        mgr.misses += fetched
        mgr.modeled_time += fetched * mgr.cfg.miss_penalty
        if self.paged:
            li = mdl.attn_slot_index(self.cfg, self._si, self._sj)
            k_hbm = pools.kv_layers["k_hbm"][li][-1]
            v_hbm = pools.kv_layers["v_hbm"][li][-1]
        else:
            k_hbm, v_hbm = pools.k_hbm, pools.v_hbm
        table, lengths = _upload(
            k_hbm.device, pools.table(gids).astype(np.int32)[None],
            np.asarray([length], np.int32))
        q = torch.as_tensor(q, dtype=k_hbm.dtype, device=k_hbm.device)
        return ops.paged_attention(q, k_hbm, v_hbm, table, lengths), fetched


# ---------------------------------------------------------------------------
# model-free traffic replay (the same scheduling core, synthetic masses)
# ---------------------------------------------------------------------------


def _sink_pattern(spec: RequestSpec, n_pages: int) -> np.ndarray:
    return W.attention_sink(spec.new_tokens, n_pages,
                            sink_pages=min(2, n_pages),
                            window_pages=min(4, n_pages),
                            seed=spec.seed, drift_every=1)


def _periodic_pattern(spec: RequestSpec, n_pages: int) -> np.ndarray:
    span = max(1, min(8, n_pages - n_pages // 4))
    return W.periodic_context(spec.new_tokens, n_pages, span_pages=span,
                              period=16, seed=spec.seed)


def _random_pattern(spec: RequestSpec, n_pages: int) -> np.ndarray:
    return W.random_lookup(spec.new_tokens, n_pages,
                           touches=min(3, n_pages), seed=spec.seed)


#: a ``RequestSpec.kind`` -> its per-step page-mass pattern
#: f32[new_tokens, n_pages]
WORKLOAD_KINDS: Dict[str, Callable[[RequestSpec, int], np.ndarray]] = {
    "sink": _sink_pattern,
    "periodic": _periodic_pattern,
    "random": _random_pattern,
}


@dataclasses.dataclass
class _SynthActive:
    spec: RequestSpec
    gids: np.ndarray
    pattern: np.ndarray                # [lifetime, n_pages]
    t: int = 0


class TrafficScheduler:
    """Model-free continuous batching over a ``core.traffic`` request
    stream: FIFO head-of-line admission of arrived requests into
    ``max_active`` rows, bucket-rounded page-aligned allocation from the
    shared pool, one merged mass feed through the ``TrafficMonitor`` a
    step, retirement on length.  Deterministic given the stream, and
    admission depends on neither residency nor period, so fixed-period
    replays of one stream are directly comparable (the brute-force sweep
    the online tuner is ranked against).

    A request holds ``bucket_pages(exact, cap=row_pages)`` pages
    (``bucket=False``: exactly its footprint); its mass pattern touches
    only the exact footprint, the bucket tail is slack.  ``row_pages`` is
    the longest request's page count, the row a packed dense cache would
    provision, so ``dense_cache_pages`` is the baseline
    ``peak_cache_pages`` is compared with.  A request that can never fit
    the logical space is rejected instead of blocking the queue; with
    ``ttl_steps``, one still queued ``ttl_steps`` after its arrival is
    shed (status "expired")."""

    def __init__(self, specs: Sequence[RequestSpec], monitor: TrafficMonitor,
                 *, page_size: int = 16, max_active: int = 8,
                 bucket: bool = True, ttl_steps: Optional[int] = None):
        self.pending = collections.deque(
            sorted(specs, key=lambda s: (s.arrival, s.rid)))
        self.monitor = monitor
        self.page_size = page_size
        self.max_active = max_active
        self.bucket = bucket
        self.row_pages = max((s.n_pages(page_size) for s in specs),
                             default=1)
        self.ttl_steps = ttl_steps
        self.active: List[_SynthActive] = []
        self.now = 0
        self.admitted = 0
        self.completed = 0
        self.rejected = 0
        self.shed = 0

    @property
    def peak_cache_pages(self) -> int:
        """The most pages allocated at once (bucket-rounded rows)."""
        return self.monitor.pools.peak_allocated

    @property
    def dense_cache_pages(self) -> int:
        """What a packed dense cache provisions up front: ``max_active``
        rows of ``row_pages``, held for the whole run."""
        return self.max_active * self.row_pages

    def _pages_alloc(self, n_exact: int) -> int:
        if not self.bucket:
            return n_exact
        return bucket_pages(n_exact, cap=max(self.row_pages, n_exact))

    def step(self) -> None:
        if self.ttl_steps is not None:
            # the queue is arrival-sorted and the TTL uniform, so the
            # expired requests are a prefix of it
            while (self.pending
                   and self.now > self.pending[0].arrival + self.ttl_steps):
                spec = self.pending.popleft()
                self.rejected += 1
                self.shed += 1
                if (r := _obs.RECORDER).enabled:
                    r.emit("serve.shed", step=self.now, rid=spec.rid,
                           reason="deadline", queue_depth=len(self.pending))
                    r.emit("serve.retire", step=self.now, rid=spec.rid,
                           tokens=0, status="expired", deadline_ms=0.0)
                    r.count("serve.shed_total")
                    r.count("serve.retired")
        joiners = pages = 0
        while (self.pending and self.pending[0].arrival <= self.now
               and len(self.active) < self.max_active):
            spec = self.pending[0]
            n_pages = spec.n_pages(self.page_size)
            n_alloc = self._pages_alloc(n_pages)
            if n_alloc > self.monitor.pools.n_logical:
                # it could never admit, not even with the pool drained
                self.pending.popleft()
                self.rejected += 1
                continue
            gids = self.monitor.pools.alloc(n_alloc, spec.rid)
            if gids is None:           # head-of-line: keep arrival order
                break
            self.pending.popleft()
            pattern = WORKLOAD_KINDS[spec.kind](spec, n_pages)
            self.admitted += 1
            joiners += 1
            pages += n_alloc
            if pattern.shape[0] == 0:      # no decode step: retire at once
                self.monitor.release(gids)
                self.completed += 1
                continue
            self.active.append(_SynthActive(spec, gids, pattern))
        if joiners and (r := _obs.RECORDER).enabled:
            r.emit("serve.admit", step=self.now, joiners=joiners,
                   pages=pages, queue_depth=len(self.pending), wall_ms=0.0)
            r.count("serve.admitted", joiners)
            r.gauge("serve.queue_depth", len(self.pending))

        # idle steps are not fed (as the batcher): a lull's near-zero cost
        # would read as a phase change to the tuner
        if self.active:
            merged = self.monitor.merge(
                [(a.gids[: a.pattern.shape[1]], a.pattern[a.t])
                 for a in self.active])
            self.monitor.on_step(merged, n_active=len(self.active))
        self.now += 1

        still: List[_SynthActive] = []
        for a in self.active:
            a.t += 1
            if a.t >= a.pattern.shape[0]:
                self.monitor.release(a.gids)
                self.completed += 1
                if (r := _obs.RECORDER).enabled:
                    r.emit("serve.retire", step=self.now, rid=a.spec.rid,
                           tokens=int(a.pattern.shape[0]),
                           status="completed", deadline_ms=0.0)
                    r.count("serve.retired")
            else:
                still.append(a)
        self.active = still

    def run(self, steps: int) -> "TrafficScheduler":
        for _ in range(steps):
            self.step()
        return self
