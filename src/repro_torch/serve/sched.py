"""Continuous-batching serving scheduler over one shared KV page pool (the
counterpart of ``repro/serve/sched.py`` for the fully-paged, synchronous
loop).

  * ``TrafficMonitor`` merges per-request page masses into the global
    logical-page space and feeds one ``TieringManager`` + ``OnlineTuner``
    for the whole mix -- the aggregation point between the scheduler and
    Cori.
  * ``ContinuousBatcher`` admits requests between decode steps (a step's
    joiners prefill as one packed forward pass and write their pages
    straight into the pool), decodes the request set with every attention
    layer reading the pool through the paged-attention kernel, and
    retires requests on EOS or length, returning their pages.  By default
    it runs macro steps: one ``model.decode_macro_step`` per movement
    period, with one monitor feed and one tiering boundary per macro, and
    the period the tuner derives is the length of the next macro.

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
                                         write_pages_batched)
from repro_torch.models import model as mdl
from repro_torch.obs import telemetry as _obs

__all__ = ["Request", "TrafficMonitor", "ContinuousBatcher"]


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
    tokens: List[int] = dataclasses.field(default_factory=list)
    _i: int = 0                        # decode iterations done
    _t_submit: float = 0.0

    @property
    def total_len(self) -> int:
        return len(self.prompt) + self.max_new_tokens


class ContinuousBatcher:
    """Continuous batching of ``max_active`` rows, fully paged.

    Each request's token pages occupy a bucket-rounded run of global pages
    (``bucket_pages``); every attention layer decodes through the pool's
    ``slot_of`` tables (``model.decode_step_paged`` per token, or
    ``model.decode_macro_step`` per movement period with ``macro=True``,
    the default), and the per-page masses the tuner reads come from every
    attention layer of the decode itself.  Before each launch every page
    the decode can touch is demand-fetched into HBM (charged as misses);
    admission is gated so the in-flight exact footprint fits the HBM slot
    pool.  Runs on ``device`` (default cuda), where the parameters must
    already live.
    """

    def __init__(self, params, cfg, *, monitor: TrafficMonitor,
                 max_active: int = 4, max_len: int = 128,
                 page_size: int = 16, macro: bool = True, device=None):
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
        self.n_row_pages = self.max_len // page_size
        self.macro_timer = StepTimer(name="serve.macro")

        # the last sampled token per row lives on the device (the next
        # step's input); positions are host ints (the host plans fetches)
        self.tok = torch.zeros((max_active, 1), dtype=torch.int64,
                               device=self.device)
        self.pos = np.zeros((max_active,), np.int64)
        self.rows_free = list(range(max_active - 1, -1, -1))
        self.active: Dict[int, Request] = {}
        self.queue: "collections.deque[Request]" = collections.deque()
        self.step_idx = 0
        #: decode steps run (one pass of every layer over the request set)
        self.decode_steps = 0
        self.completed: List[Request] = []

        pools = monitor.pools
        if pools.kv_layers is None:
            pools.attach_layered(mdl.slot_leaf_specs(cfg, page_size),
                                 dtype=torch.float32, device=self.device)
        self._hbm_need = 0     # exact pages the in-flight set can touch
        self._gid_tables = np.full((max_active, self.n_row_pages), -1,
                                   np.int32)
        # device page tables, rebuilt only when a page re-slotted
        # (pools.slot_epoch) or the row mapping changed (_rows_epoch)
        self._rows_epoch = 0
        self._tables_key = None
        self._tables_dev = None

    # -- admission -----------------------------------------------------------
    def _pages_exact(self, req: Request) -> int:
        """Exact token pages the request's positions span."""
        return -(-req.total_len // self.page_size)

    def _pages_alloc(self, req: Request) -> int:
        """Bucket-rounded allocation size (power of two, capped at one
        row): what the request actually holds in the shared pool."""
        return bucket_pages(self._pages_exact(req), cap=self.n_row_pages)

    def submit(self, req: Request) -> None:
        req._t_submit = time.monotonic()
        if req.total_len > self.max_len:
            raise ValueError(f"request {req.rid} needs {req.total_len} "
                             f"positions, cache rows hold {self.max_len}")
        pools = self.monitor.pools
        if self._pages_alloc(req) > pools.n_logical:
            raise ValueError(f"request {req.rid} needs "
                             f"{self._pages_alloc(req)} pages, the logical "
                             f"space holds {pools.n_logical}")
        if self._pages_exact(req) > pools.hbm_pages:
            raise ValueError(f"request {req.rid} touches "
                             f"{self._pages_exact(req)} pages, the HBM slot "
                             f"pool holds {pools.hbm_pages}")
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
        """The request's logical page-table row: its own run, bucket tail
        included.  (The monitor merge reads the exact pages only, so
        bucket-tail slack never accrues mass.)"""
        row = np.full(self.n_row_pages, -1, np.int32)
        row[: req.n_alloc] = req.gids
        self._gid_tables[req.row] = row
        self._rows_epoch += 1

    def _tables_for(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device (slot table, gid table) for a decode launch, cached
        until a page re-slots or the row mapping changes."""
        pools = self.monitor.pools
        key = (pools.slot_epoch, self._rows_epoch)
        if self._tables_key != key:
            slots = np.full_like(self._gid_tables, -1)
            m = self._gid_tables >= 0
            slots[m] = pools.table(self._gid_tables[m])
            self._tables_dev = (
                torch.as_tensor(slots, device=self.device),
                torch.as_tensor(self._gid_tables, device=self.device))
            self._tables_key = key
        return self._tables_dev

    def _need(self, horizon: Dict[int, int]) -> np.ndarray:
        """Every page the next decode steps can touch: each active row's
        token pages through its ``horizon[row]`` steps (write pages
        included)."""
        need = [np.asarray(req.gids[: -(-(int(self.pos[row]) + horizon[row])
                                        // self.page_size)], np.int64)
                for row, req in self.active.items()]
        return np.concatenate(need) if need else np.asarray([], np.int64)

    def _prefill(self, batch: List[Request]) -> List[Tuple[int, int]]:
        """Prefill a step's joiners as one packed forward pass, write their
        pages into the pool, and sample each first token."""
        plens = [len(r.prompt) for r in batch]
        # pow2-bucket both packed dims (width and joiner count), as the
        # reference: right-padding is inert under causal attention and
        # dummy rows are never read
        smax = bucket_pages(max(plens))
        jp = bucket_pages(len(batch))
        toks = np.zeros((jp, smax), np.int64)
        plens_p = np.ones((jp,), np.int64)
        for i, r in enumerate(batch):
            toks[i, : plens[i]] = r.prompt
            plens_p[i] = plens[i]
        logits_b, cache_b = mdl.prefill_batched(
            self.params, self.cfg, torch.as_tensor(toks, device=self.device),
            torch.as_tensor(plens_p, device=self.device))
        self._write_prefill_pages(cache_b, batch, plens)
        first = mdl.sample(logits_b[: len(batch), 0],
                           [r.temperature for r in batch],
                           [r.seed for r in batch], [0] * len(batch))
        emitted: List[Tuple[int, int]] = []
        for req, tok, plen in zip(batch, first.tolist(), plens):
            req.tokens.append(tok)
            emitted.append((req.rid, tok))
            self.tok[req.row, 0] = tok
            self.pos[req.row] = plen
            self.active[req.row] = req
            if req.max_new_tokens <= 1 or tok == req.eos_id:
                self._retire(req)
        return emitted

    def _write_prefill_pages(self, cache_b, batch: List[Request],
                             plens: List[int]) -> None:
        """Scatter an admission's prefilled cache (every joiner, every
        layer, host + HBM tiers) into the pool.  Slots are assigned
        bookkeeping-only (initial placement, not charged as misses) since
        the scatter overwrites both tiers."""
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
        leaves = {name: [c[name] for seg in cache_b["segments"] for c in seg]
                  for name in ("k", "v")}
        write_pages_batched(pools.kv_layers, leaves, gids_m, slots_m)

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

    def _step_paged(self) -> List[Tuple[int, int]]:
        """One paged decode step: demand-fetch the in-flight working set,
        decode every row off the pool, feed the monitor, sample, retire."""
        pools = self.monitor.pools
        fetched = pools.ensure_resident(
            self._need({row: 1 for row in self.active}))
        tables, gid_tables = self._tables_for()
        cur = np.full((self.max_active,), -1, np.int64)
        for row in self.active:
            cur[row] = self.pos[row]
        logits, masses = mdl.decode_step_paged(
            self.params, self.cfg, pools.kv_layers, tables, gid_tables,
            self.tok, torch.as_tensor(cur, device=self.device),
            page_size=self.page_size)
        self.decode_steps += 1
        masses = masses.cpu().numpy()
        rows = list(self.active.items())
        merged = self.monitor.merge(
            [(r.gids[: r.n_pages], masses[row, : r.n_pages])
             for row, r in rows])
        self.monitor.on_step(merged, n_active=len(rows), fetched=fetched)

        temps = [0.0] * self.max_active
        seeds = [0] * self.max_active
        iters = [0] * self.max_active
        for row, req in rows:
            temps[row], seeds[row], iters[row] = (req.temperature, req.seed,
                                                  req._i + 1)
        new_tok = mdl.sample(logits[:, 0], temps, seeds, iters)
        toks = new_tok.tolist()
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
        the whole request set in one ``model.decode_macro_step``; the host
        hands over page tables once and reads back (tokens, summed mass,
        finished flags) once, then runs one merged monitor feed -- one
        tiering boundary and one tuner update per period."""
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
        cur = np.full((self.max_active,), -1, np.int64)
        seeds = [0] * self.max_active
        iters = [0] * self.max_active
        emitted_ct = [0] * self.max_active
        max_new = [0] * self.max_active
        eos = [-1] * self.max_active
        temps = [0.0] * self.max_active
        for row, req in rows:
            cur[row] = self.pos[row]
            seeds[row], iters[row] = req.seed, req._i
            emitted_ct[row] = len(req.tokens)
            max_new[row] = req.max_new_tokens
            eos[row] = -1 if req.eos_id is None else req.eos_id
            temps[row] = req.temperature

        self.macro_timer.start()
        toks, st = mdl.decode_macro_step(
            self.params, self.cfg, pools.kv_layers, tables, gid_tables,
            self.tok, torch.as_tensor(cur, device=self.device), seeds, iters,
            emitted_ct, max_new, eos, temps, n_steps=n_steps,
            page_size=self.page_size)
        toks_np = toks.cpu().numpy()
        mass_sum = st["mass_sum"].cpu().numpy()
        alive_steps = st["alive_steps"].cpu().numpy()
        stopped = st["stopped"].cpu().numpy()
        macro_wall = self.macro_timer.stop(self.step_idx)

        # one merge + monitor feed per movement period: the mean mass over
        # the steps each row ran keeps the per-step scale the access
        # threshold expects; dt = the macro's span in token-steps
        merged = self.monitor.merge(
            [(r.gids[: r.n_pages],
              mass_sum[row, : r.n_pages] / max(1, int(alive_steps[row])))
             for row, r in rows])
        self.decode_steps += int(alive_steps.max())
        dt = max(1, int(alive_steps.max()))
        n_active = float(alive_steps.sum()) / dt
        self.monitor.on_macro_step(merged, n_active=n_active, n_tokens=dt,
                                   fetched=fetched)

        self.pos = st["pos"].cpu().numpy()
        self.tok = st["last_tok"]
        emitted: List[Tuple[int, int]] = []
        for t in range(toks_np.shape[0]):
            for row, req in rows:
                tk = int(toks_np[t, row])
                if tk >= 0:
                    req.tokens.append(tk)
                    emitted.append((req.rid, tk))
        for row, req in rows:
            req._i = st["iters"][row]
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
