"""The port's degradation ladder against the reference's
(``tests/test_faults.py``, test for test): the fault plan's schedule, the
pool ladder (retry, pin to host, rollback, pinned pages skipped) on both
packages' pools under one plan, the model-free scheduler's TTL shedding,
and the batcher under a chaos plan that fires every fault kind, a
squeeze that preempts and thaws (pipelined and synchronous), and a
worker crash with no watchdog.

Reduced gemma3-12b in float32 on weights bridged from the reference's.
Greedy streams are held to the reference batcher's under the same plan;
the port's sampled streams draw ``(seed, iteration)`` where the
reference draws from JAX keys, so they are held to the port's own
fault-free run.  ``worker.delay`` depends on the clock: its effect is
held by its outcome (a restart for a hang), not by when it lands."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

import repro.configs as RC
from repro.core.cori import OnlineTuner as RTuner
from repro.core.traffic import RequestSpec as RSpec
from repro.ft import inject as RI
from repro.memtier.tiering import SharedPagedPools as RPools
from repro.memtier.tiering import TierConfig as RTierConfig
from repro.memtier.tiering import TieringManager as RManager
from repro.models import model as RM
from repro.obs import telemetry as R_obs
from repro.serve import sched as RS

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.core.cori import OnlineTuner as TTuner
from repro_torch.core.traffic import RequestSpec as TSpec
from repro_torch.ft import inject as TI
from repro_torch.memtier.tiering import SharedPagedPools as TPools
from repro_torch.memtier.tiering import TierConfig as TTierConfig
from repro_torch.memtier.tiering import TieringManager as TManager
from repro_torch.obs import telemetry as T_obs
from repro_torch.serve import sched as TS

SIDES = {"ref": (RI, RPools, RManager, RTierConfig, RS, R_obs),
         "port": (TI, TPools, TManager, TTierConfig, TS, T_obs)}
N_LOGICAL, HBM, PAGE = 48, 16, 4


# ---------------------------------------------------------------------------
# FaultPlan: determinism, windows, the registry
# ---------------------------------------------------------------------------


def _schedule(I, seed, n=64):
    plan = I.FaultPlan([I.FaultPoint("pool.migrate_fail", prob=0.5)],
                       seed=seed)
    plan.tick()
    return [plan.fires("pool.migrate_fail") is not None for _ in range(n)]


def test_fault_plan_is_deterministic():
    a = _schedule(TI, 3)
    assert a == _schedule(TI, 3), "a seed replays its schedule"
    assert any(a) and not all(a)
    assert _schedule(TI, 4) != a, "the schedule is seed-keyed"
    for seed in (0, 3, 4, 7):
        assert _schedule(TI, seed) == _schedule(RI, seed), seed
    plan = TI.FaultPlan([TI.FaultPoint("pool.migrate_fail", prob=0.5)],
                        seed=3)
    plan.tick()
    hits = sum(plan.fires("pool.migrate_fail") is not None
               for _ in range(64))
    assert plan.fired["pool.migrate_fail"] == hits == sum(a)


def test_fault_plan_windows_and_registry():
    hits = {}
    for side, I in (("ref", RI), ("port", TI)):
        plan = I.FaultPlan([I.FaultPoint("pool.squeeze", start=2, stop=4,
                                         value=8)])
        hits[side] = []
        for _ in range(6):
            plan.tick()
            hits[side].append(plan.fires("pool.squeeze") is not None)
    assert hits["port"] == hits["ref"] == [False, True, True, False, False,
                                           False]
    with pytest.raises(ValueError, match="unknown fault kind"):
        TI.FaultPoint("bogus.kind")
    assert TI.FAULT_KINDS == RI.FAULT_KINDS
    assert not TI.NULL_PLAN.enabled
    assert all(TI.NULL_PLAN.fires(k) is None for k in TI.FAULT_KINDS)
    assert TI.NULL_PLAN.fired == {}


# ---------------------------------------------------------------------------
# the pool ladder, both packages under one plan
# ---------------------------------------------------------------------------


def _tiny_pools(side):
    Pools = SIDES[side][1]
    kw = dict(page_size=2, kv_heads=1, head_dim=2)
    if side == "port":
        kw["device"] = "cpu"
    return Pools.create(8, 4, **kw)


def _pool_state(pools):
    return dict(slot_of=pools.slot_of.tolist(),
                page_of_slot=pools.page_of_slot.tolist(),
                pinned=pools.host_pinned(np.arange(8)).tolist(),
                degraded=pools.degraded_fetches)


def test_migrate_retry_exhaustion_pins_to_host():
    """An always-failing transport spends the retries, the degraded copy
    still moves the bytes (the pages are resident and hold the host's
    rows), the pages pin to the host and the fetch is counted."""
    state, counters = {}, {}
    for side in ("ref", "port"):
        I, *_, obs = SIDES[side]
        rec = obs.install(obs.Recorder(enabled=True))
        try:
            pools = _tiny_pools(side)
            if side == "port":
                pools.k_host.copy_(torch.arange(pools.k_host.numel(),
                                                dtype=torch.float32)
                                   .reshape(pools.k_host.shape))
            else:
                pools.k_host = pools.k_host + np.arange(
                    pools.k_host.size, dtype=np.float32).reshape(
                        pools.k_host.shape)
            pools.migrate_retries = 1
            pools.retry_backoff_s = 0.0
            pools.fault_plan = I.FaultPlan([I.FaultPoint(
                "pool.migrate_fail")])
            gids = pools.alloc(2, owner=0)
            assert pools.ensure_resident(gids) == 2
            assert (pools.slot_of[gids] >= 0).all()
            assert pools.host_pinned(gids).all()
            assert pools.fault_plan.fired["pool.migrate_fail"] == 2
            k_hbm = np.asarray(pools.k_hbm)
            k_host = np.asarray(pools.k_host)
            for g in gids:
                np.testing.assert_array_equal(
                    k_hbm[pools.slot_of[g]], k_host[g])
            state[side] = _pool_state(pools)
            counters[side] = rec.summary()["counters"]
        finally:
            obs.install(obs.Recorder())
    assert state["port"] == state["ref"]
    assert state["port"]["degraded"] == 2
    for c in ("pool.degraded_fetches", "pool.fetch_misses"):
        assert counters["port"][c] == counters["ref"][c] == 2, c


def test_apply_plan_rolls_back_on_migration_failure():
    """A failed promotion batch restores the slot tables (prior residents
    keep their slots) and emits ``tier.move_failed``."""
    state, events = {}, {}
    for side in ("ref", "port"):
        I, _, Manager, TierConfig, _, obs = SIDES[side]
        rec = obs.install(obs.Recorder(enabled=True))
        try:
            pools = _tiny_pools(side)
            pools.alloc(4, owner=0)
            pools.ensure_resident(np.asarray([0, 1]))
            before = pools.slot_of.copy()
            epoch = pools.slot_epoch
            pools.fault_plan = I.FaultPlan([I.FaultPoint(
                "pool.migrate_fail")])
            mgr = Manager(8, TierConfig(page_size=2, hbm_pages=4,
                                        period_steps=1))
            mgr.apply_plan(pools, bring=np.asarray([2, 3]),
                           evict=np.asarray([], np.int64))
            np.testing.assert_array_equal(pools.slot_of, before)
            assert pools.hbm_occupied == 2
            assert pools.slot_epoch > epoch, "the table cache must rebuild"
            assert rec.summary()["counters"]["tier.moves_failed"] == 1
            events[side] = [{k: e[k] for k in ("pages", "attempts",
                                               "detail")}
                            for e in rec.events("tier.move_failed")]
            state[side] = _pool_state(pools)
        finally:
            obs.install(obs.Recorder())
    assert state["port"] == state["ref"]
    assert events["port"] == events["ref"] and events["port"][0]["pages"] \
        == 2


def test_apply_plan_skips_host_pinned_pages():
    state = {}
    for side in ("ref", "port"):
        I, _, Manager, TierConfig, *_ = SIDES[side]
        pools = _tiny_pools(side)
        pools.migrate_retries = 0
        pools.retry_backoff_s = 0.0
        pools.alloc(4, owner=0)
        pools.fault_plan = I.FaultPlan([I.FaultPoint("pool.migrate_fail")])
        pools.ensure_resident(np.asarray([0]))          # pins page 0
        pools.fault_plan = I.NULL_PLAN
        assert pools.host_pinned(np.asarray([0, 1])).tolist() == [True,
                                                                  False]
        pools.demote(np.asarray([0]))
        mgr = Manager(8, TierConfig(page_size=2, hbm_pages=4,
                                    period_steps=1))
        mgr.apply_plan(pools, bring=np.asarray([0, 1]),
                       evict=np.asarray([], np.int64))
        assert pools.slot_of[0] < 0, "pinned pages sit out the promotion"
        assert pools.slot_of[1] >= 0
        state[side] = _pool_state(pools)
    assert state["port"] == state["ref"]


def test_squeeze_clamps_placement_and_the_tier_budget():
    """Under a squeezed ``effective_hbm`` placement evicts before it
    fills a free slot, overflows only when every resident is protected,
    and ``maybe_tier`` / ``apply_plan`` promote no further than the
    squeezed capacity: both packages alike."""
    state = {}
    for side in ("ref", "port"):
        _, _, Manager, TierConfig, *_ = SIDES[side]
        pools = _tiny_pools(side)
        pools.alloc(8, owner=0)
        pools.effective_hbm = 2
        pools.ensure_resident(np.asarray([0, 1]))
        pools.ensure_resident(np.asarray([2]))          # evicts, no fill
        assert pools.hbm_occupied == 2
        pools.ensure_resident(np.asarray([3, 4, 5]))    # all protected
        occupied = pools.hbm_occupied
        mgr = Manager(8, TierConfig(page_size=2, hbm_pages=4,
                                    period_steps=1))
        mgr.on_step(np.ones(8, np.float32), pools.slot_of >= 0)
        mgr.maybe_tier(pools, active=pools.allocated_mask, force=True)
        state[side] = dict(_pool_state(pools), occupied=occupied,
                           after=pools.hbm_occupied,
                           migrations=mgr.migrations)
    assert state["port"] == state["ref"]
    assert state["port"]["occupied"] == 3


def test_degraded_fetches_are_charged_at_the_miss_penalty():
    """The monitor tops a degraded fetch up from ``fetch_cost`` to
    ``miss_penalty`` inside the tuner's window, on every feed."""
    got = {}
    for side in ("ref", "port"):
        _, Pools, Manager, TierConfig, S, _ = SIDES[side]
        tuner = (RTuner if side == "ref" else TTuner)(16, default_period=2)
        mon = S.TrafficMonitor(Pools.create(16, 8), Manager(
            16, TierConfig(page_size=4, hbm_pages=8, period_steps=2)),
            tuner)
        mass = np.linspace(0, 0.2, 16).astype(np.float32)
        mon.on_step(mass, n_active=2, fetched=3, degraded=2)
        mon.on_macro_step(mass, n_active=2, n_tokens=4, fetched=1,
                          degraded=1)
        period, plan = mon.plan_step(
            mass, 2, n_tokens=4, fetched=2, degraded=2,
            resident=mon.pools.slot_of >= 0, n_free=8,
            active=np.ones(16, bool))
        got[side] = (mon.manager.modeled_time, mon.manager.misses,
                     list(tuner.cost_log), period,
                     None if plan is None else [p.tolist() for p in plan])
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# the model-free scheduler's TTL
# ---------------------------------------------------------------------------


def test_traffic_scheduler_sheds_expired_queue():
    got = {}
    for side in ("ref", "port"):
        _, Pools, Manager, TierConfig, S, _ = SIDES[side]
        Spec = RSpec if side == "ref" else TSpec
        mgr = Manager(64, TierConfig(page_size=16, hbm_pages=16,
                                     period_steps=4))
        sched = S.TrafficScheduler(
            [Spec(i, 0, 17, 30, "sink", i) for i in range(6)],
            S.TrafficMonitor(Pools.create(64, 16), mgr), page_size=16,
            max_active=2, ttl_steps=5)
        sched.run(steps=400)
        got[side] = (sched.shed, sched.completed, sched.rejected,
                     mgr.migrations, mgr.hits, mgr.misses)
    assert got["port"] == got["ref"]
    shed, completed, rejected = got["port"][:3]
    assert shed > 0 and completed + shed == 6 and rejected == shed


# ---------------------------------------------------------------------------
# the batcher: chaos matrix, preemption, watchdog
# ---------------------------------------------------------------------------

_MODELS = {}


def _models():
    if not _MODELS:
        rcfg = dataclasses.replace(RC.reduced("gemma3-12b"),
                                   dtype="float32")
        tcfg = dataclasses.replace(TC.reduced("gemma3-12b"),
                                   dtype="float32")
        rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
        tp = bridge.from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                   device="cpu")
        _MODELS.update(rcfg=rcfg, rp=rp, tcfg=tcfg, tp=tp)
    return _MODELS


def _submissions(vocab, *, sacrificial=False, greedy=False):
    """(arrival step, request fields), as the reference test's: rids 1
    and 3 sampled unless ``greedy``; with ``sacrificial``, rid 100 (ttl 1)
    floods past the queue bound at step 0 and expires queued, rids 101 /
    102 arrive at step 4 with the queue over its bound and are shed."""
    rng = np.random.default_rng(0)
    plens, steps = (6, 9, 5, 8), (12, 10, 14, 12)
    subs = [(0, dict(rid=i, max_new_tokens=steps[i],
                     prompt=rng.integers(0, vocab, size=plens[i])
                     .astype(np.int32),
                     temperature=0.0 if greedy or i % 2 == 0 else 0.7,
                     seed=10 + i))
            for i in range(4)]
    if sacrificial:
        for rid, at, ttl in ((100, 0, 1), (101, 4, None), (102, 4, None)):
            subs.append((at, dict(
                rid=rid, max_new_tokens=4, ttl_steps=ttl,
                prompt=rng.integers(0, vocab, size=5).astype(np.int32),
                temperature=0.0, seed=10 + rid)))
    return subs


def _stack(side):
    _, Pools, Manager, TierConfig, S, _ = SIDES[side]
    kw = dict(page_size=PAGE, kv_heads=_models()["tcfg"].num_kv_heads,
              head_dim=_models()["tcfg"].head_dim)
    if side == "port":
        kw["device"] = "cpu"
    tune = dict(default_period=2, profile_steps=8, trial_steps=4)
    return S.TrafficMonitor(
        Pools.create(N_LOGICAL, HBM, **kw),
        Manager(N_LOGICAL, TierConfig(page_size=PAGE, hbm_pages=HBM,
                                      period_steps=2)),
        (RTuner if side == "ref" else TTuner)(N_LOGICAL, **tune))


def _request(side, kw):
    if side == "ref":
        kw = dict(kw)
        kw["key"] = jax.random.PRNGKey(kw.pop("seed"))
        return RS.Request(**kw)
    return TS.Request(**kw)


def _drive(side, subs, *, plan=None, baseline=False, pipeline=True,
           on_batcher=None, max_steps=200, **kw):
    """One batcher (two rows, pages of 4, pools of 48 / 16) over the
    submissions until drained, with a flight recorder.  ``baseline``
    strips the TTLs.  Returns (batcher, monitor, recorder)."""
    m = _models()
    S, obs = SIDES[side][4], SIDES[side][5]
    mon = _stack(side)
    args = dict(max_active=2, max_len=32, page_size=PAGE, monitor=mon,
                pipeline=pipeline, fault_plan=plan, **kw)
    if side == "ref":
        b = RS.ContinuousBatcher(m["rp"], m["rcfg"], **args)
    else:
        b = TS.ContinuousBatcher(m["tp"], m["tcfg"], device="cpu", **args)
    if on_batcher is not None:
        on_batcher(b)
    last = max(at for at, _ in subs)
    rec = obs.install(obs.Recorder(enabled=True))
    try:
        for t in range(max_steps):
            for at, req in subs:
                if at == t:
                    if baseline:
                        req = {k: v for k, v in req.items()
                               if k != "ttl_steps"}
                    b.submit(_request(side, req))
            b.step()
            if t >= last and b.idle:
                break
        assert b.idle, "no hang: the batcher drains under faults"
        assert mon.pools.free_pages == N_LOGICAL, "every page comes back"
    finally:
        b.close()
        obs.install(obs.Recorder())
    return b, mon, rec


def _streams(b):
    return {r.rid: list(r.tokens) for r in b.completed}


def _baseline():
    """The port's fault-free pipelined run of every submission
    (sacrificial rids included, TTLs stripped)."""
    b, _, _ = _drive("port", _submissions(_models()["tcfg"].vocab_size,
                                          sacrificial=True), baseline=True)
    streams = _streams(b)
    assert len(streams) == 7 and all(streams.values())
    return streams


def _chaos_plan(I):
    """The reference test's plan, the worker's delay 4 x the watchdog's
    0.1 s (a decision takes milliseconds here, so only the delay trips
    it, also on a loaded host)."""
    return I.FaultPlan([
        I.FaultPoint("pool.squeeze", start=4, stop=8, value=8),
        I.FaultPoint("pool.migrate_fail", start=2, stop=20, prob=0.4),
        I.FaultPoint("pool.migrate_slow", start=2, stop=20, prob=0.3,
                     value=0.002),
        I.FaultPoint("worker.delay", start=3, stop=6, prob=1.0, value=0.4),
        I.FaultPoint("worker.crash", start=8, stop=10, prob=1.0),
        I.FaultPoint("mass.nonfinite", start=2, stop=30, prob=0.5),
        I.FaultPoint("admit.flood", start=0, stop=2, prob=1.0),
    ], seed=7)


def _squeeze_plan(I):
    return I.FaultPlan([I.FaultPoint("pool.squeeze", start=4, stop=10,
                                     value=8)], seed=0)


def _checked_preempt(b):
    """Hold ``tokens[-1] == tok[row, 0]`` at every preemption: the row's
    next input is the last token it emitted, so the boundary reads
    nothing back."""
    seen = []
    preempt = b._preempt

    def checked(req):
        assert req._first_tok is None
        assert req.tokens[-1] == int(b.tok[req.row, 0]), req.rid
        seen.append(req.rid)
        preempt(req)
    b._preempt = checked
    b.checked_preemptions = seen


def test_chaos_matrix_no_hang_typed_statuses_token_parity():
    """Every fault kind fires; the run drains; every submission ends with
    the reference's typed status under the same plan; greedy streams
    equal the reference batcher's, sampled ones the port's fault-free
    run; the watchdog restarts for a hang and a crash and then decides
    in line for good."""
    vocab = _models()["tcfg"].vocab_size
    runs = {}
    for side in ("ref", "port"):
        runs[side] = _drive(
            side, _submissions(vocab, sacrificial=True),
            plan=_chaos_plan(SIDES[side][0]), max_queue=1, watchdog_s=0.1,
            max_worker_restarts=3,
            on_batcher=_checked_preempt if side == "port" else None)
    (rb, _, rrec), (tb, tmon, trec) = runs["ref"], runs["port"]
    assert set(tb.fault_plan.fired) == set(TI.FAULT_KINDS), \
        tb.fault_plan.fired
    statuses = {r.rid: r.status for r in tb.completed}
    assert statuses == {r.rid: r.status for r in rb.completed}
    assert set(statuses) == {0, 1, 2, 3, 100, 101, 102}
    assert all(statuses[i] == "completed" for i in range(4))
    assert (tb.shed, tb.expired) == (rb.shed, rb.expired)
    assert tb.shed >= 1 and tb.expired >= 1
    base, ref = _baseline(), _streams(rb)
    for r in tb.completed:
        if r.status != "completed":
            assert not r.tokens
        elif r.temperature == 0:
            assert r.tokens == ref[r.rid] == base[r.rid], r.rid
        else:
            assert r.tokens == base[r.rid], r.rid
    reasons = {e["reason"] for e in trec.events("serve.worker_restart")}
    assert {"hang", "crash"} <= reasons, reasons
    assert tb._worker_restarts > tb.max_worker_restarts
    assert tb._worker_degraded and tb._decision_worker is None
    counters = trec.summary()["counters"]
    assert counters["serve.worker_restarts"] == tb._worker_restarts
    assert counters["serve.shed_total"] == tb.shed + tb.expired
    assert tb.preemptions >= 1, "a sampled stream resumes across a freeze"
    assert tb.preemptions == len(tb.checked_preemptions)
    assert np.isfinite(tmon.tuner.cost_log).all(), \
        "the corrupted masses are clamped before the tuner"


@pytest.mark.parametrize("pipeline", [True, False])
def test_preempt_then_reactivate_is_bit_identical(pipeline):
    """A squeeze preempts the coldest row (its slots dropped, its row
    freed) and thaws it when the window closes, with no second prefill:
    on the pipelined and on the synchronous loop, the ``serve.preempt``
    events (rid, pages, need, capacity), the streams and the tiering
    counts are the reference's under the same plan (greedy requests: the
    masses, and so the victims, follow the tokens), and the streams are
    the port's fault-free run's."""
    vocab = _models()["tcfg"].vocab_size
    subs = _submissions(vocab, greedy=True)
    free, _, _ = _drive("port", subs, pipeline=pipeline)
    runs = {side: _drive(side, subs,
                         plan=_squeeze_plan(SIDES[side][0]),
                         pipeline=pipeline,
                         on_batcher=(_checked_preempt if side == "port"
                                     else None))
            for side in ("ref", "port")}
    (rb, rmon, rrec), (tb, tmon, trec) = runs["ref"], runs["port"]
    assert tb.preemptions >= 1, "the squeeze must force a preemption"
    assert tb.preemptions == rb.preemptions == len(tb.checked_preemptions)
    key = lambda rec: [{k: e[k] for k in ("step", "rid", "pages",
                                          "hbm_need", "hbm_cap")}
                       for e in rec.events("serve.preempt")]
    assert key(trec) == key(rrec)
    assert all(e["hbm_cap"] == 8 for e in key(trec))
    counters = trec.summary()["counters"]
    assert counters["serve.preempted"] == tb.preemptions
    assert counters["serve.thawed"] == tb.preemptions, "every one thaws"
    assert counters["serve.admitted"] == 4, "a thaw is never a prefill"
    assert _streams(tb) == _streams(rb) == _streams(free)
    for attr in ("migrations", "hits", "misses"):
        assert getattr(tmon.manager, attr) == getattr(rmon.manager, attr), \
            attr


def test_table_cache_moves_on_preempt_and_thaw():
    """The device tables' cache key (slot epoch, row epoch) moves on
    every preemption and every thaw, so no stale table reaches a
    launch."""
    keys = []

    def watch(b):
        for name in ("_preempt", "_thaw"):
            fn = getattr(b, name)

            def wrapped(req, fn=fn):
                pools = b.monitor.pools
                before = (pools.slot_epoch, b._rows_epoch)
                fn(req)
                keys.append(before != (pools.slot_epoch, b._rows_epoch))
            setattr(b, name, wrapped)
    b, _, _ = _drive("port", _submissions(_models()["tcfg"].vocab_size),
                     plan=_squeeze_plan(TI), on_batcher=watch)
    assert len(keys) == 2 * b.preemptions >= 2 and all(keys)


def test_worker_crash_without_watchdog_fails_loud_and_closes_clean():
    m = _models()
    plan = TI.FaultPlan([TI.FaultPoint("worker.crash", start=1)])
    b = TS.ContinuousBatcher(m["tp"], m["tcfg"], max_active=2, max_len=32,
                             page_size=PAGE, monitor=_stack("port"),
                             pipeline=True, fault_plan=plan, device="cpu")
    rng = np.random.default_rng(2)
    b.submit(TS.Request(rid=0, max_new_tokens=12,
                        prompt=rng.integers(0, m["tcfg"].vocab_size,
                                            size=6).astype(np.int32)))
    with pytest.raises(RuntimeError, match="injected decision-worker"):
        for _ in range(50):
            b.step()
    b.close()                  # mid-macro, after the error: clean
    assert b._decision_worker is None
    b.close()


def test_bounded_queue_sheds_and_ttl_expires_without_a_plan():
    """No plan: the bound sheds the submissions past it and a queued
    request's TTL expires it; the admitted ones run to completion."""
    m = _models()
    b = TS.ContinuousBatcher(m["tp"], m["tcfg"], max_active=1, max_len=32,
                             page_size=PAGE, monitor=_stack("port"),
                             max_queue=2, device="cpu")
    rng = np.random.default_rng(3)
    for rid, ttl in ((0, None), (1, 1), (2, None), (3, None)):
        b.submit(TS.Request(rid=rid, max_new_tokens=12 if rid == 0 else 3,
                            ttl_steps=ttl,
                            prompt=rng.integers(0, m["tcfg"].vocab_size,
                                                size=4).astype(np.int32)))
    b.run(max_steps=50)
    statuses = {r.rid: r.status for r in b.completed}
    assert statuses == {0: "completed", 1: "expired", 2: "shed",
                        3: "shed"}
    assert (b.shed, b.expired) == (2, 1)
    assert [len(r.tokens) for r in b.completed
            if r.status == "completed"] == [12]
