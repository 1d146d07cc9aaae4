"""The port's degradation ladder against the reference's
(``tests/test_faults.py``, test for test): the fault plan's schedule, the
pool ladder (retry, pin to host, rollback, pinned pages skipped) on both
packages' pools under one plan, and the model-free scheduler's TTL
shedding.  The batcher on the ladder (a chaos plan that fires every
fault kind, a squeeze that preempts and thaws, a worker crash with no
watchdog) is held in ``tests/test_torch_faults_batcher.py``."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core.cori import OnlineTuner as RTuner
from repro.core.traffic import RequestSpec as RSpec
from repro.ft import inject as RI
from repro.memtier.tiering import SharedPagedPools as RPools
from repro.memtier.tiering import TierConfig as RTierConfig
from repro.memtier.tiering import TieringManager as RManager
from repro.obs import telemetry as R_obs
from repro.serve import sched as RS

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
