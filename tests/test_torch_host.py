"""Host-side parity of the torch port against the JAX reference: the Cori
tuner and reuse collector, the tiering manager, the shared page pools and
the traffic monitor, fed identical input streams, must make identical
decisions.  Also pins that the port never imports JAX or the reference.

JAX stays on the CPU; inputs are numpy arrays made from fixed seeds."""
import ast
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core.cori import OnlineTuner as RTuner
from repro.core.reuse import StreamingReuseCollector as RCollector
from repro.memtier import online_replay as r_online_replay
from repro.memtier.tiering import SharedPagedPools as RPools
from repro.memtier.tiering import TierConfig as RTierConfig
from repro.memtier.tiering import TieringManager as RManager
from repro.memtier.tiering import bucket_pages as r_bucket
from repro.serve.sched import TrafficMonitor as RMonitor

from repro_torch.core.cori import OnlineTuner as TTuner
from repro_torch.core.reuse import StreamingReuseCollector as TCollector
from repro_torch.memtier import online_replay as t_online_replay
from repro_torch.memtier.tiering import SharedPagedPools as TPools
from repro_torch.memtier.tiering import TierConfig as TTierConfig
from repro_torch.memtier.tiering import TieringManager as TManager
from repro_torch.memtier.tiering import bucket_pages as t_bucket
from repro_torch.serve.sched import TrafficMonitor as TMonitor

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _mass_stream(seed, steps, n, phase_every=40):
    """Phase-shifting page masses: a hot window that jumps every
    ``phase_every`` steps plus sparse random touches."""
    rng = np.random.default_rng(seed)
    out = np.zeros((steps, n), np.float32)
    for t in range(steps):
        lo = (t // phase_every * 7) % max(1, n - 6)
        out[t, lo: lo + 6] = rng.uniform(0.05, 0.3, 6)
        out[t, rng.integers(0, n, 3)] += rng.uniform(0.0, 0.2, 3)
    return out


@pytest.mark.parametrize("seed,dt", [(0, 1), (1, 1), (2, 4)])
def test_online_tuner_transitions_identical(seed, dt):
    """Same (mass, cost) stream -> same states, periods and history."""
    n = 48
    masses = _mass_stream(seed, 300, n)
    costs = np.random.default_rng(seed + 10).uniform(1.0, 5.0, 300)
    kw = dict(default_period=4, profile_steps=16, trial_steps=8)
    rt, tt = RTuner(n, **kw), TTuner(n, **kw)
    for t in range(300):
        # cost depends on the period in force, closing the loop
        c = costs[t] * (1.0 + 0.1 * rt.period)
        p_ref = rt.on_step(masses[t], cost=c, dt=dt)
        p_port = tt.on_step(masses[t], cost=c, dt=dt)
        assert p_ref == p_port and rt.state == tt.state, t
    assert rt.history == tt.history
    assert rt.tried == tt.tried
    assert rt.retunes == tt.retunes
    assert list(rt.cost_log) == list(tt.cost_log)


def test_reuse_collector_identical():
    n = 32
    masses = _mass_stream(3, 200, n, phase_every=25)
    rc = RCollector(n, window=64, bin_width=1)
    tc = TCollector(n, window=64, bin_width=1)
    for t in range(200):
        rc.observe_mass(masses[t], 0.05, dt=1 + t % 3)
        tc.observe_mass(masses[t], 0.05, dt=1 + t % 3)
        if t % 50 == 49:
            ids = np.arange(t % n, t % n + 4) % n
            rc.forget(ids)
            tc.forget(ids)
    hr, ht = rc.histogram(), tc.histogram()
    np.testing.assert_array_equal(hr.values, ht.values)
    np.testing.assert_array_equal(hr.counts, ht.counts)
    np.testing.assert_array_equal(rc.last_access, tc.last_access)


def test_online_replay_identical():
    masses = _mass_stream(4, 240, 64)
    cfg_r = RTierConfig(hbm_pages=16, period_steps=8)
    cfg_t = TTierConfig(hbm_pages=16, period_steps=8)
    mr, tr = r_online_replay(masses, cfg_r)
    mt, tt = t_online_replay(masses, cfg_t)
    assert (mr.migrations, mr.hits, mr.misses) == \
        (mt.migrations, mt.hits, mt.misses)
    assert mr.modeled_time == mt.modeled_time
    assert tr.history == tt.history and tr.period == tt.period


def test_bucket_pages_identical():
    for n in range(1, 49):
        assert r_bucket(n) == t_bucket(n)
        assert r_bucket(n, cap=48) == t_bucket(n, cap=48)
    with pytest.raises(ValueError):
        t_bucket(49, cap=48)


def _run_pools(side, macro: bool):
    """Drive pools + manager + tuner + monitor through a scripted serving
    stream (allocations, demand fetches, merged masses, retirements) and
    record every decision.  ``side`` picks the package."""
    n_logical, hbm, page, kvh, hd = 32, 12, 4, 2, 8
    specs = [(2, {"k": (page, kvh, hd), "v": (page, kvh, hd)})]
    if side == "ref":
        import jax.numpy as jnp
        pools = RPools.create(n_logical, hbm)
        pools.attach_layered(specs, dtype=jnp.float32)
        mgr = RManager(n_logical, RTierConfig(page_size=page, hbm_pages=hbm,
                                              period_steps=3))
        mon = RMonitor(pools, mgr, RTuner(n_logical, default_period=3,
                                          profile_steps=6, trial_steps=4))
    else:
        pools = TPools.create(n_logical, hbm)
        pools.attach_layered(specs, dtype=torch.float32, device="cpu")
        mgr = TManager(n_logical, TTierConfig(page_size=page, hbm_pages=hbm,
                                              period_steps=3))
        mon = TMonitor(pools, mgr, TTuner(n_logical, default_period=3,
                                          profile_steps=6, trial_steps=4))
    # identical host-tier bytes on both sides, so migrations are checkable
    host = np.random.default_rng(9).standard_normal(
        (2, n_logical, page, kvh, hd)).astype(np.float32)
    if side == "ref":
        import jax.numpy as jnp
        kv = pools.kv_view()
        kv["k_host"][0] = jnp.asarray(host)
        kv["v_host"][0] = jnp.asarray(-host)
        pools.set_kv(kv)
    else:
        pools.kv_layers["k_host"][0].copy_(torch.from_numpy(host))
        pools.kv_layers["v_host"][0].copy_(torch.from_numpy(-host))

    rng = np.random.default_rng(5)
    owned = {}
    hist = []
    next_rid = 0
    for t in range(60):
        if len(owned) < 3 and t % 4 == 0:
            gids = pools.alloc(int(rng.integers(2, 7)), next_rid)
            if gids is not None:
                owned[next_rid] = gids
                next_rid += 1
        if owned:
            need = np.concatenate([g[: max(1, len(g) - 1)]
                                   for g in owned.values()])
            fetched = pools.ensure_resident(need[:hbm])
            contrib = [(g, rng.uniform(0, 0.4, len(g)).astype(np.float32))
                       for g in owned.values()]
            merged = mon.merge(contrib)
            if macro:
                period = mon.on_macro_step(merged, n_active=len(owned),
                                           n_tokens=1 + t % 4,
                                           fetched=fetched)
            else:
                period = mon.on_step(merged, n_active=len(owned),
                                     fetched=fetched)
            hist.append((period, fetched))
        if t % 9 == 8 and owned:
            rid = min(owned)
            mon.release(owned.pop(rid))
        if t % 13 == 12 and owned:      # preemption-style slot release
            hist.append((pools.demote(owned[max(owned)]),))
        hist.append((pools.slot_of.copy(), pools.page_of_slot.copy()))
    k_hbm = np.asarray(pools.kv_layers["k_hbm"][0])
    v_hbm = np.asarray(pools.kv_layers["v_hbm"][0])
    stats = (mgr.migrations, mgr.hits, mgr.misses, mgr.modeled_time,
             mgr.data_moved_pages, tuple(mon.tuner.history))
    return hist, stats, pools.page_of_slot.copy(), k_hbm, v_hbm


@pytest.mark.parametrize("macro", [False, True])
def test_pools_manager_monitor_histories_identical(macro):
    """Same allocations, fetches and merged masses -> identical slot
    tables after every step, identical cost ledger and tuner history, and
    identical HBM bytes for every resident page."""
    ref, port = _run_pools("ref", macro), _run_pools("port", macro)
    assert len(ref[0]) == len(port[0])
    for a, b in zip(ref[0], port[0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert ref[1] == port[1]
    resident = ref[2] >= 0
    assert resident.any()
    np.testing.assert_array_equal(ref[3][:, resident], port[3][:, resident])
    np.testing.assert_array_equal(ref[4][:, resident], port[4][:, resident])


def test_event_registry_identical():
    """scripts/check_events.py reads the reference registry for every
    emit under src/, the port's included: the copies must agree."""
    from repro.obs.events import EVENTS as R
    from repro_torch.obs.events import EVENTS as T
    assert {k: tuple(v) for k, v in R.items()} == \
        {k: tuple(v) for k, v in T.items()}


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        bad = {m for m in _imports(f)} & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
