"""The port's pipelined macro loop against the JAX reference: the models,
the drive loop and the checks its files share, and the loop's parts.

  * ``serve.pipeline.DecisionWorker`` under the reference's hand-off
    tests (ordered generations, exceptions published to ``wait``, close
    and timeout, a stress-hammered fake dispatch thread);
  * ``TrafficMonitor.plan_step`` + ``apply_decision`` equal to the
    reference's on one seeded stream of masses and snapshots (period,
    plan, modeled time, misses, ``slot_of``), and equal to the port's own
    ``on_macro_step``;
  * the pipelined batcher's argument checks.

The pipelined ``ContinuousBatcher`` against the reference's pipelined
batcher is held in ``tests/test_torch_pipelined_serve.py`` and
``tests/test_torch_pipelined_serve_more.py``, ``model.prefill_chunk`` in
``tests/test_torch_pipelined_chunk*.py``, and the recurrent and prefix
configs in ``tests/test_torch_pipelined_state.py`` and
``tests/test_torch_pipelined_squeeze.py``.

float32 on the CPU (the kernels' plain versions).  Tolerances: 1e-4
absolute on logits and 1e-5 on caches (the bars of
``tests/test_torch_geometry.py``), with a float32 relative term of 4e-6
on values above 1: the two frameworks sum in other orders, and the
order differs between CPUs."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

import repro.configs as RC
from repro.core.cori import OnlineTuner as RTuner
from repro.memtier.tiering import SharedPagedPools as RPools
from repro.memtier.tiering import TierConfig as RTierConfig
from repro.memtier.tiering import TieringManager as RManager
from repro.models import model as RM
from repro.serve import sched as RS

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.core.cori import OnlineTuner as TTuner
from repro_torch.memtier.tiering import SharedPagedPools as TPools
from repro_torch.memtier.tiering import TierConfig as TTierConfig
from repro_torch.memtier.tiering import TieringManager as TManager
from repro_torch.serve import sched as TS
from repro_torch.serve.pipeline import DecisionWorker

LOGIT_TOL, TOL = 1e-4, 1e-5
# float32 relative term: two frameworks' summation orders on different CPUs
F32_RTOL = 4e-6
CHUNK_ARCHS = ["qwen3-14b", "gemma3-12b", "deepseek-v3-671b",
               "olmoe-1b-7b", "musicgen-large", "nemotron-4-340b",
               "stablelm-12b"]
SERVED = ["gemma3-12b", "qwen3-14b", "deepseek-v3-671b", "musicgen-large"]
# the registered configs whose head dims are no power of two
FULL_HEAD_DIMS = [("stablelm-12b", 160), ("nemotron-4-340b", 192)]
# qwen3 as tests/test_torch_serve.py serves it: GQA 4/2, two layers
QWEN_KW = dict(num_kv_heads=2, segments=((("attn",), 2),))
N_LOGICAL, HBM, PAGE = 48, 16, 4
PROMPT_LENS = (6, 9, 5, 14)        # 14 > every chunk width: chunked
NEW = (6, 4, 7, 5)
ARRIVAL = (0, 0, 2, 2)             # two join mid-flight, into used rows

_CACHE = {}


def _models(arch, head_dim=None):
    """Bridged weights of reduced ``arch`` (``head_dim``: the registered
    config's own head dim in place of the reduced 16)."""
    key = (arch, head_dim)
    if key not in _CACHE:
        kw = dict(QWEN_KW) if arch == "qwen3-14b" else {}
        if head_dim is not None:
            kw["head_dim"] = head_dim
        rcfg = dataclasses.replace(RC.reduced(arch), dtype="float32", **kw)
        tcfg = dataclasses.replace(TC.reduced(arch), dtype="float32", **kw)
        rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
        tp = bridge.from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                   device="cpu")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32)
                   for n in PROMPT_LENS]
        cond = None
        if rcfg.cond_len:
            cond = rng.standard_normal(
                (1, rcfg.cond_len, rcfg.cond_dim or rcfg.d_model)) \
                .astype(np.float32)
        _CACHE[key] = dict(rcfg=rcfg, rp=rp, tcfg=tcfg, tp=tp,
                           prompts=prompts, cond=cond)
    return _CACHE[key]


def _close(t, r, atol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(r), atol=atol,
                               rtol=F32_RTOL)


# ---------------------------------------------------------------------------
# DecisionWorker: the hand-off protocol, without a model
# ---------------------------------------------------------------------------


def test_decision_worker_orders_generations():
    with DecisionWorker(lambda p: p * 2) as w:
        gens = [w.submit(i) for i in range(8)]
        assert gens == list(range(8)), "generations number submissions"
        # out-of-order waits resolve: results are keyed, not streamed
        for g in reversed(gens):
            result, waited = w.wait(g)
            assert result == g * 2
            assert waited >= 0.0
        assert w.alive and w.pulse.age() < 60.0


def test_decision_worker_propagates_exceptions():
    def fn(p):
        if p == "boom":
            raise ValueError("boom payload")
        return p

    with DecisionWorker(fn) as w:
        ok = w.submit("fine")
        bad = w.submit("boom")
        assert w.wait(ok)[0] == "fine"
        with pytest.raises(ValueError, match="boom payload"):
            w.wait(bad)
        # the worker survives a failed generation
        again = w.submit("fine")
        assert w.wait(again)[0] == "fine"


def test_decision_worker_close_and_timeout():
    w = DecisionWorker(lambda p: p)
    g = w.submit(1)
    assert w.wait(g)[0] == 1
    with pytest.raises(TimeoutError):
        w.wait(g + 1, timeout=0.01)   # never submitted
    w.close()
    assert not w.alive
    with pytest.raises(RuntimeError):
        w.submit(2)
    w.close()                          # idempotent
    z = DecisionWorker(lambda p: p)
    z.abandon()                        # walks away without a join
    with pytest.raises(RuntimeError):
        z.submit(1)


def test_decision_worker_handoff_stress():
    """Strict alternation (submit -> wait, the pipelined loop's shape),
    then a burst of generations in flight, from four fake dispatch
    threads at once: every result matches its payload."""
    def fn(p):
        time.sleep((p % 3) * 1e-4)
        return ("done", p)

    failures = []

    def dispatch(n):
        try:
            with DecisionWorker(fn) as w:
                for i in range(n):
                    g = w.submit(i)
                    result, _ = w.wait(g, timeout=10.0)
                    assert result == ("done", i), result
                gens = [w.submit(100 + i) for i in range(16)]
                for i, g in enumerate(gens):
                    result, _ = w.wait(g, timeout=10.0)
                    assert result == ("done", 100 + i), result
        except BaseException as e:      # surface into the test thread
            failures.append(e)

    threads = [threading.Thread(target=dispatch, args=(50,))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not failures, failures


# ---------------------------------------------------------------------------
# TrafficMonitor: the worker half and the dispatch half
# ---------------------------------------------------------------------------


def _mini(side):
    tier = dict(page_size=16, hbm_pages=8, period_steps=4)
    tune = dict(default_period=4, profile_steps=6, trial_steps=3)
    if side == "ref":
        return RS.TrafficMonitor(RPools.create(16, 8),
                                 RManager(16, RTierConfig(**tier)),
                                 RTuner(16, **tune))
    return TS.TrafficMonitor(TPools.create(16, 8),
                             TManager(16, TTierConfig(**tier)),
                             TTuner(16, **tune))


def _snapshot(pools):
    return dict(resident=pools.slot_of >= 0,
                n_free=int((pools.page_of_slot < 0).sum()),
                active=pools.allocated_mask, planes=2)


def test_plan_step_and_apply_decision_match_reference():
    """One seeded stream of masses (some NaN, clamped), fetch counts and
    allocations through both packages' ``plan_step`` + ``apply_decision``:
    the same period, plan, modeled time, misses and ``slot_of`` at every
    boundary, through the tuner's profile and trials."""
    rng = np.random.default_rng(0)
    ref, port = _mini("ref"), _mini("port")
    for mon in (ref, port):
        mon.pools.alloc(10, 1)
    for step in range(24):
        mass = rng.random(16).astype(np.float32) ** 3
        if step % 7 == 3:
            mass[2] = np.nan
        fetched = int(rng.integers(0, 4))
        out = [mon.plan_step(mass, n_active=2.0, n_tokens=4,
                             fetched=fetched, **_snapshot(mon.pools))
               for mon in (ref, port)]
        (rp, rplan), (tp, tplan) = out
        assert tp == rp
        assert (tplan is None) == (rplan is None)
        if rplan is not None:
            for a, b in zip(tplan, rplan):
                np.testing.assert_array_equal(a, b)
        for mon, plan in ((ref, rplan), (port, tplan)):
            mon.apply_decision(plan)
        assert port.manager.modeled_time == ref.manager.modeled_time
        assert port.manager.misses == ref.manager.misses
        assert port.manager.migrations == ref.manager.migrations
        np.testing.assert_array_equal(port.pools.slot_of, ref.pools.slot_of)
    assert port.tuner.history == ref.tuner.history
    assert port.tuner.history, "the stream must take the tuner to a period"


def test_plan_step_accounts_like_on_macro_step():
    """The worker half plus the dispatch half charge and place exactly as
    the synchronous boundary does from the same state."""
    rng = np.random.default_rng(1)
    sync_m, pipe_m = _mini("port"), _mini("port")
    for s in range(10):
        mass = rng.random(16).astype(np.float32)
        sync_m.on_macro_step(mass, n_active=2.0, n_tokens=4, fetched=3)
        period, plan = pipe_m.plan_step(mass, n_active=2.0, n_tokens=4,
                                        fetched=3, **_snapshot(pipe_m.pools))
        pipe_m.apply_decision(plan)
        assert period == sync_m.manager.period
    assert pipe_m.manager.modeled_time == sync_m.manager.modeled_time
    assert pipe_m.manager.misses == sync_m.manager.misses
    np.testing.assert_array_equal(pipe_m.pools.slot_of, sync_m.pools.slot_of)


# ---------------------------------------------------------------------------
# the pipelined batcher
# ---------------------------------------------------------------------------


def _stack(side):
    tier = dict(page_size=PAGE, hbm_pages=HBM, period_steps=2)
    tune = dict(default_period=2, profile_steps=8, trial_steps=4)
    if side == "ref":
        return RS.TrafficMonitor(RPools.create(N_LOGICAL, HBM),
                                 RManager(N_LOGICAL, RTierConfig(**tier)),
                                 RTuner(N_LOGICAL, **tune))
    return TS.TrafficMonitor(TPools.create(N_LOGICAL, HBM),
                             TManager(N_LOGICAL, TTierConfig(**tier)),
                             TTuner(N_LOGICAL, **tune))


def _drive(side, arch, *, pipeline, chunk=None, temps=(0.0,) * 4,
           head_dim=None, impl=None):
    """One batcher over the staggered requests until drained: two rows,
    requests 2 and 3 submitted after two steps into recycled rows
    (``head_dim``: see ``_models``; ``impl``: the port's
    ``attention_impl``).  Returns (rid -> tokens, monitor)."""
    m = _models(arch, head_dim)
    mon = _stack(side)
    kw = dict(max_active=2, max_len=32, page_size=PAGE, monitor=mon,
              pipeline=pipeline, admit_chunk_tokens=chunk, cond=m["cond"])
    if side == "ref":
        b = RS.ContinuousBatcher(m["rp"], m["rcfg"], **kw)
        mk = lambda i: RS.Request(rid=i, prompt=m["prompts"][i],
                                  max_new_tokens=NEW[i],
                                  key=jax.random.PRNGKey(0))
    else:
        tcfg = m["tcfg"] if impl is None else dataclasses.replace(
            m["tcfg"], attention_impl=impl)
        b = TS.ContinuousBatcher(m["tp"], tcfg, device="cpu", **kw)
        mk = lambda i: TS.Request(rid=i, prompt=m["prompts"][i],
                                  max_new_tokens=NEW[i],
                                  temperature=temps[i], seed=100 + i)
    try:
        for t in range(80):
            for i, at in enumerate(ARRIVAL):
                if at == t:
                    b.submit(mk(i))
            b.step()
            if t >= max(ARRIVAL) and b.idle:
                break
        assert b.idle, "must drain"
        got = {r.rid: list(r.tokens) for r in b.completed}
        assert sorted(got) == [0, 1, 2, 3]
        assert mon.pools.free_pages == N_LOGICAL, "every page comes back"
    finally:
        b.close()
    return got, mon


def _check_pipelined_greedy(arch, chunk):
    """The port's pipelined batcher (lazy same-boundary admission, the
    decision worker, the overlap prefetch; with ``chunk`` every prompt in
    chunks of 4 positions) against the reference's pipelined batcher:
    greedy streams rid for rid, migrations, hits, misses and the tuner's
    history."""
    ref, rmon = _drive("ref", arch, pipeline=True, chunk=chunk)
    port, tmon = _drive("port", arch, pipeline=True, chunk=chunk)
    assert port == ref
    for attr in ("migrations", "hits", "misses"):
        assert getattr(tmon.manager, attr) == getattr(rmon.manager, attr), \
            attr
    assert tmon.tuner.history == rmon.tuner.history


def test_pipeline_arguments_are_checked():
    m = _models("qwen3-14b")
    with pytest.raises(ValueError, match="macro"):
        TS.ContinuousBatcher(m["tp"], m["tcfg"], monitor=_stack("port"),
                             macro=False, pipeline=True, device="cpu")
    with pytest.raises(ValueError, match="admit_chunk_tokens"):
        TS.ContinuousBatcher(m["tp"], m["tcfg"], monitor=_stack("port"),
                             pipeline=True, admit_chunk_tokens=0,
                             device="cpu")
    b = TS.ContinuousBatcher(m["tp"], m["tcfg"], monitor=_stack("port"),
                             page_size=PAGE, pipeline=True,
                             admit_chunk_tokens=5, device="cpu")
    assert b._chunk_width == 8        # rounded up to whole pages
    b.close()
