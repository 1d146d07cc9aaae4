"""The port's pipelined macro loop against the JAX reference.

  * ``serve.pipeline.DecisionWorker`` under the reference's hand-off
    tests (ordered generations, exceptions published to ``wait``, close
    and timeout, a stress-hammered fake dispatch thread);
  * ``TrafficMonitor.plan_step`` + ``apply_decision`` equal to the
    reference's on one seeded stream of masses and snapshots (period,
    plan, modeled time, misses, ``slot_of``), and equal to the port's own
    ``on_macro_step``;
  * ``model.prefill_chunk`` + ``chunk_past_extend`` against the
    reference's on bridged weights for every batched-prefill
    architecture of the geometry matrix (qwen3, gemma3 with its window of
    8 split by chunks of 4 and 6, deepseek MLA + MoE, olmoe, musicgen
    with its conditioning, nemotron, stablelm; nemotron and stablelm also
    at their registered head dims, 192 and 160), under both
    ``attention_impl`` settings, and against the port's own
    ``prefill_batched``;
  * the pipelined ``ContinuousBatcher``, with and without
    ``admit_chunk_tokens``, against the reference's pipelined batcher on
    the same weights and staggered requests (reduced gemma3, qwen3,
    deepseek, musicgen): greedy streams rid for rid, migrations, hits,
    misses and the tuner's history, every page returned; the synchronous
    batcher on reduced stablelm at head dim 160 through the flash route
    against the reference's batcher; sampled streams
    held to the port's own parity (pipelined == synchronous == chunked ==
    ``generate``);
  * the table-upload counters and the closed set of pipeline stages, and
    a worker exception surfacing from ``step()``.

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
import jax.numpy as jnp

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
from repro_torch.models import model as TM
from repro_torch.obs import telemetry as T_obs
from repro_torch.serve import sched as TS
from repro_torch.serve.engine import generate as t_generate
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
# chunked prefill
# ---------------------------------------------------------------------------


def _pallas_ok(tcfg) -> bool:
    try:
        TM.check_supported(tcfg)
        return True
    except NotImplementedError:
        return False


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("arch", CHUNK_ARCHS)
def test_prefill_chunk_matches_reference(arch, impl):
    """Three rows of 14, 9 and 3 tokens in chunks of 4 (and of 6, which
    with gemma3's window of 8 puts a window edge inside a chunk): every
    chunk's logits and cache rows against the reference's
    ``prefill_chunk`` over the same past, the accumulated past against
    the reference's ``chunk_past_extend``, and the final past and each
    row's last logits against the port's own ``prefill_batched``.  MLA
    (deepseek) cannot take the flash route: there the setting raises."""
    _check_prefill_chunk(_models(arch), impl)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("arch,head_dim", FULL_HEAD_DIMS)
def test_prefill_chunk_at_the_registered_head_dim_matches_reference(
        arch, head_dim, impl):
    """The same at stablelm-12b's head dim (160) and nemotron-4-340b's
    (192), which the flash route takes: the bridged weights at that head
    dim, reduced widths otherwise."""
    _check_prefill_chunk(_models(arch, head_dim), impl)


def _check_prefill_chunk(m, impl):
    rcfg, rp, tp = m["rcfg"], m["rp"], m["tp"]
    tcfg = dataclasses.replace(m["tcfg"], attention_impl=impl)
    if impl == "pallas" and not _pallas_ok(tcfg):
        with pytest.raises(NotImplementedError, match="MLA"):
            TM.check_supported(tcfg)
        return
    rng = np.random.default_rng(3)
    lengths = np.asarray([14, 9, 3], np.int64)
    toks = rng.integers(0, rcfg.vocab_size, (3, 16)).astype(np.int32)
    rcond = tcond = None
    if m["cond"] is not None:
        c = np.ascontiguousarray(np.broadcast_to(m["cond"], (3,)
                                                 + m["cond"].shape[1:]))
        rcond, tcond = jnp.asarray(c), torch.from_numpy(c)
    bl, bc = TM.prefill_batched(tp, tcfg, torch.from_numpy(toks).long(),
                                torch.from_numpy(lengths), cond=tcond)
    for width in (4, 6):
        rpast = tpast = None
        last = {}
        for lo in range(0, 16, width):
            hi = min(lo + width, 16)
            rl, rc = RM.prefill_chunk(rp, rcfg, jnp.asarray(toks[:, lo:hi]),
                                      jnp.asarray(lengths, jnp.int32), rpast,
                                      start=lo, cond=rcond)
            tl, tc = TM.prefill_chunk(
                tp, tcfg, torch.from_numpy(toks[:, lo:hi]).long(),
                torch.from_numpy(lengths), tpast, start=lo, cond=tcond)
            assert tl.shape == (3, 1, rcfg.vocab_size)
            _close(tl.numpy(), rl, LOGIT_TOL)
            for tseg, rseg in zip(tc["segments"], rc["segments"]):
                for t, r in zip(tseg, rseg):
                    assert sorted(t) == sorted(r)
                    for name, a in t.items():
                        _close(a.numpy(), r[name], TOL)
            for b in range(3):
                if lo <= lengths[b] - 1 < hi:
                    last[b] = tl[b]
            rpast = RM.chunk_past_extend(rpast, rc)
            tpast = TM.chunk_past_extend(tpast, tc)
            for tseg, rseg in zip(tpast["segments"], rpast["segments"]):
                for t, r in zip(tseg, rseg):
                    assert sorted(t) == sorted(r) and "pos" not in t
                    for name, a in t.items():
                        assert a.shape[2] == hi
                        _close(a.numpy(), r[name], TOL)
        _close(torch.stack([last[b] for b in range(3)]).numpy(),
               bl.numpy(), LOGIT_TOL)
        for tseg, bseg in zip(tpast["segments"], bc["segments"]):
            for t, b in zip(tseg, bseg):
                for name, a in t.items():
                    _close(a.numpy(), b[name].numpy(), TOL)


def test_prefill_chunk_refuses_recurrent_configs():
    for name in ("recurrentgemma-2b", "xlstm-1.3b"):
        cfg = dataclasses.replace(TC.reduced(name), dtype="float32")
        tp = TM.init(cfg, seed=0, device="cpu")
        with pytest.raises(ValueError, match="chunked prefill"):
            TM.prefill_chunk(tp, cfg, torch.zeros((1, 4), dtype=torch.long),
                             torch.tensor([4]), start=0)


def test_flash_route_takes_the_past_length_as_query_offset(monkeypatch):
    """On the flash route a chunk's attention is one
    ``ops.flash_attention`` call a layer with ``q_offset`` = the chunk's
    start over ``past ++ own`` keys; key positions that are not
    ``arange(start + S)`` are refused."""
    m = _models("gemma3-12b")
    tcfg = dataclasses.replace(m["tcfg"], attention_impl="pallas")
    from repro_torch.kernels import ops
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], kw["q_offset"], kw["window"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    toks = torch.arange(8, dtype=torch.long)[None] % tcfg.vocab_size
    _, c0 = TM.prefill_chunk(m["tp"], tcfg, toks[:, :4], torch.tensor([8]),
                             start=0)
    TM.prefill_chunk(m["tp"], tcfg, toks[:, 4:], torch.tensor([8]),
                     TM.chunk_past_extend(None, c0), start=4)
    layers = tcfg.num_layers
    assert seen[:layers] == [(4, 4, 0, w) for w in
                             [8, 8, 8, 8, 8, 0]]
    assert seen[layers:] == [(4, 8, 4, w) for w in [8, 8, 8, 8, 8, 0]]
    from repro_torch.models import layers as TL
    slot = m["tp"].segments[0][0]
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(ValueError, match="start"):
        TL.attention_apply(slot, 0, tcfg, x, torch.arange(4)[None] + 4,
                           past=(torch.zeros(1, 4, tcfg.num_kv_heads,
                                             tcfg.head_dim),) * 2,
                           k_positions=torch.arange(4)[None])


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


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("arch", SERVED)
def test_pipelined_greedy_streams_match_reference(arch, chunk):
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


def test_flash_route_streams_at_head_dim_160_match_reference():
    """The synchronous batcher on reduced stablelm-12b at its registered
    head dim (160), every admission through the flash route
    (``attention_impl="pallas"``), against the reference's batcher:
    greedy streams rid for rid, migrations, hits, misses and the tuner's
    history."""
    kw = dict(pipeline=False, head_dim=160)
    ref, rmon = _drive("ref", "stablelm-12b", **kw)
    port, tmon = _drive("port", "stablelm-12b", impl="pallas", **kw)
    assert port == ref
    for attr in ("migrations", "hits", "misses"):
        assert getattr(tmon.manager, attr) == getattr(rmon.manager, attr), \
            attr
    assert tmon.tuner.history == rmon.tuner.history


def test_sampled_streams_pipelined_sync_chunked_generate():
    """Sampled rows draw ``(seed, iteration)`` on the device: the
    pipelined loop, the synchronous loop, chunked admission and
    ``generate`` emit the same streams."""
    arch = "gemma3-12b"
    temps = (0.0, 0.7, 0.7, 0.0)
    runs = {name: _drive("port", arch, temps=temps, **kw)[0]
            for name, kw in (("sync", dict(pipeline=False)),
                             ("pipelined", dict(pipeline=True)),
                             ("chunked", dict(pipeline=True, chunk=4)))}
    assert runs["pipelined"] == runs["sync"]
    assert runs["chunked"] == runs["sync"]
    m = _models(arch)
    for i in range(4):
        ref = t_generate(m["tp"], m["tcfg"],
                         torch.from_numpy(m["prompts"][i]).long()[None],
                         steps=NEW[i], temperature=temps[i], seed=100 + i,
                         device="cpu")
        assert runs["sync"][i] == ref[0].tolist(), i


def test_pipelined_table_counters_and_stages():
    """Boundaries where nothing re-slotted and no row changed skip the
    table upload (counted), and a chunked pipelined run emits the closed
    set of stages, its decisions and its chunks: one decision a completed
    macro."""
    m = _models("gemma3-12b")
    rec = T_obs.install(T_obs.Recorder(enabled=True))
    try:
        mon = _stack("port")
        b = TS.ContinuousBatcher(m["tp"], m["tcfg"], max_active=2,
                                 max_len=32, page_size=PAGE, monitor=mon,
                                 pipeline=True, admit_chunk_tokens=4,
                                 device="cpu")
        rng = np.random.default_rng(1)
        for i, n in enumerate((6, 14)):
            b.submit(TS.Request(
                rid=i, max_new_tokens=6,
                prompt=rng.integers(0, m["tcfg"].vocab_size,
                                    size=n).astype(np.int32)))
        b.run(max_steps=60)
        b.close()
        assert b.idle
        counters = rec.summary()["counters"]
        assert counters.get("pool.table_upload.performed", 0) >= 1
        assert counters.get("pool.table_upload.skipped", 0) >= 1, \
            "quiet boundaries must reuse the staged tables"
        types = {e["type"] for e in rec.events()}
        assert {"serve.pipeline.stage", "serve.pipeline.decision",
                "serve.pipeline.admit_chunk"} <= types
        stages = {e["stage"] for e in rec.events("serve.pipeline.stage")}
        assert stages == {"decision_wait", "prefetch", "tables", "admit"}
        assert len(rec.events("serve.pipeline.decision")) \
            == len(rec.events("serve.macro"))
        assert all(e["stall_ms"] >= 0 for e in rec.events("serve.admit"))
    finally:
        T_obs.install(T_obs.Recorder())


def test_worker_exception_surfaces_from_step():
    """Without a watchdog a decision that raises re-raises from
    ``step()``; ``close()`` still tears down."""
    m = _models("qwen3-14b")
    mon = _stack("port")
    b = TS.ContinuousBatcher(m["tp"], m["tcfg"], max_active=2, max_len=32,
                             page_size=PAGE, monitor=mon, pipeline=True,
                             device="cpu")

    def boom(**kw):
        raise RuntimeError("decision failed")

    mon.plan_step = boom
    b.submit(TS.Request(rid=0, prompt=m["prompts"][0], max_new_tokens=6))
    b.step()                          # launches the first macro
    with pytest.raises(RuntimeError, match="decision failed"):
        b.step()                      # completes it: its decision raises
    b.close()
    b.close()


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
