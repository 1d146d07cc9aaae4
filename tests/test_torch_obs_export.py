"""The port's exporters and report (``repro_torch.obs.export`` /
``report``, copies of the reference's) against the reference's on one
recorded event list: a port tuner driven to HOLD and through a poisoned
re-tune, a model-free traffic replay with TTL shedding, and a pipelined
batcher under a chaos plan (macros, pipeline stages, preemptions, worker
restarts, injected faults).  ``write_jsonl``, ``read_jsonl``,
``perfetto_trace``, ``decision_trace``, ``metrics_table`` and the report
CLI must give the same output from either package."""
import dataclasses
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.obs import export as r_export
from repro.obs import report as r_report

import repro_torch.configs as TC
import repro_torch.obs as tobs
from repro_torch.core import OnlineTuner
from repro_torch.core.traffic import poisson_request_stream
from repro_torch.ft.inject import FaultPlan, FaultPoint
from repro_torch.memtier import SharedPagedPools, TierConfig, TieringManager
from repro_torch.models import model as TM
from repro_torch.obs import export as t_export
from repro_torch.obs import report as t_report
from repro_torch.serve import sched as TS


def _tuner_events():
    params = dict(default_period=2, profile_steps=32, trial_steps=32,
                  horizon_steps=64, bin_width=1, patience=3)
    tuner = OnlineTuner(64, **params)
    ids = lambda t: np.array([t % 4])
    for t in range(600):
        tuner.on_step(accessed_ids=ids(t), cost=abs(tuner.period - 8) + 1.0)
    assert tuner.state == OnlineTuner.HOLD
    tuner._reprofile()
    for i in range(200):
        if tuner.state != OnlineTuner.TRIAL:
            break
        tuner.on_step(accessed_ids=ids(i),
                      cost=300.0 if (i // 8) % 2 == 0 else 1.0)


def _traffic_events():
    specs = poisson_request_stream(200, 0.2, {"sink": 0.5, "periodic": 0.5},
                                   prompt_len=(16, 48),
                                   new_tokens=(16, 48), seed=1)
    pools = SharedPagedPools.create(64, 16)
    mgr = TieringManager(64, TierConfig(page_size=16, hbm_pages=16,
                                        period_steps=4))
    tuner = OnlineTuner(64, default_period=4, profile_steps=16,
                        trial_steps=8)
    TS.TrafficScheduler(specs, TS.TrafficMonitor(pools, mgr, tuner),
                        page_size=16, max_active=3, ttl_steps=6).run(240)


def _batcher_events():
    cfg = dataclasses.replace(TC.reduced("qwen3-14b"), dtype="float32",
                              num_kv_heads=2,
                              segments=((("attn",), 2),))
    params = TM.init(cfg, seed=0, device="cpu")
    mon = TS.TrafficMonitor(
        SharedPagedPools.create(48, 16),
        TieringManager(48, TierConfig(page_size=4, hbm_pages=16,
                                      period_steps=2)),
        OnlineTuner(48, default_period=2, profile_steps=8, trial_steps=4))
    plan = FaultPlan([
        FaultPoint("pool.squeeze", start=3, stop=7, value=6),
        FaultPoint("pool.migrate_fail", start=2, stop=20, prob=0.4),
        FaultPoint("worker.delay", start=3, stop=5, prob=1.0, value=0.05),
        FaultPoint("worker.crash", start=7, stop=9, prob=1.0),
        FaultPoint("mass.nonfinite", start=2, stop=30, prob=0.5),
        FaultPoint("admit.flood", start=0, stop=1, prob=1.0),
    ], seed=3)
    b = TS.ContinuousBatcher(params, cfg, monitor=mon, max_active=2,
                             max_len=32, page_size=4, pipeline=True,
                             fault_plan=plan, max_queue=1, watchdog_s=0.01,
                             max_worker_restarts=1, device="cpu")
    rng = np.random.default_rng(0)
    try:
        for rid, (plen, new) in enumerate(((6, 10), (9, 8), (5, 12),
                                           (7, 6))):
            b.submit(TS.Request(
                rid=rid, max_new_tokens=new, ttl_steps=2 if rid == 3
                else None, prompt=rng.integers(0, cfg.vocab_size, plen)
                .astype(np.int32), temperature=0.7 * (rid % 2),
                seed=rid))
        b.run(max_steps=100)
        assert b.idle
    finally:
        b.close()


@pytest.fixture(scope="module")
def recorded():
    rec = tobs.install(tobs.Recorder(enabled=True))
    try:
        _tuner_events()
        _traffic_events()
        _batcher_events()
    finally:
        tobs.install(tobs.Recorder())
    types = {e["type"] for e in rec.events()}
    assert {"tuner.transition", "tier.move", "serve.macro", "serve.admit",
            "serve.retire", "serve.shed", "serve.pipeline.stage",
            "serve.pipeline.decision", "serve.preempt",
            "serve.worker_restart", "ft.inject"} <= types, types
    return rec


def test_write_and_read_jsonl_equal(recorded, tmp_path):
    port = t_export.write_jsonl(tmp_path / "port.jsonl", recorded)
    ref = r_export.write_jsonl(tmp_path / "ref.jsonl", recorded)
    assert port.read_text() == ref.read_text()
    back = t_export.read_jsonl(port)
    assert back == r_export.read_jsonl(ref)
    assert back[-1]["type"] == "metrics.summary"
    assert back[-1]["schema"] == t_export.SCHEMA == r_export.SCHEMA
    assert [e["type"] for e in back[:-1]] == \
        [e["type"] for e in recorded.events()]


def test_perfetto_traces_equal(recorded, tmp_path):
    events = t_export.read_jsonl(
        t_export.write_jsonl(tmp_path / "log.jsonl", recorded))
    port = t_export.perfetto_trace(events)
    assert port == r_export.perfetto_trace(events)
    assert {e["ph"] for e in port["traceEvents"]} >= {"X", "C", "M"}
    t_path = t_export.write_perfetto(tmp_path / "t.json", events)
    r_path = r_export.write_perfetto(tmp_path / "r.json", events)
    assert json.loads(t_path.read_text()) == json.loads(r_path.read_text())


@pytest.mark.parametrize("include_all", [False, True])
def test_decision_trace_and_metrics_table_equal(recorded, tmp_path,
                                                include_all):
    events = t_export.read_jsonl(
        t_export.write_jsonl(tmp_path / "log.jsonl", recorded))
    port = t_report.decision_trace(events, include_all=include_all)
    assert port == r_report.decision_trace(events, include_all=include_all)
    assert port
    summary = events[-1]
    assert t_report.metrics_table(summary) == \
        r_report.metrics_table(summary)


def test_report_cli_output_equal(recorded, tmp_path, capsys):
    log = t_export.write_jsonl(tmp_path / "log.jsonl", recorded)
    out = {}
    for name, report in (("port", t_report), ("ref", r_report)):
        side = tmp_path / f"{name}.json"
        assert report.main([str(log), "--all", "--perfetto",
                            str(side)]) == 0
        out[name] = (capsys.readouterr().out.replace(str(side), "SIDE"),
                     json.loads(side.read_text()))
    assert out["port"] == out["ref"]
    assert "preempt" in out["port"][0]
