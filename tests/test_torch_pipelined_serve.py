"""The port's pipelined batcher against the reference's on reduced
gemma3-12b and qwen3-14b (greedy streams rid for rid, migrations, hits,
misses and the tuner's history, with and without chunked admission),
sampled streams held to the port's own parity (pipelined == synchronous
== chunked == ``generate``), the table-upload counters and the closed set
of pipeline stages, and a worker exception surfacing from ``step()``.
``tests/test_torch_pipelined.py`` holds the models, the drive loop and
the tolerances; ``tests/test_torch_pipelined_serve_more.py`` the other
served configs."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.obs import telemetry as T_obs
from repro_torch.serve import sched as TS
from repro_torch.serve.engine import generate as t_generate

from test_torch_pipelined import (NEW, PAGE, SERVED, _check_pipelined_greedy,
                                  _drive, _models, _stack)


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("arch", SERVED[:2])
def test_pipelined_greedy_streams_match_reference(arch, chunk):
    _check_pipelined_greedy(arch, chunk)


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
