"""A long prompt served by the port's ``ContinuousBatcher`` against the
JAX reference's, on the three configs that declare
``supports_long_context``: reduced ``gemma3-12b`` (five local layers of
window 8, one global), reduced ``recurrentgemma-2b`` (RG-LRU state pages
beside a local layer of window 8) and reduced ``xlstm-1.3b`` (state pages
alone), float32, on weights bridged from the reference's (the recurrent
cells' conv taps drawn N(0, 0.5) before the bridge,
``tests/test_torch_geometry.py::_perturb_conv``).

The mix is the card's long-context mix (``chip_smoke.py`` phases 54-56)
cut to size: one prompt of 1100 tokens admitted alone -- its attention
runs in query chunks of 512, 512 and 76 (``layers.SDPA_Q_CHUNK``; packed
admission pads it to 2048, four chunks) -- then two short prompts one
scheduler step later, pages of 16, a row capped at 2048 tokens (128
pages).  Greedy streams rid for rid, migrations, hits, misses, pages
moved, the demand-fetched pages and the tuner's history equal the
reference batcher's, and every page comes back.  Reduced gemma3 also
runs the pipelined loop with ``admit_chunk_tokens=256`` (the long prompt
in five chunks) against the reference's pipelined loop."""
import dataclasses

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

from test_torch_geometry import _perturb_conv

ARCHS = ["gemma3-12b", "recurrentgemma-2b", "xlstm-1.3b"]
SIDES = {"ref": (RS, RPools, RManager, RTierConfig, RTuner),
         "port": (TS, TPools, TManager, TTierConfig, TTuner)}
PAGE, MAX_LEN = 16, 2048
# the long prompt first, alone in its admission; the short two arrive one
# scheduler step later
PROMPT_LENS = (1100, 24, 40)
NEW = (12, 10, 14)
ARRIVAL = (0, 1, 1)
# (logical pages, HBM slots): the long row allocates 128 pages (its 70
# bucketed, capped at MAX_LEN / PAGE), each short row 4, a recurrent row
# one state page more; the HBM slots hold the in-flight rows' exact pages
# (70 + 3 + 4, + 3 state pages) and a few more.  xlstm's rows hold one
# state page each and nothing else.
POOLS = {"gemma3-12b": (144, 84), "recurrentgemma-2b": (144, 84),
         "xlstm-1.3b": (8, 4)}
CHUNK = 256

_MODELS, _RUNS = {}, {}


def _models(arch):
    if arch not in _MODELS:
        rcfg = dataclasses.replace(RC.reduced(arch), dtype="float32")
        tcfg = dataclasses.replace(TC.reduced(arch), dtype="float32")
        rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
        rp = jax.tree.map(np.asarray, rp)
        _perturb_conv(rp, np.random.default_rng(7))
        tp = bridge.from_reference(rp, tcfg, device="cpu")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32)
                   for n in PROMPT_LENS]
        _MODELS[arch] = dict(rcfg=rcfg, rp=jax.tree.map(jax.numpy.asarray,
                                                         rp),
                             tcfg=tcfg, tp=tp, prompts=prompts)
    return _MODELS[arch]


def _drive(side, arch, *, pipeline=False, chunk=None):
    """One batcher (four rows) over the long mix until drained; returns
    its streams, monitor and the demand-fetched pages."""
    m = _models(arch)
    S, Pools, Manager, TierConfig, Tuner = SIDES[side]
    n_logical, hbm = POOLS[arch]
    pools = Pools.create(n_logical, hbm)
    mon = S.TrafficMonitor(
        pools, Manager(n_logical, TierConfig(page_size=PAGE, hbm_pages=hbm,
                                             period_steps=2)),
        Tuner(n_logical, default_period=2, profile_steps=8, trial_steps=4))
    fetched = [0]
    ensure = pools.ensure_resident

    def counted(gids):
        n = ensure(gids)
        fetched[0] += int(n)
        return n
    pools.ensure_resident = counted
    kw = dict(max_active=4, max_len=MAX_LEN, page_size=PAGE, monitor=mon,
              pipeline=pipeline, admit_chunk_tokens=chunk)
    if side == "ref":
        b = RS.ContinuousBatcher(m["rp"], m["rcfg"], **kw)
        mk = lambda i: RS.Request(rid=i, prompt=m["prompts"][i],
                                  max_new_tokens=NEW[i],
                                  key=jax.random.PRNGKey(0))
    else:
        b = TS.ContinuousBatcher(m["tp"], m["tcfg"], device="cpu", **kw)
        mk = lambda i: TS.Request(rid=i, prompt=m["prompts"][i],
                                  max_new_tokens=NEW[i], seed=100 + i)
    try:
        for t in range(200):
            for i, at in enumerate(ARRIVAL):
                if at == t:
                    b.submit(mk(i))
            b.step()
            if t >= max(ARRIVAL) and b.idle:
                break
        assert b.idle, "must drain"
        assert pools.free_pages == n_logical, "every page comes back"
    finally:
        if pipeline:
            b.close()
    streams = {r.rid: list(r.tokens) for r in b.completed}
    assert sorted(streams) == [0, 1, 2]
    assert [len(streams[i]) for i in range(3)] == list(NEW)
    mgr = mon.manager
    return dict(streams=streams, migrations=mgr.migrations, hits=mgr.hits,
                misses=mgr.misses, moved=mgr.data_moved_pages,
                history=list(mon.tuner.history), fetched=fetched[0])


def _run(side, arch, **kw):
    key = (side, arch, tuple(sorted(kw.items())))
    if key not in _RUNS:
        _RUNS[key] = _drive(side, arch, **kw)
    return _RUNS[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_long_prompt_serving_matches_reference(arch):
    """The synchronous macro loop: greedy streams, migrations, hits,
    misses, pages moved, demand fetches and the tuner's history equal the
    reference batcher's."""
    port, ref = _run("port", arch), _run("ref", arch)
    assert port == ref
    assert port["history"], "the tuner leaves its profile window"


def test_long_prompt_pipelined_chunked_matches_reference():
    """gemma3's pipelined loop with ``admit_chunk_tokens=256``: the long
    prompt's admission in five chunks behind the short rows' macros; the
    same equalities against the reference's pipelined loop."""
    port = _run("port", "gemma3-12b", pipeline=True, chunk=CHUNK)
    ref = _run("ref", "gemma3-12b", pipeline=True, chunk=CHUNK)
    assert port == ref
    assert port["history"], "the tuner leaves its profile window"
