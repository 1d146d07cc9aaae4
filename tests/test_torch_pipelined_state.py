"""The port's pipelined macro loop on the recurrent and shared-prefix
configs against the JAX reference.

Reduced ``recurrentgemma-2b`` (RG-LRU state pages beside the local
attention's window pages), reduced ``xlstm-1.3b`` (a pool of state pages
alone) and reduced ``paligemma-3b`` (a prefix of 8 positions in two
shared pages of 4, owner -1), float32, on weights bridged from the
reference's.  The reference initialises every recurrent cell's conv taps
to zero, which makes each cell an identity: the taps are drawn from
N(0, 0.5) in the reference's numpy parameters before the bridge
(``tests/test_torch_geometry.py::_perturb_conv``).  paligemma's prefix
embeddings are drawn N(0, 1) in numpy from the seed and given to both
packages.

  * the pipelined ``ContinuousBatcher`` against the reference's pipelined
    batcher on staggered requests into recycled rows: greedy streams rid
    for rid, migrations, hits, misses, pages moved, the tuner's history
    and the demand fetches of prefix pages, every page returned.  xlstm's
    state-only pool never migrates on its own, so its runs demote the
    oldest active row's state page by hand at the same scheduler steps on
    both sides; the page comes back from the host tier bit for bit.
    paligemma's pool is below two rows' working sets, so a tier evicts a
    shared prefix page that the next launch fetches back;
  * sampled streams: pipelined == synchronous == ``generate``.

``tests/test_torch_pipelined_squeeze.py`` holds the admission gate's two
other paths on the same configs (``admit_chunk_tokens`` refused, the
squeeze), on this file's helpers.  Each configuration's bridged weights
and each run the cases share are made once at module scope (``_run``)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

import repro.configs as RC
from repro.core.cori import OnlineTuner as RTuner
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
from repro_torch.ft import inject as TI
from repro_torch.memtier.tiering import SharedPagedPools as TPools
from repro_torch.memtier.tiering import TierConfig as TTierConfig
from repro_torch.memtier.tiering import TieringManager as TManager
from repro_torch.models import model as TM
from repro_torch.obs import telemetry as T_obs
from repro_torch.serve import sched as TS
from repro_torch.serve.engine import generate as t_generate

from test_torch_geometry import _perturb_conv

RECURRENT = ["recurrentgemma-2b", "xlstm-1.3b"]
ARCHS = RECURRENT + ["paligemma-3b"]
SIDES = {"ref": (RS, RPools, RManager, RTierConfig, RTuner, RI, R_obs),
         "port": (TS, TPools, TManager, TTierConfig, TTuner, TI, T_obs)}
N_LOGICAL, HBM, PAGE = 48, 16, 4
# paligemma's HBM pages: below two rows' working sets with the two shared
# prefix pages, so a tier evicts a prefix page and a launch fetches it back
PREFIX_HBM = 7
# (prompt lengths, new tokens, arrival steps): ``staggered`` as
# tests/test_torch_pipelined.py's (two join mid-flight, into used rows;
# 14 > the chunk width of 4), ``long`` as tests/test_torch_faults.py's
# squeeze (all four at once, rows busy long enough to be preempted)
MIXES = {"staggered": ((6, 9, 5, 14), (6, 4, 7, 5), (0, 0, 2, 2)),
         "long": ((6, 9, 5, 8), (12, 10, 14, 12), (0, 0, 0, 0))}
# xlstm: the oldest active row's state page demoted after every this many
# scheduler steps
DEMOTE_EVERY = 2
# the squeeze's window in scheduler steps and its capacity in HBM pages:
# below two recurrentgemma rows' pages, and below two xlstm rows' state
# pages
SQUEEZE = {"recurrentgemma-2b": (4, 10, 8), "xlstm-1.3b": (4, 10, 1)}

_MODELS, _RUNS = {}, {}


def _models(arch):
    """Reduced ``arch`` in float32: the reference's parameters (conv taps
    drawn), the port's bridged from them, the prompts and the prefix."""
    if arch not in _MODELS:
        rcfg = dataclasses.replace(RC.reduced(arch), dtype="float32")
        tcfg = dataclasses.replace(TC.reduced(arch), dtype="float32")
        rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
        rp = jax.tree.map(np.asarray, rp)
        _perturb_conv(rp, np.random.default_rng(7))
        tp = bridge.from_reference(rp, tcfg, device="cpu")
        rng = np.random.default_rng(0)
        prompts = {mix: [rng.integers(0, rcfg.vocab_size, n).astype(np.int32)
                         for n in lens] for mix, (lens, _, _) in MIXES.items()}
        ex = None
        if rcfg.prefix_len:
            ex = rng.standard_normal((1, rcfg.prefix_len, rcfg.d_model)) \
                .astype(np.float32)
        _MODELS[arch] = dict(rcfg=rcfg, rp=jax.tree.map(jax.numpy.asarray,
                                                         rp),
                             tcfg=tcfg, tp=tp, prompts=prompts, ex=ex)
    return _MODELS[arch]


def _stack(side, hbm):
    S, Pools, Manager, TierConfig, Tuner, _, _ = SIDES[side]
    tier = dict(page_size=PAGE, hbm_pages=hbm, period_steps=2)
    tune = dict(default_period=2, profile_steps=8, trial_steps=4)
    return S.TrafficMonitor(Pools.create(N_LOGICAL, hbm),
                            Manager(N_LOGICAL, TierConfig(**tier)),
                            Tuner(N_LOGICAL, **tune))


def _squeeze_plan(side, arch):
    I = SIDES[side][5]
    start, stop, value = SQUEEZE[arch]
    return I.FaultPlan([I.FaultPoint("pool.squeeze", start=start,
                                     stop=stop, value=value)], seed=0)


class _StatePages:
    """Watch a port batcher's state pages leave HBM and come back: each
    demotion (by hand, ``demote``, or by a preemption) keeps the page's
    HBM bytes, and the pool's ``migrate_slots`` is wrapped so that when a
    fetch brings the page back from the host tier its bytes are held to
    the kept ones."""

    def __init__(self, b):
        self.pools = b.monitor.pools
        self.kept, self.demoted, self.fetched = {}, 0, 0
        migrate = self.pools.migrate_slots

        def checked(slots, logicals, **kw):
            migrate(slots, logicals, **kw)
            for slot, gid in zip(np.asarray(slots).tolist(),
                                 np.asarray(logicals).tolist()):
                if gid in self.kept:
                    for leaf, kept in zip(self._leaves(),
                                          self.kept.pop(gid)):
                        assert torch.equal(leaf[:, slot], kept), gid
                    self.fetched += 1
        self.pools.migrate_slots = checked

    def _leaves(self):
        return [t for t in self.pools.kv_layers["state_hbm"]
                if t is not None]

    def keep(self, gid: int) -> None:
        slot = int(self.pools.slot_of[gid])
        if slot >= 0:
            self.kept[gid] = [t[:, slot].clone() for t in self._leaves()]
            self.demoted += 1


def _watch_preemptions(b, pages: _StatePages) -> None:
    """Keep every preempted row's state page before ``_preempt`` demotes
    it."""
    preempt = b._preempt

    def watched(req):
        pages.keep(int(req.gids[-1]))
        preempt(req)
    b._preempt = watched


def _drive(side, arch, *, mix="staggered", pipeline=True, chunk=None,
           temps=(0.0,) * 4, plan=None, demote=False):
    """One batcher (two rows, pages of 4, pools of 48 / 16, or 48 /
    ``PREFIX_HBM`` with a prefix) over ``mix``'s requests (``MIXES``)
    until drained, with a flight recorder.  ``demote``: the oldest active
    row's state page demoted after every ``DEMOTE_EVERY`` scheduler
    steps.  On the port, every state page that leaves HBM is
    held bit for bit when it comes back.  Returns a dict of the streams,
    the monitor, the batcher, the recorder, the state-page watch and the
    demand fetches of prefix pages."""
    m = _models(arch)
    prompts, new, arrival = m["prompts"][mix], MIXES[mix][1], MIXES[mix][2]
    S, obs = SIDES[side][0], SIDES[side][6]
    mon = _stack(side, PREFIX_HBM if m["ex"] is not None else HBM)
    kw = dict(max_active=2, max_len=32, page_size=PAGE, monitor=mon,
              pipeline=pipeline, admit_chunk_tokens=chunk,
              extra_embeds=m["ex"], fault_plan=plan)
    if side == "ref":
        b = RS.ContinuousBatcher(m["rp"], m["rcfg"], **kw)
        mk = lambda i: RS.Request(rid=i, prompt=prompts[i],
                                  max_new_tokens=new[i],
                                  key=jax.random.PRNGKey(0))
    else:
        b = TS.ContinuousBatcher(m["tp"], m["tcfg"], device="cpu", **kw)
        mk = lambda i: TS.Request(rid=i, prompt=prompts[i],
                                  max_new_tokens=new[i],
                                  temperature=temps[i], seed=100 + i)
    pools = mon.pools
    pages = None
    if side == "port" and TM.has_state_pages(m["tcfg"]):
        pages = _StatePages(b)
        _watch_preemptions(b, pages)
    prefix_pages = (m["rcfg"].prefix_len or 0) // PAGE
    fetched = {"prefix": 0}
    if prefix_pages:
        ensure = pools.ensure_resident

        def counted(gids):
            gids = np.asarray(gids)
            fetched["prefix"] += int(
                (pools.slot_of[gids[gids < prefix_pages]] < 0).sum())
            return ensure(gids)
        pools.ensure_resident = counted
    demoted = []
    rec = obs.install(obs.Recorder(enabled=True))
    try:
        for t in range(80):
            for i, at in enumerate(arrival):
                if at == t:
                    b.submit(mk(i))
            b.step()
            if demote and (t + 1) % DEMOTE_EVERY == 0 and b.active:
                req = min(b.active.values(), key=lambda r: r.rid)
                gid = int(req.gids[-1])
                if pages is not None:
                    pages.keep(gid)
                demoted.append((t, req.rid, int(pools.demote([gid]))))
            if t >= max(arrival) and b.idle:
                break
        assert b.idle, "must drain"
        assert mon.pools.free_pages == N_LOGICAL - prefix_pages, \
            "every owned page comes back"
    finally:
        b.close()
        obs.install(obs.Recorder())
    streams = {r.rid: list(r.tokens) for r in b.completed}
    assert sorted(streams) == [0, 1, 2, 3]
    if pages is not None:
        assert not pages.kept, "every state page that left HBM came back"
        assert pages.fetched == pages.demoted
    return dict(streams=streams, mon=mon, b=b, rec=rec, pages=pages,
                demoted=demoted, prefix_fetched=fetched["prefix"])


def _run(side, arch, kind):
    """The greedy pipelined runs the cases share, each made once:
    ``staggered`` (xlstm's demotions by hand), ``long`` (fault-free) and
    ``squeeze`` (``long`` under ``SQUEEZE``'s plan)."""
    key = (side, arch, kind)
    if key not in _RUNS:
        _RUNS[key] = _drive(
            side, arch, mix="staggered" if kind == "staggered" else "long",
            demote=arch == "xlstm-1.3b" and kind == "staggered",
            plan=_squeeze_plan(side, arch) if kind == "squeeze" else None)
    return _RUNS[key]


def _accounting(run):
    mgr = run["mon"].manager
    return dict(migrations=mgr.migrations, hits=mgr.hits,
                misses=mgr.misses, moved=mgr.data_moved_pages,
                history=list(run["mon"].tuner.history),
                prefix_fetched=run["prefix_fetched"])


# ---------------------------------------------------------------------------
# the pipelined loop against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_pipelined_greedy_streams_match_reference(arch):
    """Greedy streams rid for rid, migrations, hits, misses, pages moved,
    the tuner's history and the prefix pages' demand fetches equal the
    reference's pipelined batcher's; xlstm's hand demotions land at the
    same steps on both sides and every demoted state page comes back bit
    for bit."""
    ref = _run("ref", arch, "staggered")
    port = _run("port", arch, "staggered")
    assert port["streams"] == ref["streams"]
    assert _accounting(port) == _accounting(ref)
    assert port["demoted"] == ref["demoted"]
    if arch == "xlstm-1.3b":
        assert sum(n for *_, n in port["demoted"]) >= 2
        assert port["pages"].fetched == port["pages"].demoted >= 2
        assert port["mon"].manager.misses >= port["pages"].fetched
    if arch == "paligemma-3b":
        assert port["mon"].pools.owner_of[:2].tolist() == [-1, -1]
        assert port["prefix_fetched"] >= 1, \
            "a prefix page evicted by a tier and fetched back"
        assert port["mon"].tuner.history, "the tuner leaves its profile"


@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_streams_pipelined_sync_generate(arch):
    """Sampled rows draw ``(seed, iteration)`` on the device: the
    pipelined loop, the synchronous loop and ``generate`` emit the same
    streams."""
    m = _models(arch)
    new = MIXES["staggered"][1]
    temps = (0.0, 0.7, 0.7, 0.0)
    pipe = _drive("port", arch, temps=temps)["streams"]
    sync = _drive("port", arch, temps=temps, pipeline=False)["streams"]
    assert pipe == sync
    for i in range(4):
        want = t_generate(m["tp"], m["tcfg"],
                          torch.from_numpy(m["prompts"]["staggered"][i])
                          .long()[None], steps=new[i],
                          temperature=temps[i], seed=100 + i,
                          extra_embeds=m["ex"], device="cpu")
        assert sync[i] == want[0].tolist(), i
