"""The port's dense batcher path (``paged=False``) and ``paged_context``
against the JAX reference.

  * ``model.row_cache_from_batched`` equals per-request ``prefill`` +
    ``pad_cache`` at every position attention reads, window rings
    included (prompts with ``plen % window >= 2``), and its ``pos`` rows
    equal the reference's;
  * four-way parity for every registered architecture, in the port:
    ``generate`` == dense (``monitor=None``) == per-token paged == macro,
    on the reference matrix's workload (``tests/test_geometry.py``):
    staggered admission into a recycled row, temperature, a mid-flight
    EOS on the dense and macro paths, window rings that wrap;
  * the error contracts.

The dense batcher with a monitor and ``mirror_pages`` against the
reference's, ``paged_context`` in both modes and the dense mirror's
prefix page range are held in ``tests/test_torch_dense_mirror.py``, on
this file's models and stacks.

Reduced configs, float32, the reference's parameters carried over through
``repro_torch.bridge`` (the four-way matrix initialises the port alone,
recurrent conv taps drawn N(0, 0.5) from a numpy seed as
``tests/test_torch_geometry.py`` does).  On the CPU ``paged_context``
runs the kernel's plain version; the reference's runs its oracle
(``impl="reference"``).  Tolerances: merged masses 1e-6 absolute (the
monitor layer's softmax in float32, summed per page in another order);
cache rows, mirrored pages and attention contexts 1e-5 absolute."""
import dataclasses

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
from repro_torch.serve import sched as TS
from repro_torch.serve.engine import generate as t_generate

MASS_TOL, TOL = 1e-6, 1e-5
# float32 relative term: two frameworks' summation orders on different CPUs
F32_RTOL = 4e-6
N_LOGICAL, HBM, PAGE = 48, 10, 4
PROMPT_LENS = (6, 9, 5, 11)
NEW = (6, 4, 9, 7)
PROBE_STEPS = (2, 4, 6)
# the dense probes' HBM pool: small enough that tiering leaves some of a
# probed request's pages on the host (paged_context then fetches them)
DENSE_HBM = 6
MIRRORED = ["qwen3-14b", "gemma3-12b", "paligemma-3b"]
# reduced qwen3-14b with GQA 4/2 and two repeats (tests/test_torch_serve.py)
QWEN_KW = dict(num_kv_heads=2, segments=((("attn",), 2),))

_CACHE = {}


def _models(arch):
    """Reference and port parameters holding the same numbers, four
    prompts, and the arch's prefix (N(0, 1), numpy) when it has one."""
    if arch not in _CACHE:
        kw = dict(QWEN_KW if arch == "qwen3-14b" else {}, dtype="float32")
        rcfg = dataclasses.replace(RC.reduced(arch), **kw)
        tcfg = dataclasses.replace(TC.reduced(arch), **kw)
        rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
        tp = bridge.from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                   device="cpu")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32)
                   for n in PROMPT_LENS]
        ex = None
        if rcfg.prefix_len:
            ex = rng.standard_normal((1, rcfg.prefix_len, rcfg.d_model)) \
                .astype(np.float32)
        _CACHE[arch] = dict(rcfg=rcfg, rp=rp, tcfg=tcfg, tp=tp,
                            prompts=prompts, ex=ex)
    return _CACHE[arch]


def _close(t, r, tol=TOL, rtol=F32_RTOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(r), atol=tol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# a prefill_batched row as a dense cache row
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma3-12b", "paligemma-3b"])
def test_row_cache_from_batched_matches_prefill(arch):
    """Each joiner's row equals its own ``prefill`` + ``pad_cache`` where
    ``pos >= 0`` (and ``pos`` everywhere), and its ``pos`` rows equal the
    reference's ``row_cache_from_batched``.  gemma3's window is 8: the
    prompts of 11 and 19 tokens leave rings rolled by 3 (``plen % window
    >= 2``); paligemma's rows start with its prefix of 8."""
    m = _models(arch)
    tcfg, rcfg = m["tcfg"], m["rcfg"]
    prefix, max_len = rcfg.prefix_len or 0, 48
    rng = np.random.default_rng(3)
    plens = (5, 11, 19)
    prompts = [rng.integers(0, rcfg.vocab_size, n) for n in plens]
    toks, lens = TS.pack_prompts(prompts, prefix)
    rows = lambda t, b: None if t is None else np.broadcast_to(
        t, (b,) + t.shape[1:]).copy()
    ex_b = rows(m["ex"], toks.shape[0])
    _, tcache = TM.prefill_batched(
        m["tp"], tcfg, torch.from_numpy(toks), torch.from_numpy(lens),
        extra_embeds=None if ex_b is None else torch.from_numpy(ex_b))
    _, rcache = RM.prefill_batched(
        m["rp"], rcfg, jnp.asarray(toks, jnp.int32),
        jnp.asarray(lens, jnp.int32),
        extra_embeds=None if ex_b is None else jnp.asarray(ex_b))
    for bi, p in enumerate(prompts):
        length = prefix + len(p)
        got = TM.row_cache_from_batched(tcache, tcfg, bi, length, max_len)
        ref = RM.row_cache_from_batched(rcache, rcfg, bi, length, max_len)
        ex1 = None if m["ex"] is None else torch.from_numpy(m["ex"])
        _, one = TM.prefill(m["tp"], tcfg, torch.from_numpy(p)[None],
                            extra_embeds=ex1)
        one = TM.pad_cache(one, tcfg, max_len)
        for seg, seg_r, seg_1 in zip(got["segments"], ref["segments"],
                                     one["segments"]):
            for e, e_r, e_1 in zip(seg, seg_r, seg_1):
                np.testing.assert_array_equal(e["pos"].numpy(),
                                              np.asarray(e_r["pos"]))
                np.testing.assert_array_equal(e["pos"].numpy(),
                                              e_1["pos"][:, 0].numpy())
                live = e["pos"][0] >= 0
                for name in ("k", "v"):
                    assert e[name].shape == e_1[name][:, 0].shape
                    _close(e[name][:, live], e_1[name][:, 0][:, live])
    cap = min(rcfg.window_size, max_len) if rcfg.window_size else max_len
    assert arch != "gemma3-12b" or (cap, 19 % cap, 11 % cap) == (8, 3, 3)


def test_slot_helpers_match_reference():
    """``attn_slot_meta`` and ``attn_slot_index`` (the monitor slot's leaf
    in the layered pools; non-attention slots raise) agree with the
    reference's for every registered architecture."""
    for arch in TC.ARCHS:
        tcfg, rcfg = TC.reduced(arch), RC.reduced(arch)
        strip = lambda meta: [(si, j, r, w, str(k.base))
                              for si, j, r, w, k in meta]
        assert strip(TM.attn_slot_meta(tcfg)) \
            == strip(RM.attn_slot_meta(rcfg)), arch
        for si, j, *_ in TM.state_slot_meta(tcfg):
            try:
                want = RM.attn_slot_index(rcfg, si, j)
            except ValueError:
                with pytest.raises(ValueError, match="not an attention"):
                    TM.attn_slot_index(tcfg, si, j)
            else:
                assert TM.attn_slot_index(tcfg, si, j) == want, arch


# ---------------------------------------------------------------------------
# generate == dense == per-token paged == macro, every registered arch
# ---------------------------------------------------------------------------


def _port_model(arch):
    """The port's own seeded parameters for ``arch`` (conv taps N(0, 0.5)
    in recurrent cells), the reference matrix's prompts, steps and
    temperatures, and the conditioning / prefix the arch takes."""
    key = ("port", arch)
    if key not in _CACHE:
        cfg = dataclasses.replace(TC.reduced(arch), dtype="float32")
        params = TM.init(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(0)
        with torch.no_grad():
            for seg in params.segments:
                for slot in seg:
                    if slot.kind.is_recurrent:
                        slot.cell.conv.copy_(torch.from_numpy(rng.normal(
                            0.0, 0.5, tuple(slot.cell.conv.shape))
                            .astype(np.float32)))
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (6, 9, 5)]
        cond = ex = None
        if cfg.cond_len:
            cond = rng.standard_normal(
                (1, cfg.cond_len, cfg.cond_dim or cfg.d_model)) \
                .astype(np.float32)
        if cfg.prefix_len:
            ex = rng.standard_normal((1, cfg.prefix_len, cfg.d_model)) \
                .astype(np.float32)
        _CACHE[key] = dict(cfg=cfg, params=params, prompts=prompts,
                           steps=[6, 4, 7], temps=[0.0, 0.7, 0.7], cond=cond,
                           ex=ex)
    return _CACHE[key]


def _port_stack(n_logical=64, hbm=32, page=4):
    return TS.TrafficMonitor(
        TPools.create(n_logical, hbm),
        TManager(n_logical, TTierConfig(page_size=page, hbm_pages=hbm,
                                        period_steps=2)),
        TTuner(n_logical, default_period=2, profile_steps=8, trial_steps=4))


def _run_mode(m, mode, eos_for=None, eos_id=None):
    """The reference matrix's staggered workload on one batcher mode;
    returns ({rid: tokens}, the (rid, token) events streamed)."""
    mon = None if mode == "dense" else _port_stack()
    b = TS.ContinuousBatcher(m["params"], m["cfg"], max_active=2,
                             max_len=32, page_size=4, monitor=mon,
                             paged=mode != "dense", macro=mode == "macro",
                             cond=m["cond"], extra_embeds=m["ex"],
                             device="cpu")
    assert b.paged == (mode != "dense") and b.route == "eager"
    mk = lambda i: TS.Request(rid=i, prompt=m["prompts"][i],
                              max_new_tokens=m["steps"][i],
                              temperature=m["temps"][i], seed=10 + i,
                              eos_id=eos_id if i == eos_for else None)
    b.submit(mk(0))
    b.submit(mk(1))
    events = []
    for t in range(60):
        if t == 2:       # joins mid-flight, lands in a recycled row
            b.submit(mk(2))
        events.extend(b.step())
        if t > 2 and b.idle:
            break
    assert b.idle, "workload did not drain"
    if mon is not None:
        shared = (m["cfg"].prefix_len or 0) // 4
        assert mon.pools.free_pages == mon.pools.n_logical - shared
    return {r.rid: list(r.tokens) for r in b.completed}, events


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_four_way_parity(arch):
    """generate == dense == per-token paged == macro, token for token and
    in the streamed events; an EOS inside the first request's stream
    truncates it there on the dense and macro paths."""
    m = _port_model(arch)
    want = [t_generate(m["params"], m["cfg"], p[None], m["steps"][i],
                       temperature=m["temps"][i], seed=10 + i,
                       cond=m["cond"], extra_embeds=m["ex"],
                       device="cpu")[0].tolist()
            for i, p in enumerate(m["prompts"])]
    for mode in ("dense", "paged", "macro"):
        got, events = _run_mode(m, mode)
        for i in range(3):
            assert got[i] == want[i], (arch, mode, i)
            assert [tok for rid, tok in events if rid == i] == want[i], \
                (arch, mode, i)
    eos_at = next((i for i in range(2, len(want[0]))
                   if want[0][i] not in want[0][:i]), None)
    if eos_at is not None:
        for mode in ("dense", "macro"):
            got, _ = _run_mode(m, mode, eos_for=0, eos_id=want[0][eos_at])
            assert got[0] == want[0][:eos_at + 1], (arch, mode)
    windows = [w for *_, w, _ in TM.state_slot_meta(m["cfg"]) if w]
    assert all(9 + 7 > w for w in windows), "the rings must wrap"


# ---------------------------------------------------------------------------
# the stacks of the dense batcher with a monitor and mirror_pages (served
# against the reference in tests/test_torch_dense_mirror.py)
# ---------------------------------------------------------------------------


def _mirror_stack(side, cfg, hbm=HBM):
    tier = dict(page_size=PAGE, hbm_pages=hbm, period_steps=2)
    tune = dict(default_period=2, profile_steps=8, trial_steps=4)
    geo = dict(page_size=PAGE, kv_heads=cfg.num_kv_heads,
               head_dim=cfg.head_dim)
    if side == "ref":
        return RS.TrafficMonitor(RPools.create(N_LOGICAL, hbm, **geo),
                                 RManager(N_LOGICAL, RTierConfig(**tier)),
                                 RTuner(N_LOGICAL, **tune))
    return TS.TrafficMonitor(TPools.create(N_LOGICAL, hbm, device="cpu",
                                           **geo),
                             TManager(N_LOGICAL, TTierConfig(**tier)),
                             TTuner(N_LOGICAL, **tune))


def _probe_q(cfg, rid, step):
    rng = np.random.default_rng(1000 * step + rid)
    return rng.standard_normal((1, cfg.num_heads, cfg.head_dim)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# the contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["no_mirror", "macro_dense",
                                  "paged_no_monitor", "layered_only",
                                  "not_in_flight", "attention_free"])
def test_dense_contracts(case):
    """``paged_context`` needs the paged path or an armed mirror and a
    request in flight; ``macro`` needs the paged path, ``paged=True`` a
    monitor; ``mirror_pages`` stays off over a pool without the legacy
    pair (which still serves the dense path and drains); a config without
    a full-attention layer (xlstm-1.3b) has no dense monitor."""
    m = _models("gemma3-12b")
    kw = dict(max_active=1, max_len=32, page_size=PAGE, device="cpu")
    if case == "no_mirror":
        mon = _mirror_stack("port", m["tcfg"])
        b = TS.ContinuousBatcher(m["tp"], m["tcfg"], monitor=mon,
                                 paged=False, **kw)
        assert not b.mirror_pages
        b.submit(TS.Request(rid=0, prompt=m["prompts"][0],
                            max_new_tokens=4))
        b.step()
        with pytest.raises(ValueError, match="mirror_pages"):
            b.paged_context(0, _probe_q(m["tcfg"], 0, 0))
    elif case == "macro_dense":
        with pytest.raises(ValueError, match="fully-paged"):
            TS.ContinuousBatcher(m["tp"], m["tcfg"], paged=False,
                                 macro=True, **kw)
    elif case == "paged_no_monitor":
        with pytest.raises(ValueError, match="TrafficMonitor"):
            TS.ContinuousBatcher(m["tp"], m["tcfg"], paged=True, **kw)
    elif case == "layered_only":
        pools = TPools.create(N_LOGICAL, HBM)
        mon = TS.TrafficMonitor(pools, TManager(N_LOGICAL, TTierConfig(
            page_size=PAGE, hbm_pages=HBM, period_steps=4)))
        paged = TS.ContinuousBatcher(m["tp"], m["tcfg"], monitor=mon, **kw)
        assert paged.paged and pools.physical and pools.k_host is None
        dense = TS.ContinuousBatcher(m["tp"], m["tcfg"], monitor=mon,
                                     mirror_pages=True, paged=False, **kw)
        assert not dense.mirror_pages
        dense.submit(TS.Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                                max_new_tokens=2))
        dense.run()
        assert pools.free_pages == pools.n_logical
    elif case == "not_in_flight":
        mon = _mirror_stack("port", m["tcfg"])
        b = TS.ContinuousBatcher(m["tp"], m["tcfg"], monitor=mon,
                                 paged=False, mirror_pages=True, **kw)
        assert b.mirror_pages and b.macro is False
        with pytest.raises(KeyError):
            b.paged_context(7, _probe_q(m["tcfg"], 7, 0))
    else:
        cfg = dataclasses.replace(TC.reduced("xlstm-1.3b"), dtype="float32")
        params = TM.init(cfg, seed=0, device="cpu")
        mon = _mirror_stack("port", m["tcfg"])
        with pytest.raises(ValueError, match="full-attention"):
            TS.ContinuousBatcher(params, cfg, monitor=mon, paged=False,
                                 mirror_pages=True, **kw)
