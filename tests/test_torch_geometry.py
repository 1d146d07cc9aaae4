"""The port's MLA, MoE, sliding-window and recurrent geometries against
the JAX reference: the models and the checks the family files share.

The cases live in files of a family each, of at most seven tests, so
that ``--dist loadfile`` spreads them over workers:
``test_torch_geometry_mla.py`` and ``test_torch_geometry_mla_serve.py``
(reduced ``deepseek-v3-671b``: every layer MLA; one dense-MLP segment and
one MoE segment with a shared expert), ``test_torch_geometry_moe.py``
(reduced ``olmoe-1b-7b``: k/v attention with qk-norm, every layer MoE
without a shared expert), ``test_torch_geometry_window.py`` and
``test_torch_geometry_window_serve.py`` (reduced ``gemma3-12b``: five
sliding-window layers of window 8 and one global layer, qk-norm, SwiGLU,
tied embeddings; the prompts of 9 and 11 tokens are longer than the
window and 11 % 8 = 3 exercises the ring's roll),
``test_torch_geometry_rglru.py`` (reduced ``recurrentgemma-2b``: RG-LRU,
RG-LRU, local attention of window 8, then two RG-LRU: the prompts pass
the window too) and ``test_torch_geometry_xlstm.py`` (reduced
``xlstm-1.3b``: seven mLSTM and one sLSTM, no MLP sublayer, no token
pages).  This file holds the bridged models, the serving loop, the checks
a case runs on one arch, and the pools over mixed geometries.

All float32, with the reference's parameters carried over through
``repro_torch.bridge``.  The reference initialises every recurrent cell's
conv taps to zero, and with them all three cells output exactly zero and
keep zero states (``tests/test_torch_recurrent.py`` shows it): these
tests draw the taps from N(0, 0.5) in numpy from the seed and set them in
the reference's parameters before the bridge, so the cells' arithmetic
is what they compare.

On the CPU the paged layers run the kernels' plain versions.  Tolerances:
1e-4 absolute on logits, 1e-5 on page masses, MoE outputs and caches
(float32, different reduction orders: over a sequence the routed MoE
sums a token's experts in expert order, the reference in top-k order; a
decode step sums them in top-k order, ``tests/test_torch_moe.py``)."""
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
from repro.models import moe as RMoE
from repro.serve import sched as RS
from repro.serve.engine import generate as r_generate

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.core.cori import OnlineTuner as TTuner
from repro_torch.memtier.tiering import SharedPagedPools as TPools
from repro_torch.memtier.tiering import TierConfig as TTierConfig
from repro_torch.memtier.tiering import TieringManager as TManager
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.serve import sched as TS
from repro_torch.serve.engine import generate as t_generate

from repro_torch.serve.engine import generate as t_generate

MOE_ARCHS = ["deepseek-v3-671b", "olmoe-1b-7b"]
ARCHS = MOE_ARCHS + ["gemma3-12b"]
RECURRENT_ARCHS = ["recurrentgemma-2b", "xlstm-1.3b"]
SERVED = ARCHS + RECURRENT_ARCHS
CONV_STD = 0.5
LOGIT_TOL, TOL = 1e-4, 1e-5
# float32 relative term: two frameworks' summation orders on different CPUs
F32_RTOL = 4e-6
N_LOGICAL, HBM, PAGE = 48, 10, 4
PROMPT_LENS = (6, 9, 5, 11)
NEW = (6, 4, 9, 7)

_CACHE, _REF_RUNS = {}, {}


def _models(arch):
    if arch not in _CACHE:
        rcfg = dataclasses.replace(RC.reduced(arch), dtype="float32")
        tcfg = dataclasses.replace(TC.reduced(arch), dtype="float32")
        rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
        if arch in RECURRENT_ARCHS:
            rp = jax.tree.map(np.asarray, rp)
            _perturb_conv(rp, np.random.default_rng(7))
            rp = jax.tree.map(jnp.asarray, rp)
        tp = bridge.from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                   device="cpu")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32)
                   for n in PROMPT_LENS]
        _CACHE[arch] = dict(rcfg=rcfg, rp=rp, tcfg=tcfg, tp=tp,
                            prompts=prompts)
    return _CACHE[arch]


def _perturb_conv(ref_params, rng) -> None:
    """Non-zero conv taps, N(0, CONV_STD), in every recurrent cell of the
    reference's (numpy) parameters: the reference's zero init would make
    every cell an identity on the residual stream."""
    for seg in ref_params["segments"]:
        for slot in seg:
            if "cell" in slot:
                conv = slot["cell"]["conv"]
                slot["cell"]["conv"] = rng.normal(
                    0.0, CONV_STD, conv.shape).astype(np.float32)


def _close(t, r, tol, rtol=F32_RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(r), atol=tol,
                               rtol=rtol)


def _slot(m, si):
    """(reference slot params at repeat 0, the port's slot)."""
    ref = jax.tree.map(lambda a: a[0], m["rp"]["segments"][si][0])
    return ref, m["tp"].segments[si][0]


def _moe_segment(arch):
    return 1 if arch == "deepseek-v3-671b" else 0



# ---------------------------------------------------------------------------
# the checks a case runs on one arch
# ---------------------------------------------------------------------------


def _check_moe_dense(arch):
    """Routed MoE == the reference's dense oracle: outputs (shared expert
    included for deepseek) and the load-balance aux loss."""
    m = _models(arch)
    ref, slot = _slot(m, _moe_segment(arch))
    x = np.random.default_rng(1).standard_normal(
        (3, 7, m["rcfg"].d_model)).astype(np.float32)
    ry, raux = RMoE.moe_apply_dense(ref["moe"], m["rcfg"], jnp.asarray(x))
    ty, taux = TMoE.moe_apply(slot.moe, 0, m["tcfg"], torch.from_numpy(x))
    _close(ty, ry, TOL)
    assert abs(float(taux) - float(raux)) < TOL


def _check_forward_prefill_decode(arch):
    """Forward (logits and aux), batched prefill (refused by a recurrent
    config), prefill caches and three dense decode steps."""
    m = _models(arch)
    rcfg, rp, tcfg, tp = m["rcfg"], m["rp"], m["tcfg"], m["tp"]
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (2, 11)) \
        .astype(np.int32)
    tt = torch.from_numpy(toks).long()
    rl, raux = RM.forward(rp, rcfg, toks)
    tl, taux = TM.forward(tp, tcfg, tt)
    _close(tl, rl, LOGIT_TOL)
    assert abs(float(taux) - float(raux)) < TOL
    assert (float(taux) > 0) == (arch in MOE_ARCHS)   # aux of MoE layers

    lengths = np.asarray([11, 6], np.int32)
    if arch in RECURRENT_ARCHS:
        # a recurrent cell would fold the padding into its state
        assert not TM.batched_prefill_supported(tcfg)
        for fn, p, c, t, ln in ((RM.prefill_batched, rp, rcfg, toks, lengths),
                                (TM.prefill_batched, tp, tcfg, tt,
                                 torch.from_numpy(lengths))):
            with pytest.raises(ValueError, match="batched prefill"):
                fn(p, c, t, ln)
    else:
        rl, rc = RM.prefill_batched(rp, rcfg, jnp.asarray(toks),
                                    jnp.asarray(lengths))
        tl, tc = TM.prefill_batched(tp, tcfg, tt, torch.from_numpy(lengths))
        _close(tl, rl, LOGIT_TOL)
        for si, seg in enumerate(tc["segments"]):
            for name, a in seg[0].items():
                np.testing.assert_allclose(
                    a.numpy(), np.asarray(rc["segments"][si][0][name]),
                    atol=TOL, rtol=F32_RTOL)

    rl, rcache = RM.prefill(rp, rcfg, jnp.asarray(toks))
    tl, tcache = TM.prefill(tp, tcfg, tt)
    _close(tl, rl, LOGIT_TOL)
    if arch in RECURRENT_ARCHS:
        # every slot's cache: a local ring's rows, or a cell's final state
        for tseg, rseg in zip(tcache["segments"], rcache["segments"]):
            for t, r in zip(tseg, rseg):
                assert sorted(t) == sorted(r)
                for name, a in t.items():
                    np.testing.assert_allclose(a.numpy(), np.asarray(r[name]),
                                               atol=TOL, rtol=F32_RTOL)
    rcache = RM.pad_cache(rcache, rcfg, 16)
    tcache = TM.pad_cache(tcache, tcfg, 16)
    pos = np.full((2,), 11, np.int32)
    tok = toks[:, -1:]
    for _ in range(3):
        rl, rcache = RM.decode_step(rp, rcfg, rcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = TM.decode_step(tp, tcfg, tcache,
                                    torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos).long())
        _close(tl, rl, LOGIT_TOL)
        tok = np.asarray(rl).argmax(-1).astype(np.int32)
        pos = pos + 1


def _check_decode_step_paged(arch):
    """Identical pools and tables: logits, layer-averaged page mass and
    the write-through into both tiers (ckv/krope for MLA, the packed
    state page for a recurrent cell, at its ``state_cols`` column) agree;
    an inactive row writes nothing and carries no mass."""
    m = _models(arch)
    rcfg, rp, tcfg, tp = m["rcfg"], m["rp"], m["tcfg"], m["tp"]
    page, hbm, n_logical = 4, 12, 20
    tables = np.asarray([[3, 7, 1, -1, -1],
                         [0, 2, 5, 9, 11],
                         [-1, -1, -1, -1, -1],
                         [4, 6, 8, 10, -1]], np.int32)
    state_cols = None
    if arch in RECURRENT_ARCHS:
        # a sixth column holds each live row's state page
        hbm, n_logical = 16, 24
        tables = np.concatenate([tables, [[12], [13], [-1], [14]]], axis=1) \
            .astype(np.int32)
        state_cols = np.full((4,), tables.shape[1] - 1, np.int32)
    rng = np.random.default_rng(1)
    specs = TM.slot_leaf_specs(tcfg, page)
    assert specs == [(r, {k: tuple(v) for k, v in lv.items()})
                     for r, lv in RM.slot_leaf_specs(rcfg, page)]
    # one leaf list per name over every slot, None where a slot lacks the
    # leaf (recurrentgemma mixes k/v and state slots), as the pools hold
    names = list(dict.fromkeys(n for _, lv in specs for n in lv))
    pools = {f"{n}_{t}": [] for n in names for t in ("hbm", "host")}
    for r, leaves in specs:
        for name in names:
            for tier, n in (("hbm", hbm), ("host", n_logical)):
                if name not in leaves:
                    pools[f"{name}_{tier}"].append(None)
                    continue
                shape = (r, n) + leaves[name]
                # packed states in [0.5, 1.5): the sLSTM's normaliser n
                # stays clear of its 1e-6 floor
                draw = (rng.uniform(0.5, 1.5, shape) if name == "state"
                        else rng.standard_normal(shape))
                pools[f"{name}_{tier}"].append(draw.astype(np.float32))
    gid_tables = np.where(tables >= 0, tables + 5, -1).astype(np.int32)
    cur_pos = np.asarray([9, 18, -1, 13], np.int32)
    tokens = rng.integers(0, rcfg.vocab_size, (4, 1)).astype(np.int32)

    rkv = {k: [None if a is None else jnp.asarray(a) for a in v]
           for k, v in pools.items()}
    rl, rkv2, rmass = RM.decode_step_paged(
        rp, rcfg, rkv, jnp.asarray(tables), jnp.asarray(gid_tables),
        jnp.asarray(tokens), jnp.asarray(cur_pos), page_size=page,
        impl="reference", state_cols=(None if state_cols is None
                                      else jnp.asarray(state_cols)))
    # one sink page past the pages the tables name, as
    # ``SharedPagedPools.kv_with_sink``
    tkv = {k: [None if a is None else torch.from_numpy(
                   np.concatenate([a, np.zeros_like(a[:, :1])], axis=1))
               for a in v]
           for k, v in pools.items()}
    tl, tmass = TM.decode_step_paged(
        tp, tcfg, tkv, torch.from_numpy(tables), torch.from_numpy(gid_tables),
        torch.from_numpy(tokens).long(), torch.from_numpy(cur_pos).long(),
        page_size=page, state_cols=(None if state_cols is None
                                    else torch.from_numpy(state_cols)))
    active = cur_pos >= 0
    _close(tl[active], np.asarray(rl)[active], LOGIT_TOL)
    _close(tmass, rmass, TOL, rtol=0)
    assert torch.count_nonzero(tmass[2]) == 0
    np.testing.assert_allclose(tmass.sum(dim=1).numpy()[active], 1.0,
                               atol=TOL)
    for k in pools:
        for t, r in zip(tkv[k], rkv2[k]):
            if t is not None:
                np.testing.assert_allclose(t[:, :-1].numpy(), np.asarray(r),
                                           atol=TOL, rtol=F32_RTOL)


def _check_init_scales(arch):
    """Seeded init; each MLA / MoE leaf at N(0, 1/fan_in) with the
    reference's fan-in (``shape[0]`` of the unstacked leaf)."""
    cfg = TC.get(arch)
    tcfg = dataclasses.replace(TC.reduced(arch), dtype="float32")
    a = TM.init(tcfg, seed=3, device="cpu")
    b = TM.init(tcfg, seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    moe_slot = a.segments[_moe_segment(arch)][0]
    mo = tcfg.moe
    assert moe_slot.moe.wi_gate.shape == (1, mo.num_experts, tcfg.d_model,
                                          mo.d_expert)
    checks = [(moe_slot.moe.wi_gate, mo.num_experts),
              (moe_slot.moe.router, tcfg.d_model)]
    if cfg.mla is not None:
        mla = a.segments[0][0]
        checks += [(mla.wo, tcfg.num_heads), (mla.w_uk, tcfg.mla.kv_lora_rank),
                   (mla.w_dq, tcfg.d_model)]
        assert torch.all(mla.kv_norm == 1) and torch.all(mla.q_norm == 1)
        assert cfg.num_layers == 61
    for t, fan in checks:
        assert abs(float(t.std()) / fan ** -0.5 - 1) < 0.1, (t.shape, fan)



# ---------------------------------------------------------------------------
# the serving loop
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


def _serve(arch, side, macro, temps=(0.0, 0.0, 0.0, 0.0),
           attention_impl="reference"):
    """Serve the four requests with two rows: two submitted up front, the
    others joining mid-flight (staggered, recycled rows).  The reference's
    run of an (arch, macro) pair (greedy, whatever ``temps`` says) is made
    once and shared."""
    if side == "ref" and (arch, macro) in _REF_RUNS:
        return _REF_RUNS[arch, macro]
    m = _models(arch)
    tcfg = dataclasses.replace(m["tcfg"], attention_impl=attention_impl)
    mon = _stack(side)
    if side == "ref":
        b = RS.ContinuousBatcher(m["rp"], m["rcfg"], max_active=2,
                                 max_len=32, page_size=PAGE, monitor=mon,
                                 paged_impl="reference", macro=macro)
        mk = lambda i: RS.Request(rid=i, prompt=m["prompts"][i],
                                  max_new_tokens=NEW[i],
                                  key=jax.random.PRNGKey(0))
    else:
        b = TS.ContinuousBatcher(m["tp"], tcfg, max_active=2,
                                 max_len=32, page_size=PAGE, monitor=mon,
                                 macro=macro, device="cpu")
        mk = lambda i: TS.Request(rid=i, prompt=m["prompts"][i],
                                  max_new_tokens=NEW[i],
                                  temperature=temps[i], seed=100 + i)
    b.submit(mk(0))
    b.submit(mk(1))
    for t in range(200):
        if t in (1, 3):
            b.submit(mk(2 if t == 1 else 3))
        b.step()
        if t > 3 and not b.queue and not b.active:
            break
    got = {r.rid: list(r.tokens) for r in b.completed}
    assert sorted(got) == [0, 1, 2, 3]
    assert mon.pools.free_pages == N_LOGICAL
    if side == "ref":
        _REF_RUNS[arch, macro] = got, mon
    return got, mon


LEAVES = {"deepseek-v3-671b": {"ckv", "krope"},
          "recurrentgemma-2b": {"k", "v", "state"}, "xlstm-1.3b": {"state"}}



def _check_batcher_greedy(arch, macro):
    """Greedy streams rid for rid, migrations, hits, misses and the
    tuner's history equal the reference batcher's; the pools carry the
    slots' own leaves (two planes per migrated page with k/v or ckv/krope
    leaves, one for state pages alone)."""
    ref, ref_mon = _serve(arch, "ref", macro)
    port, port_mon = _serve(arch, "port", macro)
    assert port == ref
    for key in ("migrations", "data_moved_pages", "hits", "misses"):
        assert getattr(port_mon.manager, key) \
            == getattr(ref_mon.manager, key), key
    assert port_mon.tuner.history == ref_mon.tuner.history
    leaves = {k.rsplit("_", 1)[0] for k in port_mon.pools.kv_layers}
    assert leaves == LEAVES.get(arch, {"k", "v"})
    assert port_mon.pools.move_planes == ref_mon.pools.move_planes \
        == (1 if arch == "xlstm-1.3b" else 2)


def _check_batcher_generate(arch):
    """Greedy rows equal the reference's ``generate``; a sampled row draws
    the same tokens on the port's per-token path, macro path and
    ``generate``."""
    m = _models(arch)
    temps = (0.0, 0.8, 0.0, 0.8)
    per_token, _ = _serve(arch, "port", False, temps)
    macro, _ = _serve(arch, "port", True, temps)
    assert per_token == macro
    for i, p in enumerate(m["prompts"]):
        got = t_generate(m["tp"], m["tcfg"], p[None], steps=NEW[i],
                         temperature=temps[i], seed=100 + i,
                         device="cpu")[0].tolist()
        assert macro[i] == got, i
        if temps[i] == 0:
            ref = np.asarray(r_generate(m["rp"], m["rcfg"],
                                        jnp.asarray(p[None]),
                                        steps=NEW[i]))[0].tolist()
            assert got == ref, i



# ---------------------------------------------------------------------------
# pools over mixed geometries
# ---------------------------------------------------------------------------


def test_mixed_geometry_pools_hold_none_and_migrate():
    """Pools over k/v and MLA slots side by side: a slot lacking a leaf
    holds None there, as the reference's pools, and a migration copies
    every present leaf of every layer."""
    page = 4
    specs = [(1, {"k": (page, 2, 8), "v": (page, 2, 8)}),
             (2, {"ckv": (page, 16), "krope": (page, 8)})]
    ref = RPools.create(12, 6)
    ref.attach_layered(specs, dtype=jnp.float32)
    pools = TPools.create(12, 6)
    pools.attach_layered(specs, dtype=torch.float32, device="cpu")
    assert sorted(pools.kv_layers) == sorted(ref.kv_layers)
    for name, leaves in pools.kv_layers.items():
        assert [t is None for t in leaves] \
            == [t is None for t in ref.kv_layers[name]], name
    assert pools.move_planes == ref.move_planes == 2
    for leaves in pools.kv_layers.values():
        for t in leaves:
            if t is not None:
                t.normal_()
    pools.migrate_slots([4, 1], [7, 2])
    for name in ("k", "v", "ckv", "krope"):
        for hbm, host in zip(pools.kv_layers[f"{name}_hbm"],
                             pools.kv_layers[f"{name}_host"]):
            if hbm is not None:
                assert torch.equal(hbm[:, [4, 1]], host[:, [7, 2]])

