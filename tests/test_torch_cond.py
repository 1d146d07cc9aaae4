"""The port's cross-attention conditioning and its GELU / squared-ReLU
MLPs against the JAX reference.

Reduced ``musicgen-large`` (self-attention, then cross-attention to a
conditioning sequence of 4 positions, then a GELU MLP; untied
embeddings), reduced ``nemotron-4-340b`` (GQA with a squared-ReLU MLP)
and reduced ``stablelm-12b`` (plain GQA with SwiGLU, the registered
config at D 160 that no other test names), all float32, with the
reference's parameters carried over through ``repro_torch.bridge`` and
the same conditioning, drawn N(0, 1) in numpy from a seed, given to both
packages:

  * ``mlp_apply`` for each MLP kind and ``cross_attention`` (with a
    ``cond_dim`` of 48 beside a d_model of 64, and with qk-norm and a
    soft-cap) against the reference's ``mlp_apply`` and
    ``attention_apply(..., use_rope=False)``;
  * forward logits, batched prefill caches, prefill + dense decode, and
    the fully-paged decode step (logits, page mass, write-through into
    both tiers; the conditioning adds nothing to the mass);
  * musicgen's ``decode_body`` with ``cond`` under a host-read detector.

The ``ContinuousBatcher``'s streams against the reference batcher's
(``tests/test_torch_cond_batcher.py``) and against ``generate``, and
musicgen under ``attention_impl="pallas"``
(``tests/test_torch_cond_streams.py``), run on this file's models.

Tolerances: 1e-4 absolute on logits, 1e-5 on page masses, layer outputs
and caches (float32, different reduction orders)."""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.core.cori import OnlineTuner as RTuner
from repro.memtier.tiering import SharedPagedPools as RPools
from repro.memtier.tiering import TierConfig as RTierConfig
from repro.memtier.tiering import TieringManager as RManager
from repro.models import layers as RL
from repro.models import model as RM
from repro.serve import sched as RS

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.core.cori import OnlineTuner as TTuner
from repro_torch.memtier.tiering import SharedPagedPools as TPools
from repro_torch.memtier.tiering import TierConfig as TTierConfig
from repro_torch.memtier.tiering import TieringManager as TManager
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import sched as TS

ARCHS = ["musicgen-large", "nemotron-4-340b", "stablelm-12b"]
LOGIT_TOL, TOL = 1e-4, 1e-5
# float32 relative term: two frameworks' summation orders on different CPUs
F32_RTOL = 4e-6
N_LOGICAL, HBM, PAGE = 48, 10, 4
PROMPT_LENS = (6, 9, 5, 11)
NEW = (6, 4, 9, 7)

_CACHE = {}


def _models(arch):
    if arch not in _CACHE:
        rcfg = dataclasses.replace(RC.reduced(arch), dtype="float32")
        tcfg = dataclasses.replace(TC.reduced(arch), dtype="float32")
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
        _CACHE[arch] = dict(rcfg=rcfg, rp=rp, tcfg=tcfg, tp=tp,
                            prompts=prompts, cond=cond)
    return _CACHE[arch]


def _close(t, r, tol, rtol=F32_RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(r), atol=tol,
                               rtol=rtol)


def _cond_rows(m, b):
    """The arch's conditioning broadcast to ``b`` rows: (reference's,
    port's), both None without one."""
    if m["cond"] is None:
        return None, None
    c = np.ascontiguousarray(np.broadcast_to(
        m["cond"], (b,) + m["cond"].shape[1:]))
    return jnp.asarray(c), torch.from_numpy(c)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _mlp_leaves(tree):
    """A reference MLP's leaves as the port's, stacked [1, ...] (repeat
    0): its ``wo`` is ``w_down``."""
    return types.SimpleNamespace(**{
        "w_down" if name == "wo" else name:
            torch.tensor(np.asarray(a, np.float32))[None]
        for name, a in tree.items()})


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "squared_relu"])
def test_mlp_matches_reference(kind):
    """Each MLP kind against the reference's ``mlp_apply``: GELU is the
    tanh form (``jax.nn.gelu``'s default), which the exact erf form would
    miss by more than the bar at these activations."""
    cfg = dataclasses.replace(RC.reduced("stablelm-12b"), mlp_kind=kind)
    rp, _ = RL.mlp_init(jax.random.PRNGKey(4), cfg)
    x = np.random.default_rng(4).standard_normal((2, 5, cfg.d_model)) \
        .astype(np.float32) * 3
    ry = RL.mlp_apply(rp, cfg, jnp.asarray(x))
    p = _mlp_leaves(rp)
    ty = TL.mlp_apply(p, 0, cfg, torch.from_numpy(x))
    _close(ty, ry, TOL)
    if kind == "gelu":
        erf = torch.nn.functional.gelu(torch.from_numpy(x) @ p.wi[0]) \
            @ p.w_down[0]
        assert float((erf - ty).abs().max()) > LOGIT_TOL


@pytest.mark.parametrize("cond_dim,qk_norm,softcap,s", [
    (48, False, 0.0, 7), (48, False, 0.0, 1), (64, True, 0.0, 5),
    (48, True, 5.0, 3)])
def test_cross_attention_matches_reference(cond_dim, qk_norm, softcap, s):
    """``cross_attention`` against the reference's ``attention_apply`` with
    the cross leaves, no rotary and an all-true mask; a ``cond_dim``
    unlike d_model gives ``wk``/``wv`` their own fan-in and row count,
    carried by the bridge's reshape (both musicgen configs have
    ``cond_dim == d_model``, which would hide a wrongly shaped leaf)."""
    cfg = dataclasses.replace(RC.reduced("musicgen-large"), cond_dim=cond_dim,
                              qk_norm=qk_norm, softcap=softcap,
                              num_kv_heads=2)
    rp, _ = RL.attention_init(jax.random.PRNGKey(5), cfg, cross=True)
    assert rp["wk"].shape[0] == cond_dim
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    cond = rng.standard_normal((2, cfg.cond_len, cond_dim)) \
        .astype(np.float32)
    if qk_norm:   # norms away from one, so both are applied
        rp = dict(rp, q_norm=jnp.asarray(rng.uniform(0.5, 1.5, 16),
                                         jnp.float32),
                  k_norm=jnp.asarray(rng.uniform(0.5, 1.5, 16), jnp.float32))
    pos = jnp.arange(s)[None] + 3
    ro, _ = RL.attention_apply(
        rp, cfg, jnp.asarray(x), jnp.asarray(cond), pos,
        jnp.ones((1, s, cfg.cond_len), bool),
        kv_positions=jnp.arange(cfg.cond_len)[None], use_rope=False)
    xattn = TM.CrossAttention(cfg, 1, "cpu")
    with torch.no_grad():
        for name, t in xattn.named_parameters():
            t.copy_(torch.tensor(np.asarray(rp[name])).reshape(t.shape))
    assert xattn.wk.shape == (1, cond_dim, cfg.num_kv_heads * cfg.head_dim)
    to = TL.cross_attention(xattn, 0, cfg, torch.from_numpy(x),
                            torch.from_numpy(cond))
    _close(to, ro, TOL)


def test_cross_attention_leaves_bridge_at_cond_dim():
    """A musicgen slot with ``cond_dim`` 48: the bridge carries
    ``norm_x`` and every ``xattn`` leaf at the reference's shapes, and the
    model's logits (conditioned) match the reference's."""
    rcfg = dataclasses.replace(RC.reduced("musicgen-large"), cond_dim=48,
                               dtype="float32")
    tcfg = dataclasses.replace(TC.reduced("musicgen-large"), cond_dim=48,
                               dtype="float32")
    rp, _ = RM.init(jax.random.PRNGKey(1), rcfg)
    tp = bridge.from_reference(jax.tree.map(np.asarray, rp), tcfg,
                               device="cpu")
    slot = tp.segments[0][0]
    assert slot.xattn.wk.shape == slot.xattn.wv.shape == (
        1, 48, tcfg.num_kv_heads * tcfg.head_dim)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, rcfg.vocab_size, (2, 7)).astype(np.int32)
    cond = rng.standard_normal((2, rcfg.cond_len, 48)).astype(np.float32)
    rl, _ = RM.forward(rp, rcfg, toks, cond=jnp.asarray(cond))
    tl, _ = TM.forward(tp, tcfg, torch.from_numpy(toks).long(),
                       cond=torch.from_numpy(cond))
    _close(tl, rl, LOGIT_TOL)


def test_init_is_seeded_and_at_reference_scales():
    """Seeded init; the cross-attention leaves at N(0, 1/fan_in) with the
    reference's fan-ins (``wk``'s is cond_dim, ``wo``'s H), the GELU /
    squared-ReLU MLP's ``wi`` d and ``w_down`` d_ff; norms one; no SwiGLU
    leaves on a non-SwiGLU config."""
    cfg = dataclasses.replace(TC.reduced("musicgen-large"), cond_dim=48,
                              dtype="float32")
    a = TM.init(cfg, seed=3, device="cpu")
    b = TM.init(cfg, seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    slot = a.segments[0][0]
    for t, fan in ((slot.xattn.wq, cfg.d_model), (slot.xattn.wk, 48),
                   (slot.xattn.wv, 48), (slot.xattn.wo, cfg.num_heads),
                   (slot.wi, cfg.d_model), (slot.w_down, cfg.d_ff)):
        assert abs(float(t.std()) / fan ** -0.5 - 1) < 0.1, (t.shape, fan)
    assert torch.all(slot.norm_x == 1)
    assert not hasattr(slot, "wi_gate") and not hasattr(slot, "wi_up")
    full = TC.get("musicgen-large")
    assert (full.num_layers, full.cond_len, full.cond_dim, full.mlp_kind) \
        == (48, 64, 2048, "gelu")


def test_check_supported_accepts_the_new_archs():
    """``check_supported`` takes musicgen-large, nemotron-4-340b and
    stablelm-12b as registered, and every other registered config too,
    paligemma-3b's shared prefix included."""
    for arch in ARCHS:
        TM.check_supported(TC.get(arch))
    for arch in TC.ARCHS:
        TM.check_supported(TC.get(arch))
    assert TC.get("paligemma-3b").prefix_len == 256


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match(arch):
    m = _models(arch)
    rcfg, rp, tcfg, tp = m["rcfg"], m["rp"], m["tcfg"], m["tp"]
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (2, 11)) \
        .astype(np.int32)
    tt = torch.from_numpy(toks).long()
    rc, tc = _cond_rows(m, 2)
    _close(TM.forward(tp, tcfg, tt, cond=tc)[0],
           RM.forward(rp, rcfg, toks, cond=rc)[0], LOGIT_TOL)

    lengths = np.asarray([11, 6], np.int32)
    rl, rcache = RM.prefill_batched(rp, rcfg, jnp.asarray(toks),
                                    jnp.asarray(lengths), cond=rc)
    tl, tcache = TM.prefill_batched(tp, tcfg, tt, torch.from_numpy(lengths),
                                    cond=tc)
    _close(tl, rl, LOGIT_TOL)
    for t, r in zip(tcache["segments"][0], rcache["segments"][0]):
        assert sorted(t) == sorted(r)
        for name, a in t.items():
            np.testing.assert_allclose(a.numpy(), np.asarray(r[name]),
                                       atol=TOL, rtol=F32_RTOL)

    rl, rcache = RM.prefill(rp, rcfg, jnp.asarray(toks), cond=rc)
    tl, tcache = TM.prefill(tp, tcfg, tt, cond=tc)
    _close(tl, rl, LOGIT_TOL)
    rcache = RM.pad_cache(rcache, rcfg, 16)
    tcache = TM.pad_cache(tcache, tcfg, 16)
    pos = np.full((2,), 11, np.int32)
    tok = toks[:, -1:]
    for _ in range(3):
        rl, rcache = RM.decode_step(rp, rcfg, rcache, jnp.asarray(tok),
                                    jnp.asarray(pos), cond=rc)
        tl, tcache = TM.decode_step(tp, tcfg, tcache,
                                    torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos).long(), cond=tc)
        _close(tl, rl, LOGIT_TOL)
        tok = np.asarray(rl).argmax(-1).astype(np.int32)
        pos = pos + 1


def test_conditioning_reaches_the_logits():
    """musicgen's logits move with its conditioning, and without one its
    cross-attention is skipped on both sides, as the reference's."""
    m = _models("musicgen-large")
    rcfg, rp, tcfg, tp = m["rcfg"], m["rp"], m["tcfg"], m["tp"]
    toks = np.random.default_rng(8).integers(0, rcfg.vocab_size, (2, 5)) \
        .astype(np.int32)
    tt = torch.from_numpy(toks).long()
    _, tc = _cond_rows(m, 2)
    with_cond = TM.forward(tp, tcfg, tt, cond=tc)[0]
    other = TM.forward(tp, tcfg, tt, cond=tc * 2 + 1)[0]
    without = TM.forward(tp, tcfg, tt)[0]
    assert float((with_cond - other).abs().max()) > 100 * LOGIT_TOL
    assert float((with_cond - without).abs().max()) > 100 * LOGIT_TOL
    _close(without, RM.forward(rp, rcfg, toks)[0], LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_matches(arch):
    """Identical pools and tables and the same conditioning rows: logits,
    layer-averaged page mass and the write-through into both tiers agree;
    an inactive row writes nothing and carries no mass, and each active
    row's mass sums to 1 (cross-attention adds none)."""
    m = _models(arch)
    rcfg, rp, tcfg, tp = m["rcfg"], m["rp"], m["tcfg"], m["tp"]
    page, hbm, n_logical = 4, 12, 20
    tables = np.asarray([[3, 7, 1, -1, -1],
                         [0, 2, 5, 9, 11],
                         [-1, -1, -1, -1, -1],
                         [4, 6, 8, 10, -1]], np.int32)
    rng = np.random.default_rng(1)
    specs = TM.slot_leaf_specs(tcfg, page)
    assert specs == [(r, {k: tuple(v) for k, v in lv.items()})
                     for r, lv in RM.slot_leaf_specs(rcfg, page)]
    pools = {}
    for r, leaves in specs:
        for name, trail in leaves.items():
            for tier, n in (("hbm", hbm), ("host", n_logical)):
                pools.setdefault(f"{name}_{tier}", []).append(
                    rng.standard_normal((r, n) + trail).astype(np.float32))
    gid_tables = np.where(tables >= 0, tables + 5, -1).astype(np.int32)
    cur_pos = np.asarray([9, 18, -1, 13], np.int32)
    tokens = rng.integers(0, rcfg.vocab_size, (4, 1)).astype(np.int32)
    rc, tc = _cond_rows(m, 4)

    rkv = {k: [jnp.asarray(a) for a in v] for k, v in pools.items()}
    rl, rkv2, rmass = RM.decode_step_paged(
        rp, rcfg, rkv, jnp.asarray(tables), jnp.asarray(gid_tables),
        jnp.asarray(tokens), jnp.asarray(cur_pos), page_size=page,
        impl="reference", cond=rc)
    # one sink page past the pages the tables name, as
    # ``SharedPagedPools.kv_with_sink``
    tkv = {k: [torch.from_numpy(np.concatenate(
                   [a, np.zeros_like(a[:, :1])], axis=1)) for a in v]
           for k, v in pools.items()}
    tl, tmass = TM.decode_step_paged(
        tp, tcfg, tkv, torch.from_numpy(tables), torch.from_numpy(gid_tables),
        torch.from_numpy(tokens).long(), torch.from_numpy(cur_pos).long(),
        page_size=page, cond=tc)
    active = cur_pos >= 0
    _close(tl[active], np.asarray(rl)[active], LOGIT_TOL)
    _close(tmass, rmass, TOL, rtol=0)
    assert torch.count_nonzero(tmass[2]) == 0
    np.testing.assert_allclose(tmass.sum(dim=1).numpy()[active], 1.0,
                               atol=TOL)
    for k in pools:
        for t, r in zip(tkv[k], rkv2[k]):
            np.testing.assert_allclose(t[:, :-1].numpy(), np.asarray(r),
                                       atol=TOL, rtol=F32_RTOL)


class _NoHostReads(TorchDispatchMode):
    """Fails on an op that reads a value back to the host or has a
    data-dependent shape (a sync on a card, which a graph cannot hold)."""

    def __torch_dispatch__(self, func, types=(), args=(), kwargs=None):
        if func.overloadpacket.__name__ in ("_local_scalar_dense",
                                            "nonzero", "is_nonzero"):
            raise AssertionError(f"host read in the step body: {func}")
        return func(*args, **(kwargs or {}))


def test_decode_body_with_cond_reads_nothing_back():
    """musicgen's ``decode_body`` (what the CUDA graph captures), the
    conditioning rows included, makes no host read over three steps."""
    m = _models("musicgen-large")
    tcfg, tp = m["tcfg"], m["tp"]
    _, tc = _cond_rows(m, 2)
    pools = TPools.create(N_LOGICAL, HBM)
    pools.attach_layered(TM.slot_leaf_specs(tcfg, PAGE), device="cpu")
    for leaves in pools.kv_with_sink.values():
        for t in leaves:
            t.normal_(generator=torch.Generator().manual_seed(2))
    tables = torch.tensor([[3, 7, 1], [0, 2, 5]], dtype=torch.int32)
    gids = tables + 5
    c = TM.MacroCarry.empty(2, 3, 4, "cpu")
    c.load(tokens=torch.tensor([[5], [9]]), cur_pos=torch.tensor([5, 7]),
           seeds=torch.tensor([1, 2]), iters=torch.tensor([0, 0]),
           emitted=torch.tensor([1, 1]), max_new=torch.tensor([9, 9]),
           eos_ids=torch.tensor([-1, -1]), temps=torch.tensor([0.0, 0.0]))
    with _NoHostReads():
        for _ in range(3):
            TM.decode_body(tp, tcfg, pools.kv_with_sink, tables, gids, c,
                           page_size=PAGE, cond=tc)
    assert c.pos.tolist() == [8, 10]
    assert bool((c.toks_out[:3] >= 0).all())


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
    """Serve the four requests with two rows under the session's
    conditioning: two submitted up front, the others joining mid-flight
    (staggered, recycled rows)."""
    m = _models(arch)
    tcfg = dataclasses.replace(m["tcfg"], attention_impl=attention_impl)
    mon = _stack(side)
    if side == "ref":
        b = RS.ContinuousBatcher(m["rp"], m["rcfg"], max_active=2,
                                 max_len=32, page_size=PAGE, monitor=mon,
                                 paged_impl="reference", macro=macro,
                                 cond=m["cond"])
        mk = lambda i: RS.Request(rid=i, prompt=m["prompts"][i],
                                  max_new_tokens=NEW[i],
                                  key=jax.random.PRNGKey(0))
    else:
        b = TS.ContinuousBatcher(m["tp"], tcfg, max_active=2,
                                 max_len=32, page_size=PAGE, monitor=mon,
                                 macro=macro, cond=m["cond"], device="cpu")
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
    return got, mon


# ---------------------------------------------------------------------------
# musicgen through the flash route
# ---------------------------------------------------------------------------


