"""The port's model against the JAX reference on a reduced qwen3-14b with
GQA (4 query heads over 2 KV heads) and one segment stacked over 2
repeats: the reference's parameters are carried over through
``repro_torch.bridge``, and forward, batched prefill, dense decode, paged
decode and greedy generation must agree.

Both the default activation dtype (bf16: the embedding rounds through
bf16, then the residual stream is float32) and an all-float32 config are
covered.  Tolerances: 1e-4 absolute on logits of magnitude ~5 and 1e-5 on
page masses (float32, different reduction orders)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.models import model as RM
from repro.serve.engine import generate as r_generate

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.models import model as TM
from repro_torch.serve.engine import generate as t_generate

LOGIT_TOL, MASS_TOL = 1e-4, 1e-5
# float32 relative term: two frameworks' summation orders on different CPUs
F32_RTOL = 4e-6


def _cfgs(dtype):
    kw = dict(num_kv_heads=2, segments=((("attn",), 2),))
    if dtype is not None:
        kw["dtype"] = dtype
    return (dataclasses.replace(RC.reduced("qwen3-14b"), **kw),
            dataclasses.replace(TC.reduced("qwen3-14b"), **kw))


_CACHE = {}


def _models(dtype):
    if dtype not in _CACHE:
        rcfg, tcfg = _cfgs(dtype)
        rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
        tp = bridge.from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                   device="cpu")
        _CACHE[dtype] = (rcfg, rp, tcfg, tp)
    return _CACHE[dtype]


def _close(t, r, tol, rtol=F32_RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(r), atol=tol,
                               rtol=rtol)


DTYPES = [None, "float32"]       # None = the registered default (bf16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_prefill_decode_match(dtype):
    rcfg, rp, tcfg, tp = _models(dtype)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab_size, (2, 11)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    _close(TM.forward(tp, tcfg, tt)[0], RM.forward(rp, rcfg, toks)[0],
           LOGIT_TOL)

    # batched prefill over right-padded rows, then dense decode steps
    lengths = np.asarray([11, 6], np.int32)
    rl, rc = RM.prefill_batched(rp, rcfg, jnp.asarray(toks),
                                jnp.asarray(lengths))
    tl, tc = TM.prefill_batched(tp, tcfg, tt, torch.from_numpy(lengths))
    _close(tl, rl, LOGIT_TOL)
    for name in ("k", "v", "pos"):
        a = np.asarray(rc["segments"][0][0][name])
        b = tc["segments"][0][0][name].numpy()
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=F32_RTOL)

    rl, rcache = RM.prefill(rp, rcfg, jnp.asarray(toks))
    tl, tcache = TM.prefill(tp, tcfg, tt)
    _close(tl, rl, LOGIT_TOL)
    rcache = RM.pad_cache(rcache, rcfg, 16)
    tcache = TM.pad_cache(tcache, tcfg, 16)
    pos = np.full((2,), 11, np.int32)
    tok = np.asarray(toks[:, -1:])
    for _ in range(3):
        rl, rcache = RM.decode_step(rp, rcfg, rcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = TM.decode_step(tp, tcfg, tcache,
                                    torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos).long())
        _close(tl, rl, LOGIT_TOL)
        tok = np.asarray(rl).argmax(-1).astype(np.int32)
        pos = pos + 1


def test_decode_from_empty_cache_matches():
    """Feeding a prompt token by token through ``decode_step`` from an
    empty ``init_cache`` agrees with the reference doing the same."""
    rcfg, rp, tcfg, tp = _models("float32")
    toks = np.random.default_rng(3).integers(0, rcfg.vocab_size, (2, 6)) \
        .astype(np.int32)
    rcache = RM.init_cache(rcfg, 2, 8, dtype=jnp.float32)
    tcache = TM.init_cache(tcfg, 2, 8, device="cpu")
    for i in range(toks.shape[1]):
        pos = np.full((2,), i, np.int32)
        rl, rcache = RM.decode_step(rp, rcfg, rcache,
                                    jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(pos))
        tl, tcache = TM.decode_step(tp, tcfg, tcache,
                                    torch.from_numpy(toks[:, i:i + 1]).long(),
                                    torch.from_numpy(pos).long())
        _close(tl, rl, LOGIT_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_paged_matches(dtype):
    """Identical pools and tables: logits, layer-averaged page mass and
    the write-through into both tiers agree; an inactive row (cur_pos -1)
    writes nothing and carries no mass."""
    rcfg, rp, tcfg, tp = _models(dtype)
    page, n_rows, hbm, n_logical = 4, 5, 12, 20
    r, kvh, hd = 2, rcfg.num_kv_heads, rcfg.head_dim
    rng = np.random.default_rng(1)
    pools = {f"{n}_{t}": rng.standard_normal(
                 (r, hbm if t == "hbm" else n_logical, page, kvh, hd))
             .astype(np.float32)
             for n in ("k", "v") for t in ("hbm", "host")}
    tables = np.asarray([[3, 7, 1, -1, -1],
                         [0, 2, 5, 9, 11],
                         [-1, -1, -1, -1, -1],
                         [4, 6, 8, 10, -1]], np.int32)
    gid_tables = np.where(tables >= 0, tables + 5, -1).astype(np.int32)
    cur_pos = np.asarray([9, 18, -1, 13], np.int32)
    tokens = rng.integers(0, rcfg.vocab_size, (4, 1)).astype(np.int32)

    rkv = {k: [jnp.asarray(v)] for k, v in pools.items()}
    rl, rkv2, rmass = RM.decode_step_paged(
        rp, rcfg, rkv, jnp.asarray(tables), jnp.asarray(gid_tables),
        jnp.asarray(tokens), jnp.asarray(cur_pos), page_size=page,
        impl="reference")
    # the port's leaves carry one sink page past the pages the tables
    # name (``SharedPagedPools.kv_with_sink``): rows that must not write
    # write there
    tkv = {k: [torch.from_numpy(np.concatenate([v, np.zeros_like(v[:, :1])],
                                               axis=1))]
           for k, v in pools.items()}
    tl, tmass = TM.decode_step_paged(
        tp, tcfg, tkv, torch.from_numpy(tables), torch.from_numpy(gid_tables),
        torch.from_numpy(tokens).long(), torch.from_numpy(cur_pos).long(),
        page_size=page)
    active = cur_pos >= 0
    _close(tl[active], np.asarray(rl)[active], LOGIT_TOL)
    _close(tmass, rmass, MASS_TOL, rtol=0)
    assert torch.count_nonzero(tmass[2]) == 0
    np.testing.assert_allclose(tmass.sum(dim=1).numpy()[active], 1.0,
                               atol=MASS_TOL)
    for k in pools:
        np.testing.assert_allclose(tkv[k][0][:, :-1].numpy(),
                                   np.asarray(rkv2[k][0]), atol=1e-5,
                                   rtol=F32_RTOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_generate_identical(dtype):
    rcfg, rp, tcfg, tp = _models(dtype)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, rcfg.vocab_size, (1, 7)).astype(np.int32)
    ref = np.asarray(r_generate(rp, rcfg, jnp.asarray(prompt), steps=8))
    got = t_generate(tp, tcfg, prompt, steps=8, device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)


def test_init_is_seeded_and_at_reference_scales():
    _, tcfg = _cfgs("float32")
    a = TM.init(tcfg, seed=3, device="cpu")
    b = TM.init(tcfg, seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
        assert not x.requires_grad
    slot = a.segments[0][0]
    assert slot.wq.shape == (2, tcfg.d_model,
                             tcfg.num_heads * tcfg.head_dim)
    assert abs(float(slot.wi_gate.std()) - tcfg.d_model ** -0.5) < 0.01
    # the reference's fan-in is shape[0] of ``wo [H, hd, d]``: H
    assert abs(float(slot.wo.std()) / tcfg.num_heads ** -0.5 - 1) < 0.05
    assert torch.all(slot.norm1 == 1)


@pytest.mark.parametrize("arch", ["paligemma-3b"])
def test_other_geometries_raise_not_implemented(arch):
    """A shared prefix under ``attention_impl="pallas"``: the flash kernel
    has no prefix-LM mask, so the port refuses it at init."""
    cfg = dataclasses.replace(TC.reduced(arch), attention_impl="pallas")
    with pytest.raises(NotImplementedError, match="prefix"):
        TM.init(cfg, device="cpu")


@pytest.mark.parametrize("arch,head_dim", [("stablelm-12b", 160),
                                           ("nemotron-4-340b", 192)])
def test_flash_route_takes_the_registered_head_dims(arch, head_dim):
    """The registered configs whose head dims are no power of two build
    under ``attention_impl="pallas"`` at those head dims (reduced
    widths otherwise), and their full-width configs pass the check."""
    assert TC.get(arch).head_dim == head_dim
    assert head_dim in TM.HEAD_DIMS
    TM.check_supported(dataclasses.replace(TC.get(arch),
                                           attention_impl="pallas"))
    cfg = dataclasses.replace(TC.reduced(arch), head_dim=head_dim,
                              attention_impl="pallas")
    params = TM.init(cfg, device="cpu")
    slot = params.segments[0][0]
    assert slot.wq.shape[-1] == cfg.num_heads * head_dim


@pytest.mark.parametrize("arch,change,match", [
    ("deepseek-v3-671b", {}, "MLA"),
    ("qwen3-14b", {"softcap": 30.0}, "softcap"),
    ("qwen3-14b", {"head_dim": 80}, "head dim"),
    ("qwen3-14b", {"head_dim": 288}, "head dim"),
    ("xlstm-1.3b", {}, None)])
def test_flash_route_refuses_what_its_kernel_cannot_take(arch, change,
                                                         match):
    """``attention_impl="pallas"`` raises for MLA slots (d_qk != d_v), a
    soft-cap and head dims outside ``HEAD_DIMS`` (80: no multiple of 32;
    288: above 256), which the flash kernel cannot take; the same
    configs build under ``"reference"``, and an unknown setting raises.
    A config without attention slots takes either setting (``match``
    None): full-width xlstm-1.3b, whose head dim of 512 no flash launch
    would see, is checked and gets the same pool leaves under both (its
    weights are not built: 13.9 GB)."""
    if match is None:
        full = TC.get(arch)
        pallas = dataclasses.replace(full, attention_impl="pallas")
        assert not TM.has_attention(full) and full.head_dim not in \
            TM.HEAD_DIMS
        TM.check_supported(pallas)
        assert TM.slot_leaf_specs(pallas, 16) == TM.slot_leaf_specs(full, 16)
        with pytest.raises(ValueError, match="attention_impl"):
            TM.check_supported(dataclasses.replace(full,
                                                   attention_impl="flash"))
        return
    cfg = dataclasses.replace(TC.reduced(arch), **change)
    TM.init(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        TM.init(dataclasses.replace(cfg, attention_impl="pallas"),
                device="cpu")
    with pytest.raises(ValueError, match="attention_impl"):
        TM.init(dataclasses.replace(cfg, attention_impl="flash"),
                device="cpu")


def test_flash_route_raises_on_softcap_after_init():
    """A soft-capped config switched to the flash route after init
    (``forward``, ``prefill`` and ``prefill_batched`` do not re-run
    ``check_supported``) raises in the layer, not uncapped attention."""
    cfg = dataclasses.replace(TC.reduced("qwen3-14b"), softcap=30.0)
    params = TM.init(cfg, device="cpu")
    flash = dataclasses.replace(cfg, attention_impl="pallas")
    toks = torch.zeros((1, 4), dtype=torch.long)
    TM.forward(params, cfg, toks)
    with pytest.raises(NotImplementedError, match="soft-cap"):
        TM.forward(params, flash, toks)
    with pytest.raises(NotImplementedError, match="soft-cap"):
        TM.prefill(params, flash, toks)


def test_cuda_default_raises_without_a_card(monkeypatch):
    """Entry points run on cuda unless asked otherwise, and raise when no
    card is visible instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init(tcfg)
