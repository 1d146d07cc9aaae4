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


def _close(t, r, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(r), atol=tol,
                               rtol=0)


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
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)

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
    tkv = {k: [torch.from_numpy(v.copy())] for k, v in pools.items()}
    tl, tmass = TM.decode_step_paged(
        tp, tcfg, tkv, torch.from_numpy(tables), torch.from_numpy(gid_tables),
        torch.from_numpy(tokens).long(), torch.from_numpy(cur_pos).long(),
        page_size=page)
    active = cur_pos >= 0
    _close(tl[active], np.asarray(rl)[active], LOGIT_TOL)
    _close(tmass, rmass, MASS_TOL)
    assert torch.count_nonzero(tmass[2]) == 0
    np.testing.assert_allclose(tmass.sum(dim=1).numpy()[active], 1.0,
                               atol=MASS_TOL)
    for k in pools:
        np.testing.assert_allclose(tkv[k][0].numpy(), np.asarray(rkv2[k][0]),
                                   atol=1e-5, rtol=0)


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
    assert torch.all(slot.norm1 == 1)


@pytest.mark.parametrize("arch", ["gemma3-12b", "deepseek-v3-671b",
                                  "xlstm-1.3b", "musicgen-large",
                                  "paligemma-3b", "nemotron-4-340b"])
def test_other_geometries_raise_not_implemented(arch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        TM.init(TC.reduced(arch), device="cpu")


def test_cuda_default_raises_without_a_card(monkeypatch):
    """Entry points run on cuda unless asked otherwise, and raise when no
    card is visible instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init(tcfg)
