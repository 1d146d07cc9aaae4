"""Reduced ``gemma3-12b`` (five sliding-window layers of window 8 and one
global layer, qk-norm, SwiGLU, tied embeddings) against the JAX
reference: forward, batched prefill, prefill + ring decode (from an
empty ring cache too: 10 tokens wrap the ring of 8), the fully-paged
decode step, seeded init, and ``attention_impl="pallas"`` (prefill
self-attention through ``ops.flash_attention``, its plain version on the
CPU).  The models, checks and tolerances are
``tests/test_torch_geometry.py``'s."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from repro.models import model as RM

import repro_torch.configs as TC
from repro_torch.models import model as TM

from test_torch_geometry import (
    F32_RTOL, LOGIT_TOL, TOL, _check_decode_step_paged,
    _check_forward_prefill_decode, _close, _models)

ARCHS = ["gemma3-12b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match(arch):
    _check_forward_prefill_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_matches(arch):
    """Identical pools and tables: logits, layer-averaged page mass and
    the write-through into both tiers; an inactive row writes nothing
    and carries no mass."""
    _check_decode_step_paged(arch)


def test_gemma_decode_from_empty_ring_cache_matches():
    """Token-by-token ``decode_step`` from an empty ``init_cache``: local
    slots are rings of ``window`` rows written at ``pos % window`` (10
    tokens wrap the ring of 8), the global slot ``max_len`` rows."""
    m = _models("gemma3-12b")
    rcfg, rp, tcfg, tp = m["rcfg"], m["rp"], m["tcfg"], m["tp"]
    toks = np.random.default_rng(4).integers(0, rcfg.vocab_size, (2, 10)) \
        .astype(np.int32)
    rcache = RM.init_cache(rcfg, 2, 16, dtype=jnp.float32)
    tcache = TM.init_cache(tcfg, 2, 16, device="cpu")
    slots = tcache["segments"][0]
    assert [c["pos"].shape[2] for c in slots] == [8] * 5 + [16]
    for i in range(toks.shape[1]):
        pos = np.full((2,), i, np.int32)
        rl, rcache = RM.decode_step(rp, rcfg, rcache,
                                    jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(pos))
        tl, tcache = TM.decode_step(tp, tcfg, tcache,
                                    torch.from_numpy(toks[:, i:i + 1]).long(),
                                    torch.from_numpy(pos).long())
        _close(tl, rl, LOGIT_TOL)
    for t, r in zip(tcache["segments"][0], rcache["segments"][0]):
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(r["pos"]))

def test_gemma_init_is_seeded_and_at_reference_scales():
    """Seeded init; attention and MLP leaves at N(0, 1/fan_in) with the
    reference's fan-in, norms one; the full config's geometry."""
    cfg = TC.get("gemma3-12b")
    assert (cfg.num_layers, cfg.window_size, cfg.head_dim) == (48, 1024, 256)
    assert [w for *_, w, _ in TM.state_slot_meta(cfg)] == [1024] * 5 + [0]
    tcfg = dataclasses.replace(TC.reduced("gemma3-12b"), dtype="float32")
    a = TM.init(tcfg, seed=3, device="cpu")
    b = TM.init(tcfg, seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    slot = a.segments[0][0]
    for t, fan in ((slot.wq, tcfg.d_model), (slot.wo, tcfg.num_heads),
                   (slot.wi_gate, tcfg.d_model), (slot.w_down, tcfg.d_ff)):
        assert abs(float(t.std()) / fan ** -0.5 - 1) < 0.1, (t.shape, fan)
    assert torch.all(slot.q_norm == 1) and torch.all(slot.k_norm == 1)
    assert not hasattr(a, "unembed")                  # tied embeddings

def test_gemma_flash_prefill_matches_reference():
    """``attention_impl="pallas"``: forward logits, batched-prefill logits
    and caches, and prefill + ring decode match the reference's."""
    m = _models("gemma3-12b")
    rcfg, rp, tp = m["rcfg"], m["rp"], m["tp"]
    tcfg = dataclasses.replace(m["tcfg"], attention_impl="pallas")
    toks = np.random.default_rng(5).integers(0, rcfg.vocab_size, (2, 11)) \
        .astype(np.int32)
    tt = torch.from_numpy(toks).long()
    _close(TM.forward(tp, tcfg, tt)[0], RM.forward(rp, rcfg, toks)[0],
           LOGIT_TOL)
    lengths = np.asarray([11, 6], np.int32)
    rl, rc = RM.prefill_batched(rp, rcfg, jnp.asarray(toks),
                                jnp.asarray(lengths))
    tl, tc = TM.prefill_batched(tp, tcfg, tt, torch.from_numpy(lengths))
    _close(tl, rl, LOGIT_TOL)
    for t, r in zip(tc["segments"][0], rc["segments"][0]):
        for name, a in t.items():
            np.testing.assert_allclose(a.numpy(), np.asarray(r[name]),
                                       atol=TOL, rtol=F32_RTOL)
    rl, rcache = RM.prefill(rp, rcfg, jnp.asarray(toks))
    tl, tcache = TM.prefill(tp, tcfg, tt)
    _close(tl, rl, LOGIT_TOL)
    rcache = RM.pad_cache(rcache, rcfg, 16)
    tcache = TM.pad_cache(tcache, tcfg, 16)
    pos, tok = np.full((2,), 11, np.int32), toks[:, -1:]
    for _ in range(3):
        rl, rcache = RM.decode_step(rp, rcfg, rcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tcache = TM.decode_step(tp, tcfg, tcache,
                                    torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos).long())
        _close(tl, rl, LOGIT_TOL)
        tok, pos = np.asarray(rl).argmax(-1).astype(np.int32), pos + 1
