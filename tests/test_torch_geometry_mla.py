"""Reduced ``deepseek-v3-671b`` (every layer MLA; one dense-MLP segment
and one MoE segment with a shared expert) against the JAX reference: the
routed MoE against ``moe_apply_dense`` (outputs and aux loss) and the
routing's tie order against ``lax.top_k``; ``mla_apply`` and
``mla_decode`` against the reference's layers; forward, batched prefill,
prefill + dense decode (from an empty MLA cache too) and the
fully-paged decode step; seeded init at the reference's scales.  The
models, checks and tolerances are ``tests/test_torch_geometry.py``'s."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from repro.models import layers as RL
from repro.models import model as RM
from repro.models import moe as RMoE

from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE

from test_torch_geometry import (
    LOGIT_TOL, TOL, _check_decode_step_paged, _check_forward_prefill_decode,
    _check_init_scales, _check_moe_dense, _close, _models, _slot)

ARCHS = ["deepseek-v3-671b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_dense_reference(arch):
    """Routed MoE == the reference's dense oracle: outputs (shared expert
    included for deepseek) and the load-balance aux loss."""
    _check_moe_dense(arch)


def test_route_breaks_ties_like_lax_top_k():
    """Tied router probabilities pick the lowest expert ids, as
    ``lax.top_k`` does: a zero row ties every expert, a half-zero router
    ties groups of experts."""
    m = _models("deepseek-v3-671b")
    cfg = m["rcfg"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, cfg.d_model)).astype(np.float32)
    x[0] = 0.0
    router = rng.standard_normal((cfg.d_model, cfg.moe.num_experts)) \
        .astype(np.float32)
    router[:, 4:] = router[:, :4]             # experts 4-7 tie with 0-3
    rw, ri, rp = RMoE._route(jnp.asarray(x), jnp.asarray(router),
                             cfg.moe.top_k)
    tw, ti, tp = TMoE.route(torch.from_numpy(x), torch.from_numpy(router),
                            cfg.moe.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    _close(tw, rw, TOL)
    _close(tp, rp, TOL)

def test_mla_layers_match_reference():
    """``mla_apply`` (prefill: output and compressed cache rows) and
    ``mla_decode`` (absorbed-matrix decode over a cache with an empty
    slot) against the reference's layers."""
    m = _models("deepseek-v3-671b")
    rcfg, tcfg = m["rcfg"], m["tcfg"]
    ref, slot = _slot(m, 0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, rcfg.d_model)).astype(np.float32)
    pos = np.arange(6)[None]
    mask = np.tril(np.ones((6, 6), bool))[None]
    ro, (rc, rk) = RL.mla_apply(ref["attn"], rcfg, jnp.asarray(x),
                                jnp.asarray(pos), jnp.asarray(mask))
    to, (tc, tk) = TL.mla_apply(slot, 0, tcfg, torch.from_numpy(x),
                                torch.from_numpy(pos), torch.from_numpy(mask))
    for t, r in ((to, ro), (tc, rc), (tk, rk)):
        _close(t, r, TOL)

    xd = rng.standard_normal((2, 1, rcfg.d_model)).astype(np.float32)
    ckv = np.array(rc)
    krope = np.array(rk)
    cpos = np.tile(np.arange(6), (2, 1))
    cpos[1, 4:] = -1                                   # empty slots
    cur = np.asarray([6, 4], np.int32)
    rd = RL.mla_decode(ref["attn"], rcfg, jnp.asarray(xd), jnp.asarray(ckv),
                       jnp.asarray(krope), jnp.asarray(cpos),
                       jnp.asarray(cur))
    td = TL.mla_decode(slot, 0, tcfg, torch.from_numpy(xd),
                       torch.from_numpy(ckv), torch.from_numpy(krope),
                       torch.from_numpy(cpos), torch.from_numpy(cur).long())
    for t, r in zip(td, rd):
        _close(t, r, TOL)

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match(arch):
    _check_forward_prefill_decode(arch)


def test_decode_from_empty_cache_matches():
    """Token-by-token ``decode_step`` from an empty MLA ``init_cache``."""
    m = _models("deepseek-v3-671b")
    rcfg, rp, tcfg, tp = m["rcfg"], m["rp"], m["tcfg"], m["tp"]
    toks = np.random.default_rng(3).integers(0, rcfg.vocab_size, (2, 5)) \
        .astype(np.int32)
    rcache = RM.init_cache(rcfg, 2, 8, dtype=jnp.float32)
    tcache = TM.init_cache(tcfg, 2, 8, device="cpu")
    assert set(tcache["segments"][0][0]) == {"ckv", "krope", "pos"}
    for i in range(toks.shape[1]):
        pos = np.full((2,), i, np.int32)
        rl, rcache = RM.decode_step(rp, rcfg, rcache,
                                    jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(pos))
        tl, tcache = TM.decode_step(tp, tcfg, tcache,
                                    torch.from_numpy(toks[:, i:i + 1]).long(),
                                    torch.from_numpy(pos).long())
        _close(tl, rl, LOGIT_TOL)

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_matches(arch):
    """Identical pools and tables: logits, layer-averaged page mass and
    the write-through into both tiers; an inactive row writes nothing
    and carries no mass."""
    _check_decode_step_paged(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_is_seeded_and_at_reference_scales(arch):
    """Seeded init; each MLA / MoE leaf at N(0, 1/fan_in) with the
    reference's fan-in."""
    _check_init_scales(arch)

