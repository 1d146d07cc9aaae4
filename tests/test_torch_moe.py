"""The routed MoE of a decode step against the JAX reference, on the CPU.

A decode step (one position a row) groups its (token, expert) pairs by
expert on the device, with fixed shapes, and runs the routed-expert
kernel (``repro_torch.kernels.routed_experts``); on the CPU the kernel's
plain version ``routed_experts_plain`` stands in, over the same grouping
(``group_pairs``).  Here:

  * the same numpy inputs from a seed go through the reference's
    ``moe_apply_dense`` (JAX on the CPU) and the port, at T = 1 and T = 4
    tokens, with tied router probabilities, with every token on the same
    experts, and with deepseek-v3-671b's shared expert (reduced
    olmoe-1b-7b and deepseek-v3-671b widths; weights N(0, 1/fan-in), so
    outputs are O(1));
  * the grouping's invariants: every pair appears once, a group holds at
    most T tokens, the positions inside a group hold -1; and the CUDA
    group launch's rank count, emulated in numpy, writes the same arrays;
  * reduced olmoe-1b-7b and deepseek-v3-671b greedy decode streams, a
    batch of three rows, equal the reference's ``generate``.

Tolerance: 1e-5 absolute on the MoE outputs (float32; the products sum in
other orders than XLA's einsums, while a token's k expert outputs are
summed in the reference's top-k order)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.models import model as RM
from repro.models import moe as RMoE
from repro.serve.engine import generate as r_generate

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.kernels import routed_experts as TRE
from repro_torch.models import moe as TMoE
from repro_torch.serve.engine import generate as t_generate

MOE_ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b"]
TOL = 1e-5
# float32 relative term: two frameworks' summation orders on different CPUs
F32_RTOL = 4e-6


def _moe(arch, seed=0):
    """(reference cfg, reference params, port cfg, port ``MoE``) of one
    reduced MoE layer with the same numpy weights."""
    rcfg = dataclasses.replace(RC.reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(TC.reduced(arch), dtype="float32")
    mo = tcfg.moe
    d, e, f = tcfg.d_model, mo.num_experts, mo.d_expert
    rng = np.random.default_rng(seed)
    draw = lambda fan, *shape: (rng.standard_normal(shape)
                                / np.sqrt(fan)).astype(np.float32)
    ref = {"router": draw(d, d, e), "wi_gate": draw(d, e, d, f),
           "wi_up": draw(d, e, d, f), "wo": draw(f, e, f, d)}
    if mo.num_shared:
        fs = (mo.d_shared or mo.d_expert) * mo.num_shared
        ref["shared"] = {"wi_gate": draw(d, d, fs), "wi_up": draw(d, d, fs),
                         "wo": draw(fs, fs, d)}
    port = TMoE.MoE(tcfg, 1, "cpu")
    with torch.no_grad():
        for name in ("router", "wi_gate", "wi_up", "wo"):
            getattr(port, name).copy_(torch.from_numpy(ref[name])[None])
        if mo.num_shared:
            for name, a in ref["shared"].items():
                getattr(port.shared, name).copy_(torch.from_numpy(a)[None])
    return rcfg, ref, tcfg, port


def _tokens(case, t, d, ref, k, rng):
    """Tokens [T, d] of a case; ``tied`` and ``one_expert`` also rewrite
    the router in ``ref`` (and return True to say so)."""
    x = rng.standard_normal((t, d)).astype(np.float32)
    if case == "tied":
        # experts 4-7 tie with 0-3, and a zero row ties every expert
        ref["router"][:, 4:] = ref["router"][:, :4]
        x[0] = 0.0
    elif case == "one_expert":
        # experts 0..k-1 lead for every token, by far
        u = np.full((d,), 1.0 / np.sqrt(d), np.float32)
        x += 3.0 * np.sqrt(d) * u
        for j in range(k):
            ref["router"][:, j] = 50.0 * (j + 1) * u
    return x


@pytest.mark.parametrize("case", ["random", "tied", "one_expert"])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_moe_matches_dense_reference(arch, t, case):
    """A decode step's MoE (``moe_apply`` at S == 1: the routed-expert
    path, deepseek's shared expert added) == ``moe_apply_dense`` on the
    same inputs, and ``routed_experts_plain`` alone == the reference's
    routed part."""
    rcfg, ref, tcfg, port = _moe(arch)
    k = tcfg.moe.top_k
    x = _tokens(case, t, tcfg.d_model, ref, k, np.random.default_rng(t))
    with torch.no_grad():
        port.router.copy_(torch.from_numpy(ref["router"])[None])
    ry, _ = RMoE.moe_apply_dense(jax.tree.map(jnp.asarray, ref), rcfg,
                                 jnp.asarray(x[:, None]))
    ty, aux = TMoE.moe_apply(port, 0, tcfg, torch.from_numpy(x[:, None]),
                             with_aux=False)
    assert aux is None and ty.shape == (t, 1, tcfg.d_model)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), atol=TOL, rtol=F32_RTOL)

    xt = torch.from_numpy(x)
    w, idx, _ = TMoE.route(xt, port.router[0], k)
    _, ri, _ = RMoE._route(jnp.asarray(x), jnp.asarray(ref["router"]), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    if case == "one_expert":
        assert (idx.sort(dim=1).values == torch.arange(k)).all()
    y = TRE.routed_experts(xt, idx.contiguous(), w, port.wi_gate[0],
                           port.wi_up[0], port.wo[0])
    want = np.asarray(ry)[:, 0]
    if tcfg.moe.num_shared:
        want = want - np.asarray(RMoE._shared_out(
            jax.tree.map(jnp.asarray, ref["shared"]), jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), want, atol=TOL, rtol=F32_RTOL)


def _kernel_grouping(idx):
    """The CUDA group launch, emulated: the rank of pair p is the number of
    pairs with a smaller expert plus those with its expert and a smaller
    index; the leader of a group writes its expert and size, the others
    -1."""
    flat = np.asarray(idx).reshape(-1)
    n = flat.size
    g_expert, g_count, pair_of = (np.full(n, -9, np.int64) for _ in range(3))
    for p, e in enumerate(flat):
        before = int(np.sum((flat == e) & (np.arange(n) < p)))
        s = int(np.sum(flat < e)) + before
        pair_of[s] = p
        g_expert[s] = e if before == 0 else -1
        g_count[s] = int(np.sum(flat == e)) if before == 0 else -1
    return g_expert, g_count, pair_of


@pytest.mark.parametrize("t,k,e,case", [(1, 8, 64, "random"),
                                        (4, 8, 64, "random"),
                                        (4, 8, 256, "random"),
                                        (4, 8, 8, "same"),
                                        (7, 3, 5, "random"),
                                        (16, 2, 4, "random")])
def test_grouping_invariants(t, k, e, case):
    """``group_pairs``: ``pair`` is a permutation of the T*k pairs; a
    leader's count is its group's size, at most T, its pairs (in
    ascending order: the sort is stable) all choose its expert, and the
    leaders' experts ascend; every other position holds -1 in expert,
    first and count.  The kernel's group launch (emulated) writes the same
    expert, count and pair arrays."""
    rng = np.random.default_rng(t * 100 + k + e)
    if case == "same":
        idx = np.tile(rng.permutation(e)[:k], (t, 1))
    else:
        idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    expert, first, count, pair = (a.numpy() for a in
                                  TRE.group_pairs(torch.from_numpy(idx)))
    flat = idx.reshape(-1)
    p = t * k
    assert sorted(pair.tolist()) == list(range(p))
    lead = count > 0
    assert count[lead].sum() == p and count[lead].max() <= t
    assert (expert[~lead] == -1).all() and (first[~lead] == -1).all() \
        and (count[~lead] == -1).all()
    assert (first[lead] == np.nonzero(lead)[0]).all()
    assert (np.diff(expert[lead]) > 0).all()
    for s in np.nonzero(lead)[0]:
        members = pair[s: s + count[s]]
        assert (flat[members] == expert[s]).all()
        assert (np.diff(members) > 0).all()
        assert len(set(members // k)) == count[s]    # distinct tokens
    if case == "same":
        assert (count[lead] == t).all()
    g_expert, g_count, pair_of = _kernel_grouping(idx)
    np.testing.assert_array_equal(g_expert, expert)
    np.testing.assert_array_equal(g_count, count)
    np.testing.assert_array_equal(pair_of, pair)


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        rcfg = dataclasses.replace(RC.reduced(arch), dtype="float32")
        tcfg = dataclasses.replace(TC.reduced(arch), dtype="float32")
        rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
        tp = bridge.from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                   device="cpu")
        _MODELS[arch] = (rcfg, rp, tcfg, tp)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_decode_streams_match_reference(arch):
    """Three rows decoded together (each step's MoE over T = 3 tokens by
    the routed-expert path) give the reference ``generate``'s greedy
    tokens."""
    rcfg, rp, tcfg, tp = _models(arch)
    prompts = np.random.default_rng(3).integers(
        0, rcfg.vocab_size, (3, 7)).astype(np.int32)
    ref = np.asarray(r_generate(rp, rcfg, jnp.asarray(prompts), steps=8))
    got = t_generate(tp, tcfg, prompts, steps=8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cpu_call_takes_the_plain_version():
    """On the CPU ``routed_experts`` is its plain version and counts no
    launch; a token with no pairs (k = 0) gives zeros."""
    _, _, tcfg, port = _moe("olmoe-1b-7b")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, tcfg.d_model)).astype(np.float32))
    w, idx, _ = TMoE.route(x, port.router[0], tcfg.moe.top_k)
    idx = idx.contiguous()
    before = TRE.routed_experts.launches
    args = (x, idx, w, port.wi_gate[0], port.wi_up[0], port.wo[0])
    assert torch.equal(TRE.routed_experts(*args),
                       TRE.routed_experts_plain(*args))
    assert TRE.routed_experts.launches == before
    empty = TRE.routed_experts_plain(x, idx[:, :0], w[:, :0], *args[3:])
    assert torch.equal(empty, torch.zeros_like(x))
