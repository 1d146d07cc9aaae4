"""The port's dense batcher (``paged=False``, ``monitor=None``) against the
reference's dense batcher on the same parameters, for every registered
architecture that ``tests/test_torch_dense.py`` does not already hold
against the reference with a monitor: the recurrent branch (per-request
``prefill`` + ``pad_cache`` written into a row: recurrentgemma-2b,
xlstm-1.3b), MLA + MoE (deepseek-v3-671b), routed MoE (olmoe-1b-7b),
cross-attention conditioning (musicgen-large) and the GELU / squared-ReLU
MLPs (stablelm-12b, nemotron-4-340b).

Reduced configs, float32; the reference's parameters are carried over
through ``repro_torch.bridge``, with the recurrent cells' conv taps drawn
N(0, 0.5) from a numpy seed (the reference's zero taps make every cell an
identity), and musicgen's conditioning drawn N(0, 1) in numpy.  The
workload is the reference matrix's (``tests/test_geometry.py``): two
requests up front, a third joining mid-flight into a recycled row, greedy,
so the streams must agree token for token and in the streamed events."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.models import model as RM
from repro.serve import sched as RS

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.serve import sched as TS

ARCHS = ["recurrentgemma-2b", "xlstm-1.3b", "deepseek-v3-671b",
         "olmoe-1b-7b", "musicgen-large", "stablelm-12b", "nemotron-4-340b"]
CONV_STD = 0.5
PROMPT_LENS, STEPS = (6, 9, 5), (6, 4, 7)


def _models(arch):
    rcfg = dataclasses.replace(RC.reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(TC.reduced(arch), dtype="float32")
    rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
    rp = jax.tree.map(np.asarray, rp)
    rng = np.random.default_rng(7)
    for seg in rp["segments"]:
        for slot in seg:
            if "cell" in slot:
                slot["cell"]["conv"] = rng.normal(
                    0.0, CONV_STD, slot["cell"]["conv"].shape) \
                    .astype(np.float32)
    tp = bridge.from_reference(rp, tcfg, device="cpu")
    prompts = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    cond = None
    if rcfg.cond_len:
        cond = rng.standard_normal(
            (1, rcfg.cond_len, rcfg.cond_dim or rcfg.d_model)) \
            .astype(np.float32)
    return rcfg, jax.tree.map(jnp.asarray, rp), tcfg, tp, prompts, cond


def _serve(side, params, cfg, prompts, cond):
    """The staggered greedy workload on one package's dense batcher;
    returns ({rid: tokens}, the (rid, token) events streamed)."""
    if side == "ref":
        b = RS.ContinuousBatcher(params, cfg, max_active=2, max_len=32,
                                 page_size=4, monitor=None, paged=False,
                                 cond=None if cond is None
                                 else jnp.asarray(cond))
        mk = lambda i: RS.Request(rid=i, prompt=prompts[i],
                                  max_new_tokens=STEPS[i])
    else:
        b = TS.ContinuousBatcher(params, cfg, max_active=2, max_len=32,
                                 page_size=4, monitor=None, paged=False,
                                 cond=cond, device="cpu")
        mk = lambda i: TS.Request(rid=i, prompt=prompts[i],
                                  max_new_tokens=STEPS[i])
    assert not b.paged
    b.submit(mk(0))
    b.submit(mk(1))
    events = []
    for t in range(60):
        if t == 2:       # joins mid-flight, lands in a recycled row
            b.submit(mk(2))
        events.extend(b.step())
        if t > 2 and not b.queue and not b.active:
            break
    assert not b.queue and not b.active, "workload did not drain"
    return {r.rid: list(r.tokens) for r in b.completed}, \
        [(int(rid), int(tok)) for rid, tok in events]


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_batcher_matches_reference(arch):
    """Greedy streams and streamed events of the port's dense batcher
    equal the reference dense batcher's, token for token."""
    rcfg, rp, tcfg, tp, prompts, cond = _models(arch)
    ref, ref_events = _serve("ref", rp, rcfg, prompts, cond)
    port, port_events = _serve("port", tp, tcfg, prompts, cond)
    assert sorted(ref) == [0, 1, 2]
    assert [len(ref[i]) for i in range(3)] == list(STEPS)
    assert port == ref
    assert port_events == ref_events
