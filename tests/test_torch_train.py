"""The port's train step against the JAX reference's, one step, on every
registered architecture's reduced config: the reference's initial state is
carried over through ``bridge.state_from_reference``, both packages take
the same numpy batch (``data.pipeline.batch_at``), and the loss, gradient
norm, learning rate, every parameter and both AdamW moments after the
step must agree.

Tolerances.  Loss 1e-6 and gradient norm 5e-6 relative (float32 sums in
other orders).  ``m`` within 1e-5 and ``v`` within 2e-5 of their leaf's
largest magnitude (m = 0.1 * clip * g: the gradients agree to float32
rounding), except where a gradient is rounded to bfloat16: the
reference sums a token's embedding gradient rows in bfloat16, and the
port does too (``layers.embed``), but in another order; under
``cast_params`` every gradient passes through the bfloat16 cast's
backward.  There a float32 difference can tip an element's rounding by
one bfloat16 ulp, at most 2^-7 of it: m within 2^-7 and v (~g^2) within
2^-6 of the leaf's largest magnitude.  Parameters:
AdamW's first step is g / (|g| + eps / clip), about sign(g), so an
element whose gradient lies within float32 noise of zero (|g| ~ eps) can
move its step by a large part of it.  Every element is held within 0.1 of
a step (``lr``) of the reference's, and at most 0.1% of them may differ by
more than 1e-3 of a step.  The optimizer's own arithmetic is held far
tighter, on identical gradients, in ``test_torch_train_opt.py``;
accumulation, ``cast_params`` and int8 state in
``test_torch_train_accum.py``, and the one-step check on the last four
registered architectures in ``test_torch_train_archs.py``, on this
file's helpers."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.train import optim as RO
from repro.train import step as RS

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

OCFG = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
LOSS_RTOL, GNORM_RTOL = 1e-6, 5e-6
M_TOL, V_TOL = 1e-5, 2e-5
BF16_M_TOL, BF16_V_TOL = 2.0 ** -7, 2.0 ** -6
STEP_TOL, STEP_FINE, FINE_SHARE = 0.1, 1e-3, 1e-3
DRIFT_RTOL = 1e-4
V_INT8_TOL = 0.05


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tols(name: str, cast: bool):
    """(m, v) bars of leaf ``name``: bfloat16 ones where its gradient is
    rounded to bfloat16."""
    if cast or name == "tok":
        return BF16_M_TOL, BF16_V_TOL
    return M_TOL, V_TOL


def _check_state(ts, ref, lr, cast=False):
    """The port's state ``ts`` against the reference's ``ref`` (carried
    over) after a step, with the tolerances of the module docstring."""
    assert int(ts["step"]) == int(ref["step"])
    assert int(ts["opt"]["count"]) == int(ref["opt"]["count"])
    fine, total = 0, 0
    for n, p in ts["params"].named_parameters():
        d = (p.detach() - ref["params"].get_parameter(n).detach()).abs()
        assert float(d.max()) <= STEP_TOL * lr, (n, float(d.max()) / lr)
        fine += int((d > STEP_FINE * lr).sum())
        total += d.numel()
        for key, tol in zip(("m", "v"), _tols(n, cast)):
            got, want = ts["opt"][key][n].float(), ref["opt"][key][n].float()
            bar = tol * float(want.abs().max())
            assert float((got - want).abs().max()) <= bar, (n, key)
    assert fine <= FINE_SHARE * total, (fine, total)


def _step_both(name, *, accum=1, cast=False, state_dtype="float32",
               steps=1):
    rcfg, tcfg = RC.reduced(name), TC.reduced(name)
    rocfg = RO.OptConfig(**OCFG, state_dtype=state_dtype)
    tocfg = TO.OptConfig(**OCFG, state_dtype=state_dtype)
    rs, _ = RS.init_state(jax.random.PRNGKey(0), rcfg, rocfg)
    ts = bridge.state_from_reference(_np_tree(rs), tcfg, device="cpu")
    rstep = jax.jit(RS.make_train_step(rcfg, rocfg, accum_steps=accum,
                                       cast_params=cast))
    tstep = TS.make_train_step(tcfg, tocfg, accum_steps=accum,
                               cast_params=cast)
    dcfg = DataConfig(seed=0, global_batch=4, seq_len=16)
    out = []
    for i in range(steps):
        batch = batch_at(dcfg, tcfg, i)
        rs, rm = rstep(rs, _jnp(batch))
        ts, tm = tstep(ts, batch)
        out.append((rm, tm))
    ref = bridge.state_from_reference(_np_tree(rs), tcfg, device="cpu")
    return out, ts, ref


def _check_metrics(rm, tm):
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=GNORM_RTOL)
    assert float(tm["lr"]) == float(rm["lr"])


def _check_train_step(name):
    """One step of ``name``'s reduced config in both packages: the metrics
    and the state after it at the bars above."""
    [(rm, tm)], ts, ref = _step_both(name)
    _check_metrics(rm, tm)
    _check_state(ts, ref, float(rm["lr"]))


# the other registered architectures: tests/test_torch_train_archs.py
@pytest.mark.parametrize("name", RC.ARCHS[:6])
def test_train_step_matches_reference(name):
    _check_train_step(name)


