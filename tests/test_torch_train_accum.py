"""The port's train step against the JAX reference's with gradient
accumulation (``accum_steps=2``), ``cast_params`` and int8 AdamW state,
on reduced configs: the bars, helpers and tolerances of
``tests/test_torch_train.py``, which holds the one-step check on every
registered architecture."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.train import optim as TO

from test_torch_train import (DRIFT_RTOL, STEP_TOL, V_INT8_TOL,
                              _check_metrics, _check_state, _step_both,
                              _tols)


@pytest.mark.parametrize("name,accum,cast", [
    ("qwen3-14b", 2, False), ("olmoe-1b-7b", 2, False),
    ("qwen3-14b", 1, True), ("deepseek-v3-671b", 2, True)])
def test_accumulated_and_cast_step_matches_reference(name, accum, cast):
    """``accum_steps=2`` (float32 gradient sums over the microbatches) and
    ``cast_params`` (the bf16 cast inside autograd) against the
    reference's, with the same bars."""
    [(rm, tm)], ts, ref = _step_both(name, accum=accum, cast=cast)
    _check_metrics(rm, tm)
    _check_state(ts, ref, float(rm["lr"]), cast)


@pytest.mark.parametrize("name", ["stablelm-12b", "olmoe-1b-7b"])
def test_int8_state_steps_match_reference(name):
    """Three steps with int8 state: the first step's loss and gradient
    norm at the bars above, the later steps' within ``DRIFT_RTOL``, and
    after the third step the parameters within the bars above, the
    dequantised m within two codes (2/127 of the leaf's largest) plus its
    bar and v within 5% of the leaf's largest, at least 99.9% of m's int8
    codes and 99.5% of v's equal to the reference's, and every m code
    within one of it.  The drift of the later steps moves a code where a
    value lies near a rounding boundary, v's more often: its log-domain
    steps are finer.  On identical gradients the codes are equal, bit for
    bit, after three steps (``test_torch_train_opt.py``)."""
    out, ts, ref = _step_both(name, state_dtype="int8", steps=3)
    _check_metrics(*out[0])
    for rm, tm in out[1:]:
        # the parameters have parted by the elements whose first step
        # turned on float32 noise: later sums part a little more
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                                   rtol=DRIFT_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=DRIFT_RTOL)
    lr = float(out[-1][0]["lr"])
    same, total = {"m": 0, "v": 0}, {"m": 0, "v": 0}
    for n, p in ts["params"].named_parameters():
        d = (p.detach() - ref["params"].get_parameter(n).detach()).abs()
        assert float(d.max()) <= STEP_TOL * lr, n
        for key, mode in (("m", "linear"), ("v", "log")):
            a, b = ts["opt"][key][n], ref["opt"][key][n]
            dq = (a.q.int() - b.q.int()).abs()
            same[key] += int((dq == 0).sum())
            total[key] += dq.numel()
            if key == "m":
                assert int(dq.max()) <= 1, n
            got = TO._unpack(a, p.shape, "int8", mode)
            want = TO._unpack(b, p.shape, "int8", mode)
            # one linear code is 1/127 of the block's largest m; v's codes
            # step by exp(scale) - 1 of the element itself (a few %)
            tol = _tols(n, False)[0] + 2 / 127 if key == "m" else V_INT8_TOL
            assert float((got - want).abs().max()) <= \
                tol * float(want.abs().max()), (n, key)
    assert same["m"] >= 0.999 * total["m"], (same, total)
    assert same["v"] >= 0.995 * total["v"], (same, total)
