"""The port's recurrent cells' sequence form (``*_apply``, from the zero
state and from a carried one) and one-token form (``*_step``) against the
reference's, outputs and every state leaf, for the mLSTM, the sLSTM and
the RG-LRU with conv taps drawn from N(0, 0.5).
``tests/test_torch_recurrent.py`` holds the cells and the tolerances."""
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from repro_torch.models import recurrent as TR

from test_torch_recurrent import (CELLS, REF_FNS, _cell, _close,
                                  _close_state, _to_torch, _x)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cell_apply_matches_reference(kind):
    """The sequence form from the zero state over 5 tokens, then from the
    carried state over 4 more (the previous state folded into the first
    step): outputs and every state leaf."""
    apply = REF_FNS[kind][0]
    rcfg, ref, tcfg, cell = _cell(kind)
    x = _x(rcfg, 2, 9, seed=2)
    ry1, rst1 = apply(ref, rcfg, jnp.asarray(x[:, :5]))
    ty1, tst1 = TR.apply(cell, 0, tcfg, torch.from_numpy(x[:, :5]))
    _close(ty1, ry1)
    _close_state(tst1, rst1)
    ry2, rst2 = apply(ref, rcfg, jnp.asarray(x[:, 5:]), rst1)
    ty2, tst2 = TR.apply(cell, 0, tcfg, torch.from_numpy(x[:, 5:]),
                         _to_torch(rst1))
    _close(ty2, ry2)
    _close_state(tst2, rst2)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cell_step_matches_reference(kind):
    """Three decode steps from a carried state against the reference's;
    the port's steps also agree with its own sequence form over the same
    tokens."""
    apply, step, _ = REF_FNS[kind]
    rcfg, ref, tcfg, cell = _cell(kind)
    x = _x(rcfg, 3, 7, seed=3)
    _, rst = apply(ref, rcfg, jnp.asarray(x[:, :4]))
    tst = _to_torch(rst)
    start = dict(tst)
    for t in range(4, 7):
        ry, rst = step(ref, rcfg, jnp.asarray(x[:, t:t + 1]), rst)
        ty, tst = TR.step(cell, 0, tcfg, torch.from_numpy(x[:, t:t + 1]),
                          tst)
        assert ty.shape == (3, 1, tcfg.d_model)
        _close(ty, ry)
        _close_state(tst, rst)
    ty_seq, tst_seq = TR.apply(cell, 0, tcfg, torch.from_numpy(x[:, 4:]),
                               start)
    _close(ty_seq[:, -1:], ty)
    _close_state(tst_seq, {k: v.numpy() for k, v in tst.items()})
