"""The port's train step against the JAX reference's, one step, on the
last four registered architectures' reduced configs (the first six in
``tests/test_torch_train.py``, whose helpers, bars and tolerances these
cases use)."""
import pytest
import torch

torch.set_num_threads(1)

import repro.configs as RC

from test_torch_train import _check_train_step


@pytest.mark.parametrize("name", RC.ARCHS[6:])
def test_train_step_matches_reference(name):
    _check_train_step(name)
