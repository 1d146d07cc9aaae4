"""The port's flash-attention kernel layer against the JAX reference.

On the CPU the port's wrapper runs its plain PyTorch version
(``flash_attention_plain``); the JAX side runs the Pallas
``flash_attention`` in interpret mode and its jnp oracle.  The CUDA kernel
itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Inputs come from a numpy seed.  The Pallas kernel needs tiles that divide
S and T, so lengths that no tile divides (S = 1, 37, 200) and D = 256 are
held to the oracles only.  Tolerances: 2e-5 absolute in float32 (the
implementations reduce in different orders) and 2e-2 for bfloat16 inputs,
those of ``tests/test_kernels.py``'s flash tests."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp
import ml_dtypes

from repro.kernels import ops as rops
from repro.kernels import ref as rref

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, b, s, h, kv, d, dtype="float32", t=None):
    rng = np.random.default_rng(seed)
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    f = lambda *shape: rng.standard_normal(shape).astype(dt)
    t = s if t is None else t
    return f(b, s, h, d), f(b, t, kv, d), f(b, t, kv, d)


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _check(args, tol, *, pallas_tiles=None, **kw):
    """The port's wrapper (the plain version on the CPU) and its oracle
    against the JAX oracle and, given tiles, the Pallas kernel in
    interpret mode."""
    jargs = [jnp.asarray(a) for a in args]
    targets = [rref.flash_attention_ref(*jargs, **kw)]
    if pallas_tiles is not None:
        targets.append(rops.flash_attention(*jargs, bq=pallas_tiles,
                                            bkv=pallas_tiles,
                                            impl="interpret", **kw))
    targs = [_t(a) for a in args]
    ours = [tops.flash_attention(*targs, **kw),
            tref.flash_attention_ref(*targs, **kw)]
    for o in ours:
        assert o.shape == targs[0].shape
        for r in targets:
            np.testing.assert_allclose(_np(o), _np(r), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,kv,d", [(256, 4, 4, 64), (512, 4, 2, 64),
                                      (256, 8, 1, 128)])
def test_plain_and_oracle_match_pallas(s, h, kv, d, dtype):
    """The shapes of ``tests/test_kernels.py``'s flash tests, causal."""
    args = _inputs(s + h * 10 + kv, 2, s, h, kv, d, dtype)
    _check(args, TOL[dtype], pallas_tiles=128)


def test_sliding_window_matches_pallas():
    args = _inputs(3, 1, 256, 4, 4, 64)
    _check(args, TOL["float32"], pallas_tiles=64, window=64)


def test_noncausal_matches_pallas():
    args = _inputs(6, 1, 128, 2, 2, 64)
    _check(args, TOL["float32"], pallas_tiles=64, causal=False)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
@pytest.mark.parametrize("s", [1, 37, 200])
def test_ragged_lengths_and_d256_match_oracle(s, causal, window):
    """Lengths no tile divides, D = 256 and GQA rep 2, against the JAX
    oracle (the Pallas kernel asserts that its tiles divide S and T)."""
    args = _inputs(s, 2, s, 4, 2, 256)
    _check(args, TOL["float32"], causal=causal, window=window)


def test_shorter_queries_than_keys_match_oracle():
    """S < T: positions count from 0 for both, so query i still attends
    keys 0..i (no query offset), as the oracle."""
    args = _inputs(11, 1, 5, 4, 4, 32, t=23)
    _check(args, TOL["float32"], window=3)
    _check(args, TOL["float32"], causal=False)


def test_output_dtypes_follow_the_reference():
    """The wrapper returns q's dtype, as the Pallas kernel; the oracle
    returns v's dtype, as the JAX oracle."""
    q, k, v = _inputs(5, 1, 16, 2, 2, 16)
    q16, k16, v16 = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    j_ref = rref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k16),
                                     jnp.asarray(v16))
    t_ref = tref.flash_attention_ref(_t(q), _t(k16), _t(v16))
    assert str(j_ref.dtype) == "bfloat16" and t_ref.dtype == torch.bfloat16
    assert tfa.flash_attention(_t(q16), _t(k), _t(v)).dtype == torch.bfloat16
    assert tfa.flash_attention(_t(q), _t(k16), _t(v16)).dtype \
        == torch.float32
    j_int = rops.flash_attention(*[jnp.asarray(a) for a in (q16, k16, v16)],
                                 bq=16, bkv=16, impl="interpret")
    assert str(j_int.dtype) == "bfloat16"


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """A soft-cap, a head dim outside 16/32/64/128/256, S > T and a tensor
    that is neither on the CPU nor on a CUDA card raise on every device
    (the plain version would take the middle two; the kernel does not)."""
    q, k, v = (_t(a) for a in _inputs(0, 1, 8, 2, 2, 16))
    with pytest.raises(TypeError, match="softcap"):
        tops.flash_attention(q, k, v, softcap=5.0)
    q48, k48, v48 = (_t(a) for a in _inputs(0, 1, 8, 2, 2, 48))
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q48, k48, v48)
    with pytest.raises(ValueError, match="S <= T"):
        tfa.flash_attention(q, k[:, :4], v[:, :4])
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_attention(meta(1, 8, 2, 16), meta(1, 8, 2, 16),
                            meta(1, 8, 2, 16))
