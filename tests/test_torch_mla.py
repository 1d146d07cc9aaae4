"""The port's MLA paged-attention kernel layer against the JAX reference.

On the CPU the port's wrapper runs its plain PyTorch version
(``paged_attention_mla_plain``); the JAX side runs the Pallas
``paged_attention_mla`` in interpret mode and its jnp oracle.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Inputs come from a numpy seed: ragged rows padded with -1 and, in the
grid, a length-0 row (the reference gives such a row uniform weights, the
port zeros, so it is compared on the active rows and checked for zeros).
Tolerances: 1e-5 absolute in float32 (the implementations reduce in
different orders); 3e-2 for bfloat16 inputs, as
``tests/test_torch_kernels.py::test_bf16_matches_jax`` allows."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp
import ml_dtypes

from repro.kernels import ops as rops
from repro.kernels import ref as rref

from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention_mla as tpam
from repro_torch.kernels import ref as tref

K = 8
TABLE = np.asarray([[2, 7, 11, 3, 9],
                    [5, 1, 20, -1, -1],          # ragged short row
                    [8, 4, 6, 12, 17],
                    [10, -1, -1, -1, -1]], np.int32)   # length-0 row
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(seed, h, r, page, dtype="float32", p_phys=24):
    rng = np.random.default_rng(seed)
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    f = lambda *s: rng.standard_normal(s).astype(dt)
    b, n = TABLE.shape
    lengths = np.asarray([n * page - 2, 3 * page - 1, 2 * page + 3, 0],
                         np.int32)
    return (f(b, h, r), f(b, h, K), f(p_phys, page, r), f(p_phys, page, K),
            TABLE.copy(), lengths)


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("r", [16, 32])
@pytest.mark.parametrize("h", [4, 8])
def test_plain_and_oracle_match_jax(h, r, page, dtype):
    """Torch oracle and the port's wrapper (plain version on the CPU)
    against the JAX interpret-mode kernel and the JAX oracle, context and
    mass, on the active rows; each active row's mass sums to 1 and the
    length-0 row gets zeros."""
    args = _inputs(h * 1000 + r * 10 + page, h, r, page, dtype)
    scale = 1.0 / np.sqrt(24.0)
    kw = dict(scale=scale, return_mass=True)
    jargs = [jnp.asarray(a) for a in args]
    j_int = rops.paged_attention_mla(*jargs, impl="interpret", **kw)
    j_ref = rops.paged_attention_mla(*jargs, impl="reference", **kw)
    targs = [_t(a) for a in args]
    t_ref = tref.paged_attention_mla_ref(*targs[:4], targs[4].clamp_min(0),
                                         targs[5], **kw)
    t_ops = tops.paged_attention_mla(*targs, **kw)
    active = args[5] > 0
    tol = TOL[dtype]
    for jo, jm in (j_int, j_ref):
        for to, tm in (t_ref, t_ops):
            np.testing.assert_allclose(_np(to)[active], _np(jo)[active],
                                       atol=tol, rtol=0)
            np.testing.assert_allclose(tm.numpy()[active],
                                       np.asarray(jm)[active], atol=1e-5,
                                       rtol=0)
    out, mass = t_ops
    np.testing.assert_allclose(mass.sum(dim=1).numpy()[active], 1.0,
                               atol=1e-5)
    assert torch.count_nonzero(out[~torch.from_numpy(active)]) == 0
    assert torch.count_nonzero(mass[~torch.from_numpy(active)]) == 0
    assert out.dtype == t_ref[0].dtype == getattr(torch, dtype)


def test_output_dtypes_follow_the_reference():
    """The oracle returns the ckv dtype, as the JAX oracle; the wrapper
    returns q_abs's dtype, as the Pallas kernel (ROADMAP Queue 3)."""
    q, qr, ckv, kr, pt, ln = _inputs(5, 4, 16, 4, "float32")
    ckv16, kr16 = (a.astype(ml_dtypes.bfloat16) for a in (ckv, kr))
    scale = 0.25
    pt = np.maximum(pt, 0)
    j_ref = rref.paged_attention_mla_ref(
        *[jnp.asarray(a) for a in (q, qr, ckv16, kr16, pt, ln)], scale=scale)
    t_ref = tref.paged_attention_mla_ref(
        _t(q), _t(qr), _t(ckv16), _t(kr16), _t(pt), _t(ln), scale=scale)
    assert str(j_ref.dtype) == "bfloat16" and t_ref.dtype == torch.bfloat16
    q16 = q.astype(ml_dtypes.bfloat16)
    out, _ = tpam.paged_attention_mla_plain(_t(q16), _t(qr), _t(ckv),
                                            _t(kr), _t(pt), _t(ln),
                                            scale=scale)
    assert out.dtype == torch.bfloat16
    out, _ = tpam.paged_attention_mla_plain(_t(q), _t(qr), _t(ckv16),
                                            _t(kr16), _t(pt), _t(ln),
                                            scale=scale)
    assert out.dtype == torch.float32


def test_page_permutation_invariance():
    """Physically permuting pages (table updated to match) cannot change
    the context or the mass -- the invariant tiering relies on."""
    b, h, r, page, n, p_phys = 2, 4, 32, 8, 4, 16
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, qr, ckv, kr = f(b, h, r), f(b, h, K), f(p_phys, page, r), \
        f(p_phys, page, K)
    pt = torch.arange(b * n, dtype=torch.int32).reshape(b, n)
    ln = torch.tensor([n * page - 5, 2 * page + 1], dtype=torch.int32)
    o1, m1 = tops.paged_attention_mla(q, qr, ckv, kr, pt, ln, scale=0.2,
                                      return_mass=True)
    perm = torch.from_numpy(rng.permutation(p_phys))
    inv = torch.argsort(perm).to(torch.int32)
    o2, m2 = tops.paged_attention_mla(q, qr, ckv[perm], kr[perm],
                                      inv[pt.long()], ln, scale=0.2,
                                      return_mass=True)
    torch.testing.assert_close(o1, o2, atol=1e-5, rtol=0)
    torch.testing.assert_close(m1, m2, atol=1e-6, rtol=0)


def test_plain_unmapped_page_carries_no_mass():
    """A table entry < 0 inside the length is never read and carries no
    mass; the remaining pages of the row still sum to 1."""
    q, qr, ckv, kr, pt, ln = (_t(a) for a in _inputs(3, 4, 16, 4))
    pt[2, 1] = -1
    out, mass = tpam.paged_attention_mla_plain(q, qr, ckv, kr, pt, ln,
                                               scale=0.3)
    assert mass[2, 1] == 0
    np.testing.assert_allclose(mass.sum(dim=1).numpy()[:3], 1.0, atol=1e-5)
    assert torch.isfinite(out).all()


def test_zero_page_table_gives_zeros():
    """A table of zero pages attends to nothing: the wrapper's CPU route
    and the plain version return zeros of q_abs's shape and dtype and an
    empty [B, 0] mass, as the k/v kernel does.  There is no oracle to pin
    this to: the JAX ``paged_attention_mla_ref`` raises at n == 0
    (ZeroDivisionError in its reshape), as does the port's copy."""
    q, qr, ckv, kr, _, _ = _inputs(3, 8, 32, 4)
    pt = np.zeros((q.shape[0], 0), np.int32)
    ln = np.zeros((q.shape[0],), np.int32)
    with pytest.raises(ZeroDivisionError):
        rref.paged_attention_mla_ref(*(jnp.asarray(a) for a in
                                       (q, qr, ckv, kr, pt, ln)),
                                     scale=0.25, return_mass=True)
    for fn in (tpam.paged_attention_mla, tpam.paged_attention_mla_plain):
        out, mass = fn(*(_t(a) for a in (q, qr, ckv, kr, pt, ln)),
                       scale=0.25)
        assert out.shape == q.shape and out.dtype == torch.float32
        assert torch.count_nonzero(out) == 0
        assert mass.shape == (q.shape[0], 0) and mass.dtype == torch.float32


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; a tensor elsewhere that is
    not on a CUDA card raises instead of falling back."""
    meta = lambda *s, **kw: torch.empty(s, device="meta", **kw)
    args = [meta(1, 4, 16), meta(1, 4, 8), meta(2, 4, 16), meta(2, 4, 8),
            meta(1, 2, dtype=torch.int32), meta(1, dtype=torch.int32)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpam.paged_attention_mla(*args, scale=0.1)
