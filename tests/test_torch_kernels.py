"""The port's paged-attention kernel layer against the JAX reference.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode and its jnp oracle.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Tolerances: 1e-5 absolute in float32 (the three implementations reduce in
different orders); 3e-2 for bfloat16 inputs, as the reference's own kernel
test allows."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from repro.kernels import ops as rops
from repro.kernels import ref as rref

from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref

TABLE = np.asarray([[2, 7, 11, 3, 9],
                    [5, 1, 20, -1, -1],          # ragged short row
                    [8, 4, 6, 12, 17]], np.int32)


def _inputs(seed, h, kv, d=16, page=4, p_phys=24, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, h, d)).astype(dtype)
    kp = rng.standard_normal((p_phys, page, kv, d)).astype(dtype)
    vp = rng.standard_normal((p_phys, page, kv, d)).astype(dtype)
    n = TABLE.shape[1]
    lengths = np.asarray([n * page - 2, 3 * page - 1, 2 * page + 3], np.int32)
    return q, kp, vp, TABLE.copy(), lengths


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2), (8, 1)])  # GQA ratios
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (3, 0.0), (0, 5.0),
                                            (8, 5.0)])
def test_ref_and_plain_match_jax(h, kv, window, softcap):
    """Torch oracle == JAX interpret-mode kernel == JAX oracle, outputs and
    mass; the port's wrapper (plain version on CPU) agrees on every active
    row, and each row's mass sums to 1."""
    q, kp, vp, pt, ln = _inputs(h * 100 + window, h, kv)
    kw = dict(window=window, softcap=softcap, return_mass=True)
    j_int = rops.paged_attention(*_j(q, kp, vp, pt, ln), impl="interpret",
                                 **kw)
    j_ref = rops.paged_attention(*_j(q, kp, vp, pt, ln), impl="reference",
                                 **kw)
    tq, tk, tv, tt, tl = _t(q, kp, vp, pt, ln)
    t_ref = tref.paged_attention_ref(tq, tk, tv, tt.clamp_min(0), tl, **kw)
    t_ops = tops.paged_attention(tq, tk, tv, tt, tl, **kw)
    for jo, jm in (j_int, j_ref):
        for to, tm in (t_ref, t_ops):
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(t_ops[1].sum(dim=1).numpy(), np.ones(3),
                               atol=1e-5)


@pytest.mark.parametrize("h,kv,d,page", [(4, 4, 64, 16), (8, 2, 64, 32),
                                         (8, 1, 128, 16)])
def test_bf16_matches_jax(h, kv, d, page):
    """bfloat16 pools: the torch oracle and the port's wrapper against the
    JAX oracle on full-length, ragged and short rows."""
    import ml_dtypes
    b, n, p_phys = 3, 8, 64
    rng = np.random.default_rng(h + kv + d)
    f = lambda *s: rng.standard_normal(s).astype(ml_dtypes.bfloat16)
    q, kp, vp = f(b, h, d), f(p_phys, page, kv, d), f(p_phys, page, kv, d)
    pt = rng.permutation(p_phys)[: b * n].reshape(b, n).astype(np.int32)
    ln = np.asarray([n * page, n * page - 7, page + 3], np.int32)
    j = rref.paged_attention_ref(*_j(q, kp, vp, pt, ln))
    tb = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    args = (tb(q), tb(kp), tb(vp), torch.from_numpy(pt),
            torch.from_numpy(ln))
    for out in (tref.paged_attention_ref(*args),
                tops.paged_attention(*args)):
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(j, np.float32), atol=3e-2)


def test_page_permutation_invariance():
    """Physically permuting pages (table updated to match) cannot change
    the output or the mass -- the invariant tiering relies on."""
    b, h, kv, d, page, n, p_phys = 2, 4, 2, 64, 16, 4, 32
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    kp = torch.from_numpy(
        rng.standard_normal((p_phys, page, kv, d)).astype(np.float32))
    vp = torch.from_numpy(
        rng.standard_normal((p_phys, page, kv, d)).astype(np.float32))
    pt = torch.arange(b * n, dtype=torch.int32).reshape(b, n)
    ln = torch.full((b,), n * page - 5, dtype=torch.int32)
    o1, m1 = tops.paged_attention(q, kp, vp, pt, ln, return_mass=True)
    perm = torch.from_numpy(rng.permutation(p_phys))
    inv = torch.argsort(perm).to(torch.int32)
    o2, m2 = tops.paged_attention(q, kp[perm], vp[perm], inv[pt.long()], ln,
                                  return_mass=True)
    torch.testing.assert_close(o1, o2, atol=1e-5, rtol=0)
    torch.testing.assert_close(m1, m2, atol=1e-6, rtol=0)


def test_plain_empty_rows_and_unmapped_pages():
    """A row with length 0 gets zeros (out and mass); a table entry < 0
    inside the length is never read and carries no mass; the reference
    oracle agrees on the rows it defines."""
    q, kp, vp, pt, ln = _inputs(7, 8, 2)
    ln[1] = 0
    pt[2, 1] = -1                       # unmapped page inside row 2's span
    tq, tk, tv, tt, tl = _t(q, kp, vp, pt, ln)
    out, mass = tpa.paged_attention_plain(tq, tk, tv, tt, tl)
    assert torch.count_nonzero(out[1]) == 0
    assert torch.count_nonzero(mass[1]) == 0
    assert mass[2, 1] == 0
    np.testing.assert_allclose(mass.sum(dim=1).numpy()[[0, 2]], [1, 1],
                               atol=1e-5)
    ro, rm = rref.paged_attention_ref(*_j(q, kp, vp, np.maximum(pt, 0), ln),
                                      return_mass=True)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ro)[0], atol=1e-5)
    np.testing.assert_allclose(mass[0].numpy(), np.asarray(rm)[0], atol=1e-5)


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; a tensor elsewhere that is
    not on a CUDA card raises instead of falling back."""
    args = [torch.empty((1, 4, 16), device="meta"),
            torch.empty((2, 4, 4, 16), device="meta"),
            torch.empty((2, 4, 4, 16), device="meta"),
            torch.zeros((1, 2), dtype=torch.int32, device="meta"),
            torch.ones((1,), dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpa.paged_attention(*args)
