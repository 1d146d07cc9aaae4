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
those of ``tests/test_kernels.py``'s flash tests.

The CUDA kernel's own arithmetic is checked here where it can be: its
3xTF32 products, emulated in torch, meet the float32 tolerances it is
held to on the card (2e-5 up to 512 keys, 1e-4 at 2048) while one TF32
pass misses them, and its grid (``block_plan``) visits every attended
(query, key) pair exactly once."""
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


# ---------------------------------------------------------------------------
# The CUDA kernel's arithmetic, emulated in torch.  float32 runs both
# products on the tensor cores as 3xTF32: each operand x is split as hi =
# rna(x), lo = rna(x - hi), where rna is cvt.rna.tf32.f32 (round to nearest,
# ties away from zero, to a 10-bit mantissa), and a product is lo*hi +
# hi*lo, then + hi*hi, in float32.


def _rna(x):
    """cvt.rna.tf32.f32 on the int32 view: add half of the 13 dropped bits'
    range to the magnitude, then clear them."""
    bits = (x.float().contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def _split(x):
    hi = _rna(x)
    return hi, _rna(x.float() - hi)


def _product(a, b, eq, passes):
    """einsum ``eq`` of a and b as the kernel's TF32 passes compute it: 3
    (lo*hi + hi*lo + hi*hi) or 1 (hi*hi)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) \
        + torch.einsum(eq, ah, bh)


def _emulated(q, k, v, *, causal, window, passes):
    """``flash_attention_plain`` with q.k and p.v taken in TF32 passes."""
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    logits = _product(qg, k, "bsgrd,btgd->bgrst", passes) \
        * (1.0 / np.sqrt(d))
    i = torch.arange(s)[:, None]
    j = torch.arange(t)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= j > i - window
    logits = logits.masked_fill(~mask, tfa.NEG)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1).clamp_min(1e-30)
    out = _product(p, v, "bgrst,btgd->bsgrd", passes)
    out = out / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, h, d)


def test_tf32_rounding_is_cvt_rna():
    """The emulation rounds to nearest with ties away from zero, keeps 10
    mantissa bits, and hi + lo recovers x to ~2^-22 relative."""
    one = 1.0 + 2.0 ** -11          # a tie between 1 and 1 + 2^-10
    x = torch.tensor([one, -one, 1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -12,
                      2.0 - 2.0 ** -23, 0.0, -0.0, 1e-30])
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                         1.0 + 2.0 ** -10, 1.0, 2.0, 0.0, -0.0, 1e-30])
    got = _rna(x)
    np.testing.assert_array_equal(got[:7].numpy(), want[:7].numpy())
    assert abs(float(got[7]) - 1e-30) <= 1e-30 * 2.0 ** -11
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32)) * 100
    hi, lo = _split(r)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert (lo.view(torch.int32) & 0x1FFF == 0).all()
    rel = ((hi.double() + lo.double() - r.double()).abs()
           / r.double().abs()).max()
    assert rel <= 2.0 ** -21


_SPLIT_CASES = [(2, 1, 16, 8, True, 0), (2, 37, 16, 8, True, 0),
                (2, 256, 16, 8, True, 64), (1, 512, 16, 8, True, 0),
                (2, 200, 16, 8, False, 0), (1, 2048, 2, 1, True, 1024)]


@pytest.mark.parametrize("b,s,h,kv,causal,window", _SPLIT_CASES)
def test_3xtf32_products_meet_the_float32_tolerances(b, s, h, kv, causal,
                                                     window):
    """q.k and p.v in 3xTF32 at D = 256 against ``flash_attention_plain``
    and the JAX oracle: 2e-5 up to 512 keys, 1e-4 at 2048 (the kernel's
    tolerances on the card)."""
    q, k, v = _inputs(s + h, b, s, h, kv, 256)
    kw = dict(causal=causal, window=window)
    ours = _emulated(*(_t(a) for a in (q, k, v)), passes=3, **kw)
    tol = 2e-5 if s <= 512 else 1e-4
    plain = tfa.flash_attention_plain(*(_t(a) for a in (q, k, v)), **kw)
    oracle = rref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                      **kw)
    for r in (plain, oracle):
        np.testing.assert_allclose(_np(ours), _np(r), atol=tol, rtol=0)


@pytest.mark.parametrize("b,s,h,kv,causal,window", _SPLIT_CASES)
def test_one_tf32_pass_misses_the_float32_tolerances(b, s, h, kv, causal,
                                                     window):
    """Why the kernel splits: one TF32 pass (hi*hi) misses the same bars
    on the same inputs.  At S = 1 the output is v itself, rounded by
    ~2^-11 relative."""
    q, k, v = _inputs(s + h, b, s, h, kv, 256)
    kw = dict(causal=causal, window=window)
    one = _emulated(*(_t(a) for a in (q, k, v)), passes=1, **kw)
    plain = tfa.flash_attention_plain(*(_t(a) for a in (q, k, v)), **kw)
    tol = 2e-5 if s <= 512 else 1e-4
    assert float((one - plain).abs().max()) > tol


_PLAN_MASKS = [(300, 300, True, 0), (300, 300, True, 64),
               (300, 300, True, 1024), (300, 300, False, 0),
               (300, 300, False, 64), (70, 300, True, 0), (1, 40, True, 0)]


@pytest.mark.parametrize("h,kv,s,t,causal,window", [
    (h, kv) + m for h, kv in ((4, 4), (4, 2), (10, 2), (16, 2), (128, 1))
    for m in _PLAN_MASKS] + [(4, 4, 1100, 1100, True, 1024),
                             (4, 2, 1100, 1100, True, 1024)])
def test_block_plan_visits_each_attended_pair_once(h, kv, s, t, causal,
                                                   window):
    """``block_plan`` (the kernel's grid): every (query, head) row in one
    block of at most ``BLOCK_ROWS`` rows, every attended (row, key) pair in
    exactly one visited tile of it, no visited tile without an attended
    pair, and the last query tile first (the heaviest under a plain causal
    mask).  GQA rep 1, 2, 5 (one head a block), 8 and 128."""
    i = np.arange(s)[:, None]
    j = np.arange(t)[None, :]
    attended = np.ones((s, t), bool)
    if causal:
        attended &= j <= i
    if window > 0:
        attended &= j > i - window
    seen = np.zeros((2, h, s, t), np.int32)
    owner = np.zeros((2, h, s), np.int32)
    plan = tfa.block_plan(2, s, t, h, kv, causal=causal, window=window)
    rep = h // kv
    for row, pos, heads, tiles in plan:
        assert len(heads) in (1, rep)
        assert len(heads) * len(pos) <= tfa.BLOCK_ROWS
        assert pos.start % (tfa.BLOCK_ROWS // len(heads)) == 0
        assert heads.start // rep == (heads.stop - 1) // rep  # one KV head
        owner[row, heads.start:heads.stop, pos.start:pos.stop] += 1
        for kt in tiles:
            keys = slice(kt * tfa.KV_TILE, min((kt + 1) * tfa.KV_TILE, t))
            sub = attended[pos.start:pos.stop, keys]
            assert sub.any(), (pos, kt)
            seen[row, heads.start:heads.stop, pos.start:pos.stop, keys] \
                += sub
    assert (owner == 1).all()
    np.testing.assert_array_equal(seen, np.broadcast_to(attended, seen.shape))
    starts = [pos.start for _, pos, _, _ in plan]
    assert starts == sorted(starts, reverse=True)
    if causal and not window:
        sizes = [len(tiles) for *_, tiles in plan]
        assert sizes == sorted(sizes, reverse=True)


# ---------------------------------------------------------------------------
# The query offset: a prefill chunk's queries sit at positions q_offset + i
# over the keys of the earlier chunks and its own.  The TPU kernel counts
# query positions from 0, so the reference for a chunk is the JAX oracle
# (and the Pallas kernel, where its tiles divide) over the queries padded
# at the front to position 0, its last S rows.


def _shifted_reference(args, q_offset, *, pallas_tiles=None, **kw):
    q, k, v = args
    pad = np.zeros((q.shape[0], q_offset) + q.shape[2:], q.dtype)
    jargs = [jnp.asarray(np.concatenate([pad, q], axis=1)), jnp.asarray(k),
             jnp.asarray(v)]
    outs = [rref.flash_attention_ref(*jargs, **kw)]
    if pallas_tiles is not None:
        outs.append(rops.flash_attention(*jargs, bq=pallas_tiles,
                                         bkv=pallas_tiles,
                                         impl="interpret", **kw))
    return [np.asarray(o, np.float32)[:, q_offset:] for o in outs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,q_offset,causal,window,tiles", [
    (64, 64, True, 0, 32), (64, 128, True, 48, 32), (64, 32, False, 0, 32),
    (32, 96, True, 0, 32), (37, 59, True, 0, None), (37, 59, True, 24, None),
    (1, 95, True, 0, None), (1, 95, True, 16, None),
    (48, 0, True, 16, None)])
def test_query_offset_matches_the_shifted_reference(s, q_offset, causal,
                                                    window, tiles, dtype):
    """q_offset 32-128 with S = 64 or 32 (the Pallas kernel too, where
    its tiles divide the padded lengths), an offset that is no multiple of
    the kernel's 32-key tile (59) with S = 37, S = 1 at the last
    position, and offset 0: the port's wrapper (the plain version on the
    CPU) and the plain version itself against the JAX oracle over the
    padded queries."""
    t = q_offset + s
    args = _inputs(q_offset + 7 * s, 1, s, 4, 2, 64, dtype=dtype, t=t)
    kw = dict(causal=causal, window=window)
    targets = _shifted_reference(args, q_offset, pallas_tiles=tiles, **kw)
    targs = [_t(a) for a in args]
    for o in (tops.flash_attention(*targs, q_offset=q_offset, **kw),
              tfa.flash_attention_plain(*targs, q_offset=q_offset, **kw)):
        assert o.shape == targs[0].shape and o.dtype == targs[0].dtype
        for r in targets:
            np.testing.assert_allclose(_np(o), r, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("window", [0, 24])
def test_query_offset_chunks_equal_one_pass(window):
    """A 100-query pass cut into chunks of 32 (starts 0, 32, 64, 96), each
    over its keys so far with q_offset = its start, equals the one pass
    row for row; q_offset 0 is the one pass itself, bit for bit."""
    q, k, v = (_t(a) for a in _inputs(5, 2, 100, 4, 4, 32))
    full = tfa.flash_attention(q, k, v, window=window)
    assert torch.equal(tfa.flash_attention(q, k, v, window=window,
                                           q_offset=0), full)
    for lo in range(0, 100, 32):
        hi = min(lo + 32, 100)
        part = tfa.flash_attention(q[:, lo:hi].contiguous(),
                                   k[:, :hi].contiguous(),
                                   v[:, :hi].contiguous(), window=window,
                                   q_offset=lo)
        np.testing.assert_allclose(_np(part), _np(full[:, lo:hi]),
                                   atol=TOL["float32"], rtol=0)


def test_wrapper_refuses_a_bad_query_offset():
    """A negative offset and q_offset + S > T raise on every device."""
    q, k, v = (_t(a) for a in _inputs(0, 1, 8, 2, 2, 16, t=12))
    tfa.flash_attention(q, k, v, q_offset=4)
    for off in (-1, 5):
        with pytest.raises(ValueError, match="q_offset"):
            tfa.flash_attention(q, k, v, q_offset=off)


@pytest.mark.parametrize("h,kv,s,q_offset,causal,window", [
    (h, kv) + m for h, kv in ((4, 4), (16, 8), (10, 2))
    for m in ((512, 512, True, 0), (512, 1536, True, 1024),
              (512, 496, True, 1024), (512, 496, True, 0), (1, 2047, True, 0),
              (1, 2047, True, 1024), (70, 33, True, 16), (70, 33, False, 0),
              (300, 5, True, 64))])
def test_block_plan_with_query_offset_visits_each_attended_pair_once(
        h, kv, s, q_offset, causal, window):
    """``block_plan`` with a query offset (the served chunk shapes: S =
    512 at starts 512, 1536 and 496 -- no multiple of the 32-key tile --,
    window 1024; S = 1 at the last position): every attended (row, key)
    pair of the shifted mask in exactly one visited tile, no visited tile
    without one, so no block skips a tile its first rows need."""
    t = q_offset + s
    i = q_offset + np.arange(s)[:, None]
    j = np.arange(t)[None, :]
    attended = np.ones((s, t), bool)
    if causal:
        attended &= j <= i
    if window > 0:
        attended &= j > i - window
    seen = np.zeros((1, h, s, t), np.int32)
    owner = np.zeros((1, h, s), np.int32)
    for row, pos, heads, tiles in tfa.block_plan(
            1, s, t, h, kv, causal=causal, window=window, q_offset=q_offset):
        owner[row, heads.start:heads.stop, pos.start:pos.stop] += 1
        for kt in tiles:
            keys = slice(kt * tfa.KV_TILE, min((kt + 1) * tfa.KV_TILE, t))
            sub = attended[pos.start:pos.stop, keys]
            assert sub.any(), (pos, kt)
            seen[row, heads.start:heads.stop, pos.start:pos.stop, keys] \
                += sub
    assert (owner == 1).all()
    np.testing.assert_array_equal(seen, np.broadcast_to(attended, seen.shape))
