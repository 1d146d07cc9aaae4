"""The port's ``layers.sdpa``, chunked over queries, against the
reference's ``_sdpa_chunked`` (``repro/models/layers.py:152``).

The same numpy-seeded float32 inputs go to both: self-attention of
S = T = 1024 (the reference splits it in two chunks of 512) and 1100
(the reference takes it whole, the port in chunks of 512, 512 and 76),
GQA 4/2 and 8/1, causal, window 8, a bidirectional prefix and rows padded
to their lengths, soft-cap 0 and 30, and a value width other than the key
width (MLA's).  Outputs within 1e-5; the chunked form's gradients of q, k
and v within 1e-5 of the whole form's (``SDPA_Q_CHUNK`` set past S: one
chunk, the port's form before the chunking), since every training step
runs through it; no softmax ever sees more than ``SDPA_Q_CHUNK`` query
rows."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from repro.models import layers as RL

from repro_torch.models import layers as TL

TOL = 1e-5
B, D = 2, 16
PREFIX = 40
# (S, heads, KV heads, mask, soft-cap, value width)
CASES = {
    "s1024-gqa4/2-causal": (1024, 4, 2, "causal", 0.0, D),
    "s1100-gqa8/1-window8-softcap30": (1100, 8, 1, "window", 30.0, D),
    "s1024-gqa8/1-prefix-softcap30-dv24": (1024, 8, 1, "prefix", 30.0, 24),
    "s1100-gqa4/2-prefix-dv8": (1100, 4, 2, "prefix", 0.0, 8),
    "s1100-gqa8/1-padded-rows-softcap30": (1100, 8, 1, "padded", 30.0, D),
}


def _mask(s, kind):
    """Bool [1, S, S] (or [B, S, S] for padded rows): causal, a causal
    window of 8, causal with a bidirectional prefix of ``PREFIX``
    positions, or causal over each row's length (a batch padded on the
    right, as packed admission pads it)."""
    q = np.arange(s)[:, None]
    k = np.arange(s)[None, :]
    m = k <= q
    if kind == "window":
        m &= k > q - 8
    if kind == "prefix":
        m |= k < PREFIX
    if kind == "padded":
        lens = np.asarray([s, s // 2 + 3])
        return m[None] & (k[None] < lens[:, None, None])
    return m[None]


def _inputs(s, h, kv, dv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, h, D)).astype(np.float32)
    k = rng.standard_normal((B, s, kv, D)).astype(np.float32)
    v = rng.standard_normal((B, s, kv, dv)).astype(np.float32)
    return q, k, v


def _port(q, k, v, mask, softcap, grad=False):
    ts = [torch.from_numpy(x).requires_grad_(grad) for x in (q, k, v)]
    return TL.sdpa(*ts, torch.from_numpy(mask), softcap), ts


@pytest.mark.parametrize("case", list(CASES))
def test_sdpa_matches_reference_chunked(case):
    """Outputs equal the reference's ``_sdpa_chunked`` within 1e-5."""
    s, h, kv, kind, softcap, dv = CASES[case]
    q, k, v = _inputs(s, h, kv, dv, seed=s + h + dv)
    mask = _mask(s, kind)
    want = RL._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(mask), softcap)
    got, _ = _port(q, k, v, mask, softcap)
    assert tuple(got.shape) == (B, s, h, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_sdpa_chunked_gradients_match_whole_form(monkeypatch):
    """The gradients of q, k and v through the chunked form equal the
    whole form's (one chunk of every query) within 1e-5, at S = 1024 and
    1100, GQA 4/2 with window 8 and soft-cap 30, and a value width of 8."""
    for s in (1024, 1100):
        q, k, v = _inputs(s, 4, 2, 8, seed=s)
        mask = _mask(s, "window")
        g = torch.from_numpy(np.random.default_rng(s + 1).standard_normal(
            (B, s, 4, 8)).astype(np.float32))
        grads = {}
        for form, chunk in (("chunked", TL.SDPA_Q_CHUNK), ("whole", 1 << 30)):
            monkeypatch.setattr(TL, "SDPA_Q_CHUNK", chunk)
            out, ts = _port(q, k, v, mask, 30.0, grad=True)
            (out * g).sum().backward()
            grads[form] = (out.detach(), [t.grad for t in ts])
        monkeypatch.undo()
        np.testing.assert_allclose(grads["chunked"][0].numpy(),
                                   grads["whole"][0].numpy(), atol=TOL,
                                   rtol=0)
        for name, a, b in zip("qkv", grads["chunked"][1], grads["whole"][1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL,
                                       rtol=0, err_msg=f"d{name}, S={s}")


def test_sdpa_softmax_sees_one_chunk_of_queries(monkeypatch):
    """Every softmax ``sdpa`` runs takes at most ``SDPA_Q_CHUNK`` query
    rows: ceil(S / 512) of them over a prompt, the last ragged; a mask
    whose query dim is 1 (a decode step's) broadcasts to every row."""
    seen = []
    softmax = torch.softmax

    def watched(x, *a, **kw):
        seen.append(tuple(x.shape))
        return softmax(x, *a, **kw)

    monkeypatch.setattr(torch, "softmax", watched)
    s = 1100
    q, k, v = _inputs(s, 8, 1, D, seed=3)
    out, _ = _port(q, k, v, _mask(s, "causal"), 0.0)
    assert [x[-2] for x in seen] == [512, 512, 76]
    assert all(x[-1] == s for x in seen)
    # one query row against a [B, 1, T] mask
    seen.clear()
    one = torch.from_numpy(q[:, -1:])
    row = TL.sdpa(one, torch.from_numpy(k), torch.from_numpy(v),
                  torch.ones((B, 1, s), dtype=torch.bool), 0.0)
    assert [x[-2] for x in seen] == [1]
    monkeypatch.undo()
    np.testing.assert_allclose(row.numpy(), out[:, -1:].numpy(), atol=TOL,
                               rtol=0)
