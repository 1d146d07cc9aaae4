"""The port's chunked prefill against the JAX reference:
``model.prefill_chunk`` + ``chunk_past_extend`` against the reference's
on bridged weights (``_check_prefill_chunk``, the check every
batched-prefill architecture of the geometry matrix takes) for qwen3,
gemma3 (its window of 8 split by chunks of 4 and 6) and deepseek (MLA +
MoE), under both ``attention_impl`` settings, and against the port's own
``prefill_batched``; the flash route's query offset.  The other
architectures are in ``tests/test_torch_pipelined_chunk_more.py`` and
``tests/test_torch_pipelined_chunk_head_dims.py``.  The reference's side
of a model's chunks does not depend on the port's ``attention_impl``: it
is made once a model (``_reference_chunks``).
``tests/test_torch_pipelined.py`` holds the models and the
tolerances."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from repro.models import model as RM

from repro_torch.models import model as TM

from test_torch_pipelined import CHUNK_ARCHS, LOGIT_TOL, TOL, _close, _models

CHUNK_LENGTHS = (14, 9, 3)
CHUNK_WIDTHS = (4, 6)


def _pallas_ok(tcfg) -> bool:
    try:
        TM.check_supported(tcfg)
        return True
    except NotImplementedError:
        return False


# the other architectures: test_torch_pipelined_chunk_more.py and
# test_torch_pipelined_chunk_head_dims.py
@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("arch", CHUNK_ARCHS[:3])
def test_prefill_chunk_matches_reference(arch, impl):
    """Three rows of 14, 9 and 3 tokens in chunks of 4 (and of 6, which
    with gemma3's window of 8 puts a window edge inside a chunk): every
    chunk's logits and cache rows against the reference's
    ``prefill_chunk`` over the same past, the accumulated past against
    the reference's ``chunk_past_extend``, and the final past and each
    row's last logits against the port's own ``prefill_batched``.  MLA
    (deepseek) cannot take the flash route: there the setting raises."""
    _check_prefill_chunk(_models(arch), impl)


def _chunk_tokens(m):
    """The three rows' tokens [3, 16] (seeded) and their conditioning."""
    toks = np.random.default_rng(3).integers(
        0, m["rcfg"].vocab_size, (3, 16)).astype(np.int32)
    cond = None
    if m["cond"] is not None:
        cond = np.ascontiguousarray(np.broadcast_to(
            m["cond"], (3,) + m["cond"].shape[1:]))
    return toks, cond


def _reference_chunks(m):
    """The reference's side of ``_check_prefill_chunk``, made once a model
    (it does not depend on the port's ``attention_impl``): for each chunk
    width, each chunk's (logits, cache, accumulated past) from
    ``prefill_chunk`` + ``chunk_past_extend``."""
    if "ref_chunks" not in m:
        toks, cond = _chunk_tokens(m)
        rcond = None if cond is None else jnp.asarray(cond)
        lengths = jnp.asarray(CHUNK_LENGTHS, jnp.int32)
        out = {}
        for width in CHUNK_WIDTHS:
            rpast, out[width] = None, []
            for lo in range(0, 16, width):
                hi = min(lo + width, 16)
                rl, rc = RM.prefill_chunk(m["rp"], m["rcfg"],
                                          jnp.asarray(toks[:, lo:hi]),
                                          lengths, rpast, start=lo,
                                          cond=rcond)
                rpast = RM.chunk_past_extend(rpast, rc)
                out[width].append((rl, rc, rpast))
        m["ref_chunks"] = out
    return m["ref_chunks"]


def _check_prefill_chunk(m, impl):
    rcfg, tp = m["rcfg"], m["tp"]
    tcfg = dataclasses.replace(m["tcfg"], attention_impl=impl)
    if impl == "pallas" and not _pallas_ok(tcfg):
        with pytest.raises(NotImplementedError, match="MLA"):
            TM.check_supported(tcfg)
        return
    lengths = np.asarray(CHUNK_LENGTHS, np.int64)
    toks, cond = _chunk_tokens(m)
    tcond = None if cond is None else torch.from_numpy(cond)
    ref = _reference_chunks(m)
    bl, bc = TM.prefill_batched(tp, tcfg, torch.from_numpy(toks).long(),
                                torch.from_numpy(lengths), cond=tcond)
    for width in CHUNK_WIDTHS:
        tpast = None
        last = {}
        for lo, (rl, rc, rpast) in zip(range(0, 16, width), ref[width]):
            hi = min(lo + width, 16)
            tl, tc = TM.prefill_chunk(
                tp, tcfg, torch.from_numpy(toks[:, lo:hi]).long(),
                torch.from_numpy(lengths), tpast, start=lo, cond=tcond)
            assert tl.shape == (3, 1, rcfg.vocab_size)
            _close(tl.numpy(), rl, LOGIT_TOL)
            for tseg, rseg in zip(tc["segments"], rc["segments"]):
                for t, r in zip(tseg, rseg):
                    assert sorted(t) == sorted(r)
                    for name, a in t.items():
                        _close(a.numpy(), r[name], TOL)
            for b in range(3):
                if lo <= lengths[b] - 1 < hi:
                    last[b] = tl[b]
            tpast = TM.chunk_past_extend(tpast, tc)
            for tseg, rseg in zip(tpast["segments"], rpast["segments"]):
                for t, r in zip(tseg, rseg):
                    assert sorted(t) == sorted(r) and "pos" not in t
                    for name, a in t.items():
                        assert a.shape[2] == hi
                        _close(a.numpy(), r[name], TOL)
        _close(torch.stack([last[b] for b in range(3)]).numpy(),
               bl.numpy(), LOGIT_TOL)
        for tseg, bseg in zip(tpast["segments"], bc["segments"]):
            for t, b in zip(tseg, bseg):
                for name, a in t.items():
                    _close(a.numpy(), b[name].numpy(), TOL)


def test_flash_route_takes_the_past_length_as_query_offset(monkeypatch):
    """On the flash route a chunk's attention is one
    ``ops.flash_attention`` call a layer with ``q_offset`` = the chunk's
    start over ``past ++ own`` keys; key positions that are not
    ``arange(start + S)`` are refused."""
    m = _models("gemma3-12b")
    tcfg = dataclasses.replace(m["tcfg"], attention_impl="pallas")
    from repro_torch.kernels import ops
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], kw["q_offset"], kw["window"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    toks = torch.arange(8, dtype=torch.long)[None] % tcfg.vocab_size
    _, c0 = TM.prefill_chunk(m["tp"], tcfg, toks[:, :4], torch.tensor([8]),
                             start=0)
    TM.prefill_chunk(m["tp"], tcfg, toks[:, 4:], torch.tensor([8]),
                     TM.chunk_past_extend(None, c0), start=4)
    layers = tcfg.num_layers
    assert seen[:layers] == [(4, 4, 0, w) for w in
                             [8, 8, 8, 8, 8, 0]]
    assert seen[layers:] == [(4, 8, 4, w) for w in [8, 8, 8, 8, 8, 0]]
    from repro_torch.models import layers as TL
    slot = m["tp"].segments[0][0]
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(ValueError, match="start"):
        TL.attention_apply(slot, 0, tcfg, x, torch.arange(4)[None] + 4,
                           past=(torch.zeros(1, 4, tcfg.num_kv_heads,
                                             tcfg.head_dim),) * 2,
                           k_positions=torch.arange(4)[None])
