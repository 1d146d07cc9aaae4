"""The port's AdamW against the reference's on identical gradients, and
the port's train step under the reference's own checks
(``tests/test_archs_smoke.py``'s train step and accumulation,
``tests/test_substrate.py``'s optimizer tests) plus remat, the MoE aux
loss and the flash route's refusal.

Tolerances.  On identical gradients below the clip the moments are
bit-equal in every state precision (the same float32 operations in the
same order; ``torch.round`` and ``jnp.round`` both round half to even),
the int8 codes too; the parameters, the int8 scales and zeros within
1e-6 relative (``pow``, ``cos``, ``log`` and ``exp`` may differ by an ulp
between the two libraries).  With the clip engaged the gradient norm
differs by float32 rounding (a sum in another order), which every moment
then carries: 1e-5 relative."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.models import model as RM
from repro.train import optim as RO
from repro.train import step as RS

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.models import model as TM
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

OCFG = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
SHAPES = {"a": (300, 77), "b": (129,), "c": (4, 64, 33)}
ULP_RTOL, CLIP_RTOL = 1e-6, 1e-5


def _grads(rng, scale_exp):
    lo, hi = scale_exp
    return {k: (rng.standard_normal(s) * 10 ** rng.uniform(lo, hi, s))
            .astype(np.float32) for k, s in SHAPES.items()}


def _run_both(dtype, steps, scale_exp, **kw):
    rng = np.random.default_rng(0)
    p0 = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
          for k, s in SHAPES.items()}
    rc = RO.OptConfig(**OCFG, state_dtype=dtype, **kw)
    tc = TO.OptConfig(**OCFG, state_dtype=dtype, **kw)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    rs, ts = RO.init(rp, rc), TO.init(tp, tc)
    metrics = []
    for _ in range(steps):
        g = _grads(rng, scale_exp)
        rp, rs, rm = RO.update({k: jnp.asarray(v) for k, v in g.items()},
                               rs, rp, rc)
        tp, ts, tm = TO.update({k: torch.tensor(v) for k, v in g.items()},
                               ts, tp, tc)
        metrics.append((rm, tm))
    return rp, rs, tp, ts, metrics


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_adamw_matches_reference_on_identical_gradients(dtype):
    """Three steps below the clip: m and v (int8: their codes) bit-equal to
    the reference's, everything else within an ulp's worth."""
    rp, rs, tp, ts, metrics = _run_both(dtype, 3, (-7, -2.5))
    for rm, tm in metrics:
        assert float(tm["lr"]) == float(rm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=ULP_RTOL)
    assert int(ts["count"]) == int(rs["count"]) == 3
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                   rtol=ULP_RTOL, atol=ULP_RTOL * 0.05)
        for key in ("m", "v"):
            t, r = ts[key][k], rs[key][k]
            if dtype == "int8":
                np.testing.assert_array_equal(t.q.numpy(), np.asarray(r.q))
                for f in ("scale", "zero"):
                    np.testing.assert_allclose(
                        getattr(t, f).numpy(), np.asarray(getattr(r, f)),
                        rtol=ULP_RTOL)
            else:
                assert t.dtype == getattr(torch, dtype)
                np.testing.assert_array_equal(
                    t.float().numpy(), np.asarray(r, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_adamw_clip_matches_reference(dtype):
    """Gradients far above the clip: the norm reported before the clip,
    the clipped moments within ``CLIP_RTOL`` of the reference's."""
    rp, rs, tp, ts, metrics = _run_both(dtype, 2, (-1, 1), grad_clip=0.5)
    for rm, tm in metrics:
        assert float(tm["grad_norm"]) > 0.5
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=ULP_RTOL)
    for k in SHAPES:
        for key, mode in (("m", "linear"), ("v", "log")):
            got = TO._unpack(ts[key][k], SHAPES[k], dtype, mode)
            want = np.asarray(RO._unpack(rs[key][k], SHAPES[k], dtype, mode))
            bar = CLIP_RTOL + (2 / 127 if dtype == "int8" and mode ==
                               "linear" else 0.0)
            if dtype == "int8" and mode == "log":
                bar = 0.05          # v's codes step by a few % (log scale)
            assert np.abs(got.numpy() - want).max() <= \
                bar * np.abs(want).max(), (k, key)


def test_grad_clip_caps_update_norm():
    """The reference's check: the reported norm is the one before the
    clip."""
    cfg = TO.OptConfig(lr=1e-2, grad_clip=0.5)
    params = {"w": torch.zeros(10)}
    st = TO.init(params, cfg)
    _, _, m = TO.update({"w": torch.full((10,), 1e6)}, st, params, cfg)
    assert float(m["grad_norm"]) > 1e6


@pytest.mark.parametrize("mode", ["linear", "log"])
def test_quantize_codes_equal_reference(mode):
    """One input (zeros, tiny values, a ragged last block): the int8 codes
    equal the reference's, and dequantisation within the reference's
    error bound."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(1000).astype(np.float32) * 5
    x[:40] = 0.0
    x[40:80] = 1e-20
    if mode == "log":
        x = x * x                       # v: non-negative
    r = RO._pack(jnp.asarray(x), "int8", mode)
    t = TO._pack(torch.tensor(x), "int8", mode)
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(r.q))
    np.testing.assert_allclose(t.scale.numpy(), np.asarray(r.scale),
                               rtol=ULP_RTOL)
    np.testing.assert_allclose(t.zero.numpy(), np.asarray(r.zero),
                               rtol=ULP_RTOL)
    y = TO._unpack(t, x.shape, "int8", mode).numpy()
    np.testing.assert_allclose(
        y, np.asarray(RO._unpack(r, x.shape, "int8", mode)), rtol=ULP_RTOL,
        atol=1e-30)
    if mode == "linear":
        assert np.abs(x - y).max() <= np.abs(x).max() / 127 + 1e-6
    else:
        assert (y[:40] == 0).all()


def test_lr_schedule_matches_reference():
    cfg = dict(lr=1.0, warmup_steps=10, decay_steps=100, min_lr_frac=0.1)
    steps = [0, 5, 9, 10, 11, 50, 99, 100, 200]
    lrs = [float(TO.schedule(TO.OptConfig(**cfg), torch.tensor(s)))
           for s in steps]
    ref = [float(RO.schedule(RO.OptConfig(**cfg), jnp.asarray(s)))
           for s in steps]
    np.testing.assert_allclose(lrs, ref, rtol=ULP_RTOL)
    assert lrs[0] < lrs[1] < lrs[3]          # warmup
    assert lrs[3] >= lrs[5] >= lrs[7]        # decay
    assert abs(lrs[-1] - 0.1) < 1e-6         # floor


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_adamw_state_dtypes_converge(dtype):
    """The reference's check on the port: every state precision reduces
    the loss on an overfittable batch (int8 by less)."""
    cfg = TC.reduced("stablelm-12b")
    ocfg = TO.OptConfig(lr=2e-3, state_dtype=dtype, warmup_steps=2,
                        decay_steps=50)
    state = TS.init_state(cfg, ocfg, device="cpu")
    batch = batch_at(DataConfig(seed=0, global_batch=4, seq_len=32), cfg, 0)
    fn = TS.make_train_step(cfg, ocfg)
    losses = []
    for _ in range(10):
        state, m = fn(state, batch)
        losses.append(float(m["loss"]))
    drop = 0.05 if dtype == "int8" else 0.2
    assert losses[-1] < losses[0] - drop, losses


@pytest.mark.parametrize("name", TC.ARCHS)
def test_train_step(name):
    """``tests/test_archs_smoke.py::test_train_step`` on the port: a finite
    loss near ln(vocab), a finite non-zero gradient norm, and a second
    step on the same batch lowers the loss."""
    cfg = TC.reduced(name)
    ocfg = TO.OptConfig(**OCFG)
    state = TS.init_state(cfg, ocfg, device="cpu")
    batch = batch_at(DataConfig(seed=1, global_batch=4, seq_len=16), cfg, 0)
    ts = TS.make_train_step(cfg, ocfg)
    state, m = ts(state, batch)
    loss = float(m["loss"])
    assert np.isfinite(loss) and 2.0 < loss < 12.0, loss
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    _, m2 = ts(state, batch)
    assert float(m2["loss"]) < loss


@pytest.mark.parametrize("name", TC.ARCHS)
def test_accumulation_and_remat(name):
    """``accum_steps=2``: the gradients are the float32 mean of the two
    microbatches' (bit for bit) and, without MoE, match one pass's within
    1e-5 of the leaf's largest, the loss within 1e-6 (the reference's
    test asks 2e-2 of the loss, which MoE configs are held to: their aux
    loss is not linear in the tokens); ``cfg.remat``
    (checkpointed repeats) is bit-equal to no remat on the CPU."""
    cfg = TC.reduced(name)
    batch = TS.to_device(batch_at(DataConfig(seed=2, global_batch=4,
                                             seq_len=16), cfg, 0), "cpu")
    params = TS.trainable(TM.init(cfg, seed=3, device="cpu"))
    g1, l1 = TS._grads(params, cfg, batch, 1, False)
    g2, l2 = TS._grads(params, cfg, batch, 2, False)
    halves = [TS._grads(params, cfg, mb, 1, False)
              for mb in TS._split_microbatches(batch, 2)]
    assert float(l2) == float((halves[0][1] + halves[1][1]) / 2)
    for n in g1:
        torch.testing.assert_close(g2[n], (halves[0][0][n]
                                           + halves[1][0][n]) / 2,
                                   rtol=0, atol=0)
    if cfg.moe is not None:
        # the aux loss is a product of per-microbatch means, so the
        # microbatches' mean is not one pass's (as in the reference)
        np.testing.assert_allclose(float(l2), float(l1), rtol=2e-2)
    else:
        np.testing.assert_allclose(float(l2), float(l1), rtol=1e-6)
    for n in (g1 if cfg.moe is None else ()):
        # the token table's gradient is summed in bfloat16
        # (``layers.embed``): one bfloat16 ulp, 2^-7 of an element
        bar = 2.0 ** -7 if n == "tok" else 1e-5
        scale = float(g1[n].abs().max())
        assert float((g2[n] - g1[n]).abs().max()) <= bar * scale + 1e-12, n
    g3, l3 = TS._grads(params, dataclasses.replace(cfg, remat=True), batch,
                       1, False)
    assert float(l3) == float(l1)
    for n in g1:
        torch.testing.assert_close(g3[n], g1[n], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["qwen3-14b", "olmoe-1b-7b",
                                  "deepseek-v3-671b", "recurrentgemma-2b",
                                  "musicgen-large"])
def test_repeat_views_give_the_indexed_gradients(name, monkeypatch):
    """Three repeats a segment: the gradients through
    ``model.RepeatView`` (one unbind a leaf) equal those of indexing the
    stacked leaves a repeat at a time, bit for bit, and so does the
    loss."""
    cfg = TC.reduced(name)
    cfg = dataclasses.replace(cfg, segments=tuple(
        (pat, 3) for pat, _ in cfg.segments))
    params = TS.trainable(TM.init(cfg, seed=1, device="cpu"))
    batch = TS.to_device(batch_at(DataConfig(global_batch=2, seq_len=16),
                                  cfg, 0), "cpu")
    g1, l1 = TS._grads(params, cfg, batch, 1, False)
    monkeypatch.setattr(TM, "RepeatView", lambda mod: mod)
    g2, l2 = TS._grads(params, cfg, batch, 1, False)
    assert float(l1) == float(l2)
    for n in g1:
        torch.testing.assert_close(g1[n], g2[n], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_loss_aux_sums_moe_layers_as_reference(name):
    """The training loss's MoE aux term: the port sums every MoE layer's;
    the reference's scan adds a pattern's last slot's, the same sum for a
    single-slot pattern -- here stacked over 3 repeats."""
    rcfg = dataclasses.replace(RC.reduced(name), segments=tuple(
        (pat, 3 if any("moe" in k for k in pat) else rep)
        for pat, rep in RC.reduced(name).segments))
    tcfg = dataclasses.replace(TC.reduced(name), segments=rcfg.segments)
    rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
    tp = bridge.from_reference(jax.tree.map(np.asarray, rp), tcfg,
                               device="cpu")
    batch = batch_at(DataConfig(seed=0, global_batch=2, seq_len=16), tcfg, 0)
    rl, rm = RS.loss_fn(rp, rcfg, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    tl, tm = TS.loss_fn(tp, tcfg, TS.to_device(batch, "cpu"))
    assert float(rm["aux"]) > 0
    np.testing.assert_allclose(float(tm["aux"]), float(rm["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(tl), float(rl), rtol=1e-6)


def test_flash_route_refused():
    cfg = dataclasses.replace(TC.reduced("qwen3-14b"),
                              attention_impl="pallas")
    with pytest.raises(ValueError, match="no backward"):
        TS.make_train_step(cfg, TO.OptConfig())


def test_serving_leaves_stay_frozen():
    """``model.init`` (serving) keeps every leaf frozen; ``init_state``
    turns gradients on for its own parameters only."""
    cfg = TC.reduced("qwen3-14b")
    served = TM.init(cfg, device="cpu")
    state = TS.init_state(cfg, TO.OptConfig(), device="cpu")
    assert not any(p.requires_grad for p in served.parameters())
    assert all(p.requires_grad for p in state["params"].parameters())
