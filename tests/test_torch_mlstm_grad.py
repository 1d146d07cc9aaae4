"""The mLSTM backward's CPU side (``kernels/mlstm_scan.py``).

On the CPU ``MlstmScanFunction`` runs ``mlstm_save_plain`` forward and
``mlstm_backward_plain`` backward -- the chunkwise decomposition the CUDA
backward kernel runs, written in torch -- so these tests hold what the
kernel is compared with on the card:

  * the plain backward against autograd of the per-position loop
    (``mlstm_loop``) in float64 (the same gradients to 1e-9 of their
    largest element: the decomposition is exact) and in float32, and
    against ``jax.vjp`` of a ``lax.scan`` over the reference's own
    ``_mlstm_cell``, on numpy inputs from a seed, over two chunk
    boundaries and a partial chunk, from the zero and a carried state:
    each float32 gradient, the plain backward's and the reference's,
    within ``MS.grad_check``'s bar of the float64 loop's (``GRAD_MULT``
    times the float32 loop's own largest distance from it)
    -- with q and k small, where the clamp max(|n . q|, 1) binds at every
    position, large, where it binds at none, and in between;
  * the final state's gradients (C, n, m) through the Function against
    autograd of the loop;
  * a mutant backward that drops the m chain (each gate takes only its
    own share, none of m's) misses the bar where the clamp binds: there
    h depends on the stabiliser m;
  * the Function refusing a starting state that asks for a gradient, and
    a non-float32 input;
  * the route rule under autograd: the dense sequence form through the
    Function (its forward bit-equal to the wrapper's), the paged branch
    through the plain version, the meta device through the loop, and
    reduced xlstm-1.3b's train step through both Functions.

The card's side (the kernel against the plain backward, the mutant
there) is ``tests/test_torch_gpu.py``'s and the smoke run's phase 47."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.models import recurrent as RR

import repro_torch.configs as TC
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.kernels import mlstm_scan as MS
from repro_torch.kernels import slstm_scan as SS
from repro_torch.models import recurrent as TR
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

# two chunks of 16 and a partial one
B, S, NH, HD = 2, 37, 2, 32
# the float64 decomposition against the float64 loop, relative to the
# gradient's largest element
EXACT = 1e-9


def _inputs(scale, carried, seed, aligned=False, shape=(B, S, NH, HD)):
    """numpy float32 of ``shape`` (B, S, nh, hd): q, k ~ N(0, scale^2)
    (``aligned``: every k of a head scale (w + N(0, 0.1^2)) about one w ~
    N(0, 1), and q = k + N(0, 0.1^2), so that every term of n . q is
    positive and n . q large), v, i ~ N(0, 1), log f = logsigmoid(N(1,
    1)), the zero or a carried state (C, n ~ N(0, 0.3^2), m ~ N(0, 1)) and
    the output gradient dh ~ N(0, 1)."""
    B, S, NH, HD = shape
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    if aligned:
        k = (n(NH, HD) + n(B, S, NH, HD) * 0.1) * scale
        q = k + n(B, S, NH, HD) * 0.1
    else:
        k, q = n(B, S, NH, HD) * scale, n(B, S, NH, HD) * scale
    out = dict(q=q, k=k, v=n(B, S, NH, HD), i=n(B, S, NH))
    out["f"] = -np.log1p(np.exp(-(n(B, S, NH) + 1))).astype(np.float32)
    if carried:
        out.update(C=n(B, NH, HD, HD) * 0.3, n=n(B, NH, HD) * 0.3,
                   m=n(B, NH))
    else:
        out.update(C=np.zeros((B, NH, HD, HD), np.float32),
                   n=np.zeros((B, NH, HD), np.float32),
                   m=np.full((B, NH), -1e30, np.float32))
    out["dh"] = n(B, S, NH, HD)
    return out


def _t(a, key, dt):
    return torch.from_numpy(a[key]).to(dt)


def _loop_grads(a, dt):
    """Autograd of ``mlstm_loop``: (dq, dk, dv, di, df)."""
    ins = [_t(a, x, dt).requires_grad_() for x in "qkvif"]
    _, _, _, h = MS.mlstm_loop(_t(a, "C", dt), _t(a, "n", dt),
                               _t(a, "m", dt), *ins)
    h.backward(_t(a, "dh", dt))
    return [x.grad for x in ins]


def _plain_grads(a, dt):
    """The plain backward after the plain forward, in ``dt``."""
    x = [_t(a, key, dt) for key in ("q", "k", "v", "i", "f", "C", "n", "m")]
    _, _, _, h, saves = MS.mlstm_save_plain(*x)
    return MS.mlstm_backward_plain(*x[:5], x[7], h, _t(a, "dh", dt), saves)


def _jax_grads(a):
    """``jax.vjp`` of a ``lax.scan`` over the reference's ``_mlstm_cell``
    (float32)."""
    state = tuple(jnp.asarray(a[x]) for x in ("C", "n", "m"))

    def run(q, k, v, i, f):
        seq = tuple(jnp.swapaxes(x, 0, 1) for x in (q, k, v, i, f))
        _, hs = jax.lax.scan(RR._mlstm_cell, state, seq)
        return jnp.swapaxes(hs, 0, 1)

    _, vjp = jax.vjp(run, *(jnp.asarray(a[x]) for x in "qkvif"))
    return [torch.from_numpy(np.array(g)) for g in
            vjp(jnp.asarray(a["dh"]))]


def _binds(a) -> float:
    """The share of positions where max(|n . q|, 1) takes the 1."""
    x = [_t(a, key, torch.float64) for key in ("q", "k", "v", "i", "f", "C",
                                               "n", "m")]
    return float((MS.mlstm_save_plain(*x)[4][2].abs() < 1).double().mean())


def _assert_within(chk):
    for name, (dist, bar) in chk.items():
        assert dist <= bar, (name, dist, bar)


@pytest.mark.parametrize("scale,binds", [(0.1, "all"), (3.0, "none"),
                                         (1.0, "some")])
@pytest.mark.parametrize("carried", [False, True])
def test_plain_backward_matches_autograd_and_the_reference(scale, binds,
                                                           carried):
    a = _inputs(scale, carried, seed=int(scale * 10) + carried,
                aligned=binds == "none")
    share = _binds(a)
    assert {"all": share == 1.0, "none": share == 0.0,
            "some": 0.1 < share < 0.9}[binds], share
    loop64, loop32 = _loop_grads(a, torch.float64), \
        _loop_grads(a, torch.float32)
    plain64, plain32 = _plain_grads(a, torch.float64), \
        _plain_grads(a, torch.float32)
    for p, w in zip(plain64, loop64):
        assert float((p - w).abs().max()) <= EXACT * float(w.abs().max())
    _assert_within(MS.grad_check(plain32, loop32, loop64))
    # the reference's float32 gradients within the same bar of the float64
    # loop's: both lie within it of the exact gradient
    _assert_within(MS.grad_check(_jax_grads(a), loop32, loop64))


def test_plain_backward_at_the_kernel_layouts_edges():
    """hd = 96 (12 k-steps of 8 rows: two of the backward kernel's dv
    warps own none, its last dq / dk tile is 32 columns) over S = 17 (a
    last chunk of one position, the first the backward takes), from a
    carried state: the plain backward exact against autograd of the loop
    in float64 and within the bar in float32, the reference's gradients
    within the bar."""
    a = _inputs(1.0, True, seed=41, shape=(1, 17, 2, 96))
    loop64, loop32 = _loop_grads(a, torch.float64), \
        _loop_grads(a, torch.float32)
    for p, w in zip(_plain_grads(a, torch.float64), loop64):
        assert float((p - w).abs().max()) <= EXACT * float(w.abs().max())
    _assert_within(MS.grad_check(_plain_grads(a, torch.float32), loop32,
                                 loop64))
    _assert_within(MS.grad_check(_jax_grads(a), loop32, loop64))


def test_final_state_gradients_through_the_function():
    """Gradients of the final C, n and m too (the Function's backward
    from all four outputs) against autograd of the loop."""
    a = _inputs(1.0, True, seed=21)
    rng = np.random.default_rng(22)
    w = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for k, s in (("C", (B, NH, HD, HD)), ("n", (B, NH, HD)),
                      ("m", (B, NH)))}
    grads = []
    for use_fn in (True, False):
        ins = [_t(a, x, torch.float32).requires_grad_() for x in "qkvif"]
        st = [_t(a, x, torch.float32) for x in ("C", "n", "m")]
        if use_fn:
            h, C, n, m = MS.mlstm_scan_grad(*ins, *st)
        else:
            C, n, m, h = MS.mlstm_loop(*st, *ins)
        loss = (h * _t(a, "dh", torch.float32)).sum() + (C * w["C"]).sum() \
            + (n * w["n"]).sum() + (m * w["m"]).sum()
        loss.backward()
        grads.append([x.grad for x in ins])
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max())


def _drop_m_chain(i, fm, a, K, Q, e_end, dm_end):
    """A mutant of ``_gate_grads``: each gate keeps its own share (db,
    da) and none of the stabiliser m's."""
    dd = torch.float64
    da = torch.zeros(i.shape[0], i.shape[2], dtype=dd)
    cut = torch.exp(a) == 0
    di, df = [], []
    for t in range(i.shape[1] - 1, -1, -1):
        da = torch.where(cut[:, t], torch.zeros_like(da),
                         Q[:, t].to(dd) - K[:, t].to(dd) + da)
        di.append(K[:, t].to(dd))
        df.append(da)
    return (torch.stack(di[::-1], 1).to(i.dtype),
            torch.stack(df[::-1], 1).to(i.dtype))


def test_a_backward_without_the_m_chain_misses_the_bar(monkeypatch):
    a = _inputs(0.1, False, seed=31)
    assert _binds(a) == 1.0
    loop64, loop32 = _loop_grads(a, torch.float64), \
        _loop_grads(a, torch.float32)
    _assert_within(MS.grad_check(_plain_grads(a, torch.float32), loop32,
                                 loop64))
    monkeypatch.setattr(MS, "_gate_grads", _drop_m_chain)
    chk = MS.grad_check(_plain_grads(a, torch.float32), loop32, loop64)
    assert chk["di"][0] > chk["di"][1] and chk["df"][0] > chk["df"][1]
    for name in ("dq", "dk", "dv"):
        assert chk[name][0] <= chk[name][1]


def test_function_refuses_a_starting_state_with_a_gradient():
    a = _inputs(1.0, True, seed=41)
    ins = [_t(a, x, torch.float32).requires_grad_() for x in "qkvif"]
    for j in range(3):
        st = [_t(a, x, torch.float32) for x in ("C", "n", "m")]
        st[j].requires_grad_()
        with pytest.raises(ValueError, match="starting state"):
            MS.mlstm_scan_grad(*ins, *st)
    st = [_t(a, x, torch.float32) for x in ("C", "n", "m")]
    with pytest.raises(TypeError, match="float32"):
        MS.mlstm_scan_grad(*(x.double() for x in ins), *st)


def test_route_rule_under_autograd(monkeypatch):
    """Under autograd the dense form goes through the Function (its h
    and state bit-equal to the wrapper's without autograd), the paged
    branch through the plain version, and the meta device through the
    loop; without autograd the wrapper."""
    a = _inputs(1.0, True, seed=51)
    calls = []
    for name in ("mlstm_scan", "mlstm_scan_grad", "mlstm_scan_plain",
                 "mlstm_loop"):
        real = getattr(TR, name)
        monkeypatch.setattr(TR, name, lambda *x, _n=name, _f=real:
                            calls.append(_n) or _f(*x))
    q, k, v, i, f = (_t(a, x, torch.float32) for x in "qkvif")
    state = {x: _t(a, x, torch.float32) for x in ("C", "n", "m")}
    with torch.no_grad():
        h0, st0 = TR._mlstm_scan(q, k, v, i, f, state)
    assert calls == ["mlstm_scan"]
    qg = q.clone().requires_grad_()
    h1, st1 = TR._mlstm_scan(qg, k, v, i, f, state)
    assert calls[1:] == ["mlstm_scan_grad"]
    assert torch.equal(h1.detach(), h0)
    assert all(torch.equal(st1[x].detach(), st0[x]) for x in st0)
    h1.sum().backward()
    assert bool(torch.isfinite(qg.grad).all())
    # the paged branch: the plain version under autograd
    src = state["C"].reshape(B, -1)
    rows = torch.arange(B)
    out = torch.empty_like(src)
    TR._mlstm_scan(qg, k, v, i, f, state, (src, rows, [(out, rows)]))
    assert calls[2:] == ["mlstm_scan_plain"]
    # the meta device: the loop, never the Function
    meta = lambda t: torch.empty(t.shape, device="meta")
    TR._mlstm_scan(meta(q).requires_grad_(), meta(k), meta(v), meta(i),
                   meta(f), {x: meta(t) for x, t in state.items()})
    assert calls[3:] == ["mlstm_loop"]


def test_reduced_xlstm_train_step_runs_both_functions(monkeypatch):
    """Reduced xlstm-1.3b's train step (remat: each Function's forward
    twice, one backward) goes through both Functions and gives finite
    gradients (``tests/test_torch_train.py`` holds the step against the
    reference's)."""
    counts = {"mlstm": 0, "slstm": 0}
    for key, cls in (("mlstm", MS.MlstmScanFunction),
                     ("slstm", SS.SlstmScanFunction)):
        real = cls.backward

        def counted(ctx, *g, _k=key, _r=real):
            counts[_k] += 1
            return _r(ctx, *g)

        monkeypatch.setattr(cls, "backward", staticmethod(counted))
    cfg = TC.reduced("xlstm-1.3b")
    ocfg = TO.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=10)
    state = TS.init_state(cfg, ocfg, seed=0, device="cpu")
    batch = batch_at(DataConfig(seed=0, global_batch=2, seq_len=16), cfg, 0)
    _, metrics = TS.make_train_step(cfg, ocfg)(state, batch)
    assert np.isfinite(float(metrics["grad_norm"]))
    layers = sum(len(p) * r for p, r in cfg.segments)
    n_m = sum(p.count("mlstm") * r for p, r in cfg.segments)
    assert counts == {"mlstm": n_m, "slstm": layers - n_m}
