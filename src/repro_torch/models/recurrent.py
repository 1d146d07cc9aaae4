"""Recurrent cells: xLSTM's mLSTM and sLSTM, and RecurrentGemma's RG-LRU
(the counterpart of ``repro/models/recurrent.py``).

Each cell has a sequence form (``*_apply``: prefill and forward) and a
one-token form (``*_step``: decode), both returning the cell's new state,
a dict of float32 tensors under the reference's names; ``*_zero_state``
builds the empty one.  The reference runs the mLSTM and sLSTM sequences
as ``lax.scan`` and the RG-LRU's linear recurrence as a log-depth
``lax.associative_scan``: none of them is a Pallas kernel.  In the port
each recurrence runs through a hand-written kernel, in both forms:
``kernels.mlstm_scan`` keeps the matrix state on the chip across
positions and, in a paged decode step, reads and writes it in place on
the state page; ``kernels.slstm_scan`` keeps its share of the recurrent
weights in shared memory across positions; ``kernels.rglru_scan`` fuses
the RG-LRU's gates into a chunked linear scan.  On the CPU each wrapper
takes its plain version (the per-position loops, and the RG-LRU's
log-depth (Hillis-Steele) scan, whose sums run in another order than
JAX's tree, so its states agree to float32 rounding).  Under autograd
(``grad_route``) the mLSTM's dense sequence form, the sLSTM and the
RG-LRU run through autograd Functions with backward kernels of their own
(``mlstm_scan.MlstmScanFunction``, ``slstm_scan.SlstmScanFunction``,
``rglru_scan.RglruScanFunction``: on a card the kernels, on the CPU the
plain forward and the backward's plain version); only the mLSTM's paged
decode branch, which has no backward kernel and never runs under
autograd, and everything on the meta device take their plain versions
(``plain_route``).

Parameters live in a ``Cell`` module per pattern slot, stacked ``[R, ...]``
over the segment's repeats like every other leaf, under the reference's
leaf names; the functions take the cell and a repeat index ``r``, as
``layers.mlp_apply`` does.  The port's residual stream is float32
(``layers.embed``), so the reference's casts to the activation dtype are
identities here and are left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.mlstm_scan import (mlstm_loop, mlstm_scan,
                                             mlstm_scan_grad,
                                             mlstm_scan_plain)
from repro_torch.kernels.rglru_scan import (RGLRU_C, rglru_scan,
                                             rglru_scan_grad,
                                             rglru_scan_plain)
from repro_torch.kernels.slstm_scan import (slstm_scan, slstm_scan_grad,
                                             slstm_scan_plain)
from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.models.layers import reshape, rms_norm

__all__ = ["Cell", "causal_conv1d", "conv_step", "zero_state",
           "mlstm_zero_state", "mlstm_apply", "mlstm_step",
           "grad_route", "plain_route",
           "slstm_zero_state", "slstm_apply", "slstm_step",
           "rglru_zero_state", "rglru_apply", "rglru_step", "rglru_lambda",
           "apply", "step"]

#: m's start value (the max-stabiliser of both LSTMs), as the reference
M_INIT = -1e30


#: a stacked leaf's leading logical axis
_L = ("layers",)


def _heads(cfg: ModelConfig) -> int:
    """xLSTM's heads ride the config's ``num_kv_heads`` field."""
    return max(1, cfg.num_kv_heads)


class Cell(nn.Module):
    """One recurrent slot's cell leaves, stacked ``[R, ...]`` and named as
    the reference's (``recurrent.py`` ``*_init``):

    * mLSTM (dm = 2 d, nh heads): ``w_up``/``w_gate`` [d, dm], ``conv``
      [4, dm], ``wq``/``wk``/``wv`` [dm, dm], ``w_if`` [dm, 2 nh],
      ``out_norm`` [dm], ``w_down`` [dm, d];
    * sLSTM (hd = d / nh, ff = int(4 d / 3)): ``conv`` [4, d], ``w_gates``
      [d, 4 d], ``r_gates`` [nh, hd, 4 hd], ``out_norm`` [d], ``w_up``
      [d, ff], ``w_down`` [ff, d];
    * RG-LRU (w = lru_width or d): ``w_x``/``w_gate`` [d, w], ``conv``
      [4, w], ``lam`` [w], ``w_a``/``w_i`` [w, w / 8], ``w_a2``/``w_i2``
      [w / 8, w], ``w_out`` [w, d].

    ``fan_in`` maps each random leaf to the reference's ``_dense_init``
    fan-in (``shape[0]`` of the unstacked leaf); ``conv`` starts at zero
    and ``lam`` from ``rglru_lambda``, as the reference.  ``axes`` gives
    each leaf's logical axes (the reference's spec tree)."""

    def __init__(self, cfg: ModelConfig, kind: LayerKind, repeats: int,
                 device):
        super().__init__()
        self.base = kind.base
        d = cfg.d_model

        def leaf(*shape):
            return nn.Parameter(torch.empty((repeats,) + shape,
                                            device=device),
                                requires_grad=False)

        if kind.base == "mlstm":
            dm, nh = 2 * d, _heads(cfg)
            self.w_up, self.w_gate = leaf(d, dm), leaf(d, dm)
            self.conv = leaf(4, dm)
            self.wq, self.wk, self.wv = leaf(dm, dm), leaf(dm, dm), \
                leaf(dm, dm)
            self.w_if = leaf(dm, 2 * nh)
            self.out_norm = leaf(dm)
            self.w_down = leaf(dm, d)
            self.fan_in = {"w_up": d, "w_gate": d, "wq": dm, "wk": dm,
                           "wv": dm, "w_if": dm, "w_down": dm}
            self.axes = {"w_up": _L + ("embed", "mlp"),
                         "w_gate": _L + ("embed", "mlp"),
                         "conv": _L + (None, "mlp"),
                         "wq": _L + ("mlp", "mlp"), "wk": _L + ("mlp", "mlp"),
                         "wv": _L + ("mlp", "mlp"),
                         "w_if": _L + ("mlp", None),
                         "out_norm": _L + ("mlp",),
                         "w_down": _L + ("mlp", "embed")}
        elif kind.base == "slstm":
            nh = _heads(cfg)
            hd, ff = d // nh, int(d * 4 / 3)
            self.conv = leaf(4, d)
            self.w_gates = leaf(d, 4 * d)
            self.r_gates = leaf(nh, hd, 4 * hd)
            self.out_norm = leaf(d)
            self.w_up, self.w_down = leaf(d, ff), leaf(ff, d)
            self.fan_in = {"w_gates": d, "r_gates": nh, "w_up": d,
                           "w_down": ff}
            self.axes = {"conv": _L + (None, "embed"),
                         "w_gates": _L + ("embed", "mlp"),
                         "r_gates": _L + ("kv_heads", None, None),
                         "out_norm": _L + ("embed",),
                         "w_up": _L + ("embed", "mlp"),
                         "w_down": _L + ("mlp", "embed")}
        elif kind.base == "rglru":
            w = cfg.lru_width or d
            self.w_x, self.w_gate = leaf(d, w), leaf(d, w)
            self.conv = leaf(4, w)
            self.lam = leaf(w)
            self.w_a, self.w_a2 = leaf(w, w // 8), leaf(w // 8, w)
            self.w_i, self.w_i2 = leaf(w, w // 8), leaf(w // 8, w)
            self.w_out = leaf(w, d)
            self.fan_in = {"w_x": d, "w_gate": d, "w_a": w, "w_a2": w // 8,
                           "w_i": w, "w_i2": w // 8, "w_out": w}
            self.axes = {"w_x": _L + ("embed", "lru"),
                         "w_gate": _L + ("embed", "lru"),
                         "conv": _L + (None, "lru"), "lam": _L + ("lru",),
                         "w_a": _L + ("lru", None), "w_a2": _L + (None, "lru"),
                         "w_i": _L + ("lru", None), "w_i2": _L + (None, "lru"),
                         "w_out": _L + ("lru", "embed")}
        else:
            raise ValueError(f"{kind.base} is not a recurrent cell")


def rglru_lambda(t: torch.Tensor, generator: torch.Generator) -> None:
    """The reference's RG-LRU lambda init, in place: u ~ U[0.9, 0.999],
    lambda = log(expm1(-log(u) / c)), so that a = exp(-c softplus(lambda))
    starts in [0.9, 0.999]."""
    u = torch.rand(t.shape, generator=generator, device=t.device) \
        * (0.999 - 0.9) + 0.9
    t.copy_(torch.log(torch.expm1(-torch.log(u) / RGLRU_C)))


# ---------------------------------------------------------------------------
# the causal conv front of every cell
# ---------------------------------------------------------------------------


def causal_conv1d(x, w):
    """Depthwise causal conv.  x: [B, S, D], w: [K, D]; the reference's
    shift-and-add order."""
    k = w.shape[0]
    out = torch.zeros_like(x)
    for j in range(k):
        xs = x if j == 0 else F.pad(x, (0, 0, j, 0))[:, :-j]
        out = out + xs * w[k - 1 - j]
    return out


def conv_step(state, x_t, w):
    """One token of the conv.  state: [B, K-1, D] (the previous inputs),
    x_t: [B, D].  Returns (new state, y [B, D])."""
    window = torch.cat([state, x_t[:, None]], dim=1)           # [B, K, D]
    y = torch.einsum("bkd,kd->bd", window, w)
    return window[:, 1:], y


def _conv_seq(state_conv, u, w):
    """The sequence form's conv over ``state_conv ++ u``: (conv output
    [B, S, D], the new conv state [B, K-1, D]).  The state is a copy: a
    view would keep the whole [B, S + 3, D] input alive as long as the
    state lives (a prefill holds every layer's state until it returns)."""
    conv_in = torch.cat([state_conv, u], dim=1)
    return causal_conv1d(conv_in, w)[:, 3:], conv_in[:, -3:].clone()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_zero_state(cfg: ModelConfig, batch: int, device=None):
    """{C [B,nh,hd,hd], n [B,nh,hd], m [B,nh] (-1e30), conv [B,3,dm]}:
    dm = 2 d_model, hd = dm / nh (not ``cfg.head_dim``)."""
    dm, nh = 2 * cfg.d_model, _heads(cfg)
    hd = dm // nh
    z = lambda *s: torch.zeros((batch,) + s, device=device)
    return {"C": z(nh, hd, hd), "n": z(nh, hd),
            "m": torch.full((batch, nh), M_INIT, device=device),
            "conv": z(3, dm)}


def _mlstm_inputs(p, r: int, x_in, nh: int):
    """q, k, v [B, S, nh, hd] and the gates i, log f [B, S, nh] of the
    post-conv input [B, S, dm]."""
    b, s, dm = x_in.shape
    hd = dm // nh
    q = reshape(x_in @ p.wq[r], b, s, nh, hd)
    k = reshape(x_in @ p.wk[r], b, s, nh, hd)
    v = reshape(x_in @ p.wv[r], b, s, nh, hd)
    gf = x_in @ p.w_if[r]
    return q, k, v, gf[..., :nh], F.logsigmoid(gf[..., nh:])


def _mlstm_out(p, r: int, h, gate):
    return (rms_norm(h, p.out_norm[r]) * F.silu(gate)) @ p.w_down[r]


def grad_route(*tensors) -> bool:
    """Under autograd: gradients enabled and any input requiring grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def plain_route(*tensors) -> bool:
    """The route rule of the one recurrence form without a backward
    kernel, the mLSTM's paged decode branch (decode never runs under
    autograd): under autograd (``grad_route``) it runs as
    ``mlstm_scan_plain``, which autograd differentiates, on every device;
    so does every recurrence on the meta device (``launch.dryrun``), where
    nothing runs.  Otherwise it runs through its kernel's wrapper: the
    kernel on a card, its plain version on the CPU.  The mLSTM's dense
    sequence form, the sLSTM and the RG-LRU have backward kernels: under
    autograd they take their autograd Functions (the kernels on a card, or
    a raise; their plain versions on the CPU), never this route, but on
    the meta device."""
    return any(t.is_meta for t in tensors) or grad_route(*tensors)


def _mlstm_scan(q, k, v, i, f, state, pages=None):
    """The recurrence over q, k, v [B, S, nh, hd] and i, f [B, S, nh]
    from ``state``'s n and m.  Dense (``pages`` None): from its C;
    returns (h [B, S, nh, hd], {C, n, m}).  ``pages`` = (src, src_rows,
    dsts): C is read from and written to the rows of 2-D state buffers
    (``mlstm_scan``'s arguments); returns (h, {n, m})."""
    i, f = i.contiguous(), f.contiguous()
    n, m = state["n"].contiguous(), state["m"].contiguous()
    if pages is not None:
        scan = mlstm_scan_plain if plain_route(q, k, v, i, f, n, m) \
            else mlstm_scan
        h, n, m = scan(q, k, v, i, f, n, m, *pages)
        return h, {"n": n, "m": m}
    b, _, nh, hd = q.shape
    C = state["C"]
    ts = (q, k, v, i, f, C, n, m)
    if any(t.is_meta for t in ts):
        C, n, m, h = mlstm_loop(C, n, m, q, k, v, i, f)
        return h, {"C": C, "n": n, "m": m}
    if grad_route(*ts):
        h, C, n, m = mlstm_scan_grad(q, k, v, i, f, C, n, m)
        return h, {"C": C, "n": n, "m": m}
    rows = torch.arange(b, device=q.device)
    out = torch.empty((b, nh * hd * hd), device=q.device)
    h, n, m = mlstm_scan(q, k, v, i, f, n, m, C.reshape(b, -1).contiguous(),
                         rows, [(out, rows)])
    return h, {"C": out.view(b, nh, hd, hd), "n": n, "m": m}


def mlstm_apply(p, r: int, cfg: ModelConfig, x, state=None):
    """Sequence form.  x: [B, S, d] -> (y [B, S, d], final state)."""
    b, s, _ = x.shape
    up, gate = x @ p.w_up[r], x @ p.w_gate[r]
    if state is None:
        state = mlstm_zero_state(cfg, b, x.device)
    xc, conv = _conv_seq(state["conv"], up, p.conv[r])
    q, k, v, i, f = _mlstm_inputs(p, r, F.silu(xc), _heads(cfg))
    h, new = _mlstm_scan(q, k, v, i, f, state)
    return _mlstm_out(p, r, reshape(h, b, s, -1), gate), dict(new, conv=conv)


def mlstm_step(p, r: int, cfg: ModelConfig, x, state, pages=None):
    """Decode step.  x: [B, 1, d] -> (y [B, 1, d], new state).  With
    ``pages`` (``_mlstm_scan``'s), ``state`` holds conv, n and m, C lives
    in the state rows, and the new state holds conv, n and m."""
    up, gate = (x @ p.w_up[r])[:, 0], (x @ p.w_gate[r])[:, 0]
    conv, xc = conv_step(state["conv"], up, p.conv[r])
    q, k, v, i, f = _mlstm_inputs(p, r, F.silu(xc)[:, None], _heads(cfg))
    h, new = _mlstm_scan(q, k, v, i, f, state, pages)
    y = _mlstm_out(p, r, reshape(h, h.shape[0], -1), gate)
    return y[:, None], dict(new, conv=conv)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_zero_state(cfg: ModelConfig, batch: int, device=None):
    """{c, n (1e-6), m (-1e30), h: [B, nh, hd], conv [B, 3, d]}."""
    d, nh = cfg.d_model, _heads(cfg)
    hd = d // nh
    full = lambda v, *s: torch.full((batch,) + s, v, device=device)
    return {"c": full(0.0, nh, hd), "n": full(1e-6, nh, hd),
            "m": full(M_INIT, nh, hd), "h": full(0.0, nh, hd),
            "conv": full(0.0, 3, d)}


def _slstm_scan(wx, r_gates, state):
    """The recurrence over wx [B, S, 4 d] from ``state``'s c, n, m, h:
    (h [B, S, nh, hd], {c, n, m, h})."""
    nh, hd, _ = r_gates.shape
    wx = reshape(wx, wx.shape[0], wx.shape[1], nh, 4 * hd)
    args = (wx.contiguous(), r_gates) + tuple(
        state[k].contiguous() for k in ("c", "n", "m", "h"))
    if any(t.is_meta for t in args):
        scan = slstm_scan_plain
    else:
        scan = slstm_scan_grad if grad_route(*args) else slstm_scan
    hs, *st = scan(*args)
    return hs, dict(zip(("c", "n", "m", "h"), st))


def _slstm_out(p, r: int, h):
    h = rms_norm(h, p.out_norm[r])
    return F.gelu(h @ p.w_up[r], approximate="tanh") @ p.w_down[r]


def slstm_apply(p, r: int, cfg: ModelConfig, x, state=None):
    b, s, d = x.shape
    if state is None:
        state = slstm_zero_state(cfg, b, x.device)
    xc, conv = _conv_seq(state["conv"], x, p.conv[r])
    hs, st = _slstm_scan(F.silu(xc) @ p.w_gates[r], p.r_gates[r], state)
    h = reshape(hs, b, s, d)
    return _slstm_out(p, r, h), dict(st, conv=conv)


def slstm_step(p, r: int, cfg: ModelConfig, x, state):
    conv, xc = conv_step(state["conv"], x[:, 0], p.conv[r])
    _, st = _slstm_scan((F.silu(xc) @ p.w_gates[r])[:, None],
                        p.r_gates[r], state)
    y = _slstm_out(p, r, reshape(st["h"], x.shape[0], -1))
    return y[:, None], dict(st, conv=conv)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def rglru_zero_state(cfg: ModelConfig, batch: int, device=None):
    """{h [B, w], conv [B, 3, w]}."""
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), device=device),
            "conv": torch.zeros((batch, 3, w), device=device)}


def _rglru_scan(p, r: int, xc, h0):
    """The RG-LRU's gates and recurrence over xc [B, S, w] from h0 [B, w]:
    h [B, S, w].  The two low-rank gate products stay matmuls."""
    ra = (xc @ p.w_a[r]) @ p.w_a2[r]
    ia = (xc @ p.w_i[r]) @ p.w_i2[r]
    args = (ra, ia, xc.contiguous(), p.lam[r], h0.contiguous())
    if any(t.is_meta for t in args):
        scan = rglru_scan_plain
    else:
        scan = rglru_scan_grad if grad_route(*args) else rglru_scan
    return scan(*args)


def rglru_apply(p, r: int, cfg: ModelConfig, x, state=None):
    """x: [B, S, d] -> (y, state); the previous state's h is folded into
    the first step, as the reference."""
    if state is None:
        state = rglru_zero_state(cfg, x.shape[0], x.device)
    gate = F.gelu(x @ p.w_gate[r], approximate="tanh")
    xc, conv = _conv_seq(state["conv"], x @ p.w_x[r], p.conv[r])
    h = _rglru_scan(p, r, xc, state["h"])
    # the state a copy, as ``_conv_seq``'s: not a view that keeps h alive
    return (h * gate) @ p.w_out[r], {"h": h[:, -1].clone(), "conv": conv}


def rglru_step(p, r: int, cfg: ModelConfig, x, state):
    gate = F.gelu(x[:, 0] @ p.w_gate[r], approximate="tanh")
    conv, xc = conv_step(state["conv"], x[:, 0] @ p.w_x[r], p.conv[r])
    h = _rglru_scan(p, r, xc[:, None], state["h"])[:, 0]
    return ((h * gate) @ p.w_out[r])[:, None], {"h": h, "conv": conv}


# ---------------------------------------------------------------------------
# by kind
# ---------------------------------------------------------------------------

_ZERO = {"mlstm": mlstm_zero_state, "slstm": slstm_zero_state,
         "rglru": rglru_zero_state}
_APPLY = {"mlstm": mlstm_apply, "slstm": slstm_apply, "rglru": rglru_apply}
_STEP = {"mlstm": mlstm_step, "slstm": slstm_step, "rglru": rglru_step}


def zero_state(cfg: ModelConfig, kind: LayerKind, batch: int, device=None):
    """The empty state of a ``kind`` cell (``device="meta"`` for its
    shapes alone)."""
    return _ZERO[kind.base](cfg, batch, device)


def apply(p, r: int, cfg: ModelConfig, x, state=None):
    """The sequence form of cell ``p`` (``Cell``)."""
    return _APPLY[p.base](p, r, cfg, x, state)


def step(p, r: int, cfg: ModelConfig, x, state):
    """The one-token form of cell ``p``."""
    return _STEP[p.base](p, r, cfg, x, state)
