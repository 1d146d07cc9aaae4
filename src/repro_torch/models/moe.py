"""Mixture-of-Experts layer: the dense semantics of the reference's
``repro/models/moe.py::moe_apply_dense``, computed routed.

Routing is the reference's (``_route``): softmax over the router logits
in float32, the top-k experts per token, their probabilities
renormalised.  The reference's oracle computes every expert for every
token ([T, E, d]) and picks the chosen ones; at full width that tensor is
7.3 MB per token, so here each chosen expert runs only on the tokens that
chose it.  The function is the same: no capacity, nothing dropped, as the
reference's dense path (a single device takes it whatever ``moe_impl``
says).  Two routes to it:

  * a decode step (one position a row, S == 1) groups the (token, expert)
    pairs by expert on the device, with fixed shapes, and runs the
    routed-expert kernel (``kernels.routed_experts``; its plain version
    on the CPU): nothing is read back to the host, so a CUDA graph
    captures the step, and a token's k outputs are summed in the
    reference's top-k order;
  * a sequence (prefill, ``forward``) reads the expert counts back to the
    host and loops over the chosen experts (one gather, three
    ``torch.matmul``s and one ``index_add_`` each), summing a token's
    experts in expert order, so outputs agree with the reference to
    float32 rounding.  Its T*k pairs would want a grouped GEMM on the
    tensor cores (ROADMAP).

Expert parallelism (``moe_apply_shard_map``) is a later slice (ROADMAP
Queue 1 item 11).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.routed_experts import routed_experts
from repro_torch.models.config import ModelConfig

__all__ = ["MoE", "SharedExpert", "route", "aux_loss", "moe_apply"]


class SharedExpert(nn.Module):
    """The always-on shared SwiGLU expert(s), stacked [R, ...]:
    ``wi_gate``/``wi_up`` [R, d, fs], ``wo`` [R, fs, d] with fs =
    d_shared * num_shared."""

    def __init__(self, cfg: ModelConfig, repeats: int, device):
        super().__init__()
        mo = cfg.moe
        d, fs = cfg.d_model, (mo.d_shared or mo.d_expert) * mo.num_shared
        leaf = lambda *s: nn.Parameter(torch.empty((repeats,) + s,
                                                   device=device),
                                       requires_grad=False)
        self.wi_gate, self.wi_up, self.wo = leaf(d, fs), leaf(d, fs), \
            leaf(fs, d)
        #: the reference's ``_dense_init`` fan-in of each leaf
        self.fan_in = {"wi_gate": d, "wi_up": d, "wo": fs}


class MoE(nn.Module):
    """Router [R, d, E] and the experts stacked [R, E, ...]: ``wi_gate``/
    ``wi_up`` [R, E, d, f], ``wo`` [R, E, f, d]; ``shared`` when the config
    has shared experts.  The reference initialises every expert leaf with
    fan-in E (``_dense_init`` takes ``shape[0]``)."""

    def __init__(self, cfg: ModelConfig, repeats: int, device):
        super().__init__()
        mo = cfg.moe
        d, e, f = cfg.d_model, mo.num_experts, mo.d_expert
        leaf = lambda *s: nn.Parameter(torch.empty((repeats,) + s,
                                                   device=device),
                                       requires_grad=False)
        self.router = leaf(d, e)
        self.wi_gate, self.wi_up, self.wo = leaf(e, d, f), leaf(e, d, f), \
            leaf(e, f, d)
        self.fan_in = {"router": d, "wi_gate": e, "wi_up": e, "wo": e}
        if mo.num_shared:
            self.shared = SharedExpert(cfg, repeats, device)


def route(x, router_w, top_k: int):
    """The reference's ``_route``: (weights [T, k] in x's dtype, expert
    ids int64 [T, k], probs f32 [T, E]).  ``lax.top_k`` breaks ties by
    the lower index; ``torch.topk`` promises no order, so the experts come
    from a stable descending sort, which picks the same ones."""
    logits = (x @ router_w).float()
    probs = torch.softmax(logits, dim=-1)
    top_i = torch.sort(probs, dim=-1, descending=True,
                       stable=True).indices[:, :top_k]
    top_p = torch.gather(probs, 1, top_i)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return top_p.to(x.dtype), top_i, probs


def aux_loss(probs, top_i, num_experts: int):
    """Switch-style load-balance loss (the reference's ``_aux_loss``)."""
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(top_i[:, 0], num_experts).float() \
        .mean(dim=0)
    return num_experts * torch.sum(me * ce)


def _swiglu(x, wi_gate, wi_up, wo):
    return (torch.nn.functional.silu(x @ wi_gate) * (x @ wi_up)) @ wo


def _expert_loop(p: MoE, r: int, xt, w, idx, num_experts: int):
    """The routed experts over a sequence's tokens: grouped by expert
    through a host read of the counts, one ``_swiglu`` per chosen
    expert."""
    top_k = idx.shape[1]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=num_experts).tolist()
    tok = order // top_k
    wts = w.reshape(-1)[order]
    y = torch.zeros_like(xt)
    start = 0
    for e, cnt in enumerate(counts):
        if cnt == 0:
            continue
        t = tok[start: start + cnt]
        ye = _swiglu(xt[t], p.wi_gate[r, e], p.wi_up[r, e], p.wo[r, e])
        y.index_add_(0, t, ye * wts[start: start + cnt, None])
        start += cnt
    return y


def moe_apply(p: MoE, r: int, cfg: ModelConfig, x, *, with_aux: bool = True):
    """x: [B, S, d] -> (y [B, S, d], aux_loss) at repeat ``r``; a decode
    step (S == 1) takes the routed-expert kernel, a sequence the expert
    loop (module docstring).  ``with_aux=False`` skips the aux loss
    (None), which no decode caller reads."""
    mo = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    w, idx, probs = route(xt, p.router[r], mo.top_k)
    if s == 1:
        y = routed_experts(xt.contiguous(), idx.contiguous(), w.contiguous(),
                           p.wi_gate[r], p.wi_up[r], p.wo[r])
    else:
        y = _expert_loop(p, r, xt, w, idx, mo.num_experts)
    if mo.num_shared:
        sh = p.shared
        y = y + _swiglu(xt, sh.wi_gate[r], sh.wi_up[r], sh.wo[r])
    aux = aux_loss(probs, idx, mo.num_experts) if with_aux else None
    return y.reshape(b, s, d), aux
