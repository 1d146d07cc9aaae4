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

Expert parallelism (``moe_apply_shard_map``, the reference's production
path) runs over a ``torch.distributed`` model-axis group: the tokens are
replicated over the group, each rank computes its ``num_experts / n``
experts on the (token, expert) pairs routed to them under the reference's
capacity bound (pairs past it are dropped), and the partial outputs are
all-reduced -- one all-reduce a MoE layer, no all-to-all.  ``moe_apply``
takes it when ``cfg.moe_impl == "shard_map"`` and a group of more than
one rank is given; on one device it takes the dense semantics above
whatever ``moe_impl`` says, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.kernels.routed_experts import routed_experts
from repro_torch.models.config import ModelConfig

__all__ = ["MoE", "SharedExpert", "route", "aux_loss", "moe_apply",
           "moe_apply_shard_map"]


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
    # the experts as views of one unbind: under autograd its backward
    # stacks their gradients once, where indexing an expert at a time
    # would write a zero-filled leaf-sized gradient per expert
    wg, wu, wo = (leaf[r].unbind(0) for leaf in (p.wi_gate, p.wi_up, p.wo))
    y = torch.zeros_like(xt)
    start = 0
    for e, cnt in enumerate(counts):
        if cnt == 0:
            continue
        t = tok[start: start + cnt]
        ye = _swiglu(xt[t], wg[e], wu[e], wo[e])
        y.index_add_(0, t, ye * wts[start: start + cnt, None])
        start += cnt
    return y


def moe_apply(p: MoE, r: int, cfg: ModelConfig, x, *, with_aux: bool = True,
              group=None):
    """x: [B, S, d] -> (y [B, S, d], aux_loss) at repeat ``r``; a decode
    step (S == 1) takes the routed-expert kernel, a sequence the expert
    loop (module docstring).  ``with_aux=False`` skips the aux loss
    (None), which no decode caller reads.  With ``cfg.moe_impl ==
    "shard_map"`` and a model-axis ``group`` of more than one rank, the
    experts run expert-parallel (``moe_apply_shard_map``)."""
    if (cfg.moe_impl == "shard_map" and group is not None
            and dist.get_world_size(group) > 1):
        return moe_apply_shard_map(p, r, cfg, x, group)
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


# ---------------------------------------------------------------------------
# expert parallelism over a model-axis process group
# ---------------------------------------------------------------------------


def _local_dispatch(xt, w, idx, e0: int, e_local: int, capacity: int):
    """The [E_local, C, d] buffer of this rank's experts.  xt: [T, d];
    w/idx: [T, k].  The (token, expert) pairs whose expert lives here take
    positions within their expert in (token, k) order (a cumsum); pairs
    past ``capacity`` are dropped (the reference's ``_local_dispatch``)."""
    t, k = idx.shape
    pairs_e = idx.reshape(-1)
    pairs_w = w.reshape(-1)
    pairs_t = torch.arange(t, device=xt.device).repeat_interleave(k)
    local = (pairs_e >= e0) & (pairs_e < e0 + e_local)
    le = torch.where(local, pairs_e - e0, e_local)    # e_local: the trash
    onehot = torch.nn.functional.one_hot(le, e_local + 1)
    pos = torch.gather(onehot.cumsum(dim=0) - 1, 1, le[:, None])[:, 0]
    keep = local & (pos < capacity)
    le_c = torch.where(keep, le, e_local)
    pos_c = torch.where(keep, pos, 0)
    buf = torch.zeros((e_local + 1, capacity, xt.shape[1]), dtype=xt.dtype,
                      device=xt.device)
    buf = buf.index_put((le_c, pos_c), torch.where(
        keep[:, None], xt[pairs_t], 0.0), accumulate=True)
    return buf[:e_local], (pairs_t, le_c, pos_c, pairs_w, keep)


def _local_combine(y_buf, meta, t: int, d: int):
    """[T, d]: each kept pair's expert output times its weight, summed
    into its token in (token, k) order."""
    pairs_t, le_c, pos_c, pairs_w, keep = meta
    gathered = y_buf[torch.clamp(le_c, max=y_buf.shape[0] - 1), pos_c]
    contrib = torch.where(keep[:, None], gathered * pairs_w[:, None], 0.0)
    return torch.zeros((t, d), dtype=y_buf.dtype,
                       device=y_buf.device).index_add(0, pairs_t, contrib)


class _SumOverGroup(torch.autograd.Function):
    """all_reduce(SUM) whose backward is the identity: every rank of the
    group goes on from the same sum, so each partial's gradient is the
    sum's."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FromGroup(torch.autograd.Function):
    """The identity whose backward sums the gradient over the group: a
    replicated input that each rank uses for its own experts only gets
    the sum of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def moe_apply_shard_map(p: MoE, r: int, cfg: ModelConfig, x, group):
    """Expert-parallel MoE over the model-axis process ``group`` of n
    ranks (the reference's ``moe_apply_shard_map`` over its model mesh
    axis).  x: [B, S, d], the same on every rank of the group.  Rank i
    computes experts [i E/n, (i + 1) E/n) of ``p``'s stacked leaves.  The
    capacity is ceil(T k / E * capacity_factor) pairs an expert; the
    partial outputs are summed over the group; the shared experts run
    outside the expert-parallel part (summing them over the group would
    count them n times).  The aux loss comes from this rank's means,
    which are the group's (its tokens are the group's); a batch split
    over a data axis beside the model axis is the mesh step's (ROADMAP
    Queue 1 item 12).  Differentiable: an expert leaf's gradient is its
    rank's, a replicated input's (x, the router) the same on every
    rank."""
    mo = cfg.moe
    b, s, d = x.shape
    n = dist.get_world_size(group)
    if mo.num_experts % n:
        raise ValueError(f"{mo.num_experts} experts do not split over "
                         f"{n} ranks")
    e_local = mo.num_experts // n
    e0 = dist.get_rank(group) * e_local
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    # the routed part's inputs through _FromGroup, so their gradients sum
    # the ranks' partials; the aux loss and the shared experts, which
    # every rank computes whole, route from the inputs themselves
    xc = _FromGroup.apply(xt, group)
    w, idx, _ = route(xc, _FromGroup.apply(p.router[r], group), mo.top_k)
    capacity = max(1, math.ceil(t * mo.top_k / mo.num_experts
                                * mo.capacity_factor))
    buf, meta = _local_dispatch(xc, w, idx, e0, e_local, capacity)
    sl = slice(e0, e0 + e_local)
    h = torch.einsum("ecd,edf->ecf", buf, p.wi_gate[r, sl])
    u = torch.einsum("ecd,edf->ecf", buf, p.wi_up[r, sl])
    y_buf = torch.einsum("ecf,efd->ecd", torch.nn.functional.silu(h) * u,
                         p.wo[r, sl])
    y = _SumOverGroup.apply(_local_combine(y_buf, meta, t, d), group)
    if mo.num_shared:
        sh = p.shared
        y = y + _swiglu(xt, sh.wi_gate[r], sh.wi_up[r], sh.wo[r])
    _, idx, probs = route(xt, p.router[r], mo.top_k)
    return y.reshape(b, s, d), aux_loss(probs, idx, mo.num_experts)
