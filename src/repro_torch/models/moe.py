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
path) runs on a ``DeviceMesh`` with DTensor inputs: the tokens are split
over the batch axes and replicated over the model axis, each model rank
computes its ``num_experts / n`` experts on the (token, expert) pairs of
its tokens routed to them under the reference's capacity bound (pairs
past it are dropped), and the partial outputs are summed over the model
axis -- one all-reduce a MoE layer, no all-to-all.  ``moe_apply`` takes
it when ``cfg.moe_impl == "shard_map"`` and a mesh is given; on one
device it takes the dense semantics above whatever ``moe_impl`` says, as
the reference does.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.distributed.compat import (DTensor, Partial, Replicate,
                                            Shard)
from repro_torch.kernels.routed_experts import routed_experts
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gather_rows, rows_gathered

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
        #: each leaf's logical axes (the reference's spec tree)
        self.axes = {"wi_gate": ("layers", "embed", "mlp"),
                     "wi_up": ("layers", "embed", "mlp"),
                     "wo": ("layers", "mlp", "embed")}


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
        self.axes = {"router": ("layers", "embed", None),
                     "wi_gate": ("layers", "expert", "embed", "mlp"),
                     "wi_up": ("layers", "expert", "embed", "mlp"),
                     "wo": ("layers", "expert", "mlp", "embed")}
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
              mesh=None):
    """x: [B, S, d] -> (y [B, S, d], aux_loss) at repeat ``r``; a decode
    step (S == 1) takes the routed-expert kernel, a sequence the expert
    loop (module docstring).  ``with_aux=False`` skips the aux loss
    (None), which no decode caller reads.  On a ``mesh`` (x a DTensor) a
    ``"shard_map"`` MoE runs expert-parallel over the model axis with the
    tokens split over the others (``moe_apply_shard_map``); any other
    runs the dense semantics on every rank over replicated inputs."""
    if mesh is not None and isinstance(x, DTensor):
        if cfg.moe_impl == "shard_map":
            return moe_apply_shard_map(p, r, cfg, x, mesh,
                                       with_aux=with_aux)
        return _replicated(p, r, cfg, x, mesh, with_aux)
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
# expert parallelism on a mesh
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


class _Leaves:
    """Plain stand-ins for a MoE's leaves at repeat 0: ``name[0]`` reads
    as ``p.name[r]`` does (``moe_apply``'s routes index a repeat)."""

    def __init__(self, **leaves):
        for k, v in leaves.items():
            setattr(self, k, v[None])


def _replicated(p, r: int, cfg: ModelConfig, x, mesh, with_aux: bool):
    """``moe_apply``'s single-device semantics on a mesh: the tokens and
    leaves gathered whole on every rank (``Replicate``), the routed
    experts run on the local copies, the output a replicated DTensor.
    Every rank computes the same function of the same inputs, so the
    local gradients are the replicated ones."""
    rep = [Replicate()] * mesh.ndim
    loc = lambda t: t.redistribute(mesh, rep).to_local()
    names = ("router", "wi_gate", "wi_up", "wo")
    lp = _Leaves(**{n: loc(getattr(p, n)[r]) for n in names})
    if cfg.moe.num_shared:
        lp.shared = _Leaves(**{n: loc(getattr(p.shared, n)[r])
                               for n in names[1:]})
    y, aux = moe_apply(lp, 0, cfg, loc(x), with_aux=with_aux)
    y = DTensor.from_local(y, mesh, rep)
    if aux is not None:
        aux = DTensor.from_local(aux, mesh, rep)
    return y, aux


def moe_apply_shard_map(p, r: int, cfg: ModelConfig, x, mesh, *,
                        model_axis: str = "model", with_aux: bool = True):
    """Expert parallelism on a ``DeviceMesh`` (the reference's
    ``moe_apply_shard_map``; a model-axis group alone is a (1, n) mesh):
    x [B, S, d] a DTensor; its B*S tokens are
    split over every mesh axis but ``model_axis`` and replicated over it;
    model rank i computes experts [i E/n, (i + 1) E/n) on the (token,
    expert) pairs of its tokens routed to them, under a capacity of
    ceil(T_local k / E * capacity_factor) pairs an expert (T_local the
    local token count), and the partial outputs are summed over the model
    axis (a ``Partial`` placement).  The load-balance means are averaged
    over the batch axes before their product, as the reference's
    ``pmean``s.  The shared experts run outside, as a tensor-parallel MLP
    over the DTensors.

    Gradients: the routed part reads the tokens and the router as
    ``Partial`` over the model axis (each model rank holds its experts'
    share), the aux loss reads them replicated (every model rank computes
    it whole), and the local expert leaves are ``Partial`` over the
    batch axes (each batch rank holds its tokens' share)."""
    mo = cfg.moe
    names = list(mesh.mesh_dim_names)
    mi = names.index(model_axis)
    n = mesh.size(mi)
    if mo.num_experts % n:
        raise ValueError(f"{mo.num_experts} experts do not split over "
                         f"{n} ranks")
    e_local = mo.num_experts // n
    e0 = mesh.get_local_rank(mi) * e_local
    b, s, d = x.shape
    tok_pl = [Shard(0)] * mesh.ndim
    tok_pl[mi] = Replicate()
    xt = gather_rows(x).reshape(b * s, d).redistribute(mesh, tok_pl)
    part_m = list(tok_pl)
    part_m[mi] = Partial()
    x_routed = xt.to_local(grad_placements=part_m)
    rw = p.router[r].redistribute(mesh, [Replicate()] * mesh.ndim)
    router = rw.to_local(grad_placements=[Partial()] * mesh.ndim)
    exp_pl = [Replicate()] * mesh.ndim
    exp_pl[mi] = Shard(0)
    exp_grad = [Partial()] * mesh.ndim
    exp_grad[mi] = Shard(0)
    wg, wu, wo = (getattr(p, nm)[r].redistribute(mesh, exp_pl)
                  .to_local(grad_placements=exp_grad)
                  for nm in ("wi_gate", "wi_up", "wo"))
    t = x_routed.shape[0]
    w, idx, _ = route(x_routed, router, mo.top_k)
    capacity = max(1, math.ceil(t * mo.top_k / mo.num_experts
                                * mo.capacity_factor))
    buf, meta = _local_dispatch(x_routed, w, idx, e0, e_local, capacity)
    h = torch.einsum("ecd,edf->ecf", buf, wg)
    u = torch.einsum("ecd,edf->ecf", buf, wu)
    y_buf = torch.einsum("ecf,efd->ecd", torch.nn.functional.silu(h) * u, wo)
    y = DTensor.from_local(_local_combine(y_buf, meta, t, d), mesh, part_m)
    y = rows_gathered(y.redistribute(mesh, tok_pl).reshape(b, s, d))
    if mo.num_shared:
        sh = p.shared
        y = y + _swiglu(x, sh.wi_gate[r], sh.wi_up[r], sh.wo[r])
    if not with_aux:
        return y, None
    rep_b = [Partial()] * mesh.ndim
    rep_b[mi] = Replicate()
    _, idx_a, probs = route(xt.to_local(), rw.to_local(grad_placements=rep_b),
                            mo.top_k)
    mean_pl = [Shard(0)] * mesh.ndim
    mean_pl[mi] = Replicate()
    me = DTensor.from_local(probs.mean(dim=0)[None], mesh, mean_pl).mean(0)
    ce = DTensor.from_local(torch.nn.functional.one_hot(
        idx_a[:, 0], mo.num_experts).float().mean(dim=0)[None], mesh,
        mean_pl).mean(0)
    return y, mo.num_experts * torch.sum(me * ce)
