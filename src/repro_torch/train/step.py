"""Training step: loss, gradient accumulation, compressed cross-pod data
parallelism (the counterpart of ``repro/train/step.py``).

``make_train_step`` builds a ``(state, batch) -> (state, metrics)``
closure for a ModelConfig:

  * microbatching -- ``accum_steps`` splits the step's batch and sums the
    float32 gradients over the microbatches (the reference's ``lax.scan``),
    then divides by their number; the loss is averaged the same way;
  * remat -- ``cfg.remat`` checkpoints each repeat inside the model
    (``models.model._run_seq``);
  * the mesh step -- with a ``DeviceMesh`` (``launch.mesh``) the
    parameters and moments are DTensors laid out by
    ``distributed.sharding`` (FSDP over "data", TP/EP over "model"), the
    batch over ("pod", "data") x "model", and the model runs on them with
    the reference's ``shard`` points; DTensor inserts the collectives;
  * compressed cross-pod DP -- with ``grad_compression=True`` and a
    "pod" mesh axis of more than one rank (a pod group alone is a
    (pod, 1, 1) mesh), each pod takes its rows of the global batch,
    computes their gradients, and every gradient goes through the int8
    ``collectives.compressed_psum``; the loss is averaged over the pods
    and every pod applies the same ``optim.update``.

Loss: softmax cross-entropy in float32, targets == IGNORE (-1) masked out
(a VLM's image-prefix positions and the last position), plus
``moe.aux_loss_weight`` x the MoE load-balance loss.

The state is ``{"params": Transformer, "opt": optim state, "step": int32}``
and a step updates it in place.  The flash route
(``attention_impl="pallas"``) has no backward, in the port as in the
reference, so ``make_train_step`` refuses it.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.collectives import compressed_psum
from repro_torch.distributed.compat import (DTensor, Partial, Replicate,
                                            Shard, distribute_local,
                                            implicit_replication)
from repro_torch.models import model as mdl
from repro_torch.models.config import ModelConfig
from repro_torch.train import optim

__all__ = ["IGNORE", "cross_entropy", "loss_fn", "cast_params_tree",
           "make_train_step", "init_state", "trainable", "to_device",
           "shard_params", "shard_batch", "param_mesh", "gather_state",
           "state_specs"]

IGNORE = -1


def cross_entropy(logits, targets):
    """Mean CE over non-ignored targets.  logits: [B,S,V] (any float
    dtype), targets: [B,S] integer with IGNORE for masked positions.

    DTensor logits (the mesh step) are laid out with whole vocab rows on
    each rank (their batch and seq dims may be sharded): each rank sums
    its rows' CE and counts them, and the two sums are reduced over the
    mesh -- DTensor's own gather along the vocab would build the whole
    [B, S, V] gradient on every rank."""
    if isinstance(logits, DTensor):
        return _cross_entropy_sharded(logits, targets)
    logits = logits.float()
    mask = targets != IGNORE
    tgt = torch.where(mask, targets, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    ce = (logz - gold) * mask
    return torch.sum(ce) / torch.clamp(torch.sum(mask), min=1)


def _cross_entropy_sharded(logits, targets):
    """``cross_entropy`` of DTensor logits (its docstring)."""
    mesh, nd = logits.device_mesh, logits.ndim
    rows = [Replicate() if isinstance(pl, Partial) or (
        isinstance(pl, Shard) and pl.dim == nd - 1) else pl
        for pl in logits.placements]
    logits = logits.redistribute(mesh, rows)
    if not isinstance(targets, DTensor):
        targets = DTensor.from_local(targets, mesh,
                                     [Replicate()] * mesh.ndim)
    targets = targets.redistribute(mesh, rows)
    lg, tg = logits.to_local().float(), targets.to_local()
    mask = tg != IGNORE
    gold = torch.gather(lg, -1, torch.where(mask, tg, 0)[..., None])[..., 0]
    ce = torch.sum((torch.logsumexp(lg, dim=-1) - gold) * mask)
    # a rank's sums are partial over the mesh dims that shard its rows
    pl = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
    total = DTensor.from_local(ce, mesh, pl)
    count = DTensor.from_local(torch.sum(mask).float(), mesh, pl)
    return total.redistribute(mesh, [Replicate()] * mesh.ndim) \
        / torch.clamp(count.redistribute(mesh, [Replicate()] * mesh.ndim),
                      min=1)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any],
            leaves=None, **fwd):
    """(ce + aux_loss_weight * aux, {"ce", "aux"}) of one batch;
    ``leaves`` ({name: tensor}) stand in for the parameters' own
    (``torch.func.functional_call``); ``fwd`` holds ``forward``'s mesh
    arguments."""
    kw = dict(extra_embeds=batch.get("extra_embeds"), cond=batch.get("cond"),
              **fwd)
    if leaves is None:
        logits, aux = mdl.forward(params, cfg, batch["tokens"], **kw)
    else:
        logits, aux = torch.func.functional_call(
            params, leaves, (cfg, batch["tokens"]), kw)
    ce = cross_entropy(logits, batch["targets"])
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    return ce + aux_w * aux, {"ce": ce, "aux": aux}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on ``device``: token ids and
    targets int64, embeddings float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        t = t.long() if k in ("tokens", "targets") else t.float()
        out[k] = t.to(device)
    return out


def _split_microbatches(batch, accum: int):
    """[accum] list of microbatches, rows in order."""
    return [{k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[i]
             for k, v in batch.items()} for i in range(accum)]


def cast_params_tree(params, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """{name: float32 leaf rounded through ``dtype``}, inside autograd, so
    gradients land in the float32 masters through the cast's backward
    (itself rounded through ``dtype``, as the reference's transpose of the
    cast).  The reference's layers cast every weight back to the
    activations' dtype -- float32 past the embedding -- so computing in
    float32 on the rounded values is its arithmetic; the one exception is
    RG-LRU's ``softplus(lam)``, which the reference evaluates in
    ``dtype``."""
    named = params if isinstance(params, dict) else \
        dict(params.named_parameters())
    return {n: (p.to(dtype).float() if p.dtype == torch.float32 else p)
            for n, p in named.items()}


def _grads(params, cfg: ModelConfig, batch, accum_steps: int,
           cast_params: bool, *, leaves=None, fwd=None):
    """(grads {name: float32}, loss) of one step's batch: the float32
    gradients summed over ``accum_steps`` microbatches in order (or over
    ``batch`` itself when it is a list of them) and divided by their
    number, the loss averaged likewise.  ``leaves`` ({name: leaf tensor})
    stand in for the parameters (the pod step's sub-mesh views); ``fwd``
    holds ``forward``'s mesh arguments."""
    micro = batch if isinstance(batch, list) else _micro(batch, accum_steps)
    own = leaves is None
    leaves = dict(params.named_parameters()) if own else leaves
    for p in leaves.values():
        p.grad = None
    fwd = fwd or {}

    def one(mb):
        sub = cast_params_tree(leaves) if cast_params else \
            (None if own else leaves)
        loss, _ = loss_fn(params, cfg, mb, sub, **fwd)
        loss.backward()
        return loss.detach()

    loss = one(micro[0])
    for mb in micro[1:]:
        loss = loss + one(mb)
    if len(micro) > 1:
        loss = loss / len(micro)
    grads = {}
    for n, p in leaves.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
        grads[n] = g if len(micro) == 1 else g / len(micro)
    return grads, loss


def _rows(batch, i: int, n: int):
    """Rows [i B/n, (i + 1) B/n) of every leaf of ``batch``."""
    b = batch["tokens"].shape[0] // n
    return {k: v[i * b:(i + 1) * b] for k, v in batch.items()}


def param_mesh(mesh):
    """The mesh a step's parameters live on: ``mesh`` without its "pod"
    axis (the parameters are pod-replicated, as the reference's rules
    leave them), or ``mesh`` itself."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return mesh
    return mesh[tuple(a for a in names if a != "pod")]


_BATCH_AXES = {"tokens": ("batch", "seq"), "targets": ("batch", "seq"),
               "extra_embeds": ("batch", "seq", "embed"),
               "cond": ("batch", "seq", "embed")}


def shard_batch(batch, mesh, *, exclude=()):
    """Each leaf of a global batch (the same on every rank) as a DTensor
    laid out by ``act_spec`` of its logical axes (tokens/targets
    ("batch", "seq"): batch over ("pod", "data"), seq over "model");
    ``exclude`` drops mesh axes from the rules and places the leaves on
    the mesh without them."""
    rules = {k: tuple(a for a in v if a not in exclude)
             for k, v in SH.ACT_RULES.items()}
    dst = param_mesh(mesh) if "pod" in exclude else mesh
    out = {}
    for k, v in batch.items():
        spec = SH._resolve(_BATCH_AXES[k], tuple(v.shape), rules, mesh)
        out[k] = distribute_local(v, dst, SH.placements(spec, dst))
    return out


def make_train_step(cfg: ModelConfig, ocfg: optim.OptConfig, mesh=None,
                    shard=None, *, accum_steps: int = 1,
                    grad_compression: bool = False, param_specs=None,
                    cast_params: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    {"loss", "grad_norm", "lr"} as 0-d tensors (plain tensors, equal on
    every rank, on a mesh too).  ``batch`` holds numpy arrays or tensors
    (moved to the parameters' device): the global batch, the same on
    every rank.

    With a ``mesh`` (a ``DeviceMesh`` with named dims; the state from
    ``init_state(..., mesh=mesh)``), the step is the FSDP/TP/EP step:
    the batch is laid out by ``act_spec(("batch", "seq"))``, the model
    runs on the DTensor parameters with ``shard`` (default
    ``sharding.make_shard_fn(mesh)``) laying the residual stream out at
    the reference's points and ``param_specs`` (``model.param_specs``)
    the repeats' slot leaves, a ``moe_impl="shard_map"`` MoE runs
    expert-parallel, and the gradients are laid out as the parameters
    before the update.  With a "pod" axis of more than one rank, each pod
    takes its rows of the batch, computes its gradients over the (data,
    model) sub-mesh with the pod axis excluded from the rules
    (``make_shard_fn(mesh, exclude=("pod",))``), and every gradient is
    averaged over the mesh's pod group: through the int8
    ``collectives.compressed_psum`` with ``grad_compression`` (the
    reference's pod step), else exactly (a float32 all-reduce: the
    reference's data parallelism over ("pod", "data"), whose rows the
    pods' halves are; DTensor's planner would take minutes an op to
    place the whole step on three mesh dims).  Pod rank i takes rows
    [i B/n, (i + 1) B/n) of the global batch (the reference's
    ``P("pod")`` split)."""
    if cfg.attention_impl == "pallas":
        raise ValueError(
            f"{cfg.name}: attention_impl='pallas' has no backward (the "
            "flash kernel is forward only); train with "
            "attention_impl='reference'")
    if mesh is not None:
        return _mesh_step(cfg, ocfg, mesh, shard, accum_steps,
                          grad_compression, param_specs, cast_params)

    def train_step(state, batch):
        params = state["params"]
        dev = next(params.parameters()).device
        batch = to_device(batch, dev)
        grads, loss = _grads(params, cfg, batch, accum_steps, cast_params)
        _, opt, om = optim.update(grads, state["opt"], params, ocfg)
        del grads
        state["opt"], state["step"] = opt, state["step"] + 1
        return state, {"loss": loss, **om}

    return train_step


def _pod_mean(x, group):
    """The exact mean of ``x`` over ``group`` (float32 all-reduce)."""
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


def _micro(batch, accum: int):
    return [batch] if accum == 1 else _split_microbatches(batch, accum)


def _mesh_step(cfg, ocfg, mesh, shard, accum_steps, grad_compression,
               param_specs, cast_params):
    """``make_train_step``'s mesh step (its docstring)."""
    names = tuple(mesh.mesh_dim_names)
    use_pod = "pod" in names and mesh.size(names.index("pod")) > 1
    exclude = ("pod",) if use_pod else ()
    if use_pod or shard is None:
        shard = SH.make_shard_fn(mesh, exclude=exclude)
    pshard = SH.make_param_shard_fn(mesh, gather=("data",)) \
        if param_specs is not None else None
    fwd = dict(mesh=param_mesh(mesh) if use_pod else mesh, shard=shard,
               param_specs=param_specs, pshard=pshard)

    def train_step(state, batch):
        params = state["params"]
        named = dict(params.named_parameters())
        dev = next(iter(named.values())).to_local().device
        batch = to_device(batch, dev)
        with implicit_replication():
            if use_pod:
                pod = mesh.get_group("pod")
                batch = _rows(batch, dist.get_rank(pod),
                              dist.get_world_size(pod))
                sub = param_mesh(mesh)
                # each parameter's local shard viewed on the (data, model)
                # sub-mesh, a leaf of this step's graph
                views = {n: DTensor.from_local(
                    p.detach().to_local(), sub,
                    [pl for a, pl in zip(names, p.placements) if a != "pod"]
                ).requires_grad_() for n, p in named.items()}
            else:
                views = None
            micro = [shard_batch(mb, mesh, exclude=exclude)
                     for mb in _micro(batch, accum_steps)]
            grads, loss = _grads(params, cfg, micro, accum_steps,
                                 cast_params, leaves=views, fwd=fwd)
            loss = loss.full_tensor()
            if use_pod:
                reduce = compressed_psum if grad_compression else _pod_mean
                grads = {n: DTensor.from_local(
                    reduce(g.redistribute(
                        g.device_mesh, views[n].placements).to_local(), pod),
                    mesh, named[n].placements) for n, g in grads.items()}
                dist.all_reduce(loss, group=pod)
                loss = loss / dist.get_world_size(pod)
            else:
                grads = {n: g.redistribute(mesh, named[n].placements)
                         for n, g in grads.items()}
            _, opt, om = optim.update(grads, state["opt"], params, ocfg)
        del grads
        state["opt"], state["step"] = opt, state["step"] + 1
        return state, {"loss": loss, **om}

    return train_step


def trainable(params):
    """Turn gradients on for every leaf of ``params`` (a ``Transformer``,
    whose leaves are made frozen for serving) and return it."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


def shard_params(params, mesh):
    """Lay every leaf of ``params`` (whole, the same on every rank) out on
    ``mesh`` as a DTensor parameter with ``placements(param_spec(...))``
    of its logical axes (a fused leaf's resolved on its unfused shape,
    ``sharding.fold``); each rank keeps its own shard.  In place; returns
    ``params``."""
    specs, refs = mdl.param_specs(params), mdl.param_ref_shapes(params)
    for prefix, mod in list(params.named_modules()):
        for n, t in list(mod.named_parameters(recurse=False)):
            full = f"{prefix}.{n}" if prefix else n
            pl = SH.leaf_placements(specs[full], refs[full],
                                    tuple(t.shape), mesh)
            setattr(mod, n, nn.Parameter(distribute_local(
                t.detach(), mesh, pl), requires_grad=t.requires_grad))
    return params


def gather_state(state) -> dict:
    """The state with every DTensor gathered whole (``full_tensor``, a
    collective every rank joins) into a plain tensor, the parameters as
    a {name: tensor} map (a checkpoint writes them in the same sorted-name
    order as a ``Transformer``'s); the state itself is left as it is."""
    def whole(x):
        if isinstance(x, optim.QLeaf):
            return optim.QLeaf(*(whole(a) for a in x))
        return x.detach().full_tensor() if isinstance(x, DTensor) else x

    params = {n: whole(t) for n, t in state["params"].named_parameters()}
    opt = {k: ({n: whole(v) for n, v in tree.items()}
               if isinstance(tree, dict) else whole(tree))
           for k, tree in state["opt"].items()}
    return {"params": params, "opt": opt, "step": whole(state["step"])}


def init_state(cfg: ModelConfig, ocfg: optim.OptConfig, *, seed: int = 0,
               device=None, mesh=None) -> dict:
    """{"params", "opt", "step"}: ``model.init``'s seeded weights with
    gradients on, zero moments in ``ocfg.state_dtype``, step 0.  With a
    ``mesh`` every rank draws the same weights and keeps its shard
    (``shard_params``), and the moments take the parameters' placements
    (an int8 moment ``("qblocks", None)``)."""
    dev = resolve_device(device)
    params = trainable(mdl.init(cfg, seed=seed, device=dev))
    if mesh is not None:
        shard_params(params, mesh)
    return {"params": params, "opt": optim.init(params, ocfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def state_specs(param_specs, ocfg: optim.OptConfig) -> dict:
    """Logical-axis spec tree of the train state (the reference's)."""
    return {"params": param_specs,
            "opt": optim.state_specs(param_specs, ocfg),
            "step": None}
