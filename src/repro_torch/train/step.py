"""Training step: loss, gradient accumulation, compressed cross-pod data
parallelism (the counterpart of ``repro/train/step.py``).

``make_train_step`` builds a ``(state, batch) -> (state, metrics)``
closure for a ModelConfig:

  * microbatching -- ``accum_steps`` splits the step's batch and sums the
    float32 gradients over the microbatches (the reference's ``lax.scan``),
    then divides by their number; the loss is averaged the same way;
  * remat -- ``cfg.remat`` checkpoints each repeat inside the model
    (``models.model._run_seq``);
  * compressed cross-pod DP -- with ``grad_compression=True`` and a
    ``torch.distributed`` process group of more than one rank (the
    reference's "pod" mesh axis), each rank takes its rows of the global
    batch, computes their gradients, and every gradient goes through the
    int8 ``collectives.compressed_psum``; the loss is averaged over the
    group and every rank applies the same ``optim.update``.

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

from repro_torch import resolve_device
from repro_torch.distributed.collectives import compressed_psum
from repro_torch.models import model as mdl
from repro_torch.models.config import ModelConfig
from repro_torch.train import optim

__all__ = ["IGNORE", "cross_entropy", "loss_fn", "cast_params_tree",
           "make_train_step", "init_state", "trainable", "to_device"]

IGNORE = -1


def cross_entropy(logits, targets):
    """Mean CE over non-ignored targets.  logits: [B,S,V] (any float
    dtype), targets: [B,S] integer with IGNORE for masked positions."""
    logits = logits.float()
    mask = targets != IGNORE
    tgt = torch.where(mask, targets, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    ce = (logz - gold) * mask
    return torch.sum(ce) / torch.clamp(torch.sum(mask), min=1)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any],
            leaves=None):
    """(ce + aux_loss_weight * aux, {"ce", "aux"}) of one batch;
    ``leaves`` ({name: tensor}) stand in for the parameters' own
    (``torch.func.functional_call``)."""
    kw = dict(extra_embeds=batch.get("extra_embeds"), cond=batch.get("cond"))
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
    return {n: (p.to(dtype).float() if p.dtype == torch.float32 else p)
            for n, p in params.named_parameters()}


def _grads(params, cfg: ModelConfig, batch, accum_steps: int,
           cast_params: bool):
    """(grads {name: float32}, loss) of one step's batch: the float32
    gradients summed over ``accum_steps`` microbatches in order and
    divided by their number, the loss averaged likewise."""
    leaves = dict(params.named_parameters())
    for p in leaves.values():
        p.grad = None

    def one(mb):
        loss, _ = loss_fn(params, cfg, mb, cast_params_tree(params)
                          if cast_params else None)
        loss.backward()
        return loss.detach()

    if accum_steps == 1:
        loss = one(batch)
    else:
        loss = torch.zeros((), device=batch["tokens"].device)
        for mb in _split_microbatches(batch, accum_steps):
            loss = loss + one(mb)
        loss = loss / accum_steps
    grads = {}
    for n, p in leaves.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
        grads[n] = g if accum_steps == 1 else g / accum_steps
    return grads, loss


def make_train_step(cfg: ModelConfig, ocfg: optim.OptConfig, *,
                    accum_steps: int = 1, grad_compression: bool = False,
                    group=None, cast_params: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    {"loss", "grad_norm", "lr"} as 0-d tensors.  ``batch`` holds numpy
    arrays or tensors (moved to the parameters' device).  With
    ``grad_compression`` and a process ``group`` of n > 1 ranks, every
    rank passes the same global batch and takes rows [rank * B/n, (rank
    + 1) * B/n) of it (the reference's ``P("pod")`` split)."""
    if cfg.attention_impl == "pallas":
        raise ValueError(
            f"{cfg.name}: attention_impl='pallas' has no backward (the "
            "flash kernel is forward only); train with "
            "attention_impl='reference'")
    use_pod = (grad_compression and group is not None
               and dist.get_world_size(group) > 1)

    def train_step(state, batch):
        params = state["params"]
        dev = next(params.parameters()).device
        batch = to_device(batch, dev)
        if use_pod:
            n, rank = dist.get_world_size(group), dist.get_rank(group)
            b = batch["tokens"].shape[0] // n
            batch = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        grads, loss = _grads(params, cfg, batch, accum_steps, cast_params)
        if use_pod:
            # int8 all-reduce of every gradient (the only cross-pod hop)
            grads = {k: compressed_psum(g, group) for k, g in grads.items()}
            dist.all_reduce(loss, group=group)
            loss = loss / dist.get_world_size(group)
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


def init_state(cfg: ModelConfig, ocfg: optim.OptConfig, *, seed: int = 0,
               device=None) -> dict:
    """{"params", "opt", "step"}: ``model.init``'s seeded weights with
    gradients on, zero moments in ``ocfg.state_dtype``, step 0."""
    dev = resolve_device(device)
    params = trainable(mdl.init(cfg, seed=seed, device=dev))
    return {"params": params, "opt": optim.init(params, ocfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
