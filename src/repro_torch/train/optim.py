"""AdamW with float32, bfloat16 or int8-blockwise state (the counterpart of
``repro/train/optim.py``).

State-precision ladder:
    float32:  8 bytes/param of optimizer state
    bfloat16: 4 bytes/param
    int8:     ~2.06 bytes/param (blocks of 128 with float32 scales; the
              error is kept by re-quantising after each update, as 8-bit
              Adam)

The parameters are a ``Transformer``'s named parameters or any dict of
tensors; the moments are dicts keyed by the same names.  ``update``
writes the new values into the parameters and the state in place (the
reference returns new trees) and returns them.  Every element-wise
operation is the reference's, in its order, in float32: ``torch.round``
rounds half to even as ``jnp.round`` does, so the int8 codes of one input
equal the reference's.

On a mesh the parameters, gradients and float moments are DTensors with
the parameters' placements and every operation is the same; an int8
moment's ``QLeaf`` arrays are DTensors laid out by ``("qblocks", None)``
(``state_specs``), quantised over the whole leaf as the reference's (the
blocks run over the leaf's flat order, which no shard holds whole).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

import torch
from torch import nn

from repro_torch.distributed import sharding as SH
from repro_torch.distributed.compat import DTensor, distribute_local

__all__ = ["OptConfig", "QLeaf", "QBLOCK", "schedule", "init", "update",
           "global_norm", "state_specs"]

QBLOCK = 128


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"       # float32 | bfloat16 | int8


# ---------------------------------------------------------------------------
# int8 blockwise quantisation
# ---------------------------------------------------------------------------


class QLeaf(NamedTuple):
    """A quantised leaf (blockwise int8), the reference's ``_QLeaf``.

    Linear mode (signed data, Adam's m):  x ~ q * scale,        zero == 0
    Log mode (positive data, Adam's v):   x ~ exp(zero + (q+127)*scale)
    Log-domain quantisation keeps small second moments: linear int8 zeroes
    them within a block and the update m/sqrt(v) explodes."""
    q: torch.Tensor       # int8 [nblocks, QBLOCK]
    scale: torch.Tensor   # float32 [nblocks, 1]
    zero: torch.Tensor    # float32 [nblocks, 1]


def _blocks(x):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % QBLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, QBLOCK)


def _quantize_linear(x) -> QLeaf:
    b = _blocks(x)
    scale = torch.clamp(b.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.clamp(torch.round(b / scale), -127, 127).to(torch.int8)
    return QLeaf(q, scale, torch.zeros_like(scale))


def _quantize_log(x) -> QLeaf:
    lx = torch.log(_blocks(x) + 1e-30)
    lo = lx.amin(dim=1, keepdim=True)
    hi = lx.amax(dim=1, keepdim=True)
    scale = torch.clamp((hi - lo) / 254.0, min=1e-8)
    q = torch.clamp(torch.round((lx - lo) / scale) - 127, -127,
                    127).to(torch.int8)
    return QLeaf(q, scale, lo)


def _pack(x, dtype: str, mode: str = "linear"):
    if dtype == "int8":
        if isinstance(x, DTensor):
            mesh = x.device_mesh
            q = _pack(x.full_tensor(), dtype, mode)
            return QLeaf(*(distribute_local(a, mesh, SH.leaf_placements(
                ("qblocks", None), a.shape, a.shape, mesh)) for a in q))
        return _quantize_log(x) if mode == "log" else _quantize_linear(x)
    return x.to(getattr(torch, dtype))


def _unpack(leaf, shape, dtype: str, mode: str = "linear", like=None):
    """A moment as a float32 leaf of ``shape``; an int8 moment of a
    DTensor parameter ``like`` is dequantised whole and laid out as
    ``like``."""
    if dtype == "int8" and isinstance(leaf.q, DTensor):
        whole = _unpack(QLeaf(*(a.full_tensor() for a in leaf)), shape,
                        dtype, mode)
        return distribute_local(whole, like.device_mesh, like.placements)
    if dtype == "int8":
        n = math.prod(shape)
        if mode == "log":
            flat = torch.exp(leaf.zero + (leaf.q.float() + 127.0)
                             * leaf.scale).reshape(-1)
            flat = torch.where(flat <= 2e-30, 0.0, flat)
        else:
            flat = (leaf.q.float() * leaf.scale).reshape(-1)
        return flat[:n].reshape(shape)
    return leaf.float()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _leaves(params) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a module's parameters, or the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device: a Python float over a
    tensor would take ``reciprocal() * x`` where the reference divides."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``, in float32."""
    step = step.float()
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.decay_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(params, cfg: OptConfig) -> dict:
    """{"m", "v": {name: packed zeros}, "count": int32 0} on the
    parameters' device."""
    leaves = _leaves(params)
    # zeros_like keeps a DTensor parameter's placements
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32,
                                       requires_grad=False)
    dev = next(iter(leaves.values())).device
    return {"m": {n: _pack(zeros(p), cfg.state_dtype, "linear")
                  for n, p in leaves.items()},
            "v": {n: _pack(zeros(p), cfg.state_dtype, "log")
                  for n, p in leaves.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf; a plain scalar, a
    DTensor leaf's square sum reduced over its shards."""
    sq = [torch.sum(torch.square(x.float())) for x in tree.values()]
    sq = [x.full_tensor() if isinstance(x, DTensor) else x for x in sq]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def update(grads: Dict[str, torch.Tensor], state: dict, params,
           cfg: OptConfig):
    """One AdamW step.  Returns (params, state, metrics): the parameters
    and the state are updated in place (the reference returns new trees,
    which at full width would hold the moments twice), metrics
    ``grad_norm`` (before the clip) and ``lr`` (from the count before
    this step's increment).  Weight decay applies to every leaf, norms
    included, as the reference's."""
    leaves = _leaves(params)
    count = state["count"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(_f32(cfg.grad_clip, gnorm)
                       / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = schedule(cfg, state["count"])
    cf = count.float()
    b1c = 1 - torch.pow(_f32(cfg.b1, cf), cf)
    b2c = 1 - torch.pow(_f32(cfg.b2, cf), cf)
    for name, p in leaves.items():
        g = grads[name].float() * clip
        m = _unpack(state["m"][name], p.shape, cfg.state_dtype, "linear", p)
        v = _unpack(state["v"][name], p.shape, cfg.state_dtype, "log", p)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr * (upd + cfg.weight_decay * pf))
        # replacing a moment frees the old one before the next leaf's
        # temporaries: a full-width model holds one leaf's worth extra
        state["m"][name] = _pack(m, cfg.state_dtype, "linear")
        state["v"][name] = _pack(v, cfg.state_dtype, "log")
        del g, m, v, upd, pf
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}


def state_specs(param_specs, cfg: OptConfig):
    """Logical-axis spec tree of the optimizer state (the reference's):
    float32/bfloat16 moments mirror the parameter specs; an int8 moment
    is blockwise-flat [nblocks, 128] and shards its block dim over
    "data" when divisible ("qblocks")."""
    if cfg.state_dtype == "int8":
        wrap = lambda ax: QLeaf(("qblocks", None), ("qblocks", None),
                                ("qblocks", None))
    else:
        wrap = lambda ax: ax
    m = {n: wrap(ax) for n, ax in param_specs.items()}
    return {"m": m, "v": dict(m), "count": None}
