"""Meta-tensor stand-ins for every (arch x shape) dry-run cell (the
counterpart of ``repro/launch/specs.py``, whose ``ShapeDtypeStruct``s
become ``torch.empty(..., device="meta")``: a shape and a dtype, no
storage).

``batch_specs`` / ``decode_specs`` give a cell's step inputs with the
reference's shapes and dtypes leaf for leaf (token ids and cache
positions int32, embeddings bfloat16).  Modality frontends are stubs: the
VLM cell gets precomputed patch embeddings, the audio cell a
conditioning sequence.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

import repro_torch.configs as C
from repro_torch.models import model as mdl
from repro_torch.models.config import ModelConfig
from repro_torch.train import optim, step as tstep

__all__ = ["Cell", "cell", "meta", "batch_specs", "decode_specs",
           "state_specs_shapes"]

META = torch.device("meta")


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    step_kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


def cell(arch: str, shape: str) -> Cell:
    cfg = C.get(arch)
    sh = C.SHAPES[shape]
    return Cell(arch, shape, cfg, sh["step"], sh["seq_len"],
                sh["global_batch"])


def batch_specs(c: Cell) -> Dict[str, Any]:
    """Training/prefill batch stand-ins."""
    cfg, b = c.cfg, c.global_batch
    s = c.seq_len
    out: Dict[str, Any] = {}
    p = cfg.prefix_len or 0
    out["tokens"] = meta((b, s - p), torch.int32)
    if c.step_kind == "train":
        out["targets"] = meta((b, s), torch.int32)
    if p:
        out["extra_embeds"] = meta((b, p, cfg.d_model), torch.bfloat16)
    if cfg.cond_len:
        out["cond"] = meta((b, cfg.cond_len, cfg.d_model), torch.bfloat16)
    return out


def decode_specs(c: Cell) -> Dict[str, Any]:
    """Decode-step inputs: one new token against a seq_len cache (the
    reference's ``init_cache(cfg, b, seq_len, bfloat16)``: positions
    int32, a recurrent state float32)."""
    cfg, b = c.cfg, c.global_batch
    cache = mdl.init_cache(cfg, b, c.seq_len, dtype=torch.bfloat16,
                           device=META)
    for slots in cache["segments"]:
        for e in slots:
            if "pos" in e:
                e["pos"] = meta(e["pos"].shape, torch.int32)
    out = {"cache": cache,
           "tokens": meta((b, 1), torch.int32),
           "cur_pos": meta((b,), torch.int32)}
    if cfg.cond_len:
        out["cond"] = meta((b, cfg.cond_len, cfg.d_model), torch.bfloat16)
    return out


def state_specs_shapes(cfg: ModelConfig, ocfg: optim.OptConfig):
    """(train state on the meta device, logical spec tree) without
    allocation: the port's ``Transformer`` leaves (fused projections;
    ``model.param_ref_shapes`` gives the shapes the specs describe)."""
    params = tstep.trainable(mdl.Transformer(cfg, META))
    state = {"params": params, "opt": optim.init(params, ocfg),
             "step": meta((), torch.int32)}
    return state, tstep.state_specs(mdl.param_specs(params), ocfg)
