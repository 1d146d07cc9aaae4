"""Carry the JAX reference's parameters over to the port.

``from_reference`` takes the reference's parameter tree
(``repro.models.model.init(key, cfg)[0]``) with its leaves converted to
numpy arrays -- the caller does that conversion, so this module imports
nothing of JAX -- and returns the port's ``Transformer`` holding the same
numbers: segment leaves stay stacked ``[R, ...]``, and the attention
projections are reshaped from the reference's ``wq/wk/wv [d, H, hd]`` and
``wo [H, hd, d]`` to the port's matmul-ready ``[d, H*hd]`` / ``[H*hd, d]``.
The tests use it so both packages compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Transformer

__all__ = ["from_reference"]


def from_reference(ref_params, cfg: ModelConfig, *,
                   device=None) -> Transformer:
    """The port's parameters holding the reference's values (float32)."""
    dev = resolve_device(device)
    params = Transformer(cfg, dev)

    def put(dst: torch.Tensor, src) -> None:
        dst.copy_(torch.tensor(np.asarray(src, np.float32))
                  .reshape(dst.shape))

    with torch.no_grad():
        put(params.tok, ref_params["embed"]["tok"])
        if not cfg.tie_embeddings:
            put(params.unembed, ref_params["embed"]["unembed"])
        put(params.final_norm, ref_params["final_norm"])
        for seg, ref_seg in zip(params.segments, ref_params["segments"]):
            for slot, ref in zip(seg, ref_seg):
                attn, mlp = ref["attn"], ref["mlp"]
                put(slot.norm1, ref["norm1"])
                put(slot.norm2, ref["norm2"])
                for name in ("wq", "wk", "wv", "wo"):
                    put(getattr(slot, name), attn[name])
                if cfg.qk_norm:
                    put(slot.q_norm, attn["q_norm"])
                    put(slot.k_norm, attn["k_norm"])
                put(slot.wi_gate, mlp["wi_gate"])
                put(slot.wi_up, mlp["wi_up"])
                put(slot.w_down, mlp["wo"])
    return params
