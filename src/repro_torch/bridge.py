"""Carry the JAX reference's parameters over to the port.

``from_reference`` takes the reference's parameter tree
(``repro.models.model.init(key, cfg)[0]``) with its leaves converted to
numpy arrays -- the caller does that conversion, so this module imports
nothing of JAX -- and returns the port's ``Transformer`` holding the same
numbers: segment leaves stay stacked ``[R, ...]``, and the attention
projections are reshaped from the reference's ``wq/wk/wv [d, H, hd]`` and
``wo [H, hd, d]`` to the port's matmul-ready ``[d, H*hd]`` / ``[H*hd, d]``
(MLA's ``w_uq`` and ``wo`` likewise, and the cross-attention leaves
``xattn.{wq, wk, wv, wo}``, whose ``wk``/``wv`` take ``cond_dim`` rows;
``w_uk``/``w_uv`` keep their heads).  MLA leaves (``w_dq, q_norm, w_uq,
w_dkv, kv_norm, w_kr, w_uk, w_uv, wo``), MoE leaves (``router, wi_gate,
wi_up, wo, shared.*``), ``norm_x`` and a recurrent slot's ``cell`` leaves
carry over as they are named in the reference; the MLP's ``wo`` becomes
``w_down`` (SwiGLU's ``wi_gate``/``wi_up`` and the GELU / squared-ReLU
``wi`` keep their names).
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
                put(slot.norm1, ref["norm1"])
                if slot.kind.is_recurrent:
                    for name, t in slot.cell.named_parameters():
                        put(t, ref["cell"][name])
                else:
                    names = (("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm",
                              "w_kr", "w_uk", "w_uv", "wo") if slot.kind.mla
                             else ("wq", "wk", "wv", "wo")
                             + (("q_norm", "k_norm") if cfg.qk_norm
                                else ()))
                    for name in names:
                        put(getattr(slot, name), ref["attn"][name])
                if slot.kind.xattn:
                    put(slot.norm_x, ref["norm_x"])
                    for name, t in slot.xattn.named_parameters():
                        put(t, ref["xattn"][name])
                if "norm2" in ref:
                    put(slot.norm2, ref["norm2"])
                if slot.kind.moe:
                    moe = ref["moe"]
                    for name in ("router", "wi_gate", "wi_up", "wo"):
                        put(getattr(slot.moe, name), moe[name])
                    if cfg.moe.num_shared:
                        for name in ("wi_gate", "wi_up", "wo"):
                            put(getattr(slot.moe.shared, name),
                                moe["shared"][name])
                elif "mlp" in ref:
                    for name, src in ref["mlp"].items():
                        put(getattr(slot, "w_down" if name == "wo"
                                    else name), src)
    return params
