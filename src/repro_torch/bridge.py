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

``state_from_reference`` carries a whole reference train state over
(parameters, AdamW moments in any state precision, counts), so the tests
can hold the two packages' training side by side and load a reference
checkpoint's arrays into the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Transformer
from repro_torch.train.optim import QLeaf
from repro_torch.train.step import trainable

__all__ = ["from_reference", "state_from_reference"]


def _walk(params: Transformer, ref, cfg: ModelConfig):
    """(the port's leaf, the reference's leaf at the same place) for every
    leaf of ``params``; ``ref`` has the reference parameter tree's
    structure (the parameters, or a moment tree of the same shape).  Every
    pair holds the same elements in the same flat order: the port's leaf
    is the reference's reshaped."""
    yield params.tok, ref["embed"]["tok"]
    if not cfg.tie_embeddings:
        yield params.unembed, ref["embed"]["unembed"]
    yield params.final_norm, ref["final_norm"]
    for seg, ref_seg in zip(params.segments, ref["segments"]):
        for slot, rs in zip(seg, ref_seg):
            yield slot.norm1, rs["norm1"]
            if slot.kind.is_recurrent:
                for name, t in slot.cell.named_parameters():
                    yield t, rs["cell"][name]
            else:
                names = (("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm",
                          "w_kr", "w_uk", "w_uv", "wo") if slot.kind.mla
                         else ("wq", "wk", "wv", "wo")
                         + (("q_norm", "k_norm") if cfg.qk_norm else ()))
                for name in names:
                    yield getattr(slot, name), rs["attn"][name]
            if slot.kind.xattn:
                yield slot.norm_x, rs["norm_x"]
                for name, t in slot.xattn.named_parameters():
                    yield t, rs["xattn"][name]
            if "norm2" in rs:
                yield slot.norm2, rs["norm2"]
            if slot.kind.moe:
                moe = rs["moe"]
                for name in ("router", "wi_gate", "wi_up", "wo"):
                    yield getattr(slot.moe, name), moe[name]
                if cfg.moe.num_shared:
                    for name in ("wi_gate", "wi_up", "wo"):
                        yield getattr(slot.moe.shared, name), \
                            moe["shared"][name]
            elif "mlp" in rs:
                for name, src in rs["mlp"].items():
                    yield getattr(slot, "w_down" if name == "wo"
                                  else name), src


def from_reference(ref_params, cfg: ModelConfig, *,
                   device=None) -> Transformer:
    """The port's parameters holding the reference's values (float32)."""
    params = Transformer(cfg, resolve_device(device))
    with torch.no_grad():
        for dst, src in _walk(params, ref_params, cfg):
            dst.copy_(torch.tensor(np.asarray(src, np.float32))
                      .reshape(dst.shape))
    return params


def state_from_reference(ref_state, cfg: ModelConfig, *,
                         device=None) -> dict:
    """The port's train state (``train.step.init_state``'s structure)
    holding a reference train state ``{"params", "opt": {"m", "v",
    "count"}, "step"}`` given as numpy: the parameters (gradients on),
    the moments in the state's own precision -- float32, bfloat16, or the
    int8 ``_QLeaf`` codes, scales and zeros as they are (the blocks run
    over the same flat order) -- and the counts."""
    params = trainable(from_reference(ref_state["params"], cfg,
                                      device=device))
    dev = params.tok.device
    names = {id(t): n for n, t in params.named_parameters()}

    def leaf(dst, src):
        if hasattr(src, "_fields"):                   # the int8 _QLeaf
            return QLeaf(*(torch.tensor(np.asarray(a)).to(dev)
                           for a in (src.q, src.scale, src.zero)))
        dt = torch.bfloat16 if str(np.asarray(src).dtype) == "bfloat16" \
            else torch.float32
        return torch.tensor(np.asarray(src, np.float32)) \
            .reshape(dst.shape).to(dev, dt)

    opt = ref_state["opt"]
    moments = {}
    for key in ("m", "v"):
        got = {names[id(dst)]: leaf(dst, src)
               for dst, src in _walk(params, opt[key], cfg)}
        moments[key] = {n: got[n] for n in names.values()}
    count = lambda a: torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                                   device=dev)
    return {"params": params,
            "opt": {**moments, "count": count(opt["count"])},
            "step": count(ref_state["step"])}
