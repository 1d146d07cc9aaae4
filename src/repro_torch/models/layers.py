"""Core layers of the attention-only transformer (the subset of
``repro/models/layers.py`` this slice serves): norms, rotary, the SwiGLU
MLP, GQA attention for prefill and dense decode, embeddings.

Layouts follow the reference at every public function (activations
[B, S, H, D], caches [B, T, KV, D]); projection weights are stored
matmul-ready, ``wq [d, H*hd]`` and ``wo [H*hd, d]`` in place of the
reference's ``[d, H, hd]`` / ``[H, hd, d]`` (``repro_torch.bridge``
reshapes).  Numerics: the reference's embedding promotes the residual
stream to float32 (``embed`` below), so everything past it runs in
float32 whatever ``cfg.dtype`` says.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["dense_init", "rms_norm", "rope", "mlp_apply", "causal_mask",
           "sdpa", "attention_apply", "attention_decode", "embed", "unembed"]

NEG = -1e30     # masked logits, as the reference (not -inf)


def dense_init(t: torch.Tensor, generator: torch.Generator, fan_in: int,
               scale=None) -> torch.Tensor:
    """He-style init in place: N(0, 1) * ``scale`` (default
    1/sqrt(fan_in)), the reference's ``_dense_init`` scales."""
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return t.normal_(generator=generator).mul_(scale)


def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


def rope(x, positions, theta: float):
    """Apply rotary embedding.  x: [..., S, H, D], positions: [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq             # [..., S, half]
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p, r: int, x):
    """SwiGLU MLP of slot ``p`` at repeat ``r``."""
    h = torch.nn.functional.silu(x @ p.wi_gate[r]) * (x @ p.wi_up[r])
    return h @ p.w_down[r]


def causal_mask(q_pos, k_pos):
    """Boolean [.., Q, K] causal mask."""
    return k_pos[..., None, :] <= q_pos[..., :, None]


def sdpa(q, k, v, mask, softcap: float):
    """Softmax attention.  q: [B,S,H,D], k/v: [B,T,KV,D], mask: bool
    broadcastable to [B,S,T].  The query heads of one KV head attend it as
    a group (GQA without materialising repeated keys)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg.float(), k.float()) \
        * (1.0 / math.sqrt(d))
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    m = torch.broadcast_to(mask, (b, s, k.shape[1]))[:, None, None]
    logits = torch.where(m, logits, torch.full_like(logits, NEG))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v.to(q.dtype))
    return out.reshape(b, s, h, v.shape[-1])


def _qkv(p, r: int, cfg: ModelConfig, x, positions):
    """Projected, qk-normed, roped q [B,S,H,D] and k/v [B,S,KV,D]."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p.wq[r]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p.wk[r]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p.wv[r]).reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm[r])
        k = rms_norm(k, p.k_norm[r])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(p, r: int, cfg: ModelConfig, x, positions, mask):
    """Full causal self-attention (prefill).  Returns (out, (k, v))."""
    q, k, v = _qkv(p, r, cfg, x, positions)
    out = sdpa(q, k, v, mask, cfg.softcap)
    b, s = x.shape[:2]
    return out.reshape(b, s, -1) @ p.wo[r], (k, v)


def attention_decode(p, r: int, cfg: ModelConfig, x, cache_k, cache_v,
                     cache_pos, cur_pos):
    """One-token decode.  x: [B,1,d]; cache_k/v: [B,T,KV,D]; cache_pos:
    [B,T] absolute positions (-1 == empty); cur_pos: [B].
    Returns (out, new_k_entry, new_v_entry)."""
    q, k_new, v_new = _qkv(p, r, cfg, x, cur_pos[:, None])
    k_all = torch.cat([cache_k, k_new], dim=1).to(x.dtype)
    v_all = torch.cat([cache_v, v_new], dim=1).to(x.dtype)
    pos_all = torch.cat([cache_pos, cur_pos[:, None]], dim=1)
    m = (pos_all <= cur_pos[:, None]) & (pos_all >= 0)
    out = sdpa(q, k_all, v_all, m[:, None, :], cfg.softcap)
    return out.reshape(x.shape[0], 1, -1) @ p.wo[r], k_new, v_new


def embed(tok_table, cfg: ModelConfig, tokens):
    """Token embeddings, rounded through ``cfg.dtype`` and scaled by
    sqrt(d_model).  The reference multiplies by a strong float64 scalar,
    which promotes the result to float32 (``layers.py:366-380``,
    ``RESID_WEAK_SCALE = False``): the port keeps that float32 residual
    stream.  Rows are gathered before the cast, so the full table is
    never converted."""
    e = tok_table[tokens].to(getattr(torch, cfg.dtype)).float()
    return e * math.sqrt(cfg.d_model)


def unembed(params, cfg: ModelConfig, x):
    w = params.tok.T if cfg.tie_embeddings else params.unembed
    return x @ w
