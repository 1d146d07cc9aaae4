"""Core layers of the attention transformer (the subset of
``repro/models/layers.py`` the port serves): norms, rotary, the SwiGLU,
GELU and squared-ReLU MLPs, GQA attention (causal or sliding-window;
prefill through the flash kernel when ``cfg.attention_impl ==
"pallas"``, a prefill chunk over the earlier chunks' ``past`` too),
cross-attention to a conditioning sequence, and MLA
(DeepSeek-V3 Multi-head Latent Attention) for prefill and dense decode,
embeddings.

Layouts follow the reference at every public function (activations
[B, S, H, D], caches [B, T, KV, D]); projection weights are stored
matmul-ready, ``wq [d, H*hd]`` and ``wo [H*hd, d]`` in place of the
reference's ``[d, H, hd]`` / ``[H, hd, d]`` (``repro_torch.bridge``
reshapes); MLA keeps ``w_uq [q_lora, H*(nope+rope)]`` and ``wo
[H*v_head, d]`` flat the same way, and ``w_uk``/``w_uv`` per head
``[kv_lora, H, k]`` as the reference.  Numerics: the reference's embedding promotes the residual
stream to float32 (``embed`` below), so everything past it runs in
float32 whatever ``cfg.dtype`` says.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.compat import DTensor, Replicate, Shard
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

__all__ = ["gather_rows", "rows_gathered", "dense", "reshape", "dense_init", "rms_norm", "rope", "mlp_apply", "causal_mask",
           "sdpa", "attention_apply", "attention_decode", "cross_attention",
           "mla_apply", "mla_decode", "mla_scale", "embed", "unembed"]

NEG = -1e30     # masked logits, as the reference (not -inf)
#: queries a chunk of ``sdpa``'s softmax: the reference's ``_sdpa_chunked``
#: takes ``q_chunk=512`` (``repro/models/layers.py:152``), so a chunk's
#: logits are [B, H, 512, T] however long the prompt
SDPA_Q_CHUNK = 512


def _even_reshape(t, shape):
    """A DTensor's reshape, gathering the dims it changes first when its
    placements cannot follow (``reshape``)."""
    try:
        return t.reshape(shape)
    except RuntimeError:
        first = next((i for i, (a, b) in enumerate(zip(t.shape, shape))
                      if a != b), min(t.ndim, len(shape)))
        pl = [Replicate() if isinstance(q, Shard) and q.dim >= first else q
              for q in t.placements]
        return t.redistribute(t.device_mesh, pl).reshape(shape)


class _Reshape(torch.autograd.Function):
    """``_even_reshape`` both ways: the gradient of a merge is a split
    that may be just as uneven."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.shape = tuple(t.shape)
        return _even_reshape(t, shape)

    @staticmethod
    def backward(ctx, g):
        return _even_reshape(g, ctx.shape), None


def gather_rows(x):
    """A DTensor ``x`` [B, ..., d] with its dims between the first and the
    last gathered (``Replicate``), so that they fold into the rows: the
    sequence, which the reference's sequence parallelism shards between
    blocks.  Older DTensor releases refuse to fold a sharded inner dim
    (newer ones gather the same way by themselves).  Anything else is
    returned as it is."""
    if isinstance(x, DTensor) and x.ndim > 2:
        pl = [Replicate() if isinstance(q, Shard) and 0 < q.dim < x.ndim - 1
              else q for q in x.placements]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x


class _RowsGathered(torch.autograd.Function):
    """The identity whose backward hands on the gradient ``gather_rows``d:
    a product's output gradient folds its rows too."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return gather_rows(g)


def rows_gathered(y):
    """``y``, whose gradient is handed on ``gather_rows``d (a DTensor
    [B, ..., d] that was folded from rows; anything else as it is)."""
    if isinstance(y, DTensor) and y.ndim > 2:
        return _RowsGathered.apply(y)
    return y


def dense(x, w):
    """``x @ w`` for activations ``x`` [..., d], ``gather_rows`` first (and
    on the output's gradient)."""
    return rows_gathered(gather_rows(x) @ w)


def reshape(t, *shape):
    """``t.reshape(shape)``.  A DTensor whose sharding the reshape cannot
    carry (a fused projection split into heads unevenly over the mesh,
    or heads merged from a sharded head dim; DTensor has no rule for an
    uneven split) is gathered (``Replicate``) over the dims the reshape
    changes first, in the forward and in the backward."""
    if not isinstance(t, DTensor):
        return t.reshape(shape)
    return _Reshape.apply(t, shape)


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


def mlp_apply(p, r: int, cfg: ModelConfig, x):
    """The ``cfg.mlp_kind`` MLP of slot ``p`` at repeat ``r``: SwiGLU over
    ``wi_gate``/``wi_up``, or ``wi`` then squared ReLU or GELU.  GELU is
    the tanh form, ``jax.nn.gelu``'s default, which the reference calls."""
    if cfg.mlp_kind == "swiglu":
        h = torch.nn.functional.silu(dense(x, p.wi_gate[r])) \
            * dense(x, p.wi_up[r])
    elif cfg.mlp_kind == "squared_relu":
        h = torch.square(torch.relu(dense(x, p.wi[r])))
    else:
        h = torch.nn.functional.gelu(dense(x, p.wi[r]), approximate="tanh")
    return dense(h, p.w_down[r])


def causal_mask(q_pos, k_pos, window: int = 0, prefix_len: int = 0):
    """Boolean [.., Q, K] causal mask; ``window > 0`` -> sliding window
    (key k visible from query q iff q - window < k <= q); ``prefix_len >
    0`` -> a bidirectional prefix (PaliGemma's image tokens): every query,
    a prefix query included, sees every key below ``prefix_len``."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    if prefix_len > 0:
        m |= k_pos[..., None, :] < prefix_len
    return m


def sdpa(q, k, v, mask, softcap: float):
    """Softmax attention.  q/k: [B,S,H,D] / [B,T,KV,D], v: [B,T,KV,Dv]
    (MLA's value width differs from its key width), mask: bool
    broadcastable to [B,S,T].  The query heads of one KV head attend it as
    a group (GQA without materialising repeated keys).  Returns
    [B,S,H,Dv].  DTensor inputs (the mesh step) attend shard by shard
    (``_sdpa_sharded``).

    The softmax runs ``SDPA_Q_CHUNK`` queries at a time (the mask's query
    rows sliced with them), so the float32 logits are never larger than
    [B, H, SDPA_Q_CHUNK, T], as the reference's ``_sdpa_chunked``; a
    query's row sums over the same keys either way.  Every S past one
    chunk is chunked, the ragged last chunk too, where the reference
    takes S % 512 != 0 in one piece (a difference of memory alone)."""
    if isinstance(q, DTensor):
        return _sdpa_sharded(q, k, v, mask, softcap)
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    kf, vq = k.float(), v.to(q.dtype)
    # a mask whose query dim is 1 (a decode step's) broadcasts to every row
    rows = mask.dim() >= 2 and mask.shape[-2] != 1
    outs = []
    for lo in range(0, s, SDPA_Q_CHUNK):
        hi = min(s, lo + SDPA_Q_CHUNK)
        qg = reshape(q[:, lo:hi], b, hi - lo, kvh, h // kvh, d)
        logits = torch.einsum("bsgrd,btgd->bgrst", qg.float(), kf) \
            * (1.0 / math.sqrt(d))
        if softcap > 0:
            logits = torch.tanh(logits / softcap) * softcap
        mc = mask[..., lo:hi, :] if rows else mask
        m = torch.broadcast_to(mc, (b, hi - lo, t))[:, None, None]
        w = torch.softmax(logits.masked_fill(~m, NEG), dim=-1).to(q.dtype)
        outs.append(torch.einsum("bgrst,btgd->bsgrd", w, vq))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return reshape(out, b, s, h, v.shape[-1])


def _sdpa_sharded(q, k, v, mask, softcap: float):
    """``sdpa`` of DTensors on each rank's own rows and heads: attention is
    independent a (row, head), so a mesh dim keeps a batch shard, or a
    head shard that the KV heads follow (KV divisible by its size), and
    gathers the rest; the local ``sdpa`` runs on the shards (DTensor's
    rules for its einsums fold a sharded batch into the heads, which
    older releases refuse)."""
    mesh = q.device_mesh
    kvh = k.shape[2]
    pl = []
    for i, pq in enumerate(q.placements):
        if isinstance(pq, Shard) and (pq.dim == 0 or (
                pq.dim == 2 and kvh % mesh.size(i) == 0)):
            pl.append(Shard(pq.dim))
        else:
            pl.append(Replicate())
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    if isinstance(mask, DTensor):
        mpl = [pp if pp == Shard(0) else Replicate() for pp in pl]
        mask = mask.redistribute(mesh, mpl).to_local()
    elif mask.dim() == 3 and mask.shape[0] > 1 and any(
            pp == Shard(0) for pp in pl):
        raise ValueError("a plain mask with a batch dim over sharded rows")
    out = sdpa(q.to_local(), k.to_local(), v.to_local(), mask, softcap)
    return DTensor.from_local(out, mesh, pl)


def _qkv(p, r: int, cfg: ModelConfig, x, positions):
    """Projected, qk-normed, roped q [B,S,H,D] and k/v [B,S,KV,D]."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = reshape(dense(x, p.wq[r]), b, s, cfg.num_heads, hd)
    k = reshape(dense(x, p.wk[r]), b, s, cfg.num_kv_heads, hd)
    v = reshape(dense(x, p.wv[r]), b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm[r])
        k = rms_norm(k, p.k_norm[r])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(p, r: int, cfg: ModelConfig, x, positions, *,
                    window: int = 0, past=None, k_positions=None):
    """Causal (``window > 0``: sliding-window) self-attention for prefill.
    Returns (out, (k, v)), the cache rows of ``x``'s own positions.

    ``past`` -- optional ``(past_k, past_v)`` [B, P, KV, D] of the
    positions before ``x`` (post-qk-norm, post-rope: the cache rows an
    earlier chunk returned): the queries attend ``past ++ own`` keys at
    ``k_positions`` [1, P + S], as the reference's ``attention_apply``.

    ``cfg.attention_impl == "pallas"`` routes the attention through
    ``ops.flash_attention(causal=True, window=window, q_offset=P)`` over
    the concatenated keys (the reference's docstring puts its flash
    kernel here); otherwise ``sdpa`` runs over ``causal_mask(positions,
    k_positions, window, cfg.prefix_len)``.  The kernel puts query i at
    position q_offset + i and key j at j, and has no soft-cap and no
    prefix-LM mask, so that route serves positions ``[1, S]`` = P +
    arange(S) over keys at arange(P + S) without ``cfg.softcap`` or
    ``cfg.prefix_len`` (``model.check_supported`` refuses both): what
    forward, prefill, prefill_batched and prefill_chunk pass.  It checks
    the shapes only (the values would need a host read)."""
    q, k, v = _qkv(p, r, cfg, x, positions)
    b, s = x.shape[:2]
    k_all, v_all = k, v
    if past is not None:
        k_all = torch.cat([past[0].to(k.dtype), k], dim=1)
        v_all = torch.cat([past[1].to(v.dtype), v], dim=1)
    k_pos = positions if k_positions is None else k_positions
    if cfg.attention_impl == "pallas":
        if cfg.softcap > 0:
            raise NotImplementedError(
                "the flash route has no soft-cap (cfg.softcap = "
                f"{cfg.softcap}); use attention_impl='reference'")
        t = k_all.shape[1]
        if tuple(positions.shape) != (1, s) or \
                tuple(k_pos.shape) != (1, t):
            raise ValueError(
                "the flash route takes positions [1, S] = start + "
                "arange(S) and key positions [1, start + S] = arange(start "
                f"+ S), start the past's length {t - s}, not "
                f"{tuple(positions.shape)} / {tuple(k_pos.shape)}")
        out = ops.flash_attention(q, k_all, v_all, causal=True,
                                  window=window, q_offset=t - s)
    else:
        out = sdpa(q, k_all, v_all, causal_mask(positions, k_pos, window,
                                                cfg.prefix_len), cfg.softcap)
    return dense(reshape(out, b, s, -1), p.wo[r]), (k, v)


def attention_decode(p, r: int, cfg: ModelConfig, x, cache_k, cache_v,
                     cache_pos, cur_pos, *, window: int = 0):
    """One-token decode.  x: [B,1,d]; cache_k/v: [B,T,KV,D]; cache_pos:
    [B,T] absolute positions (-1 == empty); cur_pos: [B]; ``window > 0``
    attends only positions > cur_pos - window (a ring cache).
    Returns (out, new_k_entry, new_v_entry)."""
    q, k_new, v_new = _qkv(p, r, cfg, x, cur_pos[:, None])
    k_all = torch.cat([cache_k, k_new], dim=1).to(x.dtype)
    v_all = torch.cat([cache_v, v_new], dim=1).to(x.dtype)
    pos_all = torch.cat([cache_pos, cur_pos[:, None]], dim=1)
    m = (pos_all <= cur_pos[:, None]) & (pos_all >= 0)
    if window > 0:
        m &= pos_all > (cur_pos[:, None] - window)
    out = sdpa(q, k_all, v_all, m[:, None, :], cfg.softcap)
    return reshape(out, x.shape[0], 1, -1) @ p.wo[r], k_new, v_new


def cross_attention(p, r: int, cfg: ModelConfig, x, cond):
    """Attention from ``x`` [B, S, d] to the conditioning ``cond`` [B, T,
    cond_dim] through the cross-attention leaves ``p`` (``wq`` [R, d,
    H*hd], ``wk``/``wv`` [R, cond_dim, KV*hd], ``wo``; qk-norm as
    self-attention's): no rotary and every key visible, as the reference's
    ``attention_apply(..., use_rope=False)`` with an all-true mask.  One
    function for a sequence and a decode step (S = 1).  Returns [B, S,
    d]."""
    b, s, _ = x.shape
    t, hd = cond.shape[1], cfg.head_dim
    q = reshape(dense(x, p.wq[r]), b, s, cfg.num_heads, hd)
    k = reshape(dense(cond, p.wk[r]), b, t, cfg.num_kv_heads, hd)
    v = reshape(dense(cond, p.wv[r]), b, t, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm[r])
        k = rms_norm(k, p.k_norm[r])
    mask = torch.ones((1, s, t), dtype=torch.bool, device=x.device)
    out = sdpa(q, k, v, mask, cfg.softcap)
    return dense(reshape(out, b, s, -1), p.wo[r])


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 Multi-head Latent Attention)
# ---------------------------------------------------------------------------


def mla_scale(cfg: ModelConfig) -> float:
    """1/sqrt(qk_nope + qk_rope): the uncompressed head dim's scale, which
    the compressed shapes do not show."""
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)


def _mla_q(p, r: int, cfg: ModelConfig, x, positions):
    """(q_nope [B,S,H,nope], roped q_rope [B,S,H,rope])."""
    m = cfg.mla
    b, s, _ = x.shape
    cq = rms_norm(dense(x, p.w_dq[r]), p.q_norm[r])
    q = reshape(dense(cq, p.w_uq[r]), b, s, cfg.num_heads, -1)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_kv(p, r: int, cfg: ModelConfig, x, positions):
    """The compressed cache rows of ``x``: (c_kv [B,S,kv_lora], roped
    k_rope [B,S,rope], shared across heads)."""
    c_kv = rms_norm(dense(x, p.w_dkv[r]), p.kv_norm[r])
    k_rope = rope(dense(x, p.w_kr[r])[:, :, None, :], positions,
                  cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def mla_apply(p, r: int, cfg: ModelConfig, x, positions, mask, *,
              past=None):
    """Training/prefill MLA: materialise per-head K/V (K = k_nope ++
    k_rope, width nope + rope; V width v_head).  Returns (out,
    (c_kv, k_rope)) -- the compressed cache entries of ``x``'s own
    positions.  ``past`` -- optional ``(past_ckv, past_krope)`` [B, P,
    kv_lora] / [B, P, rope], an earlier chunk's compressed rows: the
    queries attend ``past ++ own`` (``mask`` [.., S, P + S]), as the
    reference's ``mla_apply``."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = _mla_q(p, r, cfg, x, positions)
    c_kv, k_rope = _mla_kv(p, r, cfg, x, positions)
    c_all, kr_all = c_kv, k_rope
    if past is not None:
        c_all = torch.cat([past[0].to(c_kv.dtype), c_kv], dim=1)
        kr_all = torch.cat([past[1].to(c_kv.dtype), k_rope], dim=1)
    t = c_all.shape[1]
    k_nope = torch.einsum("bsr,rhk->bshk", c_all, p.w_uk[r])
    v = torch.einsum("bsr,rhk->bshk", c_all, p.w_uv[r])
    k = torch.cat([k_nope, kr_all[:, :, None, :].expand(
        b, t, h, m.qk_rope_dim)], dim=-1)
    out = sdpa(torch.cat([q_nope, q_rope], dim=-1), k, v, mask, cfg.softcap)
    return dense(reshape(out, b, s, -1), p.wo[r]), (c_kv, k_rope)


def mla_decode(p, r: int, cfg: ModelConfig, x, cache_ckv, cache_krope,
               cache_pos, cur_pos):
    """Absorbed-matrix MLA decode over the compressed cache.  x: [B,1,d];
    cache_ckv: [B,T,kv_lora]; cache_krope: [B,T,rope]; cache_pos: [B,T]
    (-1 == empty); cur_pos: [B].  Returns (out, c_new, kr_new).

    The logits are multiplied by the precomputed ``mla_scale`` (not
    divided by a square root), as the reference, so this dense path and
    the paged kernel, which takes ``scale`` as an operand, agree."""
    b = x.shape[0]
    q_nope, q_rope = _mla_q(p, r, cfg, x, cur_pos[:, None])
    c_new, kr_new = _mla_kv(p, r, cfg, x, cur_pos[:, None])
    ckv = torch.cat([cache_ckv, c_new], dim=1).to(x.dtype)
    krope = torch.cat([cache_krope, kr_new], dim=1).to(x.dtype)
    pos_all = torch.cat([cache_pos, cur_pos[:, None]], dim=1)
    # absorb W_uk into q: q_abs[b,h,r] = sum_k q_nope[b,h,k] W_uk[r,h,k]
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p.w_uk[r])
    logits = (torch.einsum("bshr,btr->bhst", q_abs, ckv)
              + torch.einsum("bshk,btk->bhst", q_rope, krope))
    logits = logits.float() * mla_scale(cfg)
    mask = (pos_all <= cur_pos[:, None]) & (pos_all >= 0)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, NEG))
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhst,btr->bshr", w, ckv)
    out = torch.einsum("bshr,rhk->bshk", ctx, p.w_uv[r])
    return reshape(out, b, 1, -1) @ p.wo[r], c_new, kr_new


def embed(tok_table, cfg: ModelConfig, tokens):
    """Token embeddings, rounded through ``cfg.dtype`` and scaled by
    sqrt(d_model).  The reference multiplies by a strong float64 scalar,
    which promotes the result to float32 (``layers.py:366-380``,
    ``RESID_WEAK_SCALE = False``): the port keeps that float32 residual
    stream.  Without gradients rows are gathered before the cast, so the
    full table is never converted; when the table takes gradients it is
    cast first and then gathered, as the reference, so the backward sums a
    token's rows in ``cfg.dtype`` as the reference's does (the same
    forward values either way).  A sharded DTensor table or batch (the
    mesh step) takes ``F.embedding`` of the cast table, whose DTensor
    rules sum each shard's rows and reduce them: an indexed read's
    backward has no rule for sharded indices in every release."""
    dt = getattr(torch, cfg.dtype)
    if _sharded(tok_table) or _sharded(tokens):
        e = torch.nn.functional.embedding(tokens, tok_table.to(dt))
    elif torch.is_grad_enabled() and tok_table.requires_grad:
        e = tok_table.to(dt)[tokens]
    else:
        e = tok_table[tokens].to(dt)
    return e.float() * math.sqrt(cfg.d_model)


def _sharded(t) -> bool:
    return isinstance(t, DTensor) and any(isinstance(q, Shard)
                                          for q in t.placements)


def unembed(params, cfg: ModelConfig, x):
    w = params.tok.T if cfg.tie_embeddings else params.unembed
    return dense(x, w)
