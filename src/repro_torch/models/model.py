"""Model assembly for attention-only segments: init, forward, prefill,
dense decode and the fully-paged decode path (the counterpart of
``repro/models/model.py``).

Parameters live in a ``Transformer`` module whose layout mirrors the
reference's parameter tree: each segment holds one ``Slot`` per pattern
entry, its leaves stacked ``[R, ...]`` over the segment's repeats, and
execution runs the whole pattern once per repeat (slots inner, repeats
outer).  The reference traces ``lax.scan`` over repeats; PyTorch runs the
same order as a Python loop over per-repeat views.

The paged decode path updates the shared page pools in place
(``index_put_``) where the reference returned a new, donated pytree.

Only plain causal-attention layers with a SwiGLU MLP are ported here;
configs that need another layer kind raise ``NotImplementedError`` naming
the later slice (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, parse_kind

__all__ = ["Slot", "Transformer", "init", "forward", "prefill", "pad_cache",
           "init_cache", "decode_step", "prefill_batched", "state_slot_meta",
           "slot_leaf_specs", "decode_step_paged", "decode_macro_step",
           "sample"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for anything beyond plain causal
    attention + SwiGLU, naming the slice of the port that brings it."""
    later = []
    for kind in {parse_kind(s) for pat, _ in cfg.segments for s in pat}:
        if kind.base == "local":
            later.append("sliding-window/ring attention (Queue 1 item 8.1)")
        elif kind.base != "attn":
            later.append(f"recurrent {kind.base} cells (Queue 1 item 8.3)")
        if kind.mla or kind.moe:
            later.append("MLA and MoE (Queue 1 item 8.2)")
        if kind.xattn:
            later.append("cross-attention conditioning (Queue 1 item 8.4)")
    if cfg.prefix_len:
        later.append("shared prefix pages (Queue 1 item 8.5)")
    if cfg.mlp_kind != "swiglu" or not cfg.d_ff:
        later.append(f"the {cfg.mlp_kind} MLP (Queue 1 item 8.6)")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: the torch port does not serve "
            f"{'; '.join(sorted(set(later)))} yet")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class Slot(nn.Module):
    """One attention + SwiGLU pattern slot, every leaf stacked over the
    segment's ``repeats``: norms [R, d], projections [R, d, H*hd] /
    [R, H*hd, d], MLP [R, d, ff] / [R, ff, d]."""

    def __init__(self, cfg: ModelConfig, repeats: int, device):
        super().__init__()
        d, h, kv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim, cfg.d_ff)

        def leaf(*shape):
            return nn.Parameter(torch.empty((repeats,) + shape,
                                            device=device),
                                requires_grad=False)

        self.norm1 = leaf(d)
        self.wq, self.wk, self.wv = leaf(d, h * hd), leaf(d, kv * hd), \
            leaf(d, kv * hd)
        self.wo = leaf(h * hd, d)
        if cfg.qk_norm:
            self.q_norm, self.k_norm = leaf(hd), leaf(hd)
        self.norm2 = leaf(d)
        self.wi_gate, self.wi_up, self.w_down = leaf(d, ff), leaf(d, ff), \
            leaf(ff, d)


class Transformer(nn.Module):
    """The parameter tree: token table ``tok`` [V, d], ``unembed`` [d, V]
    (untied configs), ``final_norm`` [d] and ``segments[si][j]`` slots."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        check_supported(cfg)
        leaf = lambda *s: nn.Parameter(torch.empty(s, device=device),
                                       requires_grad=False)
        self.tok = leaf(cfg.vocab_size, cfg.d_model)
        if not cfg.tie_embeddings:
            self.unembed = leaf(cfg.d_model, cfg.vocab_size)
        self.final_norm = leaf(cfg.d_model)
        self.segments = nn.ModuleList(
            nn.ModuleList(Slot(cfg, repeats, device) for _ in pattern)
            for pattern, repeats in cfg.segments)


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> Transformer:
    """Random float32 weights from a seeded ``torch.Generator`` on the
    target device, at the reference's init scales (``layers._dense_init``:
    N(0, 1/fan_in); the token table N(0, 1/d); norms one).  The values
    differ from the JAX init -- ``bridge.from_reference`` carries the
    reference's own weights over when a test needs them."""
    dev = resolve_device(device)
    params = Transformer(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    d = cfg.d_model
    with torch.no_grad():
        L.dense_init(params.tok, g, d, scale=1.0 / math.sqrt(d))
        if not cfg.tie_embeddings:
            L.dense_init(params.unembed, g, d)
        params.final_norm.fill_(1.0)
        for seg in params.segments:
            for slot in seg:
                for name in ("wq", "wk", "wv", "wi_gate", "wi_up"):
                    L.dense_init(getattr(slot, name), g, d)
                L.dense_init(slot.wo, g, cfg.num_heads * cfg.head_dim)
                L.dense_init(slot.w_down, g, cfg.d_ff)
                for name in ("norm1", "norm2", "q_norm", "k_norm"):
                    if hasattr(slot, name):
                        getattr(slot, name).fill_(1.0)
    return params


def _layers(params: Transformer, cfg: ModelConfig):
    """(slot index li, repeat r, slot) in execution order: per segment,
    the whole pattern once per repeat.  ``li`` indexes
    ``state_slot_meta`` (and so the pools' layered leaves)."""
    li = 0
    for si, (pattern, repeats) in enumerate(cfg.segments):
        for r in range(repeats):
            for j in range(len(pattern)):
                yield li + j, r, params.segments[si][j]
        li += len(pattern)


def _block_tail(slot, r: int, x):
    return x + L.mlp_apply(slot, r, L.rms_norm(x, slot.norm2[r]))


# ---------------------------------------------------------------------------
# sequence mode: forward / prefill
# ---------------------------------------------------------------------------


def _run_seq(params, cfg: ModelConfig, x, positions):
    """All layers over a sequence; returns (x, per-slot lists of (k, v)
    in repeat order)."""
    mask = L.causal_mask(positions, positions)
    entries: List[List] = [[] for _ in state_slot_meta(cfg)]
    for li, r, slot in _layers(params, cfg):
        out, kv = L.attention_apply(slot, r, cfg,
                                    L.rms_norm(x, slot.norm1[r]),
                                    positions, mask)
        x = _block_tail(slot, r, x + out)
        entries[li].append(kv)
    return x, entries


def _stack_cache(cfg: ModelConfig, entries, pos):
    """Cache tree {"segments": [[{"k", "v": [R,B,T,KV,D], "pos": [R,B,T]}]]}
    from per-slot entry lists."""
    segs, li = [], 0
    for pattern, repeats in cfg.segments:
        slots = []
        for _ in pattern:
            ks, vs = zip(*entries[li])
            slots.append({"k": torch.stack(ks), "v": torch.stack(vs),
                          "pos": pos.expand(repeats, *pos.shape).clone()})
            li += 1
        segs.append(slots)
    return {"segments": segs}


def forward(params, cfg: ModelConfig, tokens):
    """Training-style forward.  tokens: [B, S].  Returns (logits [B,S,V],
    aux_loss) -- aux is 0 (no MoE in this slice)."""
    x = L.embed(params.tok, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    x, _ = _run_seq(params, cfg, x, positions)
    x = L.rms_norm(x, params.final_norm)
    return L.unembed(params, cfg, x), torch.zeros((), device=x.device)


def prefill(params, cfg: ModelConfig, tokens):
    """Forward pass that also returns the populated cache.
    Returns (last_logits [B,1,V], cache)."""
    x = L.embed(params.tok, cfg, tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None]
    x, entries = _run_seq(params, cfg, x, positions)
    x = L.rms_norm(x, params.final_norm)
    logits = L.unembed(params, cfg, x[:, -1:])
    pos = positions.expand(b, s).to(torch.int64)
    return logits, _stack_cache(cfg, entries, pos)


def pad_cache(cache, cfg: ModelConfig, max_len: int):
    """Pad prefill-produced caches out to ``max_len`` positions (pos -1 ==
    empty)."""
    segs = []
    for seg in cache["segments"]:
        slots = []
        for c in seg:
            pad = max_len - c["pos"].shape[2]
            if pad > 0:
                c = {name: torch.nn.functional.pad(
                        a, (0, 0) * (a.dim() - 3) + (0, pad),
                        value=-1 if name == "pos" else 0)
                     for name, a in c.items()}
            slots.append(c)
        segs.append(slots)
    return {"segments": segs}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.float32, device=None):
    """Empty dense decode cache mirroring the segment structure."""
    dev = resolve_device(device)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {"segments": [[{
        "k": torch.zeros((r, batch, max_len, kv, hd), dtype=dtype,
                         device=dev),
        "v": torch.zeros((r, batch, max_len, kv, hd), dtype=dtype,
                         device=dev),
        "pos": torch.full((r, batch, max_len), -1, dtype=torch.int64,
                          device=dev)} for _ in pat]
        for pat, r in cfg.segments]}


def decode_step(params, cfg: ModelConfig, cache, tokens, cur_pos):
    """One dense decode step.  tokens: [B,1]; cur_pos: [B] (current
    length).  Writes the new entries into ``cache`` in place (slot
    ``min(cur_pos, T-1)``) and returns (logits [B,1,V], cache)."""
    x = L.embed(params.tok, cfg, tokens)
    rows = torch.arange(x.shape[0], device=x.device)
    for li, r, slot in _layers(params, cfg):
        c = _slot_cache(cache, cfg, li)
        k, v, pos = c["k"][r], c["v"][r], c["pos"][r]
        out, k_new, v_new = L.attention_decode(
            slot, r, cfg, L.rms_norm(x, slot.norm1[r]), k, v, pos, cur_pos)
        wslot = cur_pos.clamp_max(k.shape[1] - 1)
        k[rows, wslot] = k_new[:, 0].to(k.dtype)
        v[rows, wslot] = v_new[:, 0].to(v.dtype)
        pos[rows, wslot] = cur_pos.to(pos.dtype)
        x = _block_tail(slot, r, x + out)
    x = L.rms_norm(x, params.final_norm)
    return L.unembed(params, cfg, x), cache


def _slot_cache(cache, cfg: ModelConfig, li: int):
    for si, (pattern, _) in enumerate(cfg.segments):
        if li < len(pattern):
            return cache["segments"][si][li]
        li -= len(pattern)
    raise IndexError(li)


def prefill_batched(params, cfg: ModelConfig, tokens, lengths):
    """Batched-admission prefill: one packed forward over right-padded
    prompts.  tokens: [B, Smax]; lengths: [B] true row lengths.
    Returns (last_logits [B,1,V], cache) where ``last_logits[b]`` is taken
    at position ``lengths[b] - 1`` and the cache keeps the full padded
    timeline with ``pos`` -1 beyond each row's length.  Causality makes
    each row's valid prefix independent of its padding."""
    x = L.embed(params.tok, cfg, tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None]
    x, entries = _run_seq(params, cfg, x, positions)
    x = L.rms_norm(x, params.final_norm)
    ln = torch.as_tensor(lengths, device=x.device).long()
    last = x[torch.arange(b, device=x.device), ln - 1][:, None]
    logits = L.unembed(params, cfg, last)
    pos = torch.where(positions < ln[:, None], positions,
                      torch.full_like(positions, -1))
    return logits, _stack_cache(cfg, entries, pos)


# ---------------------------------------------------------------------------
# fully-paged decode over the shared page pools
# ---------------------------------------------------------------------------


def state_slot_meta(cfg: ModelConfig):
    """Every state-bearing slot in execution order: (si, j, repeats,
    window, kind).  The shared pools keep one leaf set per entry."""
    out = []
    for si, (pattern, repeats) in enumerate(cfg.segments):
        for j, kind_s in enumerate(pattern):
            kind = parse_kind(kind_s)
            window = cfg.window_size if kind.base == "local" else 0
            out.append((si, j, repeats, window, kind))
    return out


def slot_leaf_specs(cfg: ModelConfig, page_size: int):
    """Leaf specs for ``SharedPagedPools.attach_layered``: one
    ``(repeats, {"k": (page, KV, D), "v": ...})`` entry per slot."""
    check_supported(cfg)
    trail = (page_size, cfg.num_kv_heads, cfg.head_dim)
    return [(repeats, {"k": trail, "v": trail})
            for (_, _, repeats, _, _) in state_slot_meta(cfg)]


def decode_step_paged(params, cfg: ModelConfig, kv, tables, gid_tables,
                      tokens, cur_pos, *, page_size: int):
    """One decode step with every attention layer reading and writing the
    shared page pools (no dense cache exists).

    kv:         the pools' layered leaves (``SharedPagedPools.kv_layers``):
                ``{"k_hbm"|"v_hbm": [per slot [R, hbm_pages, page, KV, D]],
                "k_host"|"v_host": [per slot [R, n_logical, ...]]}``,
                updated in place.
    tables:     int32[B, n] HBM slot per row page (-1 = padding/inactive).
    gid_tables: int32[B, n] logical page id per row page (-1 = padding).
    tokens: [B, 1]; cur_pos: [B] position being decoded (-1 = inactive).

    Returns (logits [B,1,V], page_mass f32[B, n]): the head-normalised
    attention mass per row page, averaged over every attention layer and
    zero for inactive rows."""
    return _paged_decode_core(params, cfg, kv, tables, gid_tables, tokens,
                              cur_pos, page_size=page_size)


def _paged_decode_core(params, cfg: ModelConfig, kv, tables, gid_tables,
                       tokens, cur_pos, *, page_size: int):
    b = tokens.shape[0]
    dev = tokens.device
    rows = torch.arange(b, device=dev)
    active = cur_pos >= 0
    lengths = torch.where(active, cur_pos + 1, 0).to(torch.int32)
    safe_pos = cur_pos.clamp_min(0)
    pg, off = safe_pos // page_size, safe_pos % page_size
    wslot = tables[rows, pg].long()
    wgid = gid_tables[rows, pg].long()
    # the reference's drop-mode scatter (`.at[...].set(mode="drop")` with
    # an out-of-range sentinel) as an explicit mask: only active rows
    # whose write page is mapped write, on each tier
    hbm_rows = torch.nonzero(active & (wslot >= 0)).squeeze(1)
    host_rows = torch.nonzero(active & (wgid >= 0)).squeeze(1)
    hbm_at = (wslot[hbm_rows], off[hbm_rows])
    host_at = (wgid[host_rows], off[host_rows])

    x = L.embed(params.tok, cfg, tokens)
    mass_sum = torch.zeros((b, tables.shape[1]), dtype=torch.float32,
                           device=dev)
    n_layers = 0
    for li, r, slot in _layers(params, cfg):
        kh, vh = kv["k_hbm"][li][r], kv["v_hbm"][li][r]
        khost, vhost = kv["k_host"][li][r], kv["v_host"][li][r]
        q, k_new, v_new = L._qkv(slot, r, cfg, L.rms_norm(x, slot.norm1[r]),
                                 cur_pos[:, None])
        # write-through: the decoding token's KV lands in its HBM slot page
        # AND the host backing page before the gather, so the kernel
        # attends the current token too
        k1, v1 = k_new[:, 0].to(kh.dtype), v_new[:, 0].to(vh.dtype)
        kh.index_put_(hbm_at, k1[hbm_rows])
        vh.index_put_(hbm_at, v1[hbm_rows])
        khost.index_put_(host_at, k1[host_rows])
        vhost.index_put_(host_at, v1[host_rows])
        ctx, mass = ops.paged_attention(q[:, 0].contiguous(), kh, vh, tables,
                                        lengths, softcap=cfg.softcap,
                                        return_mass=True)
        x = _block_tail(slot, r, x + ctx.reshape(b, 1, -1) @ slot.wo[r])
        mass_sum += mass
        n_layers += 1
    logits = L.unembed(params, cfg, L.rms_norm(x, params.final_norm))
    page_mass = torch.where(active[:, None], mass_sum / max(1, n_layers),
                            torch.zeros_like(mass_sum))
    return logits, page_mass


def _uniform(seed: int, it: int) -> float:
    """The uniform draw of a sampled token: a CPU ``torch.Generator``
    seeded from (request seed, iteration), so ``generate``, the per-token
    paged path and the macro path draw the same number for the same
    token.  (JAX's threefry ``fold_in`` schedule cannot be reproduced in
    torch; sampled streams match the port's own paths, greedy streams
    match the reference.)"""
    g = torch.Generator().manual_seed(((int(seed) & 0xFFFFFFFF) << 32)
                                      | (int(it) & 0xFFFFFFFF))
    return float(torch.rand((), generator=g))


def sample(logits, temps: Sequence[float], seeds: Sequence[int],
           iters: Sequence[int]):
    """Next token per row of ``logits`` [B, V]: argmax where the row's
    temperature is 0, otherwise an inverse-CDF draw from
    softmax(logits / temperature) at the row's ``_uniform(seed, iter)``.
    Returns int64 [B] on the logits' device."""
    greedy = logits.argmax(dim=-1)
    if not any(t > 0 for t in temps):
        return greedy
    dev = logits.device
    t = torch.tensor([t if t > 0 else 1.0 for t in temps],
                     dtype=torch.float32, device=dev)
    u = torch.tensor([_uniform(s, i) if tt > 0 else 0.0
                      for s, i, tt in zip(seeds, iters, temps)],
                     dtype=torch.float32, device=dev)
    cdf = torch.softmax(logits.float() / t[:, None], dim=-1).cumsum(dim=-1)
    drawn = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None]).squeeze(1)
    drawn = drawn.clamp_max(logits.shape[-1] - 1)
    hot = torch.tensor([tt > 0 for tt in temps], device=dev)
    return torch.where(hot, drawn, greedy)


def decode_macro_step(params, cfg: ModelConfig, kv, tables, gid_tables,
                      tokens, cur_pos, seeds, iters, emitted, max_new,
                      eos_ids, temps, *, n_steps: int, page_size: int):
    """Up to ``n_steps`` fully-paged decode steps for the whole request
    set, with on-device sampling, mass accumulation and EOS / length
    masking, so the host hands over page tables once per movement period
    and reads back (tokens, summed mass, finished flags) once.

    The reference runs this as one ``lax.scan`` whose ``lax.cond`` skips
    the model once every row is done; here it is a Python loop over the
    eager decode core that reads back one alive mask per step (the
    any-row-alive check, and each sampled row's iteration number).

    tokens int64[B,1] / cur_pos int64[B] on the device (cur_pos -1 = no
    request in the row); per-row host sequences: ``seeds`` (request seed),
    ``iters`` (decode iterations done), ``emitted`` (tokens emitted so
    far incl. the prefill sample), ``max_new`` (token budget), ``eos_ids``
    (-1 = none), ``temps``.

    A row is alive while ``cur_pos >= 0`` and no stop condition has
    fired; dead rows freeze (no KV writes, no mass, no emission), so the
    stream matches the per-token path, which retires on the host before
    the next launch.  Returns (tokens_out int64[n_steps, B] (-1 = row not
    alive), state) with state = {mass_sum f32[B, n], alive_steps int64[B],
    pos, iters (host list), emitted, stopped bool[B], last_tok [B,1]}.
    """
    b = tokens.shape[0]
    dev = tokens.device
    as_dev = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    max_new, eos_ids = as_dev(max_new), as_dev(eos_ids)
    em = as_dev(emitted)
    tok, pos = tokens.clone(), cur_pos.clone()
    it = [int(i) for i in iters]
    # a row may enter with its stop condition already met (the incoming
    # token hits EOS or the budget): it freezes before its first step
    stopped = (pos >= 0) & ((em >= max_new)
                            | ((eos_ids >= 0) & (tok[:, 0] == eos_ids)))
    mass_sum = torch.zeros((b, tables.shape[1]), dtype=torch.float32,
                           device=dev)
    alive_steps = torch.zeros((b,), dtype=torch.int64, device=dev)
    toks_out = torch.full((n_steps, b), -1, dtype=torch.int64, device=dev)
    for s in range(n_steps):
        alive = (pos >= 0) & ~stopped
        alive_h = alive.tolist()
        if not any(alive_h):
            break                      # every row done: skip the model
        cur = torch.where(alive, pos, torch.full_like(pos, -1))
        logits, mass = _paged_decode_core(params, cfg, kv, tables,
                                          gid_tables, tok, cur,
                                          page_size=page_size)
        mass_sum += mass               # the core zeroes dead rows
        alive_steps += alive
        new_tok = sample(logits[:, 0], temps, seeds,
                         [i + 1 for i in it])
        it = [i + 1 if a else i for i, a in zip(it, alive_h)]
        em = torch.where(alive, em + 1, em)
        tok = torch.where(alive[:, None], new_tok[:, None], tok)
        stopped |= alive & ((em >= max_new)
                            | ((eos_ids >= 0) & (tok[:, 0] == eos_ids)))
        pos = torch.where(alive, pos + 1, pos)
        toks_out[s] = torch.where(alive, tok[:, 0],
                                  torch.full_like(tok[:, 0], -1))
    state = {"mass_sum": mass_sum, "alive_steps": alive_steps, "pos": pos,
             "iters": it, "emitted": em, "stopped": stopped,
             "last_tok": tok}
    return toks_out, state
