"""Model assembly: init, forward, prefill, dense decode and the
fully-paged decode path (the counterpart of ``repro/models/model.py``).

Parameters live in a ``Transformer`` module whose layout mirrors the
reference's parameter tree: each segment holds one ``Slot`` per pattern
entry, its leaves stacked ``[R, ...]`` over the segment's repeats, and
execution runs the whole pattern once per repeat (slots inner, repeats
outer).  The reference traces ``lax.scan`` over repeats; PyTorch runs the
same order as a Python loop over per-repeat views.

The paged decode path updates the shared page pools in place
(``index_put_``) where the reference returned a new, donated pytree; the
rows that must not write go to each leaf's sink page, where the
reference dropped out-of-range indices.  Its step body (``decode_body``
over a ``MacroCarry``) reads nothing back to the host, so a CUDA graph
can capture it (``models.graphs``); ``decode_macro_step`` runs it from
Python (the eager route).

Ported layer kinds: causal GQA attention and sliding-window ``local``
attention (k/v cache rows; a local slot's dense cache is a ring of
``min(window, max_len)`` rows, its pages hold the whole timeline and the
paged kernel masks to the window), MLA (compressed ckv/krope rows) and
the recurrent cells mLSTM, sLSTM and RG-LRU (``models.recurrent``; one
packed state page per request, ``pack_state``), each optionally followed
by cross-attention to a conditioning sequence (``.xattn`` slots: every
entry point takes ``cond`` [B, T, cond_dim]; it is not paged, so it adds
nothing to the page mass), then a SwiGLU, GELU or squared-ReLU MLP, a
routed MoE (``models.moe``) or, with ``d_ff == 0`` and no MoE, nothing.
With ``cfg.attention_impl == "pallas"`` the sequence passes (forward,
prefill, prefill_batched, prefill_chunk) run self-attention through the
flash kernel (a chunk with its start as the kernel's query offset).
A ``prefix_len`` config (PaliGemma) takes its prefix embeddings as
``extra_embeds`` [B, P, d] at the sequence passes, prepended unscaled to
the token embeddings and attended bidirectionally (``causal_mask``); the
decode paths see it only as cache rows or pages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import resolve_device
from repro_torch.distributed.compat import DTensor
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models.config import LayerKind, ModelConfig, parse_kind
from repro_torch.models.moe import MoE, moe_apply

__all__ = ["Slot", "CrossAttention", "Transformer", "init", "forward",
           "param_specs", "param_ref_shapes", "init_specs_only",
           "cache_specs",
           "prefill", "pad_cache", "init_cache", "decode_step",
           "prefill_batched", "prefill_chunk", "chunk_past_extend",
           "row_cache_from_batched",
           "batched_prefill_supported", "state_slot_meta", "attn_slot_meta",
           "attn_slot_index", "state_dim", "pack_state", "unpack_state",
           "has_state_pages", "has_attention", "slot_leaf_specs",
           "slot_leaf_names", "decode_step_paged", "decode_macro_step",
           "decode_body", "MacroCarry", "macro_state",
           "sample", "uniform"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a shared prefix (``prefix_len``)
    beside recurrent cells (its pages cannot seed a cell's state, and no
    registered config has both; the reference batcher refuses it too) and
    for what the flash kernel cannot take under ``attention_impl ==
    "pallas"`` (checked only for configs with attention slots: the
    setting routes nothing in the others)."""
    kinds = {parse_kind(s) for pat, _ in cfg.segments for s in pat}
    if cfg.prefix_len and any(k.is_recurrent for k in kinds):
        raise NotImplementedError(
            f"{cfg.name}: a shared prefix cannot seed recurrent state")
    if cfg.attention_impl not in ("reference", "pallas"):
        raise ValueError(f"attention_impl is 'reference' or 'pallas', not "
                         f"{cfg.attention_impl!r}")
    if cfg.attention_impl == "pallas" and any(k.is_attention for k in kinds):
        # the flash kernel takes one head dim for q, k and v and no
        # soft-cap, as the TPU kernel
        if any(k.mla for k in kinds):
            raise NotImplementedError(
                f"{cfg.name}: attention_impl='pallas' cannot take MLA "
                "slots (the flash kernel needs d_qk == d_v)")
        if cfg.softcap > 0:
            raise NotImplementedError(
                f"{cfg.name}: attention_impl='pallas' cannot take "
                "softcap > 0 (the flash kernel has no soft-capping)")
        if cfg.prefix_len:
            raise NotImplementedError(
                f"{cfg.name}: attention_impl='pallas' cannot take a "
                f"prefix (prefix_len {cfg.prefix_len}: the flash kernel has "
                "no prefix-LM mask)")
        if cfg.head_dim not in HEAD_DIMS:
            raise NotImplementedError(
                f"{cfg.name}: attention_impl='pallas' cannot take head dim "
                f"{cfg.head_dim} (the flash kernel takes HEAD_DIMS "
                f"{HEAD_DIMS})")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


#: a stacked leaf's leading logical axis (the repeats)
_L = ("layers",)
#: the residual stream's logical axes (the ``shard`` points)
_RESID = ("batch", "seq", "embed")


def _stacked(repeats: int, device):
    """A maker of uninitialised, frozen leaves stacked over ``repeats``."""
    def leaf(*shape):
        return nn.Parameter(torch.empty((repeats,) + shape, device=device),
                            requires_grad=False)
    return leaf


class Slot(nn.Module):
    """One pattern slot, every leaf stacked over the segment's
    ``repeats``: ``norm1`` [R, d], then the attention leaves of its
    ``kind`` -- GQA ``wq`` [R, d, H*hd], ``wk``/``wv`` [R, d, KV*hd],
    ``wo`` [R, H*hd, d] (+ ``q_norm``/``k_norm`` [R, hd] with qk-norm), or
    MLA ``w_dq`` [R, d, q_lora], ``q_norm`` [R, q_lora], ``w_uq``
    [R, q_lora, H*(nope+rope)], ``w_dkv`` [R, d, kv_lora], ``kv_norm``
    [R, kv_lora], ``w_kr`` [R, d, rope], ``w_uk`` [R, kv_lora, H, nope],
    ``w_uv`` [R, kv_lora, H, v_head], ``wo`` [R, H*v_head, d] -- or a
    recurrent ``cell`` (``recurrent.Cell``); for an ``.xattn`` kind
    ``norm_x`` [R, d] and the cross-attention leaves ``xattn``
    (``CrossAttention``); then ``norm2`` and either the MoE (``moe``) or
    the MLP: SwiGLU ``wi_gate``/``wi_up`` [R, d, ff], or GELU / squared
    ReLU ``wi`` [R, d, ff], and ``w_down`` [R, ff, d] -- neither, and no
    ``norm2``, with ``d_ff == 0`` and no MoE (the reference's
    ``_slot_init``).

    ``fan_in`` maps each random leaf to the fan-in the reference's
    ``_dense_init`` gives it: ``shape[0]`` of the unstacked reference
    leaf, whatever its rank (``wo [H, hd, d]`` has fan-in H).  ``axes``
    gives each leaf's logical axes, the reference's spec tree, and
    ``ref_shape`` a fused leaf's unfused per-repeat shape (``wq`` [d, H,
    hd]): the axes describe that shape (``distributed.sharding.fold``)."""

    def __init__(self, cfg: ModelConfig, kind: LayerKind, repeats: int,
                 device):
        super().__init__()
        self.kind = kind
        d, h, kv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim, cfg.d_ff)
        leaf = _stacked(repeats, device)
        self.norm1 = leaf(d)
        self.fan_in = {}
        self.axes = {"norm1": _L + ("embed",)}
        self.ref_shape = {}
        if kind.is_recurrent:
            self.cell = R.Cell(cfg, kind, repeats, device)
        elif kind.mla:
            m = cfg.mla
            self.w_dq, self.q_norm = leaf(d, m.q_lora_rank), \
                leaf(m.q_lora_rank)
            self.w_uq = leaf(m.q_lora_rank,
                             h * (m.qk_nope_dim + m.qk_rope_dim))
            self.w_dkv, self.kv_norm = leaf(d, m.kv_lora_rank), \
                leaf(m.kv_lora_rank)
            self.w_kr = leaf(d, m.qk_rope_dim)
            self.w_uk = leaf(m.kv_lora_rank, h, m.qk_nope_dim)
            self.w_uv = leaf(m.kv_lora_rank, h, m.v_head_dim)
            self.wo = leaf(h * m.v_head_dim, d)
            self.fan_in.update(w_dq=d, w_uq=m.q_lora_rank, w_dkv=d,
                               w_kr=d, w_uk=m.kv_lora_rank,
                               w_uv=m.kv_lora_rank, wo=h)
            self.axes.update(
                w_dq=_L + ("embed", "q_lora"), q_norm=_L + ("q_lora",),
                w_uq=_L + ("q_lora", "heads", "head_dim"),
                w_dkv=_L + ("embed", "kv_lora"), kv_norm=_L + ("kv_lora",),
                w_kr=_L + ("embed", None),
                w_uk=_L + ("kv_lora", "heads", "head_dim"),
                w_uv=_L + ("kv_lora", "heads", "head_dim"),
                wo=_L + ("heads", "head_dim", "embed"))
            self.ref_shape.update(
                w_uq=(m.q_lora_rank, h, m.qk_nope_dim + m.qk_rope_dim),
                wo=(h, m.v_head_dim, d))
        else:
            self.wq, self.wk, self.wv = leaf(d, h * hd), leaf(d, kv * hd), \
                leaf(d, kv * hd)
            self.wo = leaf(h * hd, d)
            if cfg.qk_norm:
                self.q_norm, self.k_norm = leaf(hd), leaf(hd)
            self.fan_in.update(wq=d, wk=d, wv=d, wo=h)
            _attn_axes(self, cfg, d)
        if kind.xattn:
            self.norm_x = leaf(d)
            self.axes["norm_x"] = _L + ("embed",)
            self.xattn = CrossAttention(cfg, repeats, device)
        if kind.moe or ff > 0:
            self.axes["norm2"] = _L + ("embed",)
        if kind.moe:
            self.norm2 = leaf(d)
            self.moe = MoE(cfg, repeats, device)
        elif ff > 0:
            self.norm2 = leaf(d)
            if cfg.mlp_kind == "swiglu":
                self.wi_gate, self.wi_up = leaf(d, ff), leaf(d, ff)
                self.fan_in.update(wi_gate=d, wi_up=d)
                self.axes.update(wi_gate=_L + ("embed", "mlp"),
                                 wi_up=_L + ("embed", "mlp"))
            else:
                self.wi = leaf(d, ff)
                self.fan_in.update(wi=d)
                self.axes.update(wi=_L + ("embed", "mlp"))
            self.w_down = leaf(ff, d)
            self.fan_in.update(w_down=ff)
            self.axes.update(w_down=_L + ("mlp", "embed"))


def _attn_axes(mod, cfg: ModelConfig, rows: int) -> None:
    """The logical axes and unfused shapes of a GQA attention's leaves
    (self- or cross-attention; ``rows`` is ``wk``/``wv``'s input width):
    the reference's ``[d, H, hd]`` / ``[H, hd, d]``."""
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.head_dim)
    mod.axes.update(wq=_L + ("embed", "heads", "head_dim"),
                    wk=_L + ("embed", "kv_heads", "head_dim"),
                    wv=_L + ("embed", "kv_heads", "head_dim"),
                    wo=_L + ("heads", "head_dim", "embed"))
    mod.ref_shape.update(wq=(d, h, hd), wk=(rows, kv, hd), wv=(rows, kv, hd),
                         wo=(h, hd, d))
    if cfg.qk_norm:
        mod.axes.update(q_norm=_L + ("head_dim",), k_norm=_L + ("head_dim",))


class CrossAttention(nn.Module):
    """A slot's cross-attention leaves, stacked over ``repeats``: ``wq``
    [R, d, H*hd], ``wk``/``wv`` [R, cond_dim, KV*hd] (``cond_dim`` 0 means
    d_model), ``wo`` [R, H*hd, d], and ``q_norm``/``k_norm`` [R, hd] with
    qk-norm; ``fan_in`` as ``Slot``'s (the reference's
    ``attention_init(..., cross=True)``: ``wk``'s fan-in is cond_dim)."""

    def __init__(self, cfg: ModelConfig, repeats: int, device):
        super().__init__()
        d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim)
        cd = cfg.cond_dim or d
        leaf = _stacked(repeats, device)
        self.wq, self.wk, self.wv = leaf(d, h * hd), leaf(cd, kv * hd), \
            leaf(cd, kv * hd)
        self.wo = leaf(h * hd, d)
        if cfg.qk_norm:
            self.q_norm, self.k_norm = leaf(hd), leaf(hd)
        self.fan_in = dict(wq=d, wk=cd, wv=cd, wo=h)
        self.axes, self.ref_shape = {}, {}
        _attn_axes(self, cfg, cd)


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
        self.axes = {"tok": ("vocab", "embed"), "final_norm": ("embed",)}
        if not cfg.tie_embeddings:
            self.axes["unembed"] = ("embed", "vocab")
        self.segments = nn.ModuleList(
            nn.ModuleList(Slot(cfg, parse_kind(k), repeats, device)
                          for k in pattern)
            for pattern, repeats in cfg.segments)

    def forward(self, cfg: ModelConfig, tokens, **kw):
        """The module-level ``forward`` over these leaves, so that
        ``torch.func.functional_call`` can substitute them (the train
        step's ``cast_params``)."""
        return forward(self, cfg, tokens, **kw)


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> Transformer:
    """Random float32 weights from a seeded ``torch.Generator`` on the
    target device, at the reference's init scales (``layers._dense_init``:
    N(0, 1/fan_in) with each leaf's ``fan_in``; the token table N(0, 1/d);
    norms one; a recurrent cell's conv taps zero and its RG-LRU lambda
    from ``recurrent.rglru_lambda``).  The values differ from the JAX
    init --
    ``bridge.from_reference`` carries the reference's own weights over
    when a test needs them."""
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
                for mod in slot.modules():
                    fan = getattr(mod, "fan_in", {})
                    for name, t in mod.named_parameters(recurse=False):
                        if name in fan:
                            L.dense_init(t, g, fan[name])
                        elif name == "conv":
                            t.zero_()
                        elif name == "lam":
                            R.rglru_lambda(t, g)
                        else:            # norms
                            t.fill_(1.0)
    return params


def _leaf_table(params: Transformer, attr: str):
    """{parameter name: the owning module's ``attr`` entry} over every
    module that declares ``attr`` (``axes`` / ``ref_shape``)."""
    out = {}
    for prefix, mod in params.named_modules():
        table = getattr(mod, attr, None)
        if table is None:
            continue
        for name, value in table.items():
            out[f"{prefix}.{name}" if prefix else name] = value
    return out


def param_specs(params: Transformer):
    """{parameter name: logical axes} of ``params``' leaves (the reference's
    ``init`` spec tree; a fused leaf's axes describe its unfused shape,
    ``param_ref_shapes``)."""
    axes = _leaf_table(params, "axes")
    return {n: axes[n] for n, _ in params.named_parameters()}


def param_ref_shapes(params: Transformer):
    """{parameter name: the reference's shape of the leaf}: a fused
    projection's unfused ``[R, d, H, hd]``, every other leaf its own."""
    ref = _leaf_table(params, "ref_shape")
    return {n: ((t.shape[0],) + tuple(ref[n]) if n in ref
                else tuple(t.shape)) for n, t in params.named_parameters()}


def init_specs_only(cfg: ModelConfig):
    """{parameter name: logical axes} without allocating: the leaves of a
    ``Transformer`` on the meta device."""
    return param_specs(Transformer(cfg, torch.device("meta")))


def cache_specs(cfg: ModelConfig, shape_kind: str = "decode"):
    """Logical-axis spec tree matching ``init_cache``'s structure."""
    segs = []
    for pattern, _ in cfg.segments:
        slots = []
        for kind_s in pattern:
            kind = parse_kind(kind_s)
            if kind.is_attention:
                names = ("ckv", "krope") if kind.mla else ("k", "v")
                tail = (None,) if kind.mla else (None, None)
                c = {n: ("layers", "batch", "kv_seq") + tail for n in names}
                c["pos"] = ("layers", "batch", "kv_seq")
            else:
                proto = R.zero_state(cfg, kind, 1, torch.device("meta"))
                c = {k: ("layers", "batch") + (None,) * (v.ndim - 1)
                     for k, v in proto.items()}
            slots.append(c)
        segs.append(slots)
    return {"segments": segs}


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


def _window(cfg: ModelConfig, kind: LayerKind) -> int:
    """A slot's attention window: ``cfg.window_size`` on local slots."""
    return cfg.window_size if kind.base == "local" else 0


def _block_tail(slot, r: int, cfg: ModelConfig, x, cond=None, *,
                with_aux=False, mesh=None, shard=None):
    """What follows a slot's attention or cell, in the reference's order:
    cross-attention to ``cond`` (``.xattn`` slots, when ``cond`` is
    given), then the residual MLP or MoE if the slot has one.  Returns (x,
    aux), aux the MoE's load-balance loss when ``with_aux`` (sequence
    mode) and None otherwise (decode drops it).  On a mesh the residual
    stream is laid out by ``shard`` after the sub-block, as the
    reference's, and the MoE takes the ``mesh`` (``moe.moe_apply``)."""
    if slot.kind.xattn and cond is not None:
        x = x + L.cross_attention(slot.xattn, r, cfg,
                                  L.rms_norm(x, slot.norm_x[r]), cond)
    if slot.kind.moe:
        out, aux = moe_apply(slot.moe, r, cfg, L.rms_norm(x, slot.norm2[r]),
                             with_aux=with_aux, mesh=mesh)
        x = x + out
    elif cfg.d_ff > 0:
        x, aux = x + L.mlp_apply(slot, r, cfg,
                                 L.rms_norm(x, slot.norm2[r])), None
    else:
        aux = None
    if shard is not None:
        x = shard(x, _RESID)
    return x, aux


def _cond(cond, x):
    """The conditioning in the residual stream's dtype (the reference casts
    it so), or None."""
    return None if cond is None else cond.to(x.dtype)


# ---------------------------------------------------------------------------
# sequence mode: forward / prefill
# ---------------------------------------------------------------------------


def _run_seq(params, cfg: ModelConfig, x, positions, cond=None, *,
             pasts=None, k_positions=None, mesh=None, shard=None,
             pshard=None):
    """All layers over a sequence; returns (x, per-slot lists of cache
    entries in repeat order -- {"k", "v"}, MLA {"ckv", "krope"} or a
    recurrent cell's final state --, the summed MoE aux loss).  Local
    slots attend through a sliding window, the others causally, every
    attention kind with ``cfg.prefix_len``'s bidirectional prefix;
    ``.xattn`` slots attend ``cond`` [B, T, cond_dim] too.

    ``pasts`` (chunked prefill, the reference's ``_run_segments_seq``)
    mirrors the cache's segment/slot structure with the earlier chunks'
    attention rows stacked [R, B, P, ...] (no ``pos``): each attention
    slot attends ``past ++ own`` keys at ``k_positions`` [1, P + S].

    With ``cfg.remat`` and gradients enabled, each repeat of a segment's
    pattern runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of one repeat): its activations are recomputed in
    the backward pass, a MoE slot's host read of its expert counts
    included (the same counts: the recompute sees the same inputs).  With
    gradients enabled the slots are read through ``RepeatView``s.

    On a mesh (the parameters DTensors), ``shard`` lays the residual
    stream out after each sub-block, ``pshard`` (``param_specs`` given)
    lays each repeat's slot leaves out by their specs (the reference's
    ``_constrain_slots``), and ``mesh`` goes to the MoE."""
    cond = _cond(cond, x)
    k_pos = positions if k_positions is None else k_positions
    masks = {}          # MLA's, by window; attention_apply builds its own
    entries: List[List] = [[] for _ in state_slot_meta(cfg)]
    aux_total = torch.zeros((), device=x.device)

    def one_repeat(x, aux_total, li0, r, slots):
        out_entries = []
        for j, slot in enumerate(slots):
            window = _window(cfg, slot.kind)
            h = L.rms_norm(x, slot.norm1[r])
            if slot.kind.is_recurrent:
                out, entry = R.apply(slot.cell, r, cfg, h)
            else:
                names = slot_leaf_names(slot.kind)
                past = None
                if pasts is not None:
                    e = _slot_cache(pasts, cfg, li0 + j)
                    past = tuple(e[name][r] for name in names)
                if slot.kind.mla:
                    if window not in masks:
                        masks[window] = L.causal_mask(
                            positions, k_pos, window, cfg.prefix_len)
                    out, rows = L.mla_apply(slot, r, cfg, h, positions,
                                            masks[window], past=past)
                else:
                    out, rows = L.attention_apply(
                        slot, r, cfg, h, positions, window=window,
                        past=past, k_positions=k_positions)
                entry = dict(zip(names, rows))
            out_entries.append(entry)
            x = x + out
            if shard is not None:
                x = shard(x, _RESID)
            x, aux = _block_tail(slot, r, cfg, x, cond, with_aux=True,
                                 mesh=mesh, shard=shard)
            if aux is not None:
                aux_total = aux_total + aux
        return x, aux_total, out_entries

    grad = torch.is_grad_enabled()
    remat = cfg.remat and grad
    li0 = 0
    for si, (pattern, repeats) in enumerate(cfg.segments):
        slots = list(params.segments[si])
        if pshard is not None:
            slots = [RepeatView(s, pshard) for s in slots]
        elif grad:
            slots = [RepeatView(s) for s in slots]
        for r in range(repeats):
            if remat:
                x, aux_total, rep = torch.utils.checkpoint.checkpoint(
                    one_repeat, x, aux_total, li0, r, slots,
                    use_reentrant=False)
            else:
                x, aux_total, rep = one_repeat(x, aux_total, li0, r, slots)
            for j, entry in enumerate(rep):
                entries[li0 + j].append(entry)
        li0 += len(pattern)
    return x, entries, aux_total


class RepeatView:
    """A module's stacked leaves split over their repeats once
    (``unbind``): attribute ``name`` is the tuple of per-repeat views, so
    ``view.name[r]`` reads as ``module.name[r]`` does, child modules are
    views too, and plain attributes (``kind``, ``base``) are the module's.
    Under autograd the unbind's backward writes each leaf's gradient once
    (a stack), where indexing a repeat at a time writes a zero-filled
    leaf-sized gradient per use: 18 of them a leaf for paligemma-3b.
    ``pshard`` (``sharding.make_param_shard_fn``) lays each view out by
    its leaf's axes without the repeats."""

    def __init__(self, mod: nn.Module, pshard=None):
        for name, value in vars(mod).items():
            if not name.startswith("_"):
                setattr(self, name, value)
        axes = getattr(mod, "axes", {})
        ref = getattr(mod, "ref_shape", {})
        for name, t in mod.named_parameters(recurse=False):
            views = t.unbind(0)
            if pshard is not None and name in axes:
                views = tuple(pshard(v, axes[name][1:], ref.get(name))
                              for v in views)
            setattr(self, name, views)
        for name, child in mod.named_children():
            setattr(self, name, RepeatView(child, pshard))


def _stack_cache(cfg: ModelConfig, entries, pos):
    """Cache tree {"segments": [[{leaf: [R, B, T, ...], "pos": [R,B,T]}]]}
    from per-slot entry lists: ``k``/``v`` [R,B,T,KV,D] or MLA ``ckv``
    [R,B,T,kv_lora] / ``krope`` [R,B,T,rope]; a recurrent slot's entry is
    its final state, each leaf stacked [R, B, ...], with no ``pos``."""
    segs, li = [], 0
    for pattern, repeats in cfg.segments:
        slots = []
        for kind_s in pattern:
            c = {name: torch.stack([e[name] for e in entries[li]])
                 for name in entries[li][0]}
            if not parse_kind(kind_s).is_recurrent:
                c["pos"] = pos.expand(repeats, *pos.shape).clone()
            slots.append(c)
            li += 1
        segs.append(slots)
    return {"segments": segs}


def _embed(params, cfg: ModelConfig, tokens, extra_embeds):
    """The residual stream's input: the token embeddings, after
    ``extra_embeds`` [B, P, d] (a VLM's image prefix, cast to the stream's
    dtype and not scaled) when given."""
    x = L.embed(params.tok, cfg, tokens)
    if extra_embeds is None:
        return x
    return torch.cat([extra_embeds.to(x.dtype), x], dim=1)


def forward(params, cfg: ModelConfig, tokens, *, extra_embeds=None,
            cond=None, mesh=None, shard=None, param_specs=None,
            pshard=None):
    """Training-style forward.  tokens: [B, S]; extra_embeds: [B, P, d]
    prepended before the token embeddings (logits over all P + S
    positions, as the reference's); cond: [B, T, cond_dim] conditioning
    for ``.xattn`` slots.  Returns (logits [B,P+S,V], aux_loss): the MoE
    load-balance loss summed over the MoE layers (0 without MoE).  The
    reference's scan over repeats adds the aux of a pattern's last slot
    only (``model.py:330``), which is the same sum for every registered
    MoE config (single-slot patterns).

    The mesh path (the parameters DTensors, ``train.step``'s mesh step):
    ``shard`` (``sharding.make_shard_fn``) lays the residual stream out
    after the embedding and after each sub-block and the logits at the
    end; ``param_specs`` with ``pshard`` lays each repeat's slot leaves
    out; ``mesh`` takes a ``moe_impl="shard_map"`` MoE expert-parallel."""
    x = _embed(params, cfg, tokens, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    if shard is not None:
        x = shard(x, _RESID)
    x, _, aux = _run_seq(params, cfg, x, positions, cond, mesh=mesh,
                         shard=shard,
                         pshard=pshard if param_specs is not None else None)
    x = L.rms_norm(x, params.final_norm)
    logits = L.unembed(params, cfg, x)
    if shard is not None:
        logits = shard(logits, ("batch", "seq", "vocab"))
    return logits, aux


def prefill(params, cfg: ModelConfig, tokens, *, extra_embeds=None,
            cond=None, mesh=None, shard=None, param_specs=None,
            pshard=None):
    """Forward pass that also returns the populated cache (a recurrent
    slot's entry holds its cell's final state); ``extra_embeds`` and
    ``cond`` as ``forward``'s (the cache timeline starts at the prefix).
    Returns (last_logits [B,1,V], cache).

    A local slot keeps only its last ``window`` positions when the prompt
    is longer, rolled by ``s % window`` so that slot j holds the position
    == j (mod window): decode overwrites slot ``pos % window``, so without
    the roll it would clobber a position still inside the window (the
    reference's ring alignment, ``model.py:509-526``).  ``mesh``,
    ``shard``, ``param_specs`` and ``pshard`` as ``forward``'s."""
    x = _embed(params, cfg, tokens, extra_embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None]
    if shard is not None:
        x = shard(x, _RESID)
    x, entries, _ = _run_seq(
        params, cfg, x, positions, cond, mesh=mesh, shard=shard,
        pshard=pshard if param_specs is not None else None)
    x = L.rms_norm(x, params.final_norm)
    logits = L.unembed(params, cfg, x[:, -1:])
    pos = positions.expand(b, s).to(torch.int64)
    cache = _stack_cache(cfg, entries, pos)
    for (si, j, _, window, _) in state_slot_meta(cfg):
        if 0 < window < s:
            c = cache["segments"][si][j]
            cache["segments"][si][j] = {
                name: torch.roll(a[:, :, -window:], s % window, dims=2)
                for name, a in c.items()}
    return logits, cache


def pad_cache(cache, cfg: ModelConfig, max_len: int):
    """Pad prefill-produced caches out to their capacity (pos -1 ==
    empty): ``max_len`` positions, ``min(window, max_len)`` on local
    slots.  Recurrent states pass through."""
    segs = []
    for si, (pattern, _) in enumerate(cfg.segments):
        slots = []
        for j, kind_s in enumerate(pattern):
            c = cache["segments"][si][j]
            kind = parse_kind(kind_s)
            if kind.is_recurrent:
                slots.append(c)
                continue
            window = _window(cfg, kind)
            cap = min(window, max_len) if window > 0 else max_len
            pad = cap - c["pos"].shape[2]
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
    """Empty dense decode cache mirroring the segment structure: k/v rows
    for attention slots, compressed ckv/krope rows for MLA slots;
    ``max_len`` rows each, a ring of ``min(window, max_len)`` rows on
    local slots; a recurrent slot's zero state (``recurrent.zero_state``,
    float32 whatever ``dtype``) stacked over its repeats."""
    dev = resolve_device(device)
    segs = []
    for pat, r in cfg.segments:
        slots = []
        for kind_s in pat:
            kind = parse_kind(kind_s)
            if kind.is_recurrent:
                slots.append({k: v.expand(r, *v.shape).clone() for k, v in
                              R.zero_state(cfg, kind, batch, dev).items()})
                continue
            window = _window(cfg, kind)
            t = min(window, max_len) if window > 0 else max_len
            zeros = lambda *s: torch.zeros((r, batch, t) + s, dtype=dtype,
                                           device=dev)
            if kind.mla:
                m = cfg.mla
                c = {"ckv": zeros(m.kv_lora_rank),
                     "krope": zeros(m.qk_rope_dim)}
            else:
                kv, hd = cfg.num_kv_heads, cfg.head_dim
                c = {"k": zeros(kv, hd), "v": zeros(kv, hd)}
            c["pos"] = torch.full((r, batch, t), -1, dtype=torch.int64,
                                  device=dev)
            slots.append(c)
        segs.append(slots)
    return {"segments": segs}


def decode_step(params, cfg: ModelConfig, cache, tokens, cur_pos, *,
                cond=None, mesh=None, shard=None):
    """One dense decode step.  tokens: [B,1]; cur_pos: [B] (current
    length); cond: [B, T, cond_dim] for ``.xattn`` slots.  Writes the new
    entries (a recurrent slot's new state) into ``cache`` in place (slot
    ``_write_slot``) and returns (logits [B,1,V], cache).  ``shard`` and
    ``mesh`` as ``forward``'s."""
    x = L.embed(params.tok, cfg, tokens)
    if shard is not None:
        x = shard(x, _RESID)
    cond = _cond(cond, x)
    rows = torch.arange(x.shape[0], device=x.device)
    for li, r, slot in _layers(params, cfg):
        c = _slot_cache(cache, cfg, li)
        h = L.rms_norm(x, slot.norm1[r])
        if slot.kind.is_recurrent:
            out, new = R.step(slot.cell, r, cfg, h,
                              {k: v[r] for k, v in c.items()})
            for k, v in new.items():
                c[k][r].copy_(v)
            x, _ = _block_tail(slot, r, cfg, x + out, cond, mesh=mesh,
                               shard=shard)
            continue
        pos = c["pos"][r]
        names = slot_leaf_names(slot.kind)
        window = _window(cfg, slot.kind)
        if slot.kind.mla:
            out, *new = L.mla_decode(slot, r, cfg, h, c[names[0]][r],
                                     c[names[1]][r], pos, cur_pos)
        else:
            out, *new = L.attention_decode(slot, r, cfg, h, c[names[0]][r],
                                           c[names[1]][r], pos, cur_pos,
                                           window=window)
        wslot = _write_slot(pos, cur_pos, window)
        for name, e in zip(names, new):
            _write_rows(c[name][r], rows, wslot, e[:, 0])
        _write_rows(pos, rows, wslot, cur_pos)
        x, _ = _block_tail(slot, r, cfg, x + out, cond, mesh=mesh,
                           shard=shard)
    x = L.rms_norm(x, params.final_norm)
    return L.unembed(params, cfg, x), cache


def _write_rows(leaf, rows, slots, val):
    """``leaf[rows, slots[rows]] = val`` in place.  A DTensor cache leaf
    (sharded over its batch and time dims on a mesh) takes the write as a
    masked select over the whole leaf, which each rank does on its own
    shard (an indexed write would gather it)."""
    if not isinstance(leaf, DTensor):
        leaf[rows, slots] = val.to(leaf.dtype)
        return
    hit = torch.arange(leaf.shape[1], device=slots.device)[None] \
        == slots[:, None]
    hit = hit.reshape(hit.shape + (1,) * (leaf.ndim - 2))
    val = val.to(leaf.dtype).reshape(val.shape[:1] + (1,) + val.shape[1:])
    leaf.copy_(torch.where(hit, val, leaf))


def _write_slot(cache_pos, cur_pos, window: int):
    """Cache slot to write: the position for full caches, the ring slot
    ``cur_pos % window`` for a window-sized ring."""
    t = cache_pos.shape[1]
    if window > 0 and t == window:
        return cur_pos % window
    return cur_pos.clamp_max(t - 1)


def _slot_cache(cache, cfg: ModelConfig, li: int):
    for si, (pattern, _) in enumerate(cfg.segments):
        if li < len(pattern):
            return cache["segments"][si][li]
        li -= len(pattern)
    raise IndexError(li)


def batched_prefill_supported(cfg: ModelConfig) -> bool:
    """Whether right-padded batched prefill is exact: only when no layer
    carries sequential state across positions (a recurrent cell would
    consume the padding of short rows)."""
    return not any(parse_kind(s).is_recurrent for pat, _ in cfg.segments
                   for s in pat)


def prefill_batched(params, cfg: ModelConfig, tokens, lengths, *,
                    extra_embeds=None, cond=None, shard=None):
    """Batched-admission prefill: one packed forward over right-padded
    prompts.  tokens: [B, Smax]; lengths: [B] true row lengths, the
    prefix included; extra_embeds: [B, P, d] prepended as ``prefill``'s
    (the cache timeline starts at the prefix); cond: [B, T, cond_dim] for
    ``.xattn`` slots.
    Returns (last_logits [B,1,V], cache) where ``last_logits[b]`` is taken
    at position ``lengths[b] - 1`` and the cache keeps the full padded
    timeline with ``pos`` -1 beyond each row's length.  Causality makes
    each row's valid prefix independent of its padding; a recurrent cell
    would fold the padding into its state, so recurrent configs raise
    (``batched_prefill_supported``)."""
    if not batched_prefill_supported(cfg):
        raise ValueError(f"{cfg.name}: batched prefill needs all-attention "
                         "layers (recurrent state would fold in padding)")
    x = _embed(params, cfg, tokens, extra_embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None]
    if shard is not None:
        x = shard(x, _RESID)
    x, entries, _ = _run_seq(params, cfg, x, positions, cond, shard=shard)
    x = L.rms_norm(x, params.final_norm)
    ln = torch.as_tensor(lengths, device=x.device).long()
    last = x[torch.arange(b, device=x.device), ln - 1][:, None]
    logits = L.unembed(params, cfg, last)
    pos = torch.where(positions < ln[:, None], positions,
                      torch.full_like(positions, -1))
    return logits, _stack_cache(cfg, entries, pos)


def prefill_chunk(params, cfg: ModelConfig, tokens, lengths, past=None, *,
                  start: int, cond=None, shard=None):
    """One width-bounded chunk of a batched-admission prefill (the
    reference's ``prefill_chunk``): ``prefill_batched``'s packed forward
    split over absolute positions, so a long prompt's admission can run
    in pieces behind decode macros.  ``tokens`` [B, C]: the slice of the
    right-padded prompts at positions ``[start, start + C)``; ``lengths``
    [B]: the rows' full true lengths; ``past``: every earlier chunk's
    cache (leaves [R, B, start, ...], built by ``chunk_past_extend`` from
    this function's returns); ``cond`` [B, T, cond_dim] for ``.xattn``
    slots.  The chunk's keys are ``past ++ own`` at positions
    ``arange(start + C)``, so each valid row reduces over the same keys
    as the packed pass (in another order: logits agree to float32
    rounding).  On the flash route each attention layer is one kernel
    launch with ``q_offset = start``.

    Returns (logits [B, 1, V], cache_chunk): ``logits[b]`` at the row's
    last position clamped into this chunk (meaningful only when ``start
    <= lengths[b] - 1 < start + C``), and the chunk's cache rows as the
    positions ``[start, start + C)`` of a ``prefill_batched`` cache
    (``pos`` -1 past each row's length).  Raises for configs without
    batched prefill; takes no ``extra_embeds`` (a prefix config's
    admissions keep the packed path)."""
    if not batched_prefill_supported(cfg):
        raise ValueError(f"{cfg.name}: chunked prefill needs all-attention "
                         "layers (recurrent state would fold in padding)")
    x = L.embed(params.tok, cfg, tokens)
    b, c = x.shape[:2]
    start = int(start)
    positions = start + torch.arange(c, device=x.device)[None]
    k_positions = torch.arange(start + c, device=x.device)[None]
    if shard is not None:
        x = shard(x, _RESID)
    x, entries, _ = _run_seq(params, cfg, x, positions, cond, pasts=past,
                             k_positions=k_positions, shard=shard)
    x = L.rms_norm(x, params.final_norm)
    ln = torch.as_tensor(lengths, device=x.device).long()
    take = (ln - 1 - start).clamp(0, c - 1)
    logits = L.unembed(params, cfg,
                       x[torch.arange(b, device=x.device), take][:, None])
    pos = torch.where(positions < ln[:, None], positions,
                      torch.full_like(positions, -1))
    return logits, _stack_cache(cfg, entries, pos)


def chunk_past_extend(past, cache_chunk):
    """The chunked-prefill past with ``cache_chunk`` (a ``prefill_chunk``
    cache) appended on the time axis, its ``pos`` dropped (the next chunk
    rebuilds the key positions as ``arange``); ``past=None`` starts the
    accumulation (the reference's ``chunk_past_extend``)."""
    segs = []
    for si, slots in enumerate(cache_chunk["segments"]):
        new = []
        for j, e in enumerate(slots):
            ent = {k: v for k, v in e.items() if k != "pos"}
            if past is not None:
                old = past["segments"][si][j]
                ent = {k: torch.cat([old[k], v], dim=2)
                       for k, v in ent.items()}
            new.append(ent)
        segs.append(new)
    return {"segments": segs}


def row_cache_from_batched(cache, cfg: ModelConfig, bi: int, length: int,
                           max_len: int):
    """Request ``bi`` of a ``prefill_batched`` cache as one row of the
    packed dense cache (``init_cache``): every leaf ``[R, cap, ...]`` with
    ``cap`` = ``max_len``, or ``min(window, max_len)`` on local slots,
    whose ring keeps slot == pos % cap (the last ``cap`` positions when
    ``length`` passes it), and ``pos`` -1 past ``length``.  Equal to
    per-request ``prefill`` + ``pad_cache`` at every position attention
    reads; the rows at ``pos`` -1 hold whatever the padded timeline had
    there, as the reference's."""
    segs = []
    for si, (pattern, repeats) in enumerate(cfg.segments):
        slots = []
        for j, kind_s in enumerate(pattern):
            e = cache["segments"][si][j]
            window = _window(cfg, parse_kind(kind_s))
            cap = min(window, max_len) if window > 0 else max_len
            dev = e["pos"].device
            col = torch.arange(cap, device=dev)
            if length > cap:
                # the window ring: slot i holds the one in-window position
                # == i (mod cap), which decode's ring overwrite keeps
                lo = length - cap
                idx = lo + (col - lo) % cap
                pos = idx
            else:
                idx = col.clamp_max(e["pos"].shape[2] - 1)
                pos = torch.where(col < length, col, torch.full_like(col, -1))
            row = {name: a[:, bi, idx] for name, a in e.items()
                   if name != "pos"}
            row["pos"] = pos.expand(repeats, cap).to(e["pos"].dtype)
            slots.append(row)
        segs.append(slots)
    return {"segments": segs}


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
            out.append((si, j, repeats, _window(cfg, kind), kind))
    return out


def attn_slot_meta(cfg: ModelConfig):
    """The attention subset of ``state_slot_meta`` (same tuple layout)."""
    return [m for m in state_slot_meta(cfg) if m[4].is_attention]


def attn_slot_index(cfg: ModelConfig, si: int, j: int) -> int:
    """Index of segment ``si`` slot ``j`` in the ``state_slot_meta`` order
    (its leaf index in the shared pools' layered storage).  Raises
    ``ValueError`` unless that slot is an attention slot."""
    for i, (si_, j_, _, _, kind) in enumerate(state_slot_meta(cfg)):
        if (si_, j_) == (si, j):
            if not kind.is_attention:
                break
            return i
    raise ValueError(f"({si}, {j}) is not an attention slot of {cfg.name}")


def state_dim(cfg: ModelConfig, kind: LayerKind) -> int:
    """The floats of one request's packed state of a ``kind`` cell: the
    trailing dim of its pool leaf (one logical page per request)."""
    return sum(math.prod(a.shape[1:])
               for a in R.zero_state(cfg, kind, 1, "meta").values())


def pack_state(state) -> torch.Tensor:
    """A cell's state dict as f32 [B, state_dim], its leaves in sorted key
    order -- the order of ``jax.tree.leaves`` over the reference's dict,
    so a page holds the reference's bytes (mLSTM ``C, conv, m, n``; sLSTM
    ``c, conv, h, m, n``; RG-LRU ``conv, h``).  Reshapes and one concat:
    the round trip through ``unpack_state`` is exact."""
    b = next(iter(state.values())).shape[0]
    return torch.cat([state[k].reshape(b, -1).float()
                      for k in sorted(state)], dim=1)


def unpack_state(flat, proto):
    """The inverse of ``pack_state`` against a prototype state dict of the
    same keys and per-row shapes (e.g. ``recurrent.zero_state`` on the
    meta device): views of ``flat`` [B, state_dim]."""
    b, out, o = flat.shape[0], {}, 0
    for k in sorted(proto):
        shape = tuple(proto[k].shape[1:])
        n = math.prod(shape)
        out[k] = flat[:, o:o + n].reshape((b,) + shape)
        o += n
    return out


def has_state_pages(cfg: ModelConfig) -> bool:
    """Whether any slot is a recurrent cell: each request then holds one
    state page after its token pages."""
    return any(k.is_recurrent for *_, k in state_slot_meta(cfg))


def has_attention(cfg: ModelConfig) -> bool:
    return any(k.is_attention for *_, k in state_slot_meta(cfg))


def slot_leaf_specs(cfg: ModelConfig, page_size: int):
    """Leaf specs for ``SharedPagedPools.attach_layered``: one
    ``(repeats, leaves)`` entry per slot.  Attention pages hold (k, v)
    token rows ``{"k": (page, KV, D), "v": ...}``; MLA pages hold
    compressed rows shared across heads ``{"ckv": (page, kv_lora),
    "krope": (page, rope)}``; a recurrent cell holds one packed state per
    request ``{"state": (state_dim,)}``."""
    check_supported(cfg)
    specs = []
    for (_, _, repeats, _, kind) in state_slot_meta(cfg):
        if kind.is_recurrent:
            leaves = {"state": (state_dim(cfg, kind),)}
        elif kind.mla:
            m = cfg.mla
            leaves = {"ckv": (page_size, m.kv_lora_rank),
                      "krope": (page_size, m.qk_rope_dim)}
        else:
            trail = (page_size, cfg.num_kv_heads, cfg.head_dim)
            leaves = {"k": trail, "v": trail}
        specs.append((repeats, leaves))
    return specs


def slot_leaf_names(kind: LayerKind):
    """The pool leaves of one slot: ``("state",)`` for a recurrent cell,
    ``("ckv", "krope")`` for MLA, else ``("k", "v")``."""
    if kind.is_recurrent:
        return ("state",)
    return ("ckv", "krope") if kind.mla else ("k", "v")


def decode_step_paged(params, cfg: ModelConfig, kv, tables, gid_tables,
                      tokens, cur_pos, *, page_size: int, state_cols=None,
                      cond=None):
    """One decode step with every state-bearing layer reading and writing
    the shared page pools (no dense cache exists): attention slots
    through ``ops.paged_attention``, MLA slots through
    ``ops.paged_attention_mla``, recurrent cells through one packed state
    page per request (mLSTM slots in place on it: ``_mlstm_paged``).

    kv:         the pools' layered leaves with their sink page
                (``SharedPagedPools.kv_with_sink``): ``{"k_hbm"|"v_hbm":
                [per slot [R, hbm_pages + 1, page, KV, D]], "k_host"|
                "v_host": [per slot [R, n_logical + 1, ...]]}``, for MLA
                slots ``ckv_*`` [.., page, kv_lora] / ``krope_*``
                [.., page, rope], for recurrent slots ``state_*``
                [.., state_dim]; updated in place.  The last page of
                every leaf is the sink, which no table names.
    tables:     int32[B, n] HBM slot per row page (-1 = padding/inactive).
    gid_tables: int32[B, n] logical page id per row page (-1 = padding).
    tokens: [B, 1]; cur_pos: [B] position being decoded (-1 = inactive).
    state_cols: int [B] column of each row's state page in its tables
                (-1 = none); required iff the config has recurrent slots.
    cond:       [B, T, cond_dim] conditioning for ``.xattn`` slots: not
                paged, and it adds nothing to the page mass.

    Returns (logits [B,1,V], page_mass f32[B, n]): the access mass per
    row page averaged over every state-bearing layer -- an attention
    layer's head-normalised mass, a recurrent layer's unit touch on the
    state column -- and zero for inactive rows.  Reads nothing back to
    the host (a routed MoE layer groups its tokens by expert on the
    device: ``kernels.routed_experts``)."""
    return _paged_decode_core(params, cfg, kv, tables, gid_tables, tokens,
                              cur_pos, page_size=page_size,
                              state_cols=state_cols, cond=cond)


def _sink_page(kv, tier: str) -> int:
    """The sink page of one tier's leaves: their last page."""
    return next(t.shape[1] for key, leaves in kv.items()
                if key.endswith(tier) for t in leaves if t is not None) - 1


def _paged_attention(slot, r: int, cfg: ModelConfig, h, hbm, host, cur_pos,
                     hbm_at, host_at, tables, lengths):
    """One attention or MLA slot of the paged decode: write the token's
    rows through both tiers (at ``hbm_at`` / ``host_at``), then attend
    the pages through the kernel.  Returns (out [B, 1, d], mass)."""
    if slot.kind.mla:
        q_nope, q_rope = L._mla_q(slot, r, cfg, h, cur_pos[:, None])
        new = L._mla_kv(slot, r, cfg, h, cur_pos[:, None])
    else:
        q, *new = L._qkv(slot, r, cfg, h, cur_pos[:, None])
    # write-through: the decoding token's rows land in its HBM slot page
    # AND the host backing page before the gather, so the kernel attends
    # the current token too
    for pool_h, pool_host, e in zip(hbm, host, new):
        e1 = e[:, 0].to(pool_h.dtype)
        pool_h.index_put_(hbm_at, e1)
        pool_host.index_put_(host_at, e1)
    if slot.kind.mla:
        # the paged analogue of layers.mla_decode: attend in the
        # compressed space, then up-project with W_uv
        q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], slot.w_uk[r])
        ctx, mass = ops.paged_attention_mla(
            q_abs.contiguous(), q_rope[:, 0].contiguous(), hbm[0], hbm[1],
            tables, lengths, scale=L.mla_scale(cfg), return_mass=True)
        ctx = torch.einsum("bhr,rhk->bhk", ctx, slot.w_uv[r])
    else:
        ctx, mass = ops.paged_attention(q[:, 0].contiguous(), hbm[0], hbm[1],
                                        tables, lengths,
                                        window=_window(cfg, slot.kind),
                                        softcap=cfg.softcap,
                                        return_mass=True)
    return ctx.reshape(h.shape[0], 1, -1) @ slot.wo[r], mass


def _mlstm_paged(slot, r: int, cfg: ModelConfig, h, hbm, host, s_read,
                 s_src, s_hbm, s_host):
    """One mLSTM slot of the paged decode, in place on its state pages:
    ``kernels.mlstm_scan`` reads each row's C (the page's leading
    columns) from its HBM slot ``s_src`` and writes the new C at
    ``s_hbm`` and ``s_host``; only the small tail (conv, m, n) is gathered
    from ``s_read`` and written back through a column slice of each tier.
    A dropped row (``s_src`` -1) steps from a zero C and its clamped
    page's tail into the sinks, and its output is never used.  Returns
    the slot's out [B, 1, d]."""
    proto = R.zero_state(cfg, slot.kind, 1, "meta")
    cols = proto.pop("C")[0].numel()
    tail = unpack_state(hbm[s_read, cols:], proto)
    out, new = R.mlstm_step(slot.cell, r, cfg, h, tail,
                            pages=(hbm, s_src, ((hbm, s_hbm), (host, s_host))))
    flat = pack_state(new).to(hbm.dtype)
    hbm[:, cols:].index_put_((s_hbm,), flat)
    host[:, cols:].index_put_((s_host,), flat)
    return out


def _paged_decode_core(params, cfg: ModelConfig, kv, tables, gid_tables,
                       tokens, cur_pos, *, page_size: int, state_cols=None,
                       cond=None):
    b = tokens.shape[0]
    dev = tokens.device
    rows = torch.arange(b, device=dev)
    active = cur_pos >= 0
    lengths = torch.where(active, cur_pos + 1, 0).to(torch.int32)
    safe_pos = cur_pos.clamp_min(0)
    pg, off = safe_pos // page_size, safe_pos % page_size
    wslot = tables[rows, pg].long()
    wgid = gid_tables[rows, pg].long()
    sink_hbm, sink_host = _sink_page(kv, "_hbm"), _sink_page(kv, "_host")
    # the reference's drop-mode scatter (`.at[...].set(mode="drop")` with
    # PAGE_DROP) as a fixed-shape masked write: every row writes, and the
    # rows that must not (inactive, or their write page unmapped on that
    # tier) write into the tier's sink page, which no table names -- so no
    # live row's index is ever duplicated and nothing is read back
    hbm_at = (torch.where(active & (wslot >= 0), wslot, sink_hbm), off)
    host_at = (torch.where(active & (wgid >= 0), wgid, sink_host), off)
    if state_cols is None and has_state_pages(cfg):
        raise ValueError(f"{cfg.name}: paged decode over recurrent slots "
                         "needs state_cols (the column of each row's state "
                         "page in `tables`)")
    if state_cols is not None:
        # each row's state page: read from its HBM slot (clamped, as the
        # reference, for rows that have none), written through both tiers
        # (the sink for rows that must not write)
        scol = state_cols.long().clamp_min(0)
        sslot = tables[rows, scol].long()
        sgid = gid_tables[rows, scol].long()
        svalid = active & (state_cols >= 0) & (sslot >= 0)
        s_read = sslot.clamp_min(0)
        # an mLSTM slot's C source: the HBM slot, or none (a zero C) for a
        # dropped row, which reads no page a live row writes in place
        s_src = sslot.masked_fill(~svalid, -1)
        s_hbm = torch.where(svalid, sslot, sink_hbm)
        s_host = torch.where(svalid, sgid, sink_host)
        # a recurrent layer touches its state page once a step: a unit of
        # access mass at the state column, the scale of an attention
        # layer's head-normalised row
        cols = torch.arange(tables.shape[1], device=dev)
        smass = (svalid[:, None] & (cols[None] == scol[:, None])).float()

    x = L.embed(params.tok, cfg, tokens)
    cond = _cond(cond, x)
    mass_sum = torch.zeros((b, tables.shape[1]), dtype=torch.float32,
                           device=dev)
    n_layers = 0
    for li, r, slot in _layers(params, cfg):
        names = slot_leaf_names(slot.kind)
        hbm = [kv[f"{n}_hbm"][li][r] for n in names]
        host = [kv[f"{n}_host"][li][r] for n in names]
        h = L.rms_norm(x, slot.norm1[r])
        if slot.kind.base == "mlstm":
            out = _mlstm_paged(slot, r, cfg, h, hbm[0], host[0], s_read,
                               s_src, s_hbm, s_host)
            mass = smass
        elif slot.kind.is_recurrent:
            # the cell's state page: read from its HBM slot, stepped, and
            # written back through both tiers
            state = unpack_state(hbm[0][s_read],
                                 R.zero_state(cfg, slot.kind, 1, "meta"))
            out, new = R.step(slot.cell, r, cfg, h, state)
            flat = pack_state(new).to(hbm[0].dtype)
            hbm[0].index_put_((s_hbm,), flat)
            host[0].index_put_((s_host,), flat)
            mass = smass
        else:
            out, mass = _paged_attention(slot, r, cfg, h, hbm, host, cur_pos,
                                         hbm_at, host_at, tables, lengths)
        x, _ = _block_tail(slot, r, cfg, x + out, cond)
        mass_sum += mass
        n_layers += 1
    logits = L.unembed(params, cfg, L.rms_norm(x, params.final_norm))
    page_mass = torch.where(active[:, None], mass_sum / max(1, n_layers),
                            torch.zeros_like(mass_sum))
    return logits, page_mass


# ---------------------------------------------------------------------------
# sampling: a counter-based uniform per (seed, iteration), on the device
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 lanes x in [0, 2**32): ``c`` is split
    into 16-bit halves so that no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer hash (Wellons' "lowbias32") on int64 lanes in
    [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform(seeds, iters):
    """The uniform draw of a sampled token, float32 [B] in [0, 1): the top
    24 bits of ``mix32(mix32(seed + golden) ^ iter)`` (low 32 bits of
    each), from int64 tensors ``seeds`` and ``iters`` [B].  Integer tensor
    ops only, so the bits are the same on the CPU and the card, and no
    generator state is kept: ``generate``, the per-token paged path and
    the macro path draw the same number for the same token.  (JAX's
    threefry ``fold_in`` schedule cannot be reproduced in torch; sampled
    streams match the port's own paths, greedy streams the reference.)"""
    h = _mix32(_mix32((seeds + _GOLDEN) & _M32) ^ (iters & _M32))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def sample(logits, temps, seeds, iters):
    """Next token per row of ``logits`` [B, V]: argmax where the row's
    temperature is 0, otherwise an inverse-CDF draw from
    softmax(logits / temperature) at the row's ``uniform(seed, iter)``.
    ``temps`` f32 [B], ``seeds`` and ``iters`` int64 [B] lie on the
    logits' device; nothing is read back to the host.  Returns int64
    [B]."""
    greedy = logits.argmax(dim=-1)
    hot = temps > 0
    t = torch.where(hot, temps, torch.ones_like(temps))
    cdf = torch.softmax(logits.float() / t[:, None], dim=-1).cumsum(dim=-1)
    u = uniform(seeds, iters)
    drawn = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None]).squeeze(1)
    drawn = drawn.clamp_max(logits.shape[-1] - 1)
    return torch.where(hot, drawn, greedy)


# ---------------------------------------------------------------------------
# the decode macro: a sync-free step body over a device carry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MacroCarry:
    """A decode macro's per-row state, all on one device, updated in place
    by ``decode_body`` (so a CUDA graph can be captured over it).

    Inputs, read only in the body: ``temps`` f32[B], ``seeds`` int64[B],
    ``max_new`` int64[B] (token budget), ``eos`` int64[B] (-1 = none).
    Carried: ``tok`` int64[B, 1] (the last token), ``pos`` int64[B] (-1 =
    no request in the row), ``stopped`` bool[B], ``em`` int64[B] (tokens
    emitted, prefill sample included), ``it`` int64[B] (decode iterations
    done), ``mass_sum`` f32[B, n], ``alive_steps`` int64[B], ``toks_out``
    int64[S, B] (-1 = row not alive) and ``step`` int64[1], the row of
    ``toks_out`` the next step writes."""

    temps: torch.Tensor
    seeds: torch.Tensor
    max_new: torch.Tensor
    eos: torch.Tensor
    tok: torch.Tensor
    pos: torch.Tensor
    stopped: torch.Tensor
    em: torch.Tensor
    it: torch.Tensor
    mass_sum: torch.Tensor
    alive_steps: torch.Tensor
    toks_out: torch.Tensor
    step: torch.Tensor

    @classmethod
    def empty(cls, b: int, n_row_pages: int, max_steps: int, device):
        i64 = lambda *s: torch.zeros(s, dtype=torch.int64, device=device)
        return cls(temps=torch.zeros((b,), device=device), seeds=i64(b),
                   max_new=i64(b), eos=i64(b), tok=i64(b, 1), pos=i64(b),
                   stopped=torch.zeros((b,), dtype=torch.bool,
                                       device=device),
                   em=i64(b), it=i64(b),
                   mass_sum=torch.zeros((b, n_row_pages), device=device),
                   alive_steps=i64(b), toks_out=i64(max_steps, b),
                   step=i64(1))

    def load(self, tokens, cur_pos, seeds, iters, emitted, max_new, eos_ids,
             temps) -> None:
        """Copy a macro's inputs (device tensors, rows as ``empty``) in and
        reset the sums.  A row may enter with its stop condition already
        met (the incoming token hits EOS or the budget): it freezes before
        its first step, as the reference's entry check."""
        for dst, src in ((self.tok, tokens), (self.pos, cur_pos),
                         (self.seeds, seeds), (self.it, iters),
                         (self.em, emitted), (self.max_new, max_new),
                         (self.eos, eos_ids), (self.temps, temps)):
            dst.copy_(src)
        self.stopped.copy_(_stop(self.pos >= 0, self))
        self.mass_sum.zero_()
        self.alive_steps.zero_()
        self.step.zero_()

    def alive(self):
        return (self.pos >= 0) & ~self.stopped


def _stop(rows, c: MacroCarry):
    """Rows (of the mask ``rows``) whose budget is spent or whose last
    token is their EOS."""
    return rows & ((c.em >= c.max_new)
                   | ((c.eos >= 0) & (c.tok[:, 0] == c.eos)))


def decode_body(params, cfg: ModelConfig, kv, tables, gid_tables,
                c: MacroCarry, *, page_size: int, state_cols=None,
                cond=None) -> None:
    """One step of the decode macro over the carry ``c``, in place, with
    no read back to the host (routed MoE included): decode every alive row
    off the pools, add its page mass, sample its next token at iteration
    ``it + 1`` and apply the stop conditions.  Dead rows freeze: no KV
    writes (their position goes in as -1, so the write-through sends them
    to the sink), no mass, no emission.  Every row writes
    ``toks_out[step]`` (-1 when not alive).  ``state_cols`` and ``cond``
    as ``decode_step_paged``'s."""
    alive = c.alive()
    cur = torch.where(alive, c.pos, -1)
    logits, mass = _paged_decode_core(params, cfg, kv, tables, gid_tables,
                                      c.tok, cur, page_size=page_size,
                                      state_cols=state_cols, cond=cond)
    c.mass_sum += mass                 # the core zeroes dead rows
    c.alive_steps += alive
    new_tok = sample(logits[:, 0], c.temps, c.seeds, c.it + 1)
    c.it += alive
    c.em += alive
    c.tok.copy_(torch.where(alive[:, None], new_tok[:, None], c.tok))
    c.stopped |= _stop(alive, c)
    c.pos += alive
    c.toks_out.index_put_((c.step,),
                          torch.where(alive, c.tok[:, 0], -1)[None])
    c.step += 1


def decode_macro_step(params, cfg: ModelConfig, kv, tables, gid_tables,
                      tokens, cur_pos, seeds, iters, emitted, max_new,
                      eos_ids, temps, *, n_steps: int, page_size: int,
                      state_cols=None, cond=None):
    """Up to ``n_steps`` fully-paged decode steps for the whole request
    set, with on-device sampling, mass accumulation and EOS / length
    masking, so the host hands over page tables once per movement period
    and reads back (tokens, summed mass, finished flags) once: the eager
    route.  ``graphs.DecodeGraph`` replays the same ``decode_body`` as a
    CUDA graph.

    The reference runs this as one ``lax.scan`` whose ``lax.cond`` skips
    the model once every row is done; here it is a Python loop over
    ``decode_body`` that reads back one any-row-alive flag a step and
    stops there.

    tokens int64[B,1] / cur_pos int64[B] (-1 = no request in the row) and
    the per-row int64 [B] ``seeds`` (request seed), ``iters`` (decode
    iterations done), ``emitted`` (tokens emitted so far incl. the
    prefill sample), ``max_new`` (token budget), ``eos_ids`` (-1 = none)
    and f32 [B] ``temps``, all on the device; ``state_cols`` and ``cond``
    as ``decode_step_paged``'s.

    A row is alive while ``cur_pos >= 0`` and no stop condition has
    fired; dead rows freeze (``decode_body``), so the stream matches the
    per-token path, which retires on the host before the next launch.
    Returns (tokens_out int64[n_steps, B] (-1 = row not alive), state)
    with state = {mass_sum f32[B, n], alive_steps int64[B], pos, iters,
    emitted, stopped bool[B], last_tok [B,1]} on the device, and
    ``steps``, the steps run (an int)."""
    c = MacroCarry.empty(tokens.shape[0], tables.shape[1], n_steps,
                         tokens.device)
    c.toks_out.fill_(-1)
    c.load(tokens, cur_pos, seeds, iters, emitted, max_new, eos_ids, temps)
    steps = 0
    while steps < n_steps and bool(c.alive().any()):
        decode_body(params, cfg, kv, tables, gid_tables, c,
                    page_size=page_size, state_cols=state_cols, cond=cond)
        steps += 1
    return c.toks_out, macro_state(c, steps)


def macro_state(c: MacroCarry, steps: int) -> dict:
    """What the scheduler reads back after a macro of ``steps`` steps."""
    return {"mass_sum": c.mass_sum, "alive_steps": c.alive_steps,
            "pos": c.pos, "iters": c.it, "emitted": c.em,
            "stopped": c.stopped, "last_tok": c.tok, "steps": steps}
