"""Single-stream generation over the dense decode cache (the counterpart
of ``repro/serve/engine.py``).

``generate`` is the plain path: prefill, then one ``model.decode_step``
per token.  No paged kernel runs there -- it is the yardstick the paged
batcher's streams are held to.  ``monitored_generate`` also recomputes,
before each decode step, the attention distribution of one designated
layer for the pending token (``make_monitor``: the "accessed bits" of the
tiering scheduler, one layer sampled as the cheap monitor of the dense
path) and returns the per-page mass sequence ``memtier.replay`` and
``memtier.cori_tune_period`` consume.  The paged batcher
(``serve.sched``) takes its masses from the paged kernel of every layer
instead, and runs no monitor.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import model as mdl
from repro_torch.models.config import ModelConfig, parse_kind
from repro_torch.obs import telemetry as _obs

__all__ = ["generate", "monitored_generate", "page_mass_from_attention",
           "make_monitor", "monitor_slot"]


def _inputs(params, prompt_tokens, temperature, seed, cond, extra_embeds,
            device):
    """The device, the prompt tensor and a sampler ``i -> tokens``'s
    per-row (temps, seeds) on it, and the conditioning and prefix as
    float32 tensors there (None when not given)."""
    dev = resolve_device(device)
    if params.tok.device != dev:
        raise ValueError(f"params live on {params.tok.device}, not {dev}")
    prompt = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.int64,
                             device=dev)
    b = prompt.shape[0]
    temps = torch.full((b,), float(temperature), device=dev)
    seeds = torch.full((b,), int(seed), dtype=torch.int64, device=dev)
    as_f32 = (lambda a: None if a is None else
              torch.as_tensor(a, dtype=torch.float32, device=dev))
    return dev, prompt, temps, seeds, as_f32(cond), as_f32(extra_embeds)


def _sample(logits, temps, seeds, i: int):
    """Token ``i`` of every row (0 = the prefill's), drawn by
    ``model.sample`` at (seed, iteration ``i``) on the device."""
    its = torch.full_like(seeds, i)
    return mdl.sample(logits[:, 0], temps, seeds, its)[:, None]


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt_tokens, steps: int, *,
             max_len: Optional[int] = None, temperature: float = 0.0,
             seed: int = 0, cond=None, extra_embeds=None, device=None):
    """Greedy/temperature generation.  prompt_tokens: [B, P_len] ints
    (array or tensor); cond: [B, T, cond_dim] conditioning for ``.xattn``
    slots and extra_embeds: [B, P, d] the prefix of a ``prefix_len``
    config (arrays or tensors), passed as the reference passes them.
    Returns int64 tokens [B, steps] on the device.

    Token ``i`` (0 = the prefill's) is drawn by ``model.sample`` at
    (``seed``, iteration ``i``) on the device, the schedule the batcher
    follows per request."""
    dev, prompt, temps, seeds, cond, ex = _inputs(
        params, prompt_tokens, temperature, seed, cond, extra_embeds, device)
    b, plen = prompt.shape
    prefix = cfg.prefix_len or 0
    max_len = max_len or (plen + prefix + steps)
    logits, cache = mdl.prefill(params, cfg, prompt, cond=cond,
                                extra_embeds=ex)
    cache = mdl.pad_cache(cache, cfg, max_len)
    pos = torch.full((b,), prefix + plen, dtype=torch.int64, device=dev)
    tok = _sample(logits, temps, seeds, 0)
    out = [tok]
    for i in range(steps - 1):
        logits, cache = mdl.decode_step(params, cfg, cache, tok, pos,
                                        cond=cond)
        tok = _sample(logits, temps, seeds, i + 1)
        out.append(tok)
        pos = pos + 1
    return torch.cat(out, dim=1)


def monitor_slot(cfg: ModelConfig) -> Tuple[int, int]:
    """The monitor layer: the deepest full-attention (not local, not MLA)
    slot, as (segment, slot).  Raises ``ValueError`` for a config without
    one."""
    best = None
    for si, (pattern, _) in enumerate(cfg.segments):
        for j, ks in enumerate(pattern):
            kind = parse_kind(ks)
            if kind.base == "attn" and not kind.mla:
                best = (si, j)
    if best is None:
        raise ValueError("no full-attention layer to monitor "
                         f"in {cfg.name} (attention-free arch)")
    return best


def page_mass_from_attention(q, k, cache_pos, cur_pos, page_size: int,
                             n_pages: int):
    """Attention-probability mass per KV page for the monitor layer.
    q: [B, 1, H, D]; k: [B, T, KV, D]; cache_pos: [B, T] absolute position
    of each cache slot (-1 = empty); cur_pos: [B].  Slots map to pages by
    their stored position, so a ring or a padded tail lands where it
    belongs.  Returns f32 [B, n_pages] (per request; a single stream
    reduces over the batch itself).  The scatter-add is unordered on a
    card: equal to the reference's within float32 rounding, not bit for
    bit."""
    d = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    kr = k.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bthd->bhqt", q.float(), kr.float())
    logits = logits / np.sqrt(d)
    valid = (cache_pos <= cur_pos[:, None]) & (cache_pos >= 0)
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, L.NEG))
    mass_tok = torch.softmax(logits, dim=-1).sum(dim=(1, 2))    # [B, T]
    b, t = mass_tok.shape
    page_of = torch.where(cache_pos >= 0, cache_pos // page_size,
                          torch.full_like(cache_pos, n_pages)).long()
    # empty slots go to the extra last column, which is dropped (the
    # reference's padding of the tail to whole pages adds only such slots)
    mass =torch.zeros((b, n_pages + 1), dtype=torch.float32,
                       device=q.device)
    mass.scatter_add_(1, page_of.clamp(0, n_pages), mass_tok)
    return mass[:, :n_pages]


def make_monitor(params, cfg: ModelConfig, page_size: int, n_pages: int):
    """The per-step monitor: ``(cache, tok, pos) -> f32 [B, n_pages]``.
    Recomputes the monitor layer's query for the pending token ``tok``
    [B, 1] at ``pos`` [B] (embedding, ``norm1``, ``wq``, qk-norm and
    rotary of the slot's last repeat) and returns each row's attention
    mass per page over that slot's last repeat of the dense cache."""
    si, sj = monitor_slot(cfg)
    slot = params.segments[si][sj]
    r = slot.norm1.shape[0] - 1

    def monitor(cache, tok, pos):
        c = cache["segments"][si][sj]
        x = L.embed(params.tok, cfg, tok)
        h = L.rms_norm(x, slot.norm1[r])
        q = (h @ slot.wq[r]).reshape(h.shape[0], 1, cfg.num_heads,
                                     cfg.head_dim)
        if cfg.qk_norm:
            q = L.rms_norm(q, slot.q_norm[r])
        q = L.rope(q, pos[:, None], cfg.rope_theta)
        return page_mass_from_attention(q, c["k"][-1], c["pos"][-1], pos,
                                        page_size, n_pages)

    return monitor


@torch.no_grad()
def monitored_generate(params, cfg: ModelConfig, prompt_tokens, steps: int,
                       *, page_size: int = 16, temperature: float = 0.0,
                       seed: int = 0, cond=None, extra_embeds=None,
                       on_mass: Optional[Callable[[int, np.ndarray], None]]
                       = None, device=None):
    """``generate`` plus the monitor layer's page mass before every decode
    step.  Returns (tokens int64 [B, steps] on the device, page_mass f32
    [steps - 1, n_pages] in numpy: each step's masses, max over the
    batch).  ``on_mass(i, mass)`` is called with step ``i``'s masses
    before decode step ``i + 1`` runs: the hook an online tiering loop
    hangs off.  Sampling as ``generate``'s."""
    dev, prompt, temps, seeds, cond, ex = _inputs(
        params, prompt_tokens, temperature, seed, cond, extra_embeds, device)
    b, plen = prompt.shape
    prefix = cfg.prefix_len or 0
    max_len = plen + prefix + steps
    n_pages = -(-max_len // page_size)
    mon_fn = make_monitor(params, cfg, page_size, n_pages)
    t_start = time.monotonic()
    if (r := _obs.RECORDER).enabled:
        r.emit("serve.stream", phase="start", tokens=int(b * steps),
               wall_ms=0.0)
    logits, cache = mdl.prefill(params, cfg, prompt, cond=cond,
                                extra_embeds=ex)
    cache = mdl.pad_cache(cache, cfg, max_len)
    pos = torch.full((b,), prefix + plen, dtype=torch.int64, device=dev)
    tok = _sample(logits, temps, seeds, 0)
    out, masses = [tok], []
    for i in range(steps - 1):
        masses.append(mon_fn(cache, tok, pos).max(dim=0).values.cpu()
                      .numpy())
        if on_mass is not None:
            on_mass(i, masses[-1])
        logits, cache = mdl.decode_step(params, cfg, cache, tok, pos,
                                        cond=cond)
        tok = _sample(logits, temps, seeds, i + 1)
        out.append(tok)
        pos = pos + 1
    if (r := _obs.RECORDER).enabled:
        r.emit("serve.stream", phase="finish", tokens=int(b * steps),
               wall_ms=(time.monotonic() - t_start) * 1e3)
    return (torch.cat(out, dim=1),
            np.stack(masses) if masses else np.zeros((0, n_pages),
                                                     np.float32))
