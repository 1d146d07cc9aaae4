"""Single-stream generation over the dense decode cache (the counterpart
of ``repro/serve/engine.py::generate``): prefill, then one
``model.decode_step`` per token.  No paged kernel runs here -- it is the
yardstick the paged batcher's streams are held to."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import model as mdl
from repro_torch.models.config import ModelConfig

__all__ = ["generate"]


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt_tokens, steps: int, *,
             max_len: Optional[int] = None, temperature: float = 0.0,
             seed: int = 0, cond=None, device=None):
    """Greedy/temperature generation.  prompt_tokens: [B, P_len] ints
    (array or tensor); cond: [B, T, cond_dim] conditioning for ``.xattn``
    slots (array or tensor), passed to every layer call as the
    reference's.  Returns int64 tokens [B, steps] on the device.

    Token ``i`` (0 = the prefill's) is drawn by ``model.sample`` at
    (``seed``, iteration ``i``) on the device, the schedule the batcher
    follows per request."""
    dev = resolve_device(device)
    if params.tok.device != dev:
        raise ValueError(f"params live on {params.tok.device}, not {dev}")
    prompt = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.int64,
                             device=dev)
    b, plen = prompt.shape
    max_len = max_len or (plen + steps)
    temps = torch.full((b,), float(temperature), device=dev)
    seeds = torch.full((b,), int(seed), dtype=torch.int64, device=dev)
    its = lambda i: torch.full((b,), i, dtype=torch.int64, device=dev)
    if cond is not None:
        cond = torch.as_tensor(cond, dtype=torch.float32, device=dev)
    logits, cache = mdl.prefill(params, cfg, prompt, cond=cond)
    cache = mdl.pad_cache(cache, cfg, max_len)
    pos = torch.full((b,), plen, dtype=torch.int64, device=dev)
    tok = mdl.sample(logits[:, 0], temps, seeds, its(0))[:, None]
    out = [tok]
    for i in range(steps - 1):
        logits, cache = mdl.decode_step(params, cfg, cache, tok, pos,
                                        cond=cond)
        tok = mdl.sample(logits[:, 0], temps, seeds, its(i + 1))[:, None]
        out.append(tok)
        pos = pos + 1
    return torch.cat(out, dim=1)
