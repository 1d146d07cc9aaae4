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
             seed: int = 0, device=None):
    """Greedy/temperature generation.  prompt_tokens: [B, P_len] ints
    (array or tensor).  Returns int64 tokens [B, steps] on the device.

    Token ``i`` (0 = the prefill's) is drawn with
    ``model.sample(..., seeds=[seed], iters=[i])``, the schedule the
    batcher follows per request."""
    dev = resolve_device(device)
    if params.tok.device != dev:
        raise ValueError(f"params live on {params.tok.device}, not {dev}")
    prompt = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.int64,
                             device=dev)
    b, plen = prompt.shape
    max_len = max_len or (plen + steps)
    temps, seeds = [temperature] * b, [seed] * b
    logits, cache = mdl.prefill(params, cfg, prompt)
    cache = mdl.pad_cache(cache, cfg, max_len)
    pos = torch.full((b,), plen, dtype=torch.int64, device=dev)
    tok = mdl.sample(logits[:, 0], temps, seeds, [0] * b)[:, None]
    out = [tok]
    for i in range(steps - 1):
        logits, cache = mdl.decode_step(params, cfg, cache, tok, pos)
        tok = mdl.sample(logits[:, 0], temps, seeds, [i + 1] * b)[:, None]
        out.append(tok)
        pos = pos + 1
    return torch.cat(out, dim=1)
