"""Architecture registry: ``get(name)`` for full configs (dry-run scale),
``reduced(name)`` for CPU smoke-test configs of the same family shape.

Also defines the four assigned input shapes (train_4k / prefill_32k /
decode_32k / long_500k) and which (arch x shape) cells are lowerable --
long_500k is skipped for pure full-attention archs per the assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

from repro_torch.configs import (deepseek_v3_671b, gemma3_12b,
                                 musicgen_large, nemotron_4_340b,
                                 olmoe_1b_7b, paligemma_3b, qwen3_14b,
                                 recurrentgemma_2b, stablelm_12b, xlstm_1_3b)

_MODULES = {
    "nemotron-4-340b": nemotron_4_340b,
    "stablelm-12b": stablelm_12b,
    "qwen3-14b": qwen3_14b,
    "gemma3-12b": gemma3_12b,
    "paligemma-3b": paligemma_3b,
    "xlstm-1.3b": xlstm_1_3b,
    "musicgen-large": musicgen_large,
    "deepseek-v3-671b": deepseek_v3_671b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "recurrentgemma-2b": recurrentgemma_2b,
}

ARCHS: List[str] = list(_MODULES)

# ---------------------------------------------------------------------------
# shapes (assignment brief)
# ---------------------------------------------------------------------------

SHAPES: Dict[str, dict] = {
    "train_4k": dict(seq_len=4096, global_batch=256, step="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, step="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, step="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, step="decode"),
}


def get(name: str) -> ModelConfig:
    try:
        return _MODULES[name].config()
    except KeyError as e:
        raise ValueError(f"unknown arch {name!r}; one of {ARCHS}") from e


def cells(include_skipped: bool = False):
    """All (arch, shape) assignment cells; long_500k only where lowerable."""
    out = []
    for a in ARCHS:
        cfg = get(a)
        for s in SHAPES:
            skipped = (s == "long_500k" and not cfg.supports_long_context)
            if include_skipped or not skipped:
                out.append((a, s) if not include_skipped
                           else (a, s, skipped))
    return out


# ---------------------------------------------------------------------------
# reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------


def reduced(name: str) -> ModelConfig:
    """Same family/pattern, tiny dims: one repeat per segment, small width,
    tiny vocab/experts.  Runs a forward/train step on CPU in seconds."""
    cfg = get(name)
    d, heads, kv = 64, 4, min(4, max(1, cfg.num_kv_heads))
    if cfg.num_heads == cfg.num_kv_heads:   # MHA-style archs keep kv == heads
        kv = heads
    hd = 16
    segs = tuple((pat, 1) for pat, _ in cfg.segments)
    kw = dict(
        d_model=d, num_heads=heads, num_kv_heads=kv, head_dim=hd,
        d_ff=(128 if cfg.d_ff else 0), vocab_size=256, segments=segs,
        window_size=min(cfg.window_size, 8) if cfg.window_size else 0,
        lru_width=(64 if cfg.lru_width else 0),
        prefix_len=(8 if cfg.prefix_len else 0),
        cond_len=(4 if cfg.cond_len else 0),
        cond_dim=(d if cfg.cond_dim else 0),
        max_seq_len=64, remat=False, moe_impl="dense",
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(num_experts=8, top_k=2, d_expert=32,
                              num_shared=cfg.moe.num_shared,
                              d_shared=32 if cfg.moe.d_shared else 0,
                              capacity_factor=2.0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    return dataclasses.replace(cfg, **kw)
