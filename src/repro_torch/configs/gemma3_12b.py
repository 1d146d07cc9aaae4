"""Gemma-3-12B [hf:google]: 5:1 local:global attention, 128k context.

long_500k is lowerable: local layers are sliding-window (sub-quadratic);
global layers at decode are O(L)/step with context-parallel KV.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense",
        d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
        d_ff=15360, vocab_size=262144,
        segments=(((("local",) * 5 + ("attn",)), 8),),
        window_size=1024, mlp_kind="swiglu", qk_norm=True,
        tie_embeddings=True, rope_theta=1_000_000.0, max_seq_len=131072,
        supports_long_context=True)
