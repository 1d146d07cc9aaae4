"""MusicGen-large [arXiv:2306.05284]: decoder-only over EnCodec tokens.

Backbone only: the EnCodec tokenizer and T5 text encoder are stubs;
``input_specs`` provides token ids (vocab 2048) and a conditioning
sequence [B, 64, d_model] consumed by per-layer cross-attention.
"""
from repro_torch.models.config import ModelConfig

COND_LEN = 64


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=2048,
        segments=((("attn.xattn",), 48),),
        mlp_kind="gelu", tie_embeddings=False,
        cond_len=COND_LEN, cond_dim=2048,
        rope_theta=10_000.0, max_seq_len=32768)
