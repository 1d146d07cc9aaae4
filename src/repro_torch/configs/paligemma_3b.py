"""PaliGemma-3B [arXiv:2407.07726]: SigLIP frontend (STUB) + Gemma decoder.

The vision tower is a stub per the assignment: ``input_specs`` provides
pre-projected patch embeddings [B, 256, d_model]; the decoder applies a
bidirectional prefix mask over them (prefix-LM).
"""
from repro_torch.models.config import ModelConfig

NUM_PATCHES = 256


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm",
        d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
        d_ff=16384, vocab_size=257216,
        segments=((("attn",), 18),),
        mlp_kind="swiglu", tie_embeddings=True, prefix_len=NUM_PATCHES,
        rope_theta=10_000.0, max_seq_len=8192)
