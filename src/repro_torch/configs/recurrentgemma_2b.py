"""RecurrentGemma-2B [arXiv:2402.19427]: RG-LRU + local attention, 2:1.

Griffin pattern (rec, rec, local-attn) x 8 + (rec, rec) = 26 layers.
long_500k runs: RG-LRU state is O(1); local attention window 2048.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
        d_ff=7680, vocab_size=256000,
        segments=((("rglru", "rglru", "local"), 8), (("rglru", "rglru"), 1)),
        window_size=2048, lru_width=2560, mlp_kind="swiglu",
        tie_embeddings=True, rope_theta=10_000.0, max_seq_len=1_048_576,
        supports_long_context=True)
