"""Qwen3-14B [hf:Qwen]: dense GQA with per-head qk-norm."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
        d_ff=17408, vocab_size=151936,
        segments=((("attn",), 40),),
        mlp_kind="swiglu", qk_norm=True, tie_embeddings=False,
        rope_theta=1_000_000.0, max_seq_len=32768)
