"""StableLM-2-12B [hf:stabilityai]: dense GQA, SwiGLU."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b", family="dense",
        d_model=5120, num_heads=32, num_kv_heads=8, head_dim=160,
        d_ff=13824, vocab_size=100352,
        segments=((("attn",), 40),),
        mlp_kind="swiglu", tie_embeddings=False,
        rope_theta=10_000.0, max_seq_len=32768)
