"""Nemotron-4-340B [arXiv:2402.16819]: dense GQA, squared-ReLU MLP."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        d_model=18432, num_heads=96, num_kv_heads=8, head_dim=192,
        d_ff=73728, vocab_size=256000,
        segments=((("attn",), 96),),
        mlp_kind="squared_relu", tie_embeddings=False,
        rope_theta=10_000.0, max_seq_len=32768)
