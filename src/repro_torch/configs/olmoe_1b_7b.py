"""OLMoE-1B-7B [arXiv:2409.02060]: 64 experts top-8, qk-norm."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=0, vocab_size=50304,
        segments=((("attn.moe",), 16),),
        mlp_kind="swiglu", qk_norm=True, tie_embeddings=False,
        moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024),
        moe_impl="shard_map", rope_theta=10_000.0, max_seq_len=32768)
