"""DeepSeek-V3-671B [arXiv:2412.19437]: MLA + 1 shared/256 routed top-8 MoE.

First 3 layers dense (d_ff=18432), remaining 58 MoE (d_expert=2048).
MLA's compressed KV cache (kv_lora 512 + rope 64 per token) is the decode
cache -- the absorbed-matrix decode path is implemented.  MTP head omitted
(training-objective add-on; documented in DESIGN.md).
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        d_model=7168, num_heads=128, num_kv_heads=128, head_dim=128,
        d_ff=18432, vocab_size=129280,
        segments=((("attn.mla",), 3), (("attn.mla.moe",), 58)),
        mlp_kind="swiglu", tie_embeddings=False,
        moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                      num_shared=1, d_shared=2048),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe_impl="shard_map", rope_theta=10_000.0, max_seq_len=131072)
