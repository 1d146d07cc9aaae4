"""xLSTM-1.3B [arXiv:2405.04517]: 7:1 mLSTM:sLSTM blocks, no FFN sublayer.

Attention-free: the KV-tiering technique is inapplicable (DESIGN.md
SArch-applicability); long_500k runs (recurrent state is O(1) per step).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        d_model=2048, num_heads=4, num_kv_heads=4, head_dim=512,
        d_ff=0, vocab_size=50304,
        segments=(((("mlstm",) * 7 + ("slstm",)), 6),),
        tie_embeddings=True, max_seq_len=1_048_576,
        supports_long_context=True)
