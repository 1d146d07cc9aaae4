"""Model configuration schema covering all assigned architecture families.

A model is a sequence of *segments*; each segment is a layer pattern repeated
R times (``(pattern, R)``).  Patterns are tuples of layer-kind strings:

    "attn"    full causal self-attention + MLP
    "local"   sliding-window causal self-attention + MLP
    "mlstm"   xLSTM matrix-LSTM block
    "slstm"   xLSTM scalar-LSTM block
    "rglru"   RG-LRU recurrent block (+ MLP)

Kind strings may carry dot-flags: ``.moe`` (MLP is a routed MoE),
``.xattn`` (adds cross-attention to conditioning), ``.mla`` (attention is
Multi-head Latent Attention).  Example: ``"attn.mla.moe"`` (DeepSeek-V3).

Scanning: parameters of each segment are stacked ``[R, ...]`` and the
segment is executed with ``lax.scan`` over repeats (pattern slots unrolled
inside the scan body), keeping HLO size proportional to the pattern length
rather than the layer count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = [
    "MoEConfig", "MLAConfig", "LayerKind", "ModelConfig", "parse_kind",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int               # per-expert FFN hidden size
    num_shared: int = 0         # always-on shared experts (DeepSeek)
    d_shared: int = 0           # shared expert hidden size (0 -> d_expert)
    capacity_factor: float = 1.25
    router_noise: float = 0.0   # jitter during training
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LayerKind:
    base: str                   # attn | local | mlstm | slstm | rglru
    moe: bool = False
    xattn: bool = False
    mla: bool = False

    @property
    def is_attention(self) -> bool:
        return self.base in ("attn", "local")

    @property
    def is_recurrent(self) -> bool:
        return self.base in ("mlstm", "slstm", "rglru")


def parse_kind(s: str) -> LayerKind:
    parts = s.split(".")
    base, flags = parts[0], set(parts[1:])
    assert base in ("attn", "local", "mlstm", "slstm", "rglru"), s
    assert flags <= {"moe", "xattn", "mla"}, s
    return LayerKind(base, "moe" in flags, "xattn" in flags, "mla" in flags)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                              # dense|vlm|ssm|audio|moe|hybrid
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    segments: Tuple[Tuple[Tuple[str, ...], int], ...]  # ((pattern, repeats),...)
    # attention details
    window_size: int = 0                     # sliding window for "local"
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    softcap: float = 0.0                     # logit soft-capping (gemma-style)
    # MLP
    mlp_kind: str = "swiglu"                 # swiglu | squared_relu | gelu
    # optional sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    # recurrent sizes
    lru_width: int = 0                       # RG-LRU state width (0 -> d_model)
    # embeddings / io
    tie_embeddings: bool = True
    prefix_len: int = 0                      # VLM image-prefix tokens
    cond_len: int = 0                        # cross-attention conditioning length
    cond_dim: int = 0                        # conditioning embed dim (0 -> d_model)
    max_seq_len: int = 8192
    # numerics
    dtype: str = "bfloat16"                  # activation dtype
    param_dtype: str = "float32"
    # implementation switches
    attention_impl: str = "reference"        # reference | pallas
    moe_impl: str = "dense"                  # dense | shard_map
    moe_chunk: int = 0                       # tokens per dispatch chunk (0 = all)
    remat: bool = True
    unroll_layers: bool = False              # python-loop segments (trip-count-
                                             # correct HLO cost analysis)
    # which shapes are lowerable (long_500k needs sub-quadratic paths)
    supports_long_context: bool = False

    # ------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return sum(len(pat) * rep for pat, rep in self.segments)

    def layer_kinds(self):
        for pat, rep in self.segments:
            for _ in range(rep):
                for s in pat:
                    yield parse_kind(s)

    @property
    def has_recurrent(self) -> bool:
        return any(k.is_recurrent for k in self.layer_kinds())

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % max(1, self.num_kv_heads) == 0
        return self.num_heads // max(1, self.num_kv_heads)

    # -- parameter counting (for 6ND roofline math) ---------------------
    def param_count(self) -> int:
        """Total parameter count (embeddings included once if tied)."""
        d, h, kv, hd, ff, v = (self.d_model, self.num_heads, self.num_kv_heads,
                               self.head_dim, self.d_ff, self.vocab_size)
        n = v * d if self.tie_embeddings else 2 * v * d
        cd = self.cond_dim or d
        for k in self.layer_kinds():
            if k.base in ("attn", "local"):
                if k.mla:
                    m = self.mla
                    qk_head = m.qk_nope_dim + m.qk_rope_dim
                    n += d * m.q_lora_rank + m.q_lora_rank * h * qk_head
                    n += d * (m.kv_lora_rank + m.qk_rope_dim)
                    n += m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)
                    n += h * m.v_head_dim * d
                else:
                    n += d * h * hd + 2 * d * kv * hd + h * hd * d
            elif k.base == "mlstm":
                dm = 2 * d  # up-projection width
                n += d * 2 * dm + 3 * dm * dm // 4 + dm * d  # qkv + gates approx
            elif k.base == "slstm":
                n += 4 * d * d + d * (4 * d) // 3 * 2
            elif k.base == "rglru":
                w = self.lru_width or d
                n += 2 * d * w + 2 * w * w // 8 + w * d + 2 * w  # in/gates/out
            if k.xattn:
                n += d * h * hd + 2 * cd * kv * hd + h * hd * d
            # MLP / MoE
            if k.moe:
                mo = self.moe
                n += d * mo.num_experts  # router
                n += mo.num_experts * 3 * d * mo.d_expert
                if mo.num_shared:
                    n += mo.num_shared * 3 * d * (mo.d_shared or mo.d_expert)
            elif ff > 0:
                mult = 3 if self.mlp_kind == "swiglu" else 2
                n += mult * d * ff
        return int(n)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        full_moe = mo.num_experts * 3 * self.d_model * mo.d_expert
        act_moe = mo.top_k * 3 * self.d_model * mo.d_expert
        n_moe_layers = sum(1 for k in self.layer_kinds() if k.moe)
        return int(self.param_count() - n_moe_layers * (full_moe - act_moe))
