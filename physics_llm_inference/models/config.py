"""Model configurations.

Typed replacement for the reference's dict configs (ch01/transformer.py:103-120
LLAMA_7B_CONFIG / QWEN3_CONFIG) following its dataclass-config idiom
(SURVEY.md §5 config system). Adds what a real deployment needs beyond the
reference: RoPE settings, max sequence length, activation/weight dtypes, and
MoE hyperparameters (ref ch09/moe_layer.py:8-14 MoEConfig).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_dim: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    intermediate_dim: int
    norm_eps: float = 1e-6
    # Positional encoding. The reference model has none (ch01/transformer.py);
    # real checkpoints need RoPE. use_rope=False reproduces reference semantics.
    use_rope: bool = True
    rope_theta: float = 10000.0
    max_seq_len: int = 4096
    # dtypes as strings to keep the config hashable/static under jit.
    dtype: str = "bfloat16"
    # Unroll the layer loop for decode-shaped (s == 1) cached calls:
    # trades HLO size (L× the block body) for no per-iteration loop
    # bookkeeping around a small layer. Prefill keeps the scan.
    decode_unroll: bool = True
    # MoE: num_experts > 0 replaces every block's dense SwiGLU with a routed
    # mixture (models/moe.py; ref ch09/moe_layer.py). intermediate_dim is the
    # per-expert FFN width.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    expert_capacity_factor: float = 1.25
    # Tensor-parallel execution context. Set (via parallel/tp.py
    # tp_local_config) on the LOCAL config a shard_map body sees: num_heads /
    # num_kv_heads / intermediate_dim are the per-shard counts, hidden_dim
    # stays global (activations are replicated across TP), and the forward
    # pass psums row-parallel partial sums over `tp_axis` and all-gathers
    # vocab-sharded logits. head_dim_override carries the true head size
    # (hidden_dim // GLOBAL num_heads). None → single-device semantics.
    tp_axis: str | None = None
    tp_data_axis: str | None = None
    head_dim_override: int | None = None

    def __post_init__(self):
        if self.head_dim_override is None:
            assert self.hidden_dim % self.num_heads == 0
        assert self.num_heads % self.num_kv_heads == 0

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_dim // self.num_heads

    def param_count(self) -> int:
        """Analytic parameter count (embed + blocks + norm + lm_head)."""
        d, f, v = self.hidden_dim, self.intermediate_dim, self.vocab_size
        hd = self.head_dim
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        mlp = d * 2 * f + f * d
        norms = 2 * d
        per_layer = attn + mlp + norms
        return v * d + self.num_layers * per_layer + d + d * v


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (ref ch09/moe_layer.py:8-14: 8 experts,
    top-2, Mixtral-style dims)."""
    num_experts: int = 8
    num_experts_per_tok: int = 2
    # Static dispatch capacity per expert, as a multiple of the average load
    # (tokens·top_k/num_experts). Required for fixed-shape dispatch.
    capacity_factor: float = 1.25


# BASELINE config 1: 512-dim/8-head toy model for CachedTransformer parity.
TOY_CONFIG = ModelConfig(
    vocab_size=1000,
    hidden_dim=512,
    num_layers=4,
    num_heads=8,
    num_kv_heads=8,
    intermediate_dim=1024,
    max_seq_len=512,
    dtype="float32",
)

# Ref ch01/transformer.py:103-110.
LLAMA_7B_CONFIG = ModelConfig(
    vocab_size=32000,
    hidden_dim=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    intermediate_dim=11008,
)

# Ref ch01/transformer.py:113-120 (GQA 32q/8kv, Qwen3-style vocab).
QWEN3_CONFIG = ModelConfig(
    vocab_size=151936,
    hidden_dim=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    intermediate_dim=11008,
)

# Mixtral-style MoE dims (ref ch09/moe_layer.py:8-14).
MIXTRAL_MOE_CONFIG = ModelConfig(
    vocab_size=32000,
    hidden_dim=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    intermediate_dim=14336,
)
