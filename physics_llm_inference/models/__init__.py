"""Model definitions (reference layer L2: ch01 transformer, ch09 MoE).

Models are pure functions over explicit parameter pytrees. Layer parameters
are *stacked* on a leading num_layers axis and the forward pass scans over
them (jax.lax.scan) — one compiled block body regardless of depth, the
idiomatic XLA structure the reference's Python layer loop
(ch01/transformer.py:82-84) maps to.
"""
from .config import (
    ModelConfig, MoEConfig,
    TOY_CONFIG, LLAMA_7B_CONFIG, QWEN3_CONFIG, MIXTRAL_MOE_CONFIG,
)
from .transformer import (
    init_params, forward, count_parameters, block_forward,
)
from .moe import (
    router, moe_layer, init_moe_params, expert_load_balance_loss,
)
from .moe_inference import ExpertCache, MoEInferencePlanner
from .quant import QuantizedTensor, quantize_params_int8, quantized_param_bytes

__all__ = [
    "ModelConfig", "MoEConfig",
    "TOY_CONFIG", "LLAMA_7B_CONFIG", "QWEN3_CONFIG", "MIXTRAL_MOE_CONFIG",
    "init_params", "forward", "count_parameters", "block_forward",
    "router", "moe_layer", "init_moe_params", "expert_load_balance_loss",
    "ExpertCache", "MoEInferencePlanner",
    "QuantizedTensor", "quantize_params_int8", "quantized_param_bytes",
]
