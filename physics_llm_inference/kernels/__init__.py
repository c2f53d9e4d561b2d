"""Quantization primitives and the one hand-written GPU kernel.

`decode_attention` holds the INT8-KV paged decode attention kernel (Pallas,
Triton route) beside its plain XLA reference; `quant` holds the symmetric
INT8 quantizers every INT8 path shares. Everything else in the model is
plain JAX left to XLA.
"""
from .quant import quantize_int8, dequantize_int8

__all__ = ["quantize_int8", "dequantize_int8"]
