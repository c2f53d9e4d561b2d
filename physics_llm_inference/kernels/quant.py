"""INT8 quantization primitives.

The framework's native number format (BASELINE.json north star: INT8 weights
+ INT8 KV). Symmetric per-axis absmax quantization: q = round(x/s),
s = absmax/127 along the reduction-invariant axis (per output channel for
weights, per head for KV) — the standard recipe that holds the 0.1-perplexity
budget without calibration data.

Pure-JAX ops (XLA fuses them into neighbors); the consumer that dequantizes
inside its tiles is the decode attention kernel (decode_attention.py).
"""
from __future__ import annotations

import jax.numpy as jnp

INT8_MAX = 127.0


def quantize_int8(x: jnp.ndarray, axis: int | tuple[int, ...] = -1,
                  eps: float = 1e-8):
    """Symmetric per-axis quantization. Returns (q int8, scale f32).

    `axis` is the axis (or axes) REDUCED to compute absmax — scale broadcasts
    over it. E.g. weights (K, N) with axis=0 → per-output-channel (1, N).
    """
    absmax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=axis, keepdims=True)
    scale = jnp.maximum(absmax, eps) / INT8_MAX
    q = jnp.clip(jnp.round(x.astype(jnp.float32) / scale), -127, 127)
    return q.astype(jnp.int8), scale


def dequantize_int8(q: jnp.ndarray, scale: jnp.ndarray,
                    dtype=jnp.float32) -> jnp.ndarray:
    return (q.astype(jnp.float32) * scale).astype(dtype)


def quantization_error(x: jnp.ndarray, axis=-1) -> dict:
    """RMS/max relative error of a quantize→dequantize round trip — the
    per-tensor health check behind the perplexity budget."""
    q, s = quantize_int8(x, axis=axis)
    xhat = dequantize_int8(q, s)
    err = (x.astype(jnp.float32) - xhat)
    denom = jnp.maximum(jnp.sqrt(jnp.mean(x.astype(jnp.float32) ** 2)), 1e-8)
    return {
        "rms_rel_error": float(jnp.sqrt(jnp.mean(err ** 2)) / denom),
        "max_abs_error": float(jnp.max(jnp.abs(err))),
    }
