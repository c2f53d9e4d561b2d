"""Normalization ops (capability parity: ref ch01/transformer.py:9-17 RMSNorm)."""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def rms_norm(x: jnp.ndarray, weight: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    """x / rms(x) * weight, reducing over the last axis.

    Computes the reduction in fp32 regardless of input dtype (bf16 activations
    lose too much in the mean-of-squares), then casts back — the standard
    mixed-precision treatment; the op is memory-bound, so the fp32 math is
    free, and XLA fuses the whole op into neighbors.
    """
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    ms = jnp.mean(xf * xf, axis=-1, keepdims=True)
    normed = xf * lax.rsqrt(ms + eps)
    return (normed * weight.astype(jnp.float32)).astype(dtype)
