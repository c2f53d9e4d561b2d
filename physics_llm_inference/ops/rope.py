"""Rotary position embeddings.

The reference model has no positional encoding at all (ch01/transformer.py
embeds tokens only) — fine for teaching attention mechanics, but real
Llama/Qwen-class checkpoints (the 7B north star) require RoPE. Implemented with
precomputed cos/sin tables gathered by position index, so the
decode step is a cheap fused elementwise op with no trig inside the hot loop.
"""
from __future__ import annotations

import jax.numpy as jnp


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float = 10000.0):
    """Precompute (cos, sin) tables of shape (max_seq_len, head_dim//2), fp32."""
    inv_freq = 1.0 / (theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32) / head_dim))
    pos = jnp.arange(max_seq_len, dtype=jnp.float32)
    angles = pos[:, None] * inv_freq[None, :]
    return jnp.cos(angles), jnp.sin(angles)


def apply_rope(x: jnp.ndarray, cos: jnp.ndarray, sin: jnp.ndarray,
               positions: jnp.ndarray) -> jnp.ndarray:
    """Rotate (B, S, H, D) by per-token positions (B, S).

    Uses the half-split convention (rotate_half), matching Llama-family
    checkpoints.
    """
    dtype = x.dtype
    c = cos[positions]  # (B, S, D/2)
    s = sin[positions]
    c = c[:, :, None, :]
    s = s[:, :, None, :]
    xf = x.astype(jnp.float32)
    d2 = x.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    out = jnp.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], axis=-1)
    return out.astype(dtype)
