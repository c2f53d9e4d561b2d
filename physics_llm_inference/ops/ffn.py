"""FFN variants (capability parity: ref ch01/ffn.py — NaiveFFN L6, SwiGLUFFN L19,
FusedSwiGLUFFN L34).

The fused variant concatenates gate and up projections into one (D, 2F) matmul
— one matmul instead of two — and splits the result, exactly the trick the
reference teaches (ch01/ffn.py:43-44); XLA fuses the split/silu/mul into
neighbouring ops.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import nn


def ffn_relu(x: jnp.ndarray, w_up: jnp.ndarray, w_down: jnp.ndarray) -> jnp.ndarray:
    """relu(x @ w_up) @ w_down (ref ch01/ffn.py:6-16)."""
    return nn.relu(x @ w_up) @ w_down


def swiglu(x: jnp.ndarray, w_gate: jnp.ndarray, w_up: jnp.ndarray,
           w_down: jnp.ndarray) -> jnp.ndarray:
    """(silu(x@w_gate) * (x@w_up)) @ w_down (ref ch01/ffn.py:19-31)."""
    return (nn.silu(x @ w_gate) * (x @ w_up)) @ w_down


def fused_swiglu(x: jnp.ndarray, w_gate_up: jnp.ndarray,
                 w_down: jnp.ndarray) -> jnp.ndarray:
    """SwiGLU with fused gate+up weight (D, 2F), split after one matmul
    (ref ch01/ffn.py:34-47)."""
    gu = x @ w_gate_up
    gate, up = jnp.split(gu, 2, axis=-1)
    return (nn.silu(gate) * up) @ w_down
