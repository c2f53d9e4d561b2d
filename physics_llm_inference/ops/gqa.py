"""Grouped-query attention (capability parity: ref ch01/gqa.py:8-43).

Design note: the reference expands K/V with repeat_interleave
(ch01/gqa.py:30-31), materializing num_groups copies. Here queries are instead
reshaped to (B, Skv_heads, group, S, D) and contracted against the *unexpanded*
K/V with einsum — no copies, and XLA emits a single batched matmul with the
group dim folded into rows.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
from jax import nn

from .attention import _NEG_INF


def grouped_sdpa(q, k, v, mask=None, scale=None):
    """Attention with grouped heads, no KV expansion.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); Hq % Hkv == 0.
    mask: broadcastable to (Sq, Sk), True = attend.
    """
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    assert hq % hkv == 0, "num_heads must be divisible by num_kv_heads"
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, sq, d)
    scores = jnp.einsum("bhgqd,bhkd->bhgqk", qg, k,
                        preferred_element_type=jnp.float32) * scale
    if mask is not None:
        scores = jnp.where(mask, scores, _NEG_INF)
    weights = nn.softmax(scores, axis=-1)
    out = jnp.einsum("bhgqk,bhkd->bhgqd", weights.astype(q.dtype), v,
                     preferred_element_type=jnp.float32)
    return out.reshape(b, hq, sq, d).astype(q.dtype)


def grouped_sdpa_bshd(q, k, v, mask=None, scale=None):
    """grouped_sdpa over tensors in their PROJECTION layout (B, S, H, D) —
    no (B, H, S, D) transposes in or out.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); returns (B, Sq, Hq·D).
    Same math as grouped_sdpa — softmax in f32, mask True = attend,
    broadcastable to (B, 1, 1, Sq, Sk) against scores (B, Hkv, G, Sq, Sk).

    The plain XLA decode path over gathered pages
    (kernels/decode_attention.decode_attention_xla) attends through it.
    """
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    assert hq % hkv == 0, "num_heads must be divisible by num_kv_heads"
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, g, d)
    scores = jnp.einsum("bqhgd,bkhd->bhgqk", qg, k,
                        preferred_element_type=jnp.float32) * scale
    if mask is not None:
        scores = jnp.where(mask, scores, _NEG_INF)
    weights = nn.softmax(scores, axis=-1)
    out = jnp.einsum("bhgqk,bkhd->bqhgd", weights.astype(q.dtype), v,
                     preferred_element_type=jnp.float32)
    return out.reshape(b, sq, hq * d).astype(q.dtype)


def gqa_attention(
    x: jnp.ndarray,
    wq: jnp.ndarray, wk: jnp.ndarray, wv: jnp.ndarray, wo: jnp.ndarray,
    num_heads: int, num_kv_heads: int,
    causal: bool = True,
    rope_cos: jnp.ndarray | None = None,
    rope_sin: jnp.ndarray | None = None,
    positions: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """GQA over (B, S, D): project, (optional RoPE), grouped SDPA, output proj.

    wq: (D, Hq·hd), wk/wv: (D, Hkv·hd), wo: (Hq·hd, D).
    Parity surface of ref ch01/gqa.py:22-39 plus optional rotary embedding.
    """
    b, s, dim = x.shape
    head_dim = wq.shape[1] // num_heads
    q = (x @ wq).reshape(b, s, num_heads, head_dim)
    k = (x @ wk).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ wv).reshape(b, s, num_kv_heads, head_dim)
    if rope_cos is not None:
        from .rope import apply_rope

        if positions is None:
            positions = jnp.broadcast_to(jnp.arange(s)[None, :], (b, s))
        q = apply_rope(q, rope_cos, rope_sin, positions)
        k = apply_rope(k, rope_cos, rope_sin, positions)
    q = q.transpose(0, 2, 1, 3)  # (B, Hq, S, D)
    k = k.transpose(0, 2, 1, 3)
    v = v.transpose(0, 2, 1, 3)
    mask = None
    if causal:
        idx = jnp.arange(s)
        mask = idx[None, :] <= idx[:, None]
    out = grouped_sdpa(q, k, v, mask=mask)
    out = out.transpose(0, 2, 1, 3).reshape(b, s, num_heads * head_dim)
    return out @ wo


def kv_cache_bytes_per_token(num_kv_heads: int, head_dim: int,
                             dtype_bytes: int = 2) -> int:
    """2 · Hkv · D · bytes — per token per layer (ref ch01/gqa.py:41-43,
    ch02/kv_cache.py:104-122)."""
    return 2 * num_kv_heads * head_dim * dtype_bytes
