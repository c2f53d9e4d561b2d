"""Attention ops + memory/FLOPs accounting.

Capability parity with ref ch01/attention.py (naive_attention L8-13,
causal_attention L16-23, MultiHeadAttention L45-72) and the analysis half of
ref ch06/attention_memory.py (bytes L36-61, FLOPs L64-76, AI L79-87).

Choices: softmax statistics in fp32 with bf16 matmul inputs
(`preferred_element_type=float32` accumulates in fp32 on the tensor cores);
large-negative masking via jnp.where so XLA fuses mask+softmax; heads kept as
a leading batch axis so the (S, S) score matmuls are one batched GEMM.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
from jax import nn

_NEG_INF = -1e30  # finite large-negative: avoids NaN from (-inf) - (-inf) in softmax


def _sdpa(q, k, v, mask=None, scale=None):
    """Scaled dot-product attention over (..., S, D) with optional bool mask
    (True = keep). Scores/softmax in fp32, output cast back to q.dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = jnp.einsum("...qd,...kd->...qk", q, k,
                        preferred_element_type=jnp.float32) * scale
    if mask is not None:
        scores = jnp.where(mask, scores, _NEG_INF)
    weights = nn.softmax(scores, axis=-1)
    out = jnp.einsum("...qk,...kd->...qd", weights.astype(q.dtype), v,
                     preferred_element_type=jnp.float32)
    return out.astype(q.dtype)


def naive_attention(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Unmasked attention (ref ch01/attention.py:8-13; ch06/attention_memory.py:19-33
    uses the same math at (B, H, N, D))."""
    return _sdpa(q, k, v)


def causal_attention(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray,
                     offset: int = 0) -> jnp.ndarray:
    """Causal attention (ref ch01/attention.py:16-23).

    `offset` supports the rectangular prefill/decode case where q covers
    positions [offset, offset+Sq) of a K/V of length Sk (ref
    ch02/kv_cache.py:91-94's `diagonal=full-new+1` mask).
    """
    sq, sk = q.shape[-2], k.shape[-2]
    qi = jnp.arange(sq)[:, None] + offset
    ki = jnp.arange(sk)[None, :]
    mask = ki <= qi  # (Sq, Sk), True = attend
    return _sdpa(q, k, v, mask=mask)


def multi_head_attention(
    x: jnp.ndarray,
    wq: jnp.ndarray, wk: jnp.ndarray, wv: jnp.ndarray, wo: jnp.ndarray,
    num_heads: int,
    causal: bool = True,
) -> jnp.ndarray:
    """Full MHA over (B, S, D) with weight matrices (D, D) (ref
    ch01/attention.py:45-72). Thin wrapper over gqa_attention with
    num_kv_heads == num_heads."""
    from .gqa import gqa_attention

    return gqa_attention(x, wq, wk, wv, wo, num_heads, num_heads, causal=causal)


# --- analysis (ref ch06/attention_memory.py) ---------------------------------

def attention_flops(batch: int, heads: int, seq: int, head_dim: int) -> int:
    """FLOPs of the two score/value matmuls: 2 * (2·S²·D) per head (ref :64-76)."""
    return batch * heads * (2 * seq * seq * head_dim) * 2


def attention_memory_bytes(batch: int, heads: int, seq: int, head_dim: int,
                           dtype_bytes: int = 2) -> dict:
    """HBM bytes of naive attention: Q/K/V/O plus the materialized (S, S)
    score + weight matrices that flash attention eliminates (ref :36-61)."""
    qkvo = 4 * batch * heads * seq * head_dim * dtype_bytes
    scores = 2 * batch * heads * seq * seq * dtype_bytes  # scores + softmax weights
    return {"qkvo_bytes": qkvo, "scores_bytes": scores, "total_bytes": qkvo + scores}


def attention_arithmetic_intensity(batch: int, heads: int, seq: int,
                                   head_dim: int, dtype_bytes: int = 2) -> float:
    """FLOP/byte of naive attention (ref :79-87)."""
    flops = attention_flops(batch, heads, seq, head_dim)
    mem = attention_memory_bytes(batch, heads, seq, head_dim, dtype_bytes)
    return flops / mem["total_bytes"]


def max_attendable_seq(hbm_budget_bytes: int, batch: int, heads: int,
                       head_dim: int, dtype_bytes: int = 2,
                       flash: bool = False) -> int:
    """Largest S whose attention working set fits an HBM budget — the
    analytic half of ref ch06/attention_memory.py:116-162's OOM sweep.
    Naive attention is quadratic in S (materialized scores); flash is
    linear (Q/K/V/O only), which is the whole point of the comparison."""
    lo, hi = 0, 1 << 24
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        m = attention_memory_bytes(batch, heads, mid, head_dim, dtype_bytes)
        used = m["qkvo_bytes"] if flash else m["total_bytes"]
        if used <= hbm_budget_bytes:
            lo = mid
        else:
            hi = mid
    return lo


def probe_attention_memory(batch: int = 1, heads: int = 32,
                           head_dim: int = 128, start_seq: int = 1024,
                           max_seq: int = 1 << 20, flash: bool = False,
                           dtype=None) -> dict:
    """DEVICE probe of the longest attendable context: doubles S until the
    allocation/computation OOMs, the on-device twin of the analytic sweep
    (ref ch06/attention_memory.py:116-162 probes CUDA OOM the same way).
    Returns per-S results plus the first failing S. Runs real allocations —
    expect RESOURCE_EXHAUSTED warnings from the runtime at the boundary."""
    import jax

    dtype = dtype or jnp.bfloat16
    results, failed_at = [], None
    s = start_seq
    while s <= max_seq:
        try:
            ks = jax.random.split(jax.random.PRNGKey(0), 3)
            q = jax.random.normal(ks[0], (batch, heads, s, head_dim), dtype)
            k = jax.random.normal(ks[1], (batch, heads, s, head_dim), dtype)
            v = jax.random.normal(ks[2], (batch, heads, s, head_dim), dtype)
            if flash:
                # cuDNN's fused (flash) attention on a GPU, XLA's elsewhere
                impl = "cudnn" if jax.default_backend() == "gpu" else None
                bshd = lambda t: t.transpose(0, 2, 1, 3)
                out = jax.nn.dot_product_attention(
                    bshd(q), bshd(k), bshd(v), is_causal=True,
                    implementation=impl)
            else:
                out = causal_attention(q, k, v)
            jax.block_until_ready(out)
            m = attention_memory_bytes(batch, heads, s, head_dim,
                                       jnp.dtype(dtype).itemsize)
            results.append({"seq": s, "ok": True,
                            "predicted_bytes": (m["qkvo_bytes"] if flash
                                                else m["total_bytes"])})
            del q, k, v, out
        except Exception as e:  # XlaRuntimeError RESOURCE_EXHAUSTED
            failed_at = s
            results.append({"seq": s, "ok": False,
                            "error": type(e).__name__})
            break
        s *= 2
    return {"results": results, "failed_at": failed_at, "flash": flash,
            "max_ok": max((r["seq"] for r in results if r["ok"]),
                          default=0)}
