"""Dense KV cache.

Capability parity: ref ch02/kv_cache.py (KVCache dataclass L9-51: preallocated
(B, max_S, Hkv, hd) K/V, in-place append, memory accounting;
calculate_kv_cache_size L104-122). The paged variant lives in paged_kv.py.

The cache is a frozen pytree of fixed-shape jax arrays, stacked
over layers (L, B, max_S, Hkv, hd) so the model's layer-scan threads it in one
pass; "in-place append" is lax.dynamic_update_slice inside jit (XLA aliases
the buffer donation so no copy materializes when threaded through a jitted
step with donate_argnums).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..models.config import ModelConfig
from ..models.transformer import KVSlice, QuantKV


class KVCache(NamedTuple):
    """Stacked per-layer K/V + fill length. A pytree — jit-transparent.

    dtype="int8" builds the framework-native QuantKV format (int8 values +
    per-token-per-head scales); the model's cache read/write path dispatches
    on the type (models/transformer.py _cache_write/_cache_read).
    """

    k: jnp.ndarray | QuantKV  # (L, B, max_S, Hkv, hd)
    v: jnp.ndarray | QuantKV
    length: jnp.ndarray  # scalar int32: slots filled so far

    @classmethod
    def create(cls, cfg: ModelConfig, batch_size: int, max_seq_len: int,
               dtype=None) -> "KVCache":
        shape = (cfg.num_layers, batch_size, max_seq_len, cfg.num_kv_heads,
                 cfg.head_dim)
        if dtype is not None and jnp.dtype(dtype) == jnp.int8:
            # flat values + token-major scales — see QuantKV docstring
            qshape = (cfg.num_layers, batch_size, max_seq_len,
                      cfg.num_kv_heads * cfg.head_dim)
            sshape = (cfg.num_layers, batch_size, max_seq_len,
                      cfg.num_kv_heads)
            mk = lambda: QuantKV(q=jnp.zeros(qshape, jnp.int8),
                                 s=jnp.zeros(sshape, jnp.float32))
            return cls(k=mk(), v=mk(), length=jnp.int32(0))
        dtype = dtype or jnp.dtype(cfg.dtype)
        return cls(k=jnp.zeros(shape, dtype), v=jnp.zeros(shape, dtype),
                   length=jnp.int32(0))

    def as_slice(self) -> KVSlice:
        return KVSlice(self.k, self.v, self.length)

    @classmethod
    def from_slice(cls, s: KVSlice) -> "KVCache":
        return cls(k=s.k, v=s.v, length=s.start)

    @property
    def max_seq_len(self) -> int:
        k = self.k.q if isinstance(self.k, QuantKV) else self.k
        return k.shape[2]

    def memory_bytes(self) -> int:
        """Total bytes of both caches incl. quant scales
        (ref ch02/kv_cache.py:49-51)."""
        import jax

        return sum(x.nbytes for x in jax.tree_util.tree_leaves((self.k, self.v)))


def calculate_kv_cache_size(
    batch_size: int, seq_len: int, num_layers: int, num_kv_heads: int,
    head_dim: int, dtype_bytes: int = 2,
) -> dict:
    """Analytic KV sizing (ref ch02/kv_cache.py:104-122): per-token-per-layer,
    per-token, and total bytes."""
    per_token_per_layer = 2 * num_kv_heads * head_dim * dtype_bytes
    per_token = per_token_per_layer * num_layers
    total = per_token * batch_size * seq_len
    return {
        "bytes_per_token_per_layer": per_token_per_layer,
        "bytes_per_token": per_token,
        "total_bytes": total,
        "total_gb": total / 1e9,
    }
