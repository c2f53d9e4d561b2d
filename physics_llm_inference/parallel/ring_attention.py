"""Ring attention: sequence-parallel causal attention over a device ring.

ADDITIVE capability beyond the reference — it has no sequence/context
parallelism at all (SURVEY.md §5 long-context: flash tiling + chunked prefill
only). For contexts whose KV exceeds one card's memory, shard the sequence over
a mesh axis: each device keeps its query chunk resident and the K/V chunks
rotate around the ring with lax.ppermute (XLA lowers to peer-to-peer
transfers), while the online-softmax state (m, l, o) accumulates locally —
the same recurrence as the flash kernel (ops/softmax.py), applied across
devices instead of on-chip tiles. Compute overlaps the next hop's transfer
because XLA schedules the ppermute asynchronously.

Cost: n-1 hops of the local KV chunk per layer — bandwidth-optimal (each
byte crosses each link once), matching specs/collectives.py's all-gather model
without ever materializing the gathered sequence.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

_NEG_INF = -1e30


def ring_attention(mesh: Mesh, q: jnp.ndarray, k: jnp.ndarray,
                   v: jnp.ndarray, axis: str = "model",
                   causal: bool = True) -> jnp.ndarray:
    """Causal (GQA) attention with the sequence sharded over `axis`.

    q: (B, Hq, S, D); k, v: (B, Hkv, S, D) — full logical shapes; S must
    divide the axis size. Returns (B, Hq, S, D), sharded like q.
    """
    n = mesh.shape[axis]
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    assert s % n == 0, "sequence must divide the ring size"
    assert hq % hkv == 0
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    perm = [(i, (i + 1) % n) for i in range(n)]

    def fn(q, k, v):
        # local shapes: q (B, Hq, S/n, D); k, v (B, Hkv, S/n, D)
        my = jax.lax.axis_index(axis)
        s_loc = q.shape[2]
        qf = q.astype(jnp.float32)
        q_pos = my * s_loc + jnp.arange(s_loc)

        m = jnp.full((b, hq, s_loc, 1), _NEG_INF, jnp.float32)
        l = jnp.zeros((b, hq, s_loc, 1), jnp.float32)
        o = jnp.zeros((b, hq, s_loc, d), jnp.float32)
        kv = (k.astype(jnp.float32), v.astype(jnp.float32))

        for t in range(n):
            src = (my - t) % n          # whose chunk we currently hold
            kc = jnp.repeat(kv[0], group, axis=1)
            vc = jnp.repeat(kv[1], group, axis=1)
            sc = jnp.einsum("bhqd,bhkd->bhqk", qf, kc,
                            preferred_element_type=jnp.float32) * scale
            if causal:
                k_pos = src * s_loc + jnp.arange(s_loc)
                mask = k_pos[None, :] <= q_pos[:, None]
                sc = jnp.where(mask[None, None], sc, _NEG_INF)
            m_new = jnp.maximum(m, jnp.max(sc, axis=-1, keepdims=True))
            alpha = jnp.exp(m - m_new)
            p = jnp.exp(sc - m_new)
            l = l * alpha + jnp.sum(p, axis=-1, keepdims=True)
            o = o * alpha + jnp.einsum("bhqk,bhkd->bhqd", p, vc)
            m = m_new
            if t + 1 < n:
                kv = jax.lax.ppermute(kv, axis, perm)

        safe_l = jnp.where(l > 0, l, 1.0)
        return (o / safe_l).astype(q.dtype)

    fn_sharded = shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, None, axis, None),) * 3,
        out_specs=P(None, None, axis, None),
    )
    return fn_sharded(q, k, v)
