"""Paged-KV transformer step functions.

The model side of true paged serving: KV lives in per-layer block pools
managed by runtime/paged_kv.py block tables. Decode attends through the
block table (the INT8 decode kernel on a GPU, kernels/decode_attention.py;
a gather of the live blocks in XLA otherwise), and chunked prefill
scatters its blocks, then attends its rectangular window over the request's
gathered prefix.

Shapes are fully static: (batch, max_blocks_per_request, chunk buckets) are
compile-time; per-request raggedness rides in block tables and lengths.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..kernels.decode_attention import (decode_attention_xla, dequant_pages,
                                        gather_pages, int8_decode_attention)
from ..kernels.quant import quantize_int8
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_frequencies
from .config import ModelConfig
from .transformer import (QuantKV, _attend, _ffn, _linear, _tp_psum,
                          embed_lookup, layer_view, lm_logits)


def _rope_tables(cfg: ModelConfig):
    if not cfg.use_rope:
        return None, None
    return rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta)


def _merged_pages(kv_pools: QuantKV):
    """View merged pools (L, NB, 2, bs, ...) as (L, 2·NB, bs, ...) pages:
    block n's K page is 2n, its V page 2n+1 (a free reshape)."""
    return tuple(a.reshape(a.shape[0], a.shape[1] * 2, *a.shape[3:])
                 for a in kv_pools)


def _paged_int8_attention(q, kv_pools: QuantKV, tables, lengths, layer):
    """Decode attention over merged int8 pools for (B, Hq, d) queries whose
    tokens [0, lengths) live in the blocks of `tables`."""
    kv, kvs = _merged_pages(kv_pools)
    return int8_decode_attention(q, kv, kvs, kv, kvs, 2 * tables,
                                 2 * tables + 1, jnp.zeros_like(lengths),
                                 lengths, layer)


def _paged_decode_step_impl(params, tokens: jnp.ndarray,
                            k_pools, v_pools,
                            tables: jnp.ndarray, lengths: jnp.ndarray,
                            cfg: ModelConfig):
    """One decode step for all requests over paged KV.

    tokens: (B,) current token per request; k_pools/v_pools:
    dense pools (L, num_blocks, bs, Hkv, hd), or the merged QuantKV int8
    pools (each block's K and V pages side by side; see
    serve/paged_engine.py) with v_pools=None; tables: (B, max_blocks) int32;
    lengths: (B,) tokens already in cache (the new token lands at
    position `lengths`). Returns (logits (B, V), k_pools, v_pools).
    """
    b = tokens.shape[0]
    quantized = isinstance(k_pools, QuantKV)
    # quantized pools are MERGED: k_pools carries the K+V pair
    # (L, NB, 2, BS, Hkv·hd) / (L, NB, 2, BS, Hkv) and v_pools is None
    bs = k_pools.q.shape[3] if quantized else k_pools.shape[2]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    x = embed_lookup(params, tokens, cfg)[:, None, :]
    cos, sin = _rope_tables(cfg)
    positions = lengths[:, None]
    block_ids = tables[jnp.arange(b), lengths // bs]
    offsets = lengths % bs

    # Pools ride the scan CARRY (one stacked buffer, in-place aliased
    # updates); threading them through xs/ys makes XLA rebuild the whole
    # (L, nb, bs, Hkv, hd) stack every step.
    def body(carry, l):
        x, k_pools, v_pools = carry
        bp = layer_view(params["blocks"], l)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        qkv = _linear(h, bp["wqkv"])
        q, k, v = jnp.split(qkv, [hq * hd, (hq + hkv) * hd], axis=-1)
        q = q.reshape(b, 1, hq, hd)
        k = k.reshape(b, 1, hkv, hd)
        v = v.reshape(b, 1, hkv, hd)
        if cos is not None:
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
        if quantized:
            # merged QuantKV pools: flat int8 values + scales, K at dim-2
            # index 0, V at index 1
            kq8, ksc = quantize_int8(k[:, 0], axis=-1)
            vq8, vsc = quantize_int8(v[:, 0], axis=-1)
            k_pools = QuantKV(
                q=k_pools.q.at[l, block_ids, 0, offsets].set(
                    kq8.reshape(b, hkv * hd)).at[l, block_ids, 1,
                                                 offsets].set(
                    vq8.reshape(b, hkv * hd)),
                s=k_pools.s.at[l, block_ids, 0, offsets].set(
                    ksc[..., 0]).at[l, block_ids, 1, offsets].set(
                    vsc[..., 0]))
            attn = _paged_int8_attention(q[:, 0], k_pools, tables,
                                         lengths + 1, l)
        else:
            k_pools = k_pools.at[l, block_ids, offsets].set(
                k[:, 0].astype(k_pools.dtype))
            v_pools = v_pools.at[l, block_ids, offsets].set(
                v[:, 0].astype(v_pools.dtype))
            lv = lambda a: lax.dynamic_index_in_dim(a, l, 0, keepdims=False)
            attn = decode_attention_xla(
                q[:, 0], gather_pages(lv(k_pools), tables),
                gather_pages(lv(v_pools), tables),
                jnp.zeros_like(lengths), lengths + 1)
        x = x + _tp_psum(_linear(attn.reshape(b, 1, hq * hd), bp["wo"]), cfg)
        # dense fused SwiGLU or routed MoE (cfg.num_experts > 0) — the same
        # _ffn dispatch as the slot/dense path (transformer.py), so MoE
        # models serve through the paged engine too
        x = x + _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps), cfg)
        return (x, k_pools, v_pools), None

    (x, k_pools, v_pools), _ = lax.scan(
        body, (x, k_pools, v_pools), jnp.arange(cfg.num_layers))
    logits = lm_logits(x, params, cfg)
    return logits[:, 0], k_pools, v_pools


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(2, 3))
def paged_decode_step(params, tokens: jnp.ndarray,
                      k_pools, v_pools,
                      tables: jnp.ndarray, lengths: jnp.ndarray,
                      cfg: ModelConfig):
    """Jitted single decode step (see _paged_decode_step_impl)."""
    return _paged_decode_step_impl(params, tokens, k_pools, v_pools,
                                   tables, lengths, cfg)


def paged_decode_scan_impl(params, tokens: jnp.ndarray,
                           k_pools, v_pools,
                           tables: jnp.ndarray, lengths: jnp.ndarray,
                           rng: jax.Array, temps: jnp.ndarray,
                           top_ps: jnp.ndarray, cfg: ModelConfig,
                           horizon: int = 1, top_ks=None,
                           filtered: bool = True):
    """Multi-step paged decode: `horizon` tokens per dispatch, fully
    in-device (sampling included) — the paged engine's multi-step
    scheduling path (EngineConfig.decode_horizon equivalent). Block tables
    must already cover lengths+horizon (the engine pre-extends). Returns
    (tokens (B, horizon), k_pools, v_pools).

    `filtered=False` statically drops top-k/top-p (no per-step vocab sort);
    `top_ks` (B,) int32 enables per-request top-k when filtered.

    Unjitted: the engine jits this directly (single device) or inside a
    shard_map over the 'model' mesh axis (TP serving)."""
    from ..ops.sampling import sample_token

    def one(carry, _):
        tok, k, v, lens, rng = carry
        logits, k, v = _paged_decode_step_impl(params, tok, k, v, tables,
                                               lens, cfg)
        rng, sub = jax.random.split(rng)
        nxt = sample_token(
            logits, sub, temperature=temps,
            top_k=(top_ks if (filtered and top_ks is not None) else 0),
            top_p=top_ps if filtered else None).astype(jnp.int32)
        return (nxt, k, v, lens + 1, rng), nxt

    (_, k_pools, v_pools, _, _), toks = jax.lax.scan(
        one, (tokens, k_pools, v_pools, lengths, rng), None, length=horizon)
    return jnp.swapaxes(toks, 0, 1), k_pools, v_pools


paged_decode_scan = partial(jax.jit,
                            static_argnames=("cfg", "horizon", "filtered"),
                            donate_argnums=(2, 3))(paged_decode_scan_impl)


def paged_prefill_chunk_impl(params, ids: jnp.ndarray,
                             k_pools: jnp.ndarray, v_pools: jnp.ndarray,
                             table: jnp.ndarray, start: jnp.ndarray,
                             nvalid: jnp.ndarray, cfg: ModelConfig):
    """Prefill one chunk of R requests into their paged blocks, BATCHED.

    ids: (R, C) chunk tokens right-padded; table: (R, max_blocks) block
    tables; start: (R,) each chunk's first global position; nvalid: (R,)
    real tokens per chunk (0 = padding row: no writes, garbage logits the
    caller ignores). Attends over each request's prefix gathered from the
    pool plus the chunk itself, causally from each request's own offset.
    Returns (last-valid-position logits (R, V), k_pools, v_pools).

    Batched over requests: one (R, C) dispatch instead of R (1, C) ones.
    A 1D table / scalar start are promoted to a batch of one.
    """
    if table.ndim == 1:
        table = table[None]
        start = jnp.asarray(start).reshape(1)
        nvalid = jnp.asarray(nvalid).reshape(1)
    R, c = ids.shape
    quantized = isinstance(k_pools, QuantKV)
    # quantized pools are MERGED: k_pools carries the K+V pair, v_pools
    # is None (see _paged_decode_step_impl)
    bs = k_pools.q.shape[3] if quantized else k_pools.shape[2]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    max_blocks = table.shape[1]
    prefix_cap = max_blocks * bs  # static gather width

    x = embed_lookup(params, ids, cfg)
    cos, sin = _rope_tables(cfg)
    positions = start[:, None] + jnp.arange(c)[None, :]     # (R, C)
    # scatter targets for the chunks' tokens, flattened over (R·C)
    nb = (k_pools.q if quantized else k_pools).shape[1]
    blk = jnp.take_along_axis(table, positions // bs, axis=1)
    blk = jnp.where(jnp.arange(c)[None, :] < nvalid[:, None], blk,
                    nb).reshape(R * c)                      # drop padding
    off = (positions % bs).reshape(R * c)

    # Pools in the scan carry for the same in-place-aliasing reason as the
    # decode step above.
    def body(carry, l):
        x, k_pools, v_pools = carry
        bp = layer_view(params["blocks"], l)
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        qkv = _linear(h, bp["wqkv"])
        q, k, v = jnp.split(qkv, [hq * hd, (hq + hkv) * hd], axis=-1)
        q = q.reshape(R, c, hq, hd)
        k = k.reshape(R, c, hkv, hd)
        v = v.reshape(R, c, hkv, hd)
        if cos is not None:
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
        if quantized:
            kq8, ksc = quantize_int8(k.reshape(R * c, hkv, hd), axis=-1)
            vq8, vsc = quantize_int8(v.reshape(R * c, hkv, hd), axis=-1)
            k_pools = QuantKV(
                q=k_pools.q.at[l, blk, 0, off].set(
                    kq8.reshape(R * c, hkv * hd), mode="drop")
                .at[l, blk, 1, off].set(
                    vq8.reshape(R * c, hkv * hd), mode="drop"),
                s=k_pools.s.at[l, blk, 0, off].set(ksc[..., 0], mode="drop")
                .at[l, blk, 1, off].set(vsc[..., 0], mode="drop"))
            kv, kvs = (lax.dynamic_index_in_dim(a, l, 0, keepdims=False)
                       for a in _merged_pages(k_pools))
            k_seq = dequant_pages(kv, kvs, 2 * table, hkv, q.dtype)
            v_seq = dequant_pages(kv, kvs, 2 * table + 1, hkv, q.dtype)
        else:
            k_pools = k_pools.at[l, blk, off].set(
                k.reshape(R * c, hkv, hd).astype(k_pools.dtype),
                mode="drop")
            v_pools = v_pools.at[l, blk, off].set(
                v.reshape(R * c, hkv, hd).astype(v_pools.dtype),
                mode="drop")
            # gather each request's whole (padded) KV range contiguously:
            # (max_blocks·bs, Hkv, hd) — includes the chunk just written
            k_pool = lax.dynamic_index_in_dim(k_pools, l, 0, keepdims=False)
            v_pool = lax.dynamic_index_in_dim(v_pools, l, 0, keepdims=False)
            k_seq = k_pool[table].reshape(R, prefix_cap, hkv, hd)
            v_seq = v_pool[table].reshape(R, prefix_cap, hkv, hd)
        attn = _attend(q.transpose(0, 2, 1, 3),
                       k_seq.transpose(0, 2, 1, 3).astype(q.dtype),
                       v_seq.transpose(0, 2, 1, 3).astype(q.dtype),
                       positions, jnp.arange(prefix_cap))
        attn = attn.transpose(0, 2, 1, 3).reshape(R, c, hq * hd)
        x = x + _tp_psum(_linear(attn, bp["wo"]), cfg)
        x = x + _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps), cfg)
        return (x, k_pools, v_pools), None

    (x, k_pools, v_pools), _ = lax.scan(
        body, (x, k_pools, v_pools), jnp.arange(cfg.num_layers))
    logits = lm_logits(x, params, cfg)
    last = jnp.take_along_axis(
        logits, jnp.maximum(nvalid - 1, 0)[:, None, None], axis=1)
    return last[:, 0], k_pools, v_pools


paged_prefill_chunk = partial(jax.jit, static_argnames=("cfg",),
                              donate_argnums=(2, 3))(paged_prefill_chunk_impl)
