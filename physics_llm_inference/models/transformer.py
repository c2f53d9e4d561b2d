"""Dense transformer model as pure functions over a stacked-parameter pytree.

Capability parity: ref ch01/transformer.py (TransformerBlock L20-44,
TransformerModel L47-100, count_parameters L89-100) and the cached forward of
ref ch02/cached_generation.py:137-187 (CachedTransformerBlock/Model) — here a
single code path serves both, selected by whether a KV cache is threaded in.

Structure:
- Layer weights are stacked on a leading num_layers axis and the forward pass
  is a jax.lax.scan over layers: one compiled block body, O(1) HLO size in
  depth (the reference's Python loop ch01/transformer.py:82-84 would unroll).
- KV caches are fixed-shape (L, B, max_S, Hkv, hd) arrays updated with
  lax.dynamic_update_slice and masked by position — no dynamic shapes, so a
  single compilation serves every step of decode (the CUDA-graph equivalent,
  ref ch08/cuda_graph.py:18-82).
- Attention masks combine causality and cache-validity in one predicate
  (k_pos <= q_pos), which covers square prefill, rectangular chunked prefill,
  and single-token decode (ref ch02/kv_cache.py:86-94's rectangular mask).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..kernels import decode_attention
from ..ops.gqa import grouped_sdpa
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_frequencies
from .config import ModelConfig


class StackedQuant(NamedTuple):
    """A layer's view into FULL-stack quantized weights (L, K, N)/(L, 1, N).

    Handed to _linear instead of a sliced per-layer QuantizedTensor: the
    layer is selected where the weight is consumed, so XLA can fuse the
    slice into the matmul's operand instead of copying it first."""

    w: Any               # QuantizedTensor with stacked leaves
    layer: jnp.ndarray   # traced int32 scalar


def layer_view(blocks: dict, l: jnp.ndarray) -> dict:
    """One layer's parameter view for a lax.scan body where only the layer
    INDEX rides xs. Quantized matmul weights become StackedQuant (sliced at
    the matmul); small leaves (norm scales) and non-2D quantized stacks (MoE
    experts) are dynamic-sliced, exactly what scanning them as xs would do."""
    from .quant import QuantizedTensor, QuantizedTensor4

    bp = {}
    for name, w in blocks.items():
        if isinstance(w, (QuantizedTensor, QuantizedTensor4)) \
                and w.q.ndim == 3:
            bp[name] = StackedQuant(w, l)
        elif isinstance(w, QuantizedTensor):
            bp[name] = QuantizedTensor(
                lax.dynamic_index_in_dim(w.q, l, 0, keepdims=False),
                lax.dynamic_index_in_dim(w.s, l, 0, keepdims=False))
        else:
            bp[name] = lax.dynamic_index_in_dim(w, l, 0, keepdims=False)
    return bp


def _linear(x: jnp.ndarray, w) -> jnp.ndarray:
    """Matmul dispatch: plain array → x @ w; QuantizedTensor → INT8
    weight-only path (int8 → activation-dtype convert feeding one dot with
    f32 accumulation, per-channel scale applied to the output); StackedQuant
    → the same with the layer sliced here. x: (..., K); returns (..., N)."""
    from .quant import QuantizedTensor, QuantizedTensor4

    layer = None
    if isinstance(w, StackedQuant):
        layer = w.layer
        w = w.w
    if isinstance(w, QuantizedTensor4):
        # INT4: unpack + group-scale this layer's weights in XLA and run a
        # dense matmul
        wd = (w.dequantize_layer(layer, x.dtype) if layer is not None
              else w.dequantize(x.dtype))
        n = wd.shape[-1]
        out = jnp.dot(x.reshape(-1, wd.shape[-2]), wd,
                      preferred_element_type=jnp.float32).astype(x.dtype)
        return out.reshape(*x.shape[:-1], n)
    if not isinstance(w, QuantizedTensor):
        if layer is not None:
            w = lax.dynamic_index_in_dim(w, layer, 0, keepdims=False)
        return x @ w
    w_q, scale = w.q, w.s
    if layer is not None:
        w_q = lax.dynamic_index_in_dim(w_q, layer, 0, keepdims=False)
        scale = lax.dynamic_index_in_dim(scale, layer, 0, keepdims=False)
    k, n = w_q.shape
    acc = jnp.dot(x.reshape(-1, k), w_q.astype(x.dtype),
                  preferred_element_type=jnp.float32)
    out = (acc * scale.reshape(1, n)).astype(x.dtype)
    return out.reshape(*x.shape[:-1], n)


class QuantKV(NamedTuple):
    """INT8 KV storage: int8 values + per-token-per-head f32 scales.

    The framework's native KV format: halves the cache's share of decode
    memory traffic against bf16. Per-(token, head) absmax scales keep the
    attention error inside the 0.1-ppl budget.

    Both arrays are token-major, as the decode kernel reads them
    (kernels/decode_attention.py): values FLAT, (..., S, Hkv·hd) — the same
    bytes as (..., S, Hkv, hd) — and scales (..., S, Hkv).
    """

    q: jnp.ndarray  # int8  (..., S, Hkv·hd)
    s: jnp.ndarray  # f32   (..., S, Hkv)


class KVSlice(NamedTuple):
    """Per-call KV threading: stacked caches + the write offset."""

    k: jnp.ndarray | QuantKV  # (L, B, max_S, Hkv, hd)
    v: jnp.ndarray | QuantKV
    start: jnp.ndarray  # int32 scalar or (B,): first slot of this call's tokens


def _cache_write(cache, new: jnp.ndarray, start: jnp.ndarray,
                 layer: jnp.ndarray | None = None):
    """Write `new` (B, s, H, hd) into the cache at slot offset(s) `start`
    (scalar, or (B,) for per-request offsets). Handles dense and QuantKV.

    With `layer`, the cache is the FULL stacked (L, B, S, H, hd) array and the
    write lands at that layer — the cache then lives in the layer-scan CARRY
    and every update aliases in place. (Threading per-layer caches through
    scan xs/ys instead makes XLA rebuild the entire cache every step.)"""
    def write(buf, val):
        val = val.astype(buf.dtype)
        if layer is None:
            if start.ndim == 0:
                return lax.dynamic_update_slice(buf, val, (0, start, 0, 0))
            return jax.vmap(lambda c, n, off: lax.dynamic_update_slice(
                c, n, (off, 0, 0)))(buf, val, start)
        if start.ndim == 0:
            return lax.dynamic_update_slice(buf, val[None],
                                            (layer, 0, start, 0, 0))
        # vmap over batch (axis 1 of the stacked cache)
        return jax.vmap(
            lambda c, n, off: lax.dynamic_update_slice(
                c, n[None], (layer, off, 0, 0)),
            in_axes=(1, 0, 0), out_axes=1)(buf, val, start)

    def write_flat(buf, val):
        # flat value layout (..., S, Hkv·hd): one rank lower than dense
        val = val.astype(buf.dtype)
        if layer is None:
            if start.ndim == 0:
                return lax.dynamic_update_slice(buf, val, (0, start, 0))
            return jax.vmap(lambda c, n, off: lax.dynamic_update_slice(
                c, n, (off, 0)))(buf, val, start)
        if start.ndim == 0:
            return lax.dynamic_update_slice(buf, val[None],
                                            (layer, 0, start, 0))
        return jax.vmap(
            lambda c, n, off: lax.dynamic_update_slice(
                c, n[None], (layer, off, 0)),
            in_axes=(1, 0, 0), out_axes=1)(buf, val, start)

    if isinstance(cache, QuantKV):
        from ..kernels.quant import quantize_int8

        qv, sv = quantize_int8(new, axis=-1)
        qv = qv.reshape(*qv.shape[:-2], -1)  # flat (B, s, Hkv·hd)
        # scales (B, s, Hkv) share the values' rank and token axis
        return QuantKV(q=write_flat(cache.q, qv),
                       s=write_flat(cache.s, sv[..., 0]))
    return write(cache, new)


def _cache_read_layer(cache, layer, dtype):
    """Layer slice of the stacked cache, dequantized to `dtype`."""
    def idx(buf):
        return lax.dynamic_index_in_dim(buf, layer, 0, keepdims=False)

    if isinstance(cache, QuantKV):
        s = idx(cache.s)[..., None]                     # (B, S, Hkv, 1)
        q = idx(cache.q)                                # (B, S, Hkv·hd)
        hkv = s.shape[2]
        q = q.reshape(*q.shape[:-1], hkv, -1)
        return (q.astype(jnp.float32) * s).astype(dtype)
    return idx(cache).astype(dtype)


def _cache_read(cache, dtype) -> jnp.ndarray:
    """Materialize the cache for attention in the compute dtype (dequantizes
    QuantKV; XLA fuses the dequant into the attention matmuls)."""
    if isinstance(cache, QuantKV):
        s = cache.s[..., None]                  # (..., S, Hkv, 1)
        hkv = s.shape[-2]
        q = cache.q.reshape(*cache.q.shape[:-1], hkv, -1)
        return (q.astype(jnp.float32) * s).astype(dtype)
    return cache.astype(dtype)


def init_params(rng: jax.Array, cfg: ModelConfig) -> dict:
    """Initialize a stacked-parameter pytree.

    Layout:
      embed:   (V, D)
      blocks:  each leaf has leading dim L —
        ln1 (L, D), wq (L, D, Hq·hd), wk/wv (L, D, Hkv·hd), wo (L, Hq·hd, D),
        ln2 (L, D), w_gate_up (L, D, 2F), w_down (L, F, D)
      norm:    (D,)
      lm_head: (D, V)
    """
    dtype = jnp.dtype(cfg.dtype)
    d, f, v, L = cfg.hidden_dim, cfg.intermediate_dim, cfg.vocab_size, cfg.num_layers
    hd = cfg.head_dim
    keys = jax.random.split(rng, 8)

    def w(key, shape, fan_in):
        return (jax.random.normal(key, shape) * (fan_in ** -0.5)).astype(dtype)

    # qkv fused into one projection: a single matmul / weight stream per
    # block instead of three (the ch01 fused-projection lesson applied to
    # attention); layout [q | k | v] on the output dim.
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    blocks = {
        "ln1": jnp.ones((L, d), dtype),
        "wqkv": w(keys[1], (L, d, qkv_out), d),
        "wo": w(keys[4], (L, cfg.num_heads * hd, d), d),
        "ln2": jnp.ones((L, d), dtype),
    }
    if cfg.num_experts > 0:
        e = cfg.num_experts
        ks = jax.random.split(keys[5], 4)
        blocks.update({
            "moe_gate": w(ks[0], (L, d, e), d),
            "moe_w1": w(ks[1], (L, e, d, f), d),
            "moe_w3": w(ks[2], (L, e, d, f), d),
            "moe_w2": w(ks[3], (L, e, f, d), f),
        })
    else:
        blocks.update({
            "w_gate_up": w(keys[5], (L, d, 2 * f), d),
            "w_down": w(keys[6], (L, f, d), f),
        })
    return {
        "embed": w(keys[0], (v, d), d),
        "blocks": blocks,
        "norm": jnp.ones((d,), dtype),
        "lm_head": w(keys[7], (d, v), d),
    }


def _tp_psum(y: jnp.ndarray, cfg: ModelConfig) -> jnp.ndarray:
    """Reduce a row-parallel partial product over the TP axis. Identity in
    single-device semantics; inside a shard_map body (cfg.tp_axis set) this
    is the per-block all-reduce the reference only documents
    (ref ch09/tensor_parallel.py:142-147) — XLA hands it to NCCL."""
    if cfg.tp_axis is None:
        return y
    return lax.psum(y, cfg.tp_axis)


def embed_lookup(params: dict, input_ids: jnp.ndarray,
                 cfg: ModelConfig) -> jnp.ndarray:
    """Token embedding in the compute dtype. Under TP (cfg.tp_axis) the
    embedding is vocab-ROW-sharded (Megatron layout): each shard looks up
    the ids in its row range, contributes 0 elsewhere, and one psum
    assembles the full embedding."""
    if cfg.tp_axis is None:
        return params["embed"][input_ids].astype(jnp.dtype(cfg.dtype))
    vloc = params["embed"].shape[0]
    idx = lax.axis_index(cfg.tp_axis)
    loc = input_ids - idx * vloc
    ok = (loc >= 0) & (loc < vloc)
    emb = params["embed"][jnp.clip(loc, 0, vloc - 1)]
    x = lax.psum(jnp.where(ok[..., None], emb, 0), cfg.tp_axis)
    return x.astype(jnp.dtype(cfg.dtype))


def lm_logits(x: jnp.ndarray, params: dict, cfg: ModelConfig) -> jnp.ndarray:
    """Final norm + lm_head. Under TP the head is column(vocab)-sharded, so
    the vocab shards are all-gathered — every TP rank then samples from
    identical full logits (rank-consistent next tokens)."""
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    logits = _linear(x, params["lm_head"]).astype(jnp.float32)
    if cfg.tp_axis is not None:
        logits = lax.all_gather(logits, cfg.tp_axis, axis=logits.ndim - 1,
                                tiled=True)
    return logits


def _ffn(bp: dict, h: jnp.ndarray, cfg: ModelConfig,
         valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """Block FFN: dense fused SwiGLU, or routed MoE when cfg.num_experts > 0
    (ref ch09/moe_layer.py integrated into the block — the reference never
    wires MoE into its transformer). `valid` masks padding tokens out of MoE
    routing so pads can't claim expert capacity (models/moe.py).

    Under TP (cfg.tp_axis): gate_up is column-sharded and w_down row-sharded,
    so the down projection yields a partial sum that is psum-reduced here.
    MoE expert weights replicate across TP (they shard over the 'expert'
    axis instead — parallel/ep.py), so the routed path needs no reduction."""
    if cfg.num_experts > 0:
        from .config import MoEConfig
        from .moe import moe_layer

        moe_cfg = MoEConfig(num_experts=cfg.num_experts,
                            num_experts_per_tok=cfg.num_experts_per_tok,
                            capacity_factor=cfg.expert_capacity_factor)
        out, _ = moe_layer(h, {"gate": bp["moe_gate"], "w1": bp["moe_w1"],
                               "w3": bp["moe_w3"], "w2": bp["moe_w2"]},
                           moe_cfg, valid=valid)
        return out
    gu = _linear(h, bp["w_gate_up"])
    gate, up = jnp.split(gu, 2, axis=-1)
    return _tp_psum(_linear(jax.nn.silu(gate) * up, bp["w_down"]), cfg)


def _attend(q, k, v, q_slots, k_slots, valid_from=None):
    """Grouped attention with the unified causal/validity mask.

    q: (B, Hq, Sq, hd); k, v: (B, Hkv, Sk, hd). Slots are *cache slot indices*
    (not RoPE positions — they differ under left-padding).
    mask[b, q, k] = k_slots[k] <= q_slots[b, q] (and k_slots[k] >=
    valid_from[b] when given, masking left-pad garbage) — one predicate covers
    causal prefill, rectangular cached prefill, and decode over a padded cache.
    """
    mask = k_slots[None, None, :] <= q_slots[:, :, None]  # (B, Sq, Sk)
    if valid_from is not None:
        mask = mask & (k_slots[None, None, :] >= valid_from[:, None, None])
    return grouped_sdpa(q, k, v, mask=mask[:, None, None, :, :])


def block_forward(
    bp: dict,
    x: jnp.ndarray,
    cfg: ModelConfig,
    rope_cos: jnp.ndarray | None,
    rope_sin: jnp.ndarray | None,
    positions: jnp.ndarray,
    kv: tuple[jnp.ndarray, jnp.ndarray] | None = None,
    start: jnp.ndarray | None = None,
    slots: jnp.ndarray | None = None,
    valid_from: jnp.ndarray | None = None,
    layer: jnp.ndarray | None = None,
    k_limit: int | None = None,
):
    """One transformer block: pre-norm GQA + residual, pre-norm SwiGLU +
    residual (ref ch01/transformer.py:34-44).

    With `kv=(k_cache, v_cache)` FULL stacked caches (L, B, max_S, Hkv, hd)
    and `layer` (traced index), new K/V are written in place at that layer and
    offset `start`, and attention runs over that layer's cache
    (ref ch02/cached_generation.py:52-98 CachedGQA). Returns (x, (k, v)).
    """
    b, s, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    qkv = _linear(h, bp["wqkv"])
    q, k, v = jnp.split(qkv, [hq * hd, (hq + hkv) * hd], axis=-1)
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if rope_cos is not None:
        q = apply_rope(q, rope_cos, rope_sin, positions)
        k = apply_rope(k, rope_cos, rope_sin, positions)

    if slots is None:
        slots = positions

    # token validity for MoE routing: left-pad slots below valid_from must
    # not claim expert capacity
    ffn_valid = None
    if cfg.num_experts > 0 and valid_from is not None:
        ffn_valid = slots >= valid_from[:, None]

    if kv is None:
        kq = k.transpose(0, 2, 1, 3)
        vq = v.transpose(0, 2, 1, 3)
        k_slots = jnp.arange(s)
        new_kv = None
    else:
        k_cache, v_cache = kv
        start = jnp.asarray(start)
        k_cache = _cache_write(k_cache, k, start, layer=layer)
        v_cache = _cache_write(v_cache, v, start, layer=layer)
        new_kv = (k_cache, v_cache)

        if (s == 1 and isinstance(k_cache, QuantKV)
                and decode_attention.use_decode_kernel()):
            # INT8-KV decode: the kernel reads the int8 cache once and
            # dequantizes in registers, where the XLA path below writes and
            # re-reads a dequantized copy of the whole layer cache
            attn = _slot_decode_attention(q[:, 0], k_cache, v_cache,
                                          slots[:, 0], valid_from, layer)
            x = x + _tp_psum(_linear(attn.reshape(b, 1, hq * hd), bp["wo"]),
                             cfg)
            x = x + _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps), cfg,
                         valid=ffn_valid)
            return x, new_kv

        if k_limit is not None and k_limit == s:
            # One-shot prefill (slots [0, s) were written by THIS call —
            # the only k_limit caller, runtime/generate._prefill, writes at
            # start=0 with k_limit=p=s): attend the freshly computed
            # post-RoPE K/V directly instead of round-tripping through the
            # cache. Skips two dequant passes + the int8 read-back per
            # layer; with a QuantKV cache this also means intra-prompt
            # attention sees pre-quantization values (production-engine
            # semantics — cache noise enters at decode, where the cache is
            # actually the source), which only tightens the accuracy
            # budget. Bit-identical for non-quantized caches.
            kq = k.transpose(0, 2, 1, 3)
            vq = v.transpose(0, 2, 1, 3)
            k_slots = jnp.arange(s)
        elif layer is None:
            kq = _cache_read(k_cache, q.dtype).transpose(0, 2, 1, 3)
            vq = _cache_read(v_cache, q.dtype).transpose(0, 2, 1, 3)
        else:
            kq = _cache_read_layer(k_cache, layer, q.dtype).transpose(0, 2, 1, 3)
            vq = _cache_read_layer(v_cache, layer, q.dtype).transpose(0, 2, 1, 3)
        if k_limit is not None and k_limit < kq.shape[2]:
            # STATIC bound on attendable cache slots (e.g. one-shot prefill
            # of P tokens into a P+decode cache): slicing before attention
            # drops the dead tail's dequant + scores + softmax — the mask
            # already excluded it, but masked work still costs time
            kq = kq[:, :, :k_limit]
            vq = vq[:, :, :k_limit]
        k_slots = jnp.arange(kq.shape[2])

    attn = _attend(q.transpose(0, 2, 1, 3), kq, vq, slots, k_slots,
                   valid_from)
    attn = attn.transpose(0, 2, 1, 3).reshape(b, s, hq * hd)
    x = x + _tp_psum(_linear(attn, bp["wo"]), cfg)
    x = x + _ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps), cfg,
                 valid=ffn_valid)
    return x, new_kv


def _slot_decode_attention(q, k_cache: QuantKV, v_cache: QuantKV, q_slot,
                          valid_from, layer):
    """Decode attention over the stacked int8 slot cache (L, B, S, ...)
    through the paged kernel: each slot is viewed as a run of contiguous
    pages, and the request's window is [valid_from, q_slot]."""
    kq, ks, vq, vs = k_cache.q, k_cache.s, v_cache.q, v_cache.s
    if layer is None:  # one layer's (B, S, ...) cache
        kq, ks, vq, vs = (a[None] for a in (kq, ks, vq, vs))
        layer = 0
    L, b, seq = kq.shape[:3]
    t, table = decode_attention.slot_pages(b, seq)
    view = lambda a: a.reshape(L, b * seq // t, t, a.shape[-1])
    lo = (jnp.zeros((b,), jnp.int32) if valid_from is None
          else valid_from.astype(jnp.int32))
    return decode_attention.int8_paged_decode_attention(
        q, view(kq), view(ks), view(vq), view(vs), table, table, lo,
        q_slot.astype(jnp.int32) + 1, layer, interpret=False)


def forward(
    params: dict,
    input_ids: jnp.ndarray,
    cfg: ModelConfig,
    kv: KVSlice | None = None,
    positions: jnp.ndarray | None = None,
    slots: jnp.ndarray | None = None,
    valid_from: jnp.ndarray | None = None,
    last_only: bool = False,
    greedy_head: bool = False,
    k_limit: int | None = None,
):
    """Model forward: embed → scan blocks → norm → lm_head
    (ref ch01/transformer.py:80-87; cached: ch02/cached_generation.py:174-187).

    input_ids: (B, S) int32. With `kv`, tokens occupy cache slots
    [kv.start, kv.start+S) and the returned KVSlice has start advanced by S.
    `positions` (B, S) are RoPE positions; `slots` (B, S) are cache slot
    indices for the causal mask (defaults to positions — they differ only for
    left-padded ragged batches); `valid_from` (B,) masks cache slots below it
    (left-pad garbage). `last_only` computes logits for the final position
    only (decode hot path — skips the (S,V) lm_head matmul during
    prefill-and-sample). Returns (logits, new_kv).

    `greedy_head` (static): return greedy next-token ids (B,) int32 for the
    last position instead of logits (argmax over the f32 logits; XLA fuses
    the reduction into the head's epilogue).
    """
    b, s = input_ids.shape
    x = embed_lookup(params, input_ids, cfg)

    if positions is None:
        base = jnp.asarray(kv.start if kv is not None else 0)
        base = base[:, None] if base.ndim == 1 else base
        positions = jnp.broadcast_to(jnp.arange(s)[None, :] + base, (b, s))

    if cfg.use_rope:
        rope_cos, rope_sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                              cfg.rope_theta)
    else:
        rope_cos = rope_sin = None

    if kv is None:
        def body(carry, l):
            out, _ = block_forward(layer_view(params["blocks"], l), carry,
                                   cfg, rope_cos, rope_sin, positions,
                                   slots=slots, valid_from=valid_from)
            return out, None

        x, _ = lax.scan(body, x, jnp.arange(cfg.num_layers))
        new_kv = None
    else:
        # Caches ride the scan CARRY (not xs/ys): every layer's one-token
        # update aliases the buffers in place instead of rebuilding the whole
        # (L, B, S, H, hd) stack each step.
        def body(carry, l):
            x, k_all, v_all = carry
            out, (k_all, v_all) = block_forward(
                layer_view(params["blocks"], l), x, cfg, rope_cos, rope_sin,
                positions, kv=(k_all, v_all), start=kv.start, slots=slots,
                valid_from=valid_from, layer=l, k_limit=k_limit)
            return (out, k_all, v_all), None

        if s == 1 and cfg.decode_unroll:
            # decode: unrolled layer loop with concrete layer indices (no
            # per-iteration loop bookkeeping)
            carry = (x, kv.k, kv.v)
            for l in range(cfg.num_layers):
                carry, _ = body(carry, l)
            x, k_new, v_new = carry
        else:
            (x, k_new, v_new), _ = lax.scan(
                body, (x, kv.k, kv.v), jnp.arange(cfg.num_layers))
        new_kv = KVSlice(k_new, v_new, kv.start + s)

    if last_only:
        x = x[:, -1:, :]
    if greedy_head:
        logits = lm_logits(x[:, -1:], params, cfg)
        return jnp.argmax(logits[:, -1].astype(jnp.float32), -1).astype(
            jnp.int32), new_kv
    logits = lm_logits(x, params, cfg)
    return logits, new_kv


def count_parameters(params: dict) -> dict:
    """Per-section parameter counts (ref ch01/transformer.py:89-100)."""
    size = lambda t: sum(x.size for x in jax.tree_util.tree_leaves(t))
    out = {
        "embed_tokens": size(params["embed"]),
        "layers": size(params["blocks"]),
        "norm": size(params["norm"]),
        "lm_head": size(params["lm_head"]),
    }
    out["total"] = sum(out.values())
    return out
