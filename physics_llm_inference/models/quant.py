"""INT8 weight-only model quantization.

Converts a dense parameter pytree (models/transformer.py layout) into one
where every matmul weight is a QuantizedTensor (int8 values + per-output-
channel f32 scales). The forward pass is unchanged — transformer._linear
dispatches on the leaf type (int8 → bf16 convert feeding the matmul, scale
on the output).

This is the framework's native format (INT8 W+KV at <=0.1 perplexity vs
fp32). Norms, embeddings and biases stay high-precision;
per-channel scales are what holds the accuracy budget.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.quant import quantize_int8


class QuantizedTensor(NamedTuple):
    """int8 values + broadcastable f32 scale. A pytree — scans/shards like a
    plain array; sliced along a leading layer axis inside lax.scan."""

    q: jnp.ndarray   # int8, same shape as original weight
    s: jnp.ndarray   # f32, shape broadcastable (reduction axes = 1)

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self, dtype=jnp.bfloat16) -> jnp.ndarray:
        return (self.q.astype(jnp.float32) * self.s).astype(dtype)


class QuantizedTensor4(NamedTuple):
    """INT4 weight-only container: nibble-packed values + GROUP-WISE scales.

    q: int8 (L, K, N//2) — byte j of a row packs output channel j in the
       LOW nibble and channel N//2 + j in the HIGH nibble (two's
       complement). Unpacking is two arithmetic shifts and a concat, and
       the channel order comes out natural — no permutation anywhere.
    s: f32 (L, K//G, N) — one scale per (K-group, output channel), with
       G = int4_group_size(K, N).
    """

    q: jnp.ndarray
    s: jnp.ndarray

    @property
    def shape(self):
        l, k, nh = self.q.shape
        return (l, k, 2 * nh)

    @property
    def group(self) -> int:
        return self.q.shape[1] // self.s.shape[1]

    def dequantize(self, dtype=jnp.bfloat16) -> jnp.ndarray:
        lo = jnp.right_shift(jnp.left_shift(self.q, 4), 4)
        hi = jnp.right_shift(self.q, 4)
        w4 = jnp.concatenate([lo, hi], axis=-1).astype(jnp.float32)
        g = self.group
        l, k, n = self.shape
        sfull = jnp.repeat(self.s, g, axis=1)
        return (w4 * sfull).astype(dtype)

    def dequantize_layer(self, layer, dtype=jnp.bfloat16) -> jnp.ndarray:
        """One layer's (K, N) weights."""
        q = jax.lax.dynamic_index_in_dim(self.q, layer, 0, keepdims=False)
        s = jax.lax.dynamic_index_in_dim(self.s, layer, 0, keepdims=False)
        lo = jnp.right_shift(jnp.left_shift(q, 4), 4)
        hi = jnp.right_shift(q, 4)
        w4 = jnp.concatenate([lo, hi], axis=-1).astype(jnp.float32)
        return (w4 * jnp.repeat(s, self.group, axis=0)).astype(dtype)


def int4_group_size(k: int, n: int, cap: int = 3 << 20) -> int:
    """Scale-group length along K for an INT4 (K, N) matrix: the largest
    power of two in 8..1024 that divides k and whose slab of packed rows
    (group × N/2 bytes) stays within `cap` bytes; k itself when none does.
    Larger groups store fewer scales, smaller ones track the weights more
    closely."""
    for g in (1024, 512, 256, 128, 64, 32, 16, 8):
        if k % g == 0 and g * (n // 2) <= cap:
            return g
    return k


_QUANT_LEAVES = ("wqkv", "wo", "w_gate_up", "w_down",
                 "moe_w1", "moe_w2", "moe_w3")


def _quantize_stacked(w: jnp.ndarray) -> QuantizedTensor:
    """Stacked weight (L, K, N): per-(layer, output-channel) scales (L, 1, N)."""
    q, s = quantize_int8(w, axis=-2)
    return QuantizedTensor(q, s)


def quantize_params_int8(params: dict, quantize_lm_head: bool = True) -> dict:
    """Quantize all block matmul weights (+ optionally lm_head).

    Embeddings and norms stay in the original dtype: embeds are a gather (no
    bandwidth win at decode batch sizes) and norm scales are tiny.
    """
    out = {
        "embed": params["embed"],
        "norm": params["norm"],
        "blocks": {},
    }
    for name, w in params["blocks"].items():
        if name in _QUANT_LEAVES:
            out["blocks"][name] = _quantize_stacked(w)
        else:
            out["blocks"][name] = w
    if quantize_lm_head:
        q, s = quantize_int8(params["lm_head"], axis=0)
        out["lm_head"] = QuantizedTensor(q, s)
    else:
        out["lm_head"] = params["lm_head"]
    return out


def init_params_int8(rng, cfg) -> dict:
    """Initialize a model DIRECTLY in the quantized format.

    For benchmarking models without materializing bf16 weights first (a
    7B-class model is ~14 GB bf16 + ~7 GB int8 during quantize_params_int8).
    Matmul weights are sampled as int8 values with
    per-channel scales matching init_params' fan-in scaling; embeds/norms
    init normally."""
    d, f, v = cfg.hidden_dim, cfg.intermediate_dim, cfg.vocab_size
    hd = cfg.head_dim
    L = cfg.num_layers
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd

    def qw(key, shape, fan_in):
        # generate per layer: randint over the full (L, K, N) stack
        # materializes a 4-byte random-bits transient (~11.5 GB for a 7B
        # w_gate_up); per-layer slices keep it at ~1/L of that
        keys = jax.random.split(key, shape[0])
        q = jnp.stack([jax.random.randint(k, shape[1:], -127, 128, jnp.int8)
                       for k in keys])
        # absmax-style scale so dequantized std ≈ fan_in**-0.5
        s = jnp.full(shape[:-2] + (1, shape[-1]),
                     (fan_in ** -0.5) / 73.9, jnp.float32)  # std(unif int8)
        return QuantizedTensor(q, s)

    keys = jax.random.split(rng, 8)
    dtype = jnp.dtype(cfg.dtype)
    blocks = {
        "ln1": jnp.ones((L, d), dtype),
        "wqkv": qw(keys[1], (L, d, qkv_out), d),
        "wo": qw(keys[4], (L, cfg.num_heads * hd, d), d),
        "ln2": jnp.ones((L, d), dtype),
        "w_gate_up": qw(keys[5], (L, d, 2 * f), d),
        "w_down": qw(keys[6], (L, f, d), f),
    }
    emb = (jax.random.normal(keys[0], (v, d)) * (d ** -0.5)).astype(dtype)
    return {
        "embed": emb,
        "blocks": blocks,
        "norm": jnp.ones((d,), dtype),
        "lm_head": qw(keys[7], (d, v), d),
    }


def _quantize_stacked_int4(w: jnp.ndarray, group: int,
                           mse: bool = False) -> QuantizedTensor4:
    """(L, K, N) → nibble-packed int4 with (L, K//G, N) group scales.

    mse=True: per-(group, channel) SCALE SEARCH instead of plain absmax
    RTN — absmax wastes the 4-bit range on the group's single largest
    weight; shrinking the scale trades a little clip error on that
    outlier for finer resolution on everything else. 11 candidates in
    [0.75, 1.0]·absmax, argmin of the group's squared dequant error
    (round 4, ACCURACY.md int4 rows)."""
    l, k, n = w.shape
    assert k % group == 0 and n % 2 == 0
    wf = w.astype(jnp.float32).reshape(l, k // group, group, n)
    amax = jnp.max(jnp.abs(wf), axis=2, keepdims=True)
    s = jnp.maximum(amax, 1e-8) / 7.0
    if mse:
        cands = np.linspace(0.75, 1.0, 11)

        def err_for(c):
            sc = s * c
            q = jnp.clip(jnp.round(wf / sc), -8, 7)
            return jnp.sum((wf - q * sc) ** 2, axis=2, keepdims=True)

        errs = jnp.stack([err_for(float(c)) for c in cands])
        s = s * jnp.asarray(cands, jnp.float32)[
            jnp.argmin(errs, axis=0)]
    q = jnp.clip(jnp.round(wf / s), -8, 7).astype(jnp.int8).reshape(l, k, n)
    lo = q[..., :n // 2]
    hi = q[..., n // 2:]
    packed = jnp.bitwise_or(jnp.bitwise_and(lo, 0x0F),
                            jnp.left_shift(hi, 4)).astype(jnp.int8)
    return QuantizedTensor4(packed, s[:, :, 0, :])


def quantize_params_int4(params: dict, mse: bool = False) -> dict:
    """INT4 (W4A16) block weights; embeds/norms/lm_head stay as in the INT8
    path (lm_head int8 — its N=vocab is the logits edge where 4-bit error
    is most visible and its bytes are ~2% of a 7B). mse=True: per-group
    scale search (see _quantize_stacked_int4) — same wire format."""
    out = {
        "embed": params["embed"],
        "norm": params["norm"],
        "blocks": {},
    }
    for name, w in params["blocks"].items():
        if name in _QUANT_LEAVES:
            if isinstance(w, QuantizedTensor):
                w = w.dequantize(jnp.float32)
            if w.ndim != 3:
                # MoE expert stacks are (L, E, K, N): keep such leaves int8
                out["blocks"][name] = _quantize_stacked(w)
                continue
            _, k, n = w.shape
            out["blocks"][name] = _quantize_stacked_int4(
                w, int4_group_size(k, n), mse=mse)
        else:
            out["blocks"][name] = w
    lm = params["lm_head"]
    if not isinstance(lm, QuantizedTensor):
        q, s = quantize_int8(lm, axis=0)
        lm = QuantizedTensor(q, s)
    out["lm_head"] = lm
    return out


def init_params_int4(rng, cfg) -> dict:
    """Direct-int4 init for bench-scale models (see init_params_int8)."""
    d, f, v = cfg.hidden_dim, cfg.intermediate_dim, cfg.vocab_size
    hd = cfg.head_dim
    L = cfg.num_layers
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd

    def qw4(key, shape, fan_in):
        l, k, n = shape
        g = int4_group_size(k, n)
        keys = jax.random.split(key, l)
        packed = jnp.stack([
            jax.random.randint(kk, (k, n // 2), -128, 128, jnp.int8)
            for kk in keys])
        # std of a uniform int4 nibble ≈ 4.6; match fan_in**-0.5 dequant std
        s = jnp.full((l, k // g, n), (fan_in ** -0.5) / 4.6, jnp.float32)
        return QuantizedTensor4(packed, s)

    def qw8(key, shape, fan_in):
        keys = jax.random.split(key, shape[0]) if len(shape) == 3 else [key]
        if len(shape) == 3:
            q = jnp.stack([jax.random.randint(k, shape[1:], -127, 128,
                                              jnp.int8) for k in keys])
            s = jnp.full(shape[:-2] + (1, shape[-1]),
                         (fan_in ** -0.5) / 73.9, jnp.float32)
        else:
            q = jax.random.randint(key, shape, -127, 128, jnp.int8)
            s = jnp.full((1, shape[-1]), (fan_in ** -0.5) / 73.9, jnp.float32)
        return QuantizedTensor(q, s)

    keys = jax.random.split(rng, 8)
    dtype = jnp.dtype(cfg.dtype)
    blocks = {
        "ln1": jnp.ones((L, d), dtype),
        "wqkv": qw4(keys[1], (L, d, qkv_out), d),
        "wo": qw4(keys[4], (L, cfg.num_heads * hd, d), d),
        "ln2": jnp.ones((L, d), dtype),
        "w_gate_up": qw4(keys[5], (L, d, 2 * f), d),
        "w_down": qw4(keys[6], (L, f, d), f),
    }
    emb = (jax.random.normal(keys[0], (v, d)) * (d ** -0.5)).astype(dtype)
    return {
        "embed": emb,
        "blocks": blocks,
        "norm": jnp.ones((d,), dtype),
        "lm_head": qw8(keys[7], (d, v), d),
    }


def quantized_param_bytes(params: dict) -> dict:
    """Memory accounting: bytes by precision class (the decode-bandwidth
    denominator for the roofline model)."""
    int8 = 0
    int4 = 0
    other = 0
    is_q = lambda x: isinstance(x, (QuantizedTensor, QuantizedTensor4))
    for leaf in jax.tree_util.tree_leaves(params, is_leaf=is_q):
        if isinstance(leaf, QuantizedTensor4):
            int4 += leaf.q.nbytes + leaf.s.nbytes
        elif isinstance(leaf, QuantizedTensor):
            int8 += leaf.q.nbytes + leaf.s.nbytes
        else:
            other += leaf.nbytes
    return {"int8_bytes": int8, "int4_bytes": int4, "other_bytes": other,
            "total_bytes": int8 + int4 + other}
