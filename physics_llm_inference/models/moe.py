"""Mixture-of-experts layer: router + static-capacity expert dispatch.

Capability parity: ref ch09/moe_layer.py (Router L17-34, ExpertLayer L37-45,
MoELayer L48-83, expert_load_balance_loss L86-98).

Design: the reference dispatches with a Python loop over experts and
boolean-mask gathers (ch09/moe_layer.py:66-81) — dynamic shapes XLA cannot
compile. Here dispatch is the GShard/Mesh-TF pattern: each token's top-k
choices claim a slot in a fixed (E, C) capacity grid via a position-in-expert
cumsum; gather/combine are einsums against one-hot dispatch masks, which XLA
lowers to batched matmuls with fully static shapes. Tokens overflowing an
expert's capacity are dropped from that expert (weighted-combine just omits
them) — the standard capacity-factor trade.

Expert-parallel sharding (experts over a mesh axis, all-to-all dispatch) is
layered on in parallel/; this module is the single-device math.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .config import ModelConfig, MoEConfig
from ..ops.ffn import swiglu


def init_moe_params(rng: jax.Array, cfg: ModelConfig, moe: MoEConfig,
                    dtype=None) -> dict:
    """Router gate (D, E) + per-expert SwiGLU stacks (E, ...)."""
    dtype = dtype or jnp.dtype(cfg.dtype)
    d, f, e = cfg.hidden_dim, cfg.intermediate_dim, moe.num_experts
    ks = jax.random.split(rng, 4)
    w = lambda k, shape, fan: (jax.random.normal(k, shape) * fan**-0.5).astype(dtype)
    return {
        "gate": w(ks[0], (d, e), d),
        "w1": w(ks[1], (e, d, f), d),   # gate proj per expert
        "w3": w(ks[2], (e, d, f), d),   # up proj
        "w2": w(ks[3], (e, f, d), f),   # down proj
    }


def router(x: jnp.ndarray, gate: jnp.ndarray, top_k: int):
    """Linear gate → softmax → top-k → renormalize (ref ch09/moe_layer.py:23-34).

    x: (T, D); returns (weights (T, K), indices (T, K), probs (T, E)).
    """
    logits = (x @ gate).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    weights, indices = jax.lax.top_k(probs, top_k)
    weights = weights / jnp.sum(weights, axis=-1, keepdims=True)
    return weights, indices, probs


def _dispatch_masks(indices: jnp.ndarray, weights: jnp.ndarray,
                    num_experts: int, capacity: int,
                    valid: jnp.ndarray | None = None):
    """Build (T, K, E) one-hot routing with per-expert slot positions.

    Returns dispatch (T, E, C) bool and combine (T, E, C) f32 tensors.

    valid (T,) bool masks PADDING tokens out of routing entirely: without
    it, left-padded batches route their pad tokens first (the capacity
    cumsum is token-ordered), and a run of identical pads can claim an
    expert's whole capacity before any real token — dropping real tokens
    from their experts.
    """
    t, k = indices.shape
    onehot = jax.nn.one_hot(indices, num_experts, dtype=jnp.int32)  # (T, K, E)
    if valid is not None:
        onehot = onehot * valid.reshape(t, 1, 1).astype(jnp.int32)
    flat = onehot.reshape(t * k, num_experts)
    # Slot index of each (token, choice) within its expert, in token order.
    pos_in_expert = jnp.cumsum(flat, axis=0) - flat  # (T·K, E)
    pos = jnp.sum(flat * pos_in_expert, axis=-1).reshape(t, k)
    fits = pos < capacity
    slot_onehot = jax.nn.one_hot(pos, capacity, dtype=jnp.float32)  # (T, K, C)
    dispatch = jnp.einsum("tke,tkc->tec",
                          (onehot * fits[..., None]).astype(jnp.float32),
                          slot_onehot)
    combine = jnp.einsum("tke,tkc,tk->tec",
                         (onehot * fits[..., None]).astype(jnp.float32),
                         slot_onehot, weights)
    return dispatch, combine


def moe_layer(x: jnp.ndarray, params: dict, moe: MoEConfig,
              valid: jnp.ndarray | None = None):
    """Routed MoE forward over (B, S, D) or (T, D).

    Per-expert SwiGLU (ref ExpertLayer :37-45) on capacity-grid token slots;
    weighted combine (ref :74-81). `valid` (broadcastable to x's token dims)
    masks padding tokens out of routing (see _dispatch_masks). Returns
    (output, aux) where aux carries the router probs/indices for
    load-balance metrics.
    """
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    e, k = moe.num_experts, moe.num_experts_per_tok
    capacity = max(1, int(moe.capacity_factor * t * k / e))

    weights, indices, probs = router(xt, params["gate"], k)
    if valid is not None:
        valid = jnp.broadcast_to(valid, orig_shape[:-1]).reshape(t)
    dispatch, combine = _dispatch_masks(indices, weights, e, capacity, valid)

    def dq(w):
        # INT8 expert weights (models/quant.py quantizes moe_w1/w3/w2):
        # dequantize into the compute dtype — XLA fuses the scale multiply
        # into the einsum's operand read
        from .quant import QuantizedTensor

        if isinstance(w, QuantizedTensor):
            return (w.q.astype(jnp.float32) * w.s).astype(x.dtype)
        return w

    # Gather token slots: (E, C, D)
    expert_in = jnp.einsum("tec,td->ecd", dispatch, xt.astype(jnp.float32))
    expert_in = expert_in.astype(x.dtype)
    # Batched per-expert SwiGLU — one (E,C,D)x(E,D,F) batched matmul per proj.
    hidden = jax.nn.silu(
        jnp.einsum("ecd,edf->ecf", expert_in, dq(params["w1"]))) \
        * jnp.einsum("ecd,edf->ecf", expert_in, dq(params["w3"]))
    expert_out = jnp.einsum("ecf,efd->ecd", hidden, dq(params["w2"]))
    out = jnp.einsum("tec,ecd->td", combine, expert_out.astype(jnp.float32))
    out = out.astype(x.dtype).reshape(orig_shape)
    # routed-drop observability: (token, choice) pairs that overflowed their
    # expert's capacity (production MoE serving behavior under pressure —
    # ref ch09/moe_inference.py routing stats)
    routed = dispatch.sum()
    total = (jnp.sum(valid.astype(jnp.float32)) * k if valid is not None
             else jnp.float32(t * k))
    aux = {"probs": probs, "indices": indices, "weights": weights,
           "capacity": capacity, "dropped": total - routed}
    return out, aux


def expert_load_balance_loss(probs: jnp.ndarray, indices: jnp.ndarray,
                             num_experts: int) -> jnp.ndarray:
    """Switch-style aux loss: E · Σ_e (avg_prob_e · token_frac_e)
    (ref ch09/moe_layer.py:86-98)."""
    onehot = jax.nn.one_hot(indices, num_experts)  # (T, K, E)
    token_frac = jnp.mean(jnp.sum(onehot, axis=1), axis=0)
    avg_prob = jnp.mean(probs, axis=0)
    return num_experts * jnp.sum(avg_prob * token_frac)
