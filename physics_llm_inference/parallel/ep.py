"""Expert parallelism: experts sharded over a mesh axis with all-to-all
dispatch.

The executable version of what the reference only narrates
(ch09/moe_inference.py:141-144: "all-to-all communication... experts
distributed across GPUs"). Built on the same static-capacity dispatch as
models/moe.py: tokens are packed into a (E, C, D) capacity grid, the grid is
exchanged over the 'expert' axis with lax.all_to_all (XLA hands it to NCCL),
each device runs its local experts' SwiGLU, and a reverse all-to-all
returns results for the weighted combine.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..models.config import MoEConfig
from ..models.moe import _dispatch_masks, router


def moe_layer_ep(mesh: Mesh, x: jnp.ndarray, params: dict, moe: MoEConfig,
                 axis: str = "expert"):
    """Expert-parallel MoE forward over (T, D) tokens.

    params as from init_moe_params: gate (D, E) replicated; w1/w3 (E, D, F)
    and w2 (E, F, D) sharded on the expert dim across `axis`. Tokens are
    replicated into the shard_map (each device routes identically — the gate
    is tiny); capacity grids are exchanged with all_to_all.

    Returns (T, D) output (replicated).
    """
    n_dev = mesh.shape[axis]
    e, k = moe.num_experts, moe.num_experts_per_tok
    assert e % n_dev == 0, "num_experts must divide the expert axis"
    assert x.shape[0] % n_dev == 0, "tokens must divide the expert axis"

    # INT8 expert weights stay INT8 through the sharding boundary: q and s
    # leaves are sharded on the expert dim and dequantized per-LOCAL-expert
    # inside the einsum (XLA fuses the convert+scale into the operand read),
    # so each device's HBM holds and streams 1 byte/weight — dequantizing
    # before the shard_map would materialize the whole expert stack in
    # compute dtype exactly where weights are biggest.
    from ..models.quant import QuantizedTensor

    compute_dtype = x.dtype

    def _dq(w):
        if isinstance(w, QuantizedTensor):
            return (w.q.astype(jnp.float32) * w.s).astype(compute_dtype)
        return w

    def fn(x, gate, w1, w3, w2):
        w1, w3, w2 = _dq(w1), _dq(w3), _dq(w2)
        # x: LOCAL token shard (t_loc, D) — each device routes its own tokens
        # (the gate is replicated and tiny), packs them into a full (E, C, D)
        # capacity grid, and a2a delivers each expert's slots to its owner.
        t_loc = x.shape[0]
        capacity = max(1, int(moe.capacity_factor * t_loc * k / e))
        weights, indices, probs = router(x, gate, k)
        dispatch, combine = _dispatch_masks(indices, weights, e, capacity)
        expert_in = jnp.einsum("tec,td->ecd", dispatch,
                               x.astype(jnp.float32)).astype(x.dtype)
        # (E, C, D) → (e_local, n_dev·C, D): expert chunks out, token-source
        # chunks in. This IS the MoE dispatch all-to-all.
        local_in = jax.lax.all_to_all(expert_in, axis, split_axis=0,
                                      concat_axis=1, tiled=True)
        hidden = jax.nn.silu(jnp.einsum("ecd,edf->ecf", local_in, w1)) \
            * jnp.einsum("ecd,edf->ecf", local_in, w3)
        local_out = jnp.einsum("ecf,efd->ecd", hidden, w2)
        # reverse: (e_local, n_dev·C, D) → (E, C, D) back at the token owner
        expert_out = jax.lax.all_to_all(local_out, axis, split_axis=1,
                                        concat_axis=0, tiled=True)
        out = jnp.einsum("tec,ecd->td", combine,
                         expert_out.astype(jnp.float32))
        return out.astype(x.dtype)

    sharded = shard_map(
        fn, mesh=mesh,
        in_specs=(P(axis), P(), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )
    return sharded(x, params["gate"], params["w1"], params["w3"], params["w2"])
