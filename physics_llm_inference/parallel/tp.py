"""Tensor parallelism: sharding rules + explicit Megatron-style layers.

Capability parity: ref ch09/tensor_parallel.py — ColumnParallelLinear L15-40
(shard output dim), RowParallelLinear L43-68 (shard input dim, needs
all-reduce), TensorParallelMLP L71-100, compute_tp_memory_savings L103-125.
The reference's layers hold shard-shaped weights but never communicate; here
the reduction is real (lax.psum over the 'model' mesh axis inside shard_map,
an NCCL all-reduce).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def tp_param_specs():
    """PartitionSpec rule for the stacked transformer param pytree
    (models/transformer.py layout) on a ('data','model') mesh.

    Megatron layout: qkv + gate_up column-sharded (output dim on 'model'),
    o_proj + down row-sharded (input dim on 'model') so each block needs
    exactly two all-reduces, which GSPMD inserts; norms replicated; embedding
    row(vocab)-sharded, lm_head column(vocab)-sharded.
    """
    def spec(path, x) -> P:
        names = [getattr(p, "key", getattr(p, "name", str(p))) for p in path]
        leaf = names[-1]
        if leaf == "embed":
            return P("model", None)
        if leaf == "lm_head":
            return P(None, "model")
        if leaf in ("wqkv", "w_gate_up", "moe_gate"):
            return P(None, None, "model")   # (L, D, out) column-parallel
        if leaf in ("wo", "w_down"):
            return P(None, "model", None)   # (L, in, D) row-parallel
        return P()                           # norms etc. replicated

    return spec


def tp_param_spec_tree(params, axis: str = "model"):
    """PartitionSpec PYTREE for a (possibly INT8-quantized) param pytree.

    Same Megatron rules as tp_param_specs, extended to QuantizedTensor
    leaves: a column-sharded weight's per-output-channel scales shard with
    the output dim; a row-sharded weight's scales are per-OUTPUT-channel so
    they replicate. Usable directly as shard_map in/out specs or wrapped in
    NamedSharding for device_put.
    """
    def spec(path, x) -> P:
        names = [getattr(p, "key", getattr(p, "name", str(p))) for p in path]
        is_scale = names[-1] == "s"
        name = names[-2] if names[-1] in ("q", "s") else names[-1]
        if name == "embed":
            return P(axis, None)
        if name == "lm_head":
            # q (D, V) or dense (D, V): column(vocab)-sharded; s (1, V) too
            return P(None, axis)
        if name in ("wqkv", "w_gate_up"):
            # (L, D, out) column-parallel; scales (L, 1, out) shard on out
            return P(None, None, axis)
        if name in ("wo", "w_down"):
            if is_scale:
                return P()                   # (L, 1, D): per-out, replicated
            return P(None, axis, None)       # (L, in, D) row-parallel
        return P()

    return jax.tree_util.tree_map_with_path(spec, params)


def tp_shard_params(params, mesh: Mesh, axis: str = "model"):
    """Lay the param pytree out on the mesh per tp_param_spec_tree."""
    from jax.sharding import NamedSharding

    specs = tp_param_spec_tree(params, axis)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs)


def _fused_column_perm(widths: list[int], tp: int):
    """new→old column index for a FUSED projection [seg0 | seg1 | ...] so a
    contiguous 1/tp column shard holds [seg0_i | seg1_i | ...].

    The stacked layouts fuse q|k|v (wqkv) and gate|up (w_gate_up) on the
    output dim; naive column sharding would hand shard 0 only q (or only
    gate) columns. This permutation, applied once before device_put, makes
    each shard a complete miniature of the fused layout so the unmodified
    block code (split at local hq·hd / local F) is correct per shard."""
    import numpy as np

    offs = np.cumsum([0] + list(widths[:-1]))
    idx = []
    for i in range(tp):
        for w, off in zip(widths, offs):
            per = w // tp
            idx.extend(range(off + i * per, off + (i + 1) * per))
    return np.asarray(idx, dtype=np.int32)


def _permute_cols(w, idx):
    from ..models.quant import QuantizedTensor

    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(jnp.take(w.q, idx, axis=-1),
                               jnp.take(w.s, idx, axis=-1))
    return jnp.take(w, idx, axis=-1)


def tp_prepare_params(params, cfg, mesh: Mesh, axis: str = "model"):
    """Permute fused projections for shard locality, then shard onto the
    mesh. The one-stop param prep for a TP serving engine."""
    from ..models.quant import QuantizedTensor4

    tp = mesh.shape[axis]
    hd = cfg.head_dim
    out = dict(params)
    blocks = dict(params["blocks"])
    assert not any(isinstance(w, QuantizedTensor4) for w in blocks.values()), \
        ("INT4 (nibble-packed) weights are not TP-shardable: splitting the "
         "packed last dim interleaves lo/hi channel pairs. Use INT8 for TP.")
    if tp > 1:
        if "wqkv" in blocks:
            qkv_idx = _fused_column_perm(
                [cfg.num_heads * hd, cfg.num_kv_heads * hd,
                 cfg.num_kv_heads * hd], tp)
            blocks["wqkv"] = _permute_cols(blocks["wqkv"], qkv_idx)
        if "w_gate_up" in blocks:
            gu_idx = _fused_column_perm(
                [cfg.intermediate_dim, cfg.intermediate_dim], tp)
            blocks["w_gate_up"] = _permute_cols(blocks["w_gate_up"], gu_idx)
    out["blocks"] = blocks
    return tp_shard_params(out, mesh, axis)


def tp_kv_spec(quantized: bool, data: str | None = "data",
               model: str | None = "model", paged_merged: bool = False):
    """PartitionSpec for a slot/paged KV cache pytree: requests (axis 1)
    sharded over `data`, KV heads sharded over `model`.

    Dense cache (L, B, S, Hkv, hd) → one P; QuantKV (flat int8 values
    (L, B, S, Hkv·hd) head-major + scales (L, B, S, Hkv)) → a QuantKV of
    Ps. The flat value layout is head-major, so a model-axis shard of the
    last dim is exactly a contiguous group of KV heads.

    paged_merged: the MERGED paged pools — values (L, NB, 2, BS, Hkv·hd),
    scales (L, NB, 2, BS, Hkv) (each block's K and V pages side by side;
    serve/paged_engine.py)."""
    from ..models.transformer import QuantKV

    if quantized and paged_merged:
        return QuantKV(q=P(None, data, None, None, model),
                       s=P(None, data, None, None, model))
    if quantized:
        return QuantKV(q=P(None, data, None, model),
                       s=P(None, data, None, model))
    return P(None, data, None, model, None)


def tp_local_config(cfg, tp: int, axis: str = "model",
                    data_axis: str | None = "data"):
    """The per-shard ModelConfig seen INSIDE shard_map: heads and FFN width
    divided by the TP degree, with cfg.tp_axis set so the forward pass psums
    row-parallel partial sums and all-gathers vocab-sharded logits
    (models/transformer.py). Vocab stays the GLOBAL size in the config (only
    the embed/lm_head leaves are shard-shaped)."""
    import dataclasses

    assert cfg.num_kv_heads % tp == 0, \
        f"num_kv_heads {cfg.num_kv_heads} must divide TP degree {tp}"
    assert cfg.intermediate_dim % tp == 0
    return dataclasses.replace(
        cfg,
        num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_dim=cfg.intermediate_dim // tp,
        # hidden_dim stays global: activations are replicated across TP
        head_dim_override=cfg.head_dim,
        tp_axis=axis,
        tp_data_axis=data_axis,
    )


def column_parallel_linear(x: jnp.ndarray, w_shard: jnp.ndarray) -> jnp.ndarray:
    """Per-shard matmul with the weight split on the OUTPUT dim
    (ref ch09/tensor_parallel.py:15-40). Output stays sharded — no collective,
    exactly as Megatron prescribes (the following row-parallel layer reduces).
    Call inside shard_map."""
    return x @ w_shard


def row_parallel_linear(x_shard: jnp.ndarray, w_shard: jnp.ndarray,
                        axis: str = "model") -> jnp.ndarray:
    """Per-shard partial matmul + the all-reduce the reference only documents
    (ch09/tensor_parallel.py:66-68, docstring :142-147): lax.psum over the
    mesh axis — XLA lowers it to an NCCL all-reduce. Call inside
    shard_map."""
    partial_out = x_shard @ w_shard
    return jax.lax.psum(partial_out, axis)


def tp_mlp_shardmap(mesh: Mesh, x: jnp.ndarray, w_gate: jnp.ndarray,
                    w_up: jnp.ndarray, w_down: jnp.ndarray) -> jnp.ndarray:
    """Tensor-parallel SwiGLU MLP over the 'model' axis
    (ref TensorParallelMLP ch09/tensor_parallel.py:71-100):
    column(gate), column(up) → silu·mul → row(down) + psum.

    x: (..., D) replicated; w_gate/w_up: (D, F); w_down: (F, D) — full arrays,
    sharded here via shard_map in_specs.
    """
    def mlp(x, wg, wu, wd):
        gate = column_parallel_linear(x, wg)
        up = column_parallel_linear(x, wu)
        hidden = jax.nn.silu(gate) * up
        return row_parallel_linear(hidden, wd)

    fn = shard_map(
        mlp, mesh=mesh,
        in_specs=(P(), P(None, "model"), P(None, "model"), P("model", None)),
        out_specs=P(),
    )
    return fn(x, w_gate, w_up, w_down)


def compute_tp_memory_savings(num_params: int, world_size: int,
                              dtype_bytes: int = 2) -> dict:
    """Params/bytes per device vs world size (ref ch09/tensor_parallel.py:103-125)."""
    per_device = num_params / world_size
    return {
        "total_params": num_params,
        "params_per_device": per_device,
        "bytes_per_device": per_device * dtype_bytes,
        "reduction_factor": world_size,
    }
