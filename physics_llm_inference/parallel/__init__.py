"""Distributed layer (reference Lx: ch09 tensor_parallel + nccl_primitives).

Two complementary TP paths, both real (the reference executes neither — its
ColumnParallelLinear/RowParallelLinear never call a collective,
ch09/tensor_parallel.py:40,66-68):

1. GSPMD path (`tp_param_specs` + NamedSharding on a Mesh): annotate weight
   shardings, jit the unchanged model, and XLA inserts the all-reduces
   (NCCL over NVLink). This is the production path — zero model-code changes.
2. Explicit path (`column_parallel_linear`/`row_parallel_linear`/`tp_mlp`
   inside shard_map): the Megatron pattern with a visible lax.psum, used for
   teaching parity with ch09 and for kernels that need manual collectives.
"""
from .mesh import make_mesh, local_mesh_shape
from .tp import (
    tp_param_specs,
    tp_param_spec_tree,
    tp_prepare_params,
    tp_shard_params,
    tp_local_config,
    tp_kv_spec,
    column_parallel_linear,
    row_parallel_linear,
    tp_mlp_shardmap,
    compute_tp_memory_savings,
)
from .ep import moe_layer_ep
from .multihost import (
    initialize_multihost,
    pod_mesh,
    is_leader,
    broadcast_bytes,
    DPServingGroup,
)

__all__ = [
    "make_mesh", "local_mesh_shape",
    "tp_param_specs", "tp_param_spec_tree", "tp_prepare_params",
    "tp_shard_params", "tp_local_config", "tp_kv_spec",
    "column_parallel_linear", "row_parallel_linear",
    "tp_mlp_shardmap", "compute_tp_memory_savings", "moe_layer_ep",
    "initialize_multihost", "pod_mesh", "is_leader", "broadcast_bytes",
    "DPServingGroup",
]
