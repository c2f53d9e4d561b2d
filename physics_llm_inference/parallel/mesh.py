"""Device mesh construction.

The JAX replacement for the reference's world_size/rank bookkeeping
(ch09/tensor_parallel.py:7-12 TensorParallelConfig): a jax.sharding.Mesh with
named axes. Axis convention across the framework:
  data    — replicate weights, shard the batch (DP / request parallelism)
  model   — tensor parallelism (shard heads / FFN channels)
  expert  — expert parallelism for MoE layers
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(data: int = 1, model: int = 1, expert: int = 1,
              devices=None) -> Mesh:
    """Build a Mesh with ('data', 'model'[, 'expert']) axes.

    Axes of size 1 are still present (harmless, lets one code path serve all
    layouts). Device order follows jax.devices(); the cards of a host are
    joined all to all (NVLink through NVSwitch), so the order does not
    change collective cost. `model` (the chatty axis) is innermost, so a TP
    group stays inside one host when the mesh spans hosts.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = data * model * expert
    if len(devices) < n:
        raise ValueError(f"mesh {data}x{model}x{expert} needs {n} devices, "
                         f"have {len(devices)}")
    arr = np.array(devices[:n])
    if expert > 1:
        return Mesh(arr.reshape(data, expert, model),
                    ("data", "expert", "model"))
    return Mesh(arr.reshape(data, model), ("data", "model"))


def local_mesh_shape(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))
