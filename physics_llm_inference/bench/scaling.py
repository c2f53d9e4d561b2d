"""Scaling-efficiency benchmark: measured TP decode throughput vs mesh size,
against the collective cost-model prediction.

Runs the TP-sharded model step at increasing 'model'-axis sizes on whatever
devices exist (virtual CPU mesh in tests, the cards of a host in
production), and compares against specs/collectives.CollectiveCostModel —
the executable successor of ref ch09/nccl_primitives.py's analytic-only
scaling story. Predictions are for a named card from the device table
(default: H100 SXM, 8 cards per host joined by NVLink).
"""
from __future__ import annotations

import time

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models import ModelConfig, init_params
from ..models.transformer import KVSlice, forward
from ..parallel import make_mesh, tp_param_specs
from ..specs import H100_SXM, CollectiveCostModel, DeviceSpec
from ..specs.collectives import NETWORK_GBPS

CARDS_PER_HOST = 8


def measure_tp_decode(cfg: ModelConfig, mesh_sizes: list[int],
                      batch: int = 8, cache_len: int = 256,
                      iters: int = 10) -> dict:
    """Decode-step wall time at each TP width. Returns per-size timings and
    efficiency relative to ideal linear scaling of the 1-chip time."""
    params = init_params(jax.random.PRNGKey(0), cfg)
    results = {}
    for n in mesh_sizes:
        if n > len(jax.devices()):
            continue
        mesh = make_mesh(data=1, model=n)
        specs = tp_param_specs()
        sharded = jax.tree_util.tree_map_with_path(
            lambda path, x: jax.device_put(
                x, NamedSharding(mesh, specs(path, x))), params)
        kv_shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
                    cfg.head_dim)
        k = jax.device_put(jnp.zeros(kv_shape, jnp.dtype(cfg.dtype)),
                           NamedSharding(mesh, P()))
        v = jax.device_put(jnp.zeros_like(k), NamedSharding(mesh, P()))
        tok = jnp.zeros((batch, 1), jnp.int32)
        lens = jnp.full((batch,), cache_len // 2, jnp.int32)

        @jax.jit
        def step(p, tok, k, v, lens):
            logits, kvs = forward(p, tok, cfg,
                                  kv=KVSlice(k, v, lens), last_only=True)
            return jnp.argmax(logits[:, 0], -1).astype(jnp.int32), kvs.k, kvs.v

        with mesh:
            out = step(sharded, tok, k, v, lens)
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            for _ in range(iters):
                out = step(sharded, tok, k, v, lens)
            jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        results[n] = {"step_ms": dt * 1e3}

    if 1 in results:
        t1 = results[1]["step_ms"]
        for n, r in results.items():
            # TP efficiency: ideal step time is t1/n
            r["efficiency"] = (t1 / n) / r["step_ms"]
    return results


def measure_dp_step(cfg: ModelConfig, dp_sizes: list[int], batch_per_replica: int = 4,
                    cache_len: int = 128, iters: int = 10) -> dict:
    """DP decode-step wall time at each 'data'-axis width.

    DP shards requests, replicates weights: the per-replica step is
    unchanged, so ideal DP throughput is linear in replicas at CONSTANT step
    time. This measures that on the available devices (virtual CPU mesh in
    tests): global batch = dp * batch_per_replica, batch sharded over
    'data', weights replicated — the serving layout multi-host DP uses
    (parallel/multihost.py), minus the cross-host admission broadcast,
    which is measured separately by the 2-process test.
    """
    params = init_params(jax.random.PRNGKey(0), cfg)
    results = {}
    for n in dp_sizes:
        if n > len(jax.devices()):
            continue
        mesh = make_mesh(data=n, model=1)
        sharded = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P())), params)
        b = n * batch_per_replica
        kv_shape = (cfg.num_layers, b, cache_len, cfg.num_kv_heads,
                    cfg.head_dim)
        kv_spec = NamedSharding(mesh, P(None, "data"))
        k = jax.device_put(jnp.zeros(kv_shape, jnp.dtype(cfg.dtype)), kv_spec)
        v = jax.device_put(jnp.zeros_like(k), kv_spec)
        tok = jax.device_put(jnp.zeros((b, 1), jnp.int32),
                             NamedSharding(mesh, P("data")))
        lens = jax.device_put(jnp.full((b,), cache_len // 2, jnp.int32),
                              NamedSharding(mesh, P("data")))

        @jax.jit
        def step(p, tok, k, v, lens):
            logits, kvs = forward(p, tok, cfg,
                                  kv=KVSlice(k, v, lens), last_only=True)
            return jnp.argmax(logits[:, 0], -1).astype(jnp.int32), kvs.k, kvs.v

        with mesh:
            out = step(sharded, tok, k, v, lens)
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            for _ in range(iters):
                out = step(sharded, tok, k, v, lens)
            jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        results[n] = {"step_ms": dt * 1e3,
                      "tokens_per_step": b}

    if 1 in results:
        t1 = results[1]["step_ms"]
        for n, r in results.items():
            # DP efficiency: throughput gain over n× the 1-replica throughput
            thru = r["tokens_per_step"] / r["step_ms"]
            r["efficiency"] = thru / (n * batch_per_replica / t1)
    return results


def predict_dp_scaling(cfg: ModelConfig, batch_per_replica: int = 64,
                       hosts=(1, 2, 4, 8, 16), weight_dtype_bytes: int = 1,
                       admission_bytes: int = 4096,
                       network_bandwidth: float = NETWORK_GBPS * 1e9,
                       spec: DeviceSpec = H100_SXM) -> dict:
    """Cost-model prediction of multi-host DP serving scaling.

    Each host's decode step is the single-chip step (weights replicated);
    the only cross-host cost is the per-iteration admission broadcast
    (parallel/multihost.py DPServingGroup) over the network — a few KB against a
    multi-ms step, so predicted efficiency stays ~1 until thousands of
    hosts. This is the quantitative version of the 'DP scales hosts,
    TP scales latency' tradeoff (vs predict_scaling above).
    """
    weight_bytes = cfg.param_count() * weight_dtype_bytes
    step_s = weight_bytes / spec.hbm_bandwidth
    out = {}
    for n in hosts:
        bcast = 0.0 if n == 1 else \
            admission_bytes * (n - 1) / n / network_bandwidth + 10e-6 * np.log2(n)
        tot = step_s + bcast
        out[n] = {
            "predicted_step_ms": tot * 1e3,
            "broadcast_ms": bcast * 1e3,
            "tokens_per_s": n * batch_per_replica / tot,
            "efficiency": step_s / tot,
        }
    return out


def predict_scaling(cfg: ModelConfig, batch: int = 8,
                    mesh_sizes=(1, 2, 4, 8, 16),
                    weight_dtype_bytes: int = 1,
                    spec: DeviceSpec = H100_SXM) -> dict:
    """Cost-model prediction of TP decode scaling on `spec` cards: NVLink
    inside a host of CARDS_PER_HOST, the network beyond it."""
    model = CollectiveCostModel(spec)
    weight_bytes = cfg.param_count() * weight_dtype_bytes
    out = {}
    for n in mesh_sizes:
        compute = weight_bytes / n / spec.hbm_bandwidth  # memory-bound step
        act_bytes = batch * cfg.hidden_dim * 2
        comm = 2 * model.all_reduce_time(
            act_bytes, n, across_hosts=n > CARDS_PER_HOST) * cfg.num_layers
        step = max(compute, comm) if n > 1 else compute
        out[n] = {
            "predicted_step_ms": step * 1e3,
            "compute_ms": compute * 1e3,
            "comm_ms": comm * 1e3,
            "efficiency": compute / step if step else 1.0,
        }
    return out
