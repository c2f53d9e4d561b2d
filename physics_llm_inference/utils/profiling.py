"""Tracing / profiling utilities.

The reference has no tracing framework — only sync+perf_counter loops and
peak-memory probes (SURVEY.md §5). Realized here:
- trace(): context manager around jax.profiler.trace → xplane/Perfetto dump
  viewable in XProf/TensorBoard (the nsys/ncu equivalent the reference only
  mentions in docstrings, ch04/__init__.py:8).
- device_memory_stats(): per-device memory usage (peak-memory probe analogue of
  torch.cuda.max_memory_allocated, ref ch01/benchmark_ch01.py:140-146).
- dispatch_overhead(): measures per-call dispatch latency — the analogue
  of the reference's kernel-launch-overhead bench (ch04/launch_overhead.py),
  where the fix is jit-fusing many ops into one dispatch instead of CUDA
  graphs.
"""
from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/jax-trace"):
    """Capture a device trace: `with trace('/tmp/t'): step()` then open in
    XProf/TensorBoard."""
    with jax.profiler.trace(log_dir):
        yield log_dir


def device_memory_stats(device=None) -> dict:
    dev = device or jax.devices()[0]
    stats = getattr(dev, "memory_stats", lambda: None)()
    if not stats:
        return {"available": False}
    return {
        "available": True,
        "bytes_in_use": stats.get("bytes_in_use", 0),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use", 0),
        "bytes_limit": stats.get("bytes_limit", 0),
    }


def dispatch_overhead(iters: int = 50) -> dict:
    """Per-dispatch overhead: tiny kernel, timed individually vs pipelined
    (ref ch04/launch_overhead.py:16-61 many-small vs one-big)."""
    f = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros((8, 128))
    jax.block_until_ready(f(x))
    # individually synced dispatches
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(f(x))
    synced = (time.perf_counter() - t0) / iters
    # pipelined: enqueue all, sync once (async dispatch hides host latency)
    t0 = time.perf_counter()
    y = x
    for _ in range(iters):
        y = f(y)
    jax.block_until_ready(y)
    pipelined = (time.perf_counter() - t0) / iters
    return {
        "synced_us_per_dispatch": synced * 1e6,
        "pipelined_us_per_dispatch": pipelined * 1e6,
        "pipelining_speedup": synced / pipelined if pipelined else 0.0,
    }


def fusion_benefit(n_ops: int = 8, size: int = 1 << 20, iters: int = 20) -> dict:
    """Unfused (n dispatches) vs jit-fused (one) elementwise chain
    (ref ch04/launch_overhead.py:112-149 unfused vs fused ops)."""
    x = jnp.ones((size // 128, 128))

    def chain(x):
        for i in range(n_ops):
            x = x * 1.0001 + 0.001
        return x

    fused = jax.jit(chain)
    step = jax.jit(lambda x: x * 1.0001 + 0.001)

    def unfused(x):
        for _ in range(n_ops):
            x = step(x)
        return x

    jax.block_until_ready(fused(x)); jax.block_until_ready(unfused(x))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fused(x)
    jax.block_until_ready(out)
    t_f = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = unfused(x)
    jax.block_until_ready(out)
    t_u = (time.perf_counter() - t0) / iters
    return {"fused_ms": t_f * 1e3, "unfused_ms": t_u * 1e3,
            "fusion_speedup": t_u / t_f if t_f else 0.0}
