"""Microbenchmarks with roofline attribution.

Port of the reference's kernel-level benches: GEMM (prefill proxy,
ch03/gemm_benchmark.py:26-82), GEMV/batched-GEMV (decode proxy,
ch03/gemv_benchmark.py:26-72, ch03/batching_benchmark.py:16-94), and
attention. Every result is attributed against the roofline of the device
the benchmark runs on (specs/device.py table; an unknown device raises).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..specs import get_device_spec, roofline_throughput
from ..utils.timing import benchmark_fn


def _roofline_frac(flops: float, bytes_moved: float, seconds: float,
                   dtype: str) -> dict:
    spec = get_device_spec()
    ai = flops / bytes_moved
    attainable = roofline_throughput(ai, spec, dtype)
    achieved = flops / seconds
    return {
        "achieved_tflops": achieved / 1e12,
        "attainable_tflops": attainable / 1e12,
        "roofline_fraction": achieved / attainable,
        "arithmetic_intensity": ai,
        "gb_per_s": bytes_moved / seconds / 1e9,
    }


def bench_gemm(m: int = 4096, n: int = 4096, k: int = 4096,
               dtype=jnp.bfloat16, iters: int = 10) -> dict:
    """Prefill-shaped GEMM (ref ch03/gemm_benchmark.py:26-82)."""
    a = jax.random.normal(jax.random.PRNGKey(0), (m, k), dtype)
    b = jax.random.normal(jax.random.PRNGKey(1), (k, n), dtype)
    fn = jax.jit(lambda a, b: jnp.dot(a, b))
    r = benchmark_fn(fn, a, b, iters=iters, name=f"gemm {m}x{n}x{k}")
    itemsize = jnp.dtype(dtype).itemsize
    moved = itemsize * (m * k + k * n + m * n)
    out = {"mean_ms": r.mean_ms, "shape": (m, n, k)}
    out.update(_roofline_frac(2.0 * m * n * k, moved, r.mean_ms / 1e3,
                              "bf16" if dtype == jnp.bfloat16 else "fp32"))
    return out


def bench_gemv(batch: int = 1, n: int = 4096, k: int = 4096,
               dtype=jnp.bfloat16, iters: int = 20,
               int8_weights: bool = False) -> dict:
    """Decode-shaped (batched) GEMV (ref ch03/gemv_benchmark.py:26-72,
    batching sweep ch03/batching_benchmark.py:16-58). With int8_weights=True
    runs the model's INT8 weight-only matmul — weight bytes halve, so the
    memory-bound ceiling doubles."""
    x = jax.random.normal(jax.random.PRNGKey(0), (batch, k), dtype)
    w = jax.random.normal(jax.random.PRNGKey(1), (k, n), jnp.float32)
    if int8_weights:
        from ..kernels.quant import quantize_int8
        from ..models.quant import QuantizedTensor
        from ..models.transformer import _linear

        wq = QuantizedTensor(*quantize_int8(w, axis=0))
        fn = jax.jit(lambda x: _linear(x, wq))
        weight_bytes = wq.q.nbytes + wq.s.nbytes
    else:
        wd = w.astype(dtype)
        fn = jax.jit(lambda x: jnp.dot(x, wd))
        weight_bytes = wd.nbytes
    r = benchmark_fn(fn, x, iters=iters, name=f"gemv b{batch} {k}x{n}")
    itemsize = jnp.dtype(dtype).itemsize
    moved = weight_bytes + itemsize * (batch * k + batch * n)
    out = {"mean_ms": r.mean_ms, "batch": batch, "int8": int8_weights}
    out.update(_roofline_frac(2.0 * batch * n * k, moved, r.mean_ms / 1e3,
                              "bf16" if dtype == jnp.bfloat16 else "fp32"))
    return out


def bench_attention(batch: int = 4, heads: int = 16, kv_heads: int = 4,
                    seq: int = 2048, head_dim: int = 128,
                    dtype=jnp.bfloat16, iters: int = 10,
                    use_flash: bool = True, causal: bool = True) -> dict:
    """Flash vs naive attention (ref ch06 benches). Flash is cuDNN's fused
    attention on a GPU (jax.nn.dot_product_attention), XLA's elsewhere."""
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(ks[0], (batch, heads, seq, head_dim), dtype)
    k = jax.random.normal(ks[1], (batch, kv_heads, seq, head_dim), dtype)
    v = jax.random.normal(ks[2], (batch, kv_heads, seq, head_dim), dtype)
    if use_flash:
        impl = "cudnn" if jax.default_backend() == "gpu" else None
        bshd = lambda t: t.transpose(0, 2, 1, 3)
        fn = jax.jit(lambda q, k, v: jax.nn.dot_product_attention(
            bshd(q), bshd(k), bshd(v), is_causal=causal,
            implementation=impl))
    else:
        from ..ops.gqa import grouped_sdpa

        mask = None
        if causal:
            idx = jnp.arange(seq)
            mask = (idx[None, :] <= idx[:, None])[None, None, None]
        fn = jax.jit(lambda q, k, v: grouped_sdpa(q, k, v, mask=mask))
    r = benchmark_fn(fn, q, k, v, iters=iters,
                     name=f"attn s{seq} {'flash' if use_flash else 'naive'}")
    flops = 4.0 * batch * heads * seq * seq * head_dim * (0.5 if causal else 1.0)
    moved = q.nbytes * 2 + k.nbytes + v.nbytes
    out = {"mean_ms": r.mean_ms, "flash": use_flash, "seq": seq}
    out.update(_roofline_frac(flops, moved, r.mean_ms / 1e3,
                              "bf16" if dtype == jnp.bfloat16 else "fp32"))
    return out


def roofline_report(results: list[dict]) -> str:
    lines = ["kernel roofline report:"]
    for r in results:
        lines.append(
            f"  {r.get('shape', r.get('seq', r.get('batch')))}: "
            f"{r['achieved_tflops']:.1f}/{r['attainable_tflops']:.1f} TF "
            f"({100*r['roofline_fraction']:.0f}% of roofline, "
            f"AI {r['arithmetic_intensity']:.1f})")
    return "\n".join(lines)


def bench_precision(size: int = 4096, iters: int = 10) -> dict:
    """bf16 (tensor cores) vs fp32 matmul throughput — the reference's
    tensor-core detection bench (ch05/tensor_cores.py:28-74,
    verify_tensor_core_usage :112-130: >1.5x speedup heuristic)."""
    a32 = jax.random.normal(jax.random.PRNGKey(0), (size, size), jnp.float32)
    b32 = jax.random.normal(jax.random.PRNGKey(1), (size, size), jnp.float32)
    a16, b16 = a32.astype(jnp.bfloat16), b32.astype(jnp.bfloat16)
    f32 = jax.jit(lambda a, b: jnp.dot(a, b,
                                       precision=jax.lax.Precision.HIGHEST))
    f16 = jax.jit(lambda a, b: jnp.dot(a, b))
    r32 = benchmark_fn(f32, a32, b32, iters=iters, name="fp32")
    r16 = benchmark_fn(f16, a16, b16, iters=iters, name="bf16")
    speedup = r32.mean_ms / r16.mean_ms
    return {
        "fp32_ms": r32.mean_ms,
        "bf16_ms": r16.mean_ms,
        "speedup": speedup,
        "tensor_core_path_detected": speedup > 1.5,
    }
