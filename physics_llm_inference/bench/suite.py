"""Comparison benchmark suite — the reference's per-chapter headline
experiments, one command, JSON out.

Mirrors: ch01/benchmark_ch01.py (MHA vs GQA, fused vs unfused SwiGLU),
ch02/benchmark_ch02.py (naive O(n^2) vs cached O(n) generation, KV sizes),
ch03 benches (GEMM vs GEMV roofline placement), ch05/tensor_cores.py
(precision speedups → here bf16 vs int8 weights), ch06 (flash vs naive
attention), ch07/static_batcher.py (padding waste).

Run: python -m physics_llm_inference.bench.suite [--quick]
"""
from __future__ import annotations

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from ..models import ModelConfig, init_params
from ..ops import gqa_attention, swiglu, fused_swiglu, kv_cache_bytes_per_token
from ..runtime import cached_generate, naive_generate
from ..sched import analyze_static_batching_waste
from ..utils.timing import benchmark_fn
from .micro import bench_gemm, bench_gemv, bench_attention


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def mha_vs_gqa(dim=1024, heads=8, seq=512, iters=10):
    """ref ch01/benchmark_ch01.py MHA vs GQA block latency + KV accounting."""
    x = jax.random.normal(jax.random.PRNGKey(0), (4, seq, dim), jnp.bfloat16)
    ks = jax.random.split(jax.random.PRNGKey(1), 4)
    hd = dim // heads
    out = {}
    for name, hkv in [("mha", heads), ("gqa4x", heads // 4)]:
        wq = jax.random.normal(ks[0], (dim, dim), jnp.bfloat16) * 0.05
        wk = jax.random.normal(ks[1], (dim, hkv * hd), jnp.bfloat16) * 0.05
        wv = jax.random.normal(ks[2], (dim, hkv * hd), jnp.bfloat16) * 0.05
        wo = jax.random.normal(ks[3], (dim, dim), jnp.bfloat16) * 0.05
        fn = jax.jit(lambda x: gqa_attention(x, wq, wk, wv, wo, heads, hkv))
        r = benchmark_fn(fn, x, iters=iters, name=name)
        out[name] = {"mean_ms": r.mean_ms,
                     "kv_bytes_per_token": kv_cache_bytes_per_token(hkv, hd)}
    out["kv_reduction"] = (out["mha"]["kv_bytes_per_token"]
                           / out["gqa4x"]["kv_bytes_per_token"])
    return out


def fused_vs_unfused(dim=1024, ff=2816, seq=512, iters=10):
    """ref ch01/benchmark_ch01.py fused vs unfused SwiGLU."""
    x = jax.random.normal(jax.random.PRNGKey(0), (4, seq, dim), jnp.bfloat16)
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    wg = jax.random.normal(ks[0], (dim, ff), jnp.bfloat16) * 0.05
    wu = jax.random.normal(ks[1], (dim, ff), jnp.bfloat16) * 0.05
    wd = jax.random.normal(ks[2], (ff, dim), jnp.bfloat16) * 0.05
    wgu = jnp.concatenate([wg, wu], axis=1)
    r_u = benchmark_fn(jax.jit(lambda x: swiglu(x, wg, wu, wd)), x,
                       iters=iters, name="unfused")
    r_f = benchmark_fn(jax.jit(lambda x: fused_swiglu(x, wgu, wd)), x,
                       iters=iters, name="fused")
    return {"unfused_ms": r_u.mean_ms, "fused_ms": r_f.mean_ms,
            "speedup": r_u.mean_ms / r_f.mean_ms}


def naive_vs_cached(prompt_len=64, new_tokens=64):
    """ref ch02/benchmark_ch02.py O(n^2) vs O(n) generation."""
    cfg = ModelConfig(vocab_size=1000, hidden_dim=256, num_layers=4,
                      num_heads=4, num_kv_heads=2, intermediate_dim=512,
                      max_seq_len=512, dtype="bfloat16")
    params = init_params(jax.random.PRNGKey(0), cfg)
    ids = jnp.ones((1, prompt_len), jnp.int32)
    import time

    naive_generate(params, cfg, ids, 4)  # compile
    t0 = time.perf_counter()
    naive_generate(params, cfg, ids, new_tokens)
    t_naive = time.perf_counter() - t0
    prompt = [1] * prompt_len
    cached_generate(params, cfg, [prompt], 4)  # compile
    out = cached_generate(params, cfg, [prompt], new_tokens)
    t_cached = out.prefill_s + out.decode_s
    return {"naive_s": t_naive, "cached_s": t_cached,
            "speedup": t_naive / t_cached if t_cached else 0.0}


def static_batching_waste():
    """ref ch07/static_batcher.py:71-109 on a skewed length distribution."""
    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.lognormal(4.5, 0.8, 256).clip(8, 2048)]
    return analyze_static_batching_waste(lens, batch_size=8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    iters = 3 if args.quick else 10

    results = {}
    log("[suite] mha vs gqa ...")
    results["mha_vs_gqa"] = mha_vs_gqa(iters=iters)
    log("[suite] fused vs unfused swiglu ...")
    results["swiglu_fusion"] = fused_vs_unfused(iters=iters)
    log("[suite] naive vs cached generation ...")
    results["naive_vs_cached"] = naive_vs_cached(
        prompt_len=32 if args.quick else 64,
        new_tokens=16 if args.quick else 64)
    log("[suite] gemm/gemv roofline ...")
    size = 1024 if args.quick else 4096
    results["gemm"] = bench_gemm(size, size, size, iters=iters)
    results["gemv_bf16"] = bench_gemv(8, size, size, iters=iters)
    results["gemv_int8"] = bench_gemv(8, size, size, iters=iters,
                                      int8_weights=True)
    log("[suite] flash vs naive attention ...")
    seq = 512 if args.quick else 2048
    results["attn_flash"] = bench_attention(seq=seq, iters=iters,
                                            use_flash=True)
    results["attn_naive"] = bench_attention(seq=seq, iters=iters,
                                            use_flash=False)
    log("[suite] static batching waste ...")
    results["static_batching"] = static_batching_waste()

    print(json.dumps(results, indent=2, default=float))


if __name__ == "__main__":
    main()
