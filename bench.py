"""Headline benchmark: decode tokens/sec/chip on the flagship dense model.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

vs_baseline is measured throughput / roofline speed-of-light throughput for
the same step (weights + live KV streamed from device memory once per token,
at the device table's bandwidth — specs/device.py; an unknown device is an
error). The reference publishes no measured numbers (BASELINE.md), so the
physics bound is the honest baseline. Times are host clock around
block_until_ready.

Diagnostics (device, card name and power limit, XLA_FLAGS) go to stderr;
stdout carries exactly the one JSON line.
"""
from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import os
    import subprocess

    from physics_llm_inference.models import (ModelConfig, init_params,
                                              quantize_params_int8)
    from physics_llm_inference.runtime import cached_generate
    from physics_llm_inference.runtime.kv_cache import calculate_kv_cache_size
    from physics_llm_inference.specs import get_device_spec
    from physics_llm_inference.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    # The headline is decode tokens/s on a 7B-class GQA model with INT8
    # weights + INT8 KV (the framework's native format); BENCH_MODEL=0.85b
    # selects a smaller model of the same family.
    model = os.environ.get("BENCH_MODEL", "7b")
    shapes = {
        "0.85b": dict(hidden_dim=2048, num_layers=16, num_heads=16,
                      num_kv_heads=4, intermediate_dim=5632),
        # ~6.9B params, initialized directly in int8
        "7b": dict(hidden_dim=4096, num_layers=32, num_heads=32,
                   num_kv_heads=8, intermediate_dim=11008),
    }[model]
    cfg = ModelConfig(vocab_size=32000, max_seq_len=2048, dtype="bfloat16",
                      **shapes)
    # decode is weight-streaming-bound at small batch, so tokens/s grows
    # with batch until the KV stream and the matmuls catch up (the ch03
    # batching lesson)
    batch = int(os.environ.get("BENCH_BATCH",
                               "64" if model == "7b" else "128"))
    prompt_len, new_tokens = 128, 128

    dev = jax.devices()[0]
    spec = get_device_spec(dev)   # raises for a device not in the table
    log(f"devices: {jax.devices()} platform {dev.platform} device_kind "
        f"{dev.device_kind!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    log(f"card (name, power limit): {card}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"model: {cfg.param_count()/1e9:.2f}B params INT8 W+KV, "
        f"batch {batch}, prompt {prompt_len}, decode {new_tokens}")

    # BENCH_WBITS=4: W4A16 blocks (nibble-packed, group scales) — halves
    # the weight stream that dominates 7B decode. Default 8.
    wbits = int(os.environ.get("BENCH_WBITS", "8"))
    if model == "7b":
        from physics_llm_inference.models.quant import (init_params_int4,
                                                            init_params_int8)

        init = init_params_int4 if wbits == 4 else init_params_int8
        params = init(jax.random.PRNGKey(0), cfg)
    else:
        params = quantize_params_int8(init_params(jax.random.PRNGKey(0), cfg))
        if wbits == 4:
            from physics_llm_inference.models.quant import \
                quantize_params_int4
            params = quantize_params_int4(params)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, prompt_len))
               for _ in range(batch)]

    t0 = time.time()
    out = cached_generate(params, cfg, prompts, new_tokens, temperature=0.0,
                          kv_dtype=jnp.int8)
    log(f"compile+first run: {time.time()-t0:.1f}s")
    # median of 5 steady-state runs
    runs = []
    for _ in range(5):
        out = cached_generate(params, cfg, prompts, new_tokens,
                              temperature=0.0, kv_dtype=jnp.int8)
        runs.append(out)
        log(f"steady: prefill {out.prefill_s*1e3:.1f} ms, "
            f"decode {out.decode_s*1e3:.1f} ms, "
            f"{out.decode_tokens_per_s:.1f} tok/s")
    runs.sort(key=lambda o: o.decode_tokens_per_s)
    out = runs[len(runs) // 2]
    tok_s = out.decode_tokens_per_s
    # p50 TTFT: batched prefill → every request's first token lands together,
    # so the batch prefill wall time IS each request's TTFT
    ttft_p50_ms = out.prefill_s * 1e3

    # Speed-of-light decode throughput: every weight byte + live KV byte
    # crosses device memory once per step (param_count at the native weight
    # width; scales excluded)
    weight_bytes = cfg.param_count() * wbits // 8
    kv = calculate_kv_cache_size(batch, prompt_len + new_tokens,
                                 cfg.num_layers, cfg.num_kv_heads,
                                 cfg.head_dim, 1)  # int8 KV
    step_floor_s = (weight_bytes + kv["total_bytes"]) / spec.hbm_bandwidth
    sol_tok_s = batch / step_floor_s
    log(f"roofline floor: {step_floor_s*1e6:.0f} µs/step → {sol_tok_s:.0f} tok/s "
        f"speed-of-light on {spec.name}")

    print(json.dumps({
        "metric": "decode_tokens_per_s_per_chip",
        "value": round(tok_s, 1),
        "unit": "tokens/s",
        "vs_baseline": round(tok_s / sol_tok_s, 4),
        "ttft_p50_ms": round(ttft_p50_ms, 1),
    }))


if __name__ == "__main__":
    main()
