"""MoE decode throughput on the GPU (BASELINE config 5).

Serves an INT8 MoE config through the integrated generation path
(cached_generate; this measures the routed-FFN cost) and reports tok/s + TTFT against
two floors:

- all-expert floor: every expert's weights stream per step (what GShard
  dense-dispatch einsums actually do — the (E,C,D)x(E,D,F) batched matmul
  reads all E experts regardless of routing);
- active-expert floor: only routed experts' weights stream (what a
  gather-style implementation could approach at small batch).

Usage:  python scripts/bench_moe.py [--batch 32] [--layers 16]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=2048)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--topk", type=int, default=2)
    ap.add_argument("--expert-ff", type=int, default=2816)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--decode", type=int, default=64)
    ap.add_argument("--engine", action="store_true",
                    help="serve the MoE model through the SLOT engine "
                         "(continuous batching + decode horizon) instead "
                         "of cached_generate")
    args = ap.parse_args()

    from physics_llm_inference.models import (ModelConfig, init_params,
                                                  quantize_params_int8)
    from physics_llm_inference.runtime import cached_generate
    from physics_llm_inference.specs import get_device_spec

    cfg = ModelConfig(vocab_size=32000, max_seq_len=1024, dtype="bfloat16",
                      hidden_dim=args.hidden, num_layers=args.layers,
                      num_heads=args.hidden // 128, num_kv_heads=4,
                      intermediate_dim=args.expert_ff,
                      num_experts=args.experts,
                      num_experts_per_tok=args.topk,
                      expert_capacity_factor=1.25)
    # init_params_int8 is dense-only; MoE leaves come from the bf16 init +
    # quantization pass
    params = quantize_params_int8(init_params(jax.random.PRNGKey(0), cfg))
    # real parameter count from leaf sizes (ModelConfig.param_count is
    # dense-only and undercounts the E-times expert stacks)
    total = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        params, is_leaf=lambda x: hasattr(x, "shape")))
    expert_w = (cfg.num_layers * cfg.num_experts * 3 * cfg.hidden_dim
                * cfg.intermediate_dim)
    active = total - expert_w + (expert_w * args.topk // args.experts
                                 if args.experts else 0)
    print(f"MoE: {total/1e9:.2f}B total / {active/1e9:.2f}B active params "
          f"({args.experts} experts top-{args.topk}), INT8 W+KV, "
          f"batch {args.batch}", file=sys.stderr)

    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, args.prompt))
               for _ in range(args.batch)]

    if args.engine:
        # MoE through the integrated SLOT engine: continuous batching,
        # chunked prefill, multi-step decode — the per-op MoE FFN path
        # dispatched by the same _ffn the dense engine uses. Closed-loop
        # 2x oversubscription; ch10 harness metrics.
        from physics_llm_inference.bench.harness import (
            BenchmarkConfig, run_benchmark)
        from physics_llm_inference.serve.engine import (
            EngineConfig, GenerationRequest, InferenceEngine)
        from physics_llm_inference.serve.http_server import ServingLoop

        ec = EngineConfig(num_slots=args.batch,
                          max_seq_len=-(-(args.prompt + args.decode)
                                        // 128) * 128,
                          kv_dtype="int8", decode_horizon=8,
                          prompt_buckets=(128,))
        engine = InferenceEngine(params, cfg, ec)
        loop = ServingLoop(engine)

        def generate_fn(prompt_tokens, max_tokens):
            rid = engine.submit_request(GenerationRequest(
                prompt_tokens=prompt_tokens, max_tokens=max_tokens,
                temperature=0.0))
            loop.notify()
            res = engine.wait_result(rid, timeout=900.0)
            assert res is not None, "engine loop dead?"
            return {"tokens": res.tokens, "ttft_s": res.ttft_s}

        def prompt_fn(i):
            return list(rng.integers(1, cfg.vocab_size, args.prompt))

        n_req = 2 * args.batch
        warm = BenchmarkConfig(num_requests=n_req, concurrency=args.batch,
                               warmup_requests=1, prompt_len=args.prompt,
                               max_tokens=args.decode)
        t0 = time.time()
        run_benchmark(warm, generate_fn, prompt_fn)
        print(f"[moe-engine] warm wave done at {time.time()-t0:.0f}s",
              file=sys.stderr, flush=True)
        bc = BenchmarkConfig(num_requests=n_req, concurrency=args.batch,
                             warmup_requests=0, prompt_len=args.prompt,
                             max_tokens=args.decode)
        result = run_benchmark(bc, generate_fn, prompt_fn)
        loop.shutdown()
        out = result.to_dict()
        out["metric"] = "moe_serving_slot_engine"
        out["config"] = {"slots": args.batch, "prompt": args.prompt,
                         "decode": args.decode, "horizon": 8}
        print(json.dumps(out))
        print(result.summary(), file=sys.stderr)
        return

    t0 = time.time()
    out = cached_generate(params, cfg, prompts, args.decode,
                          temperature=0.0, kv_dtype=jnp.int8)
    print(f"compile+first: {time.time()-t0:.1f}s", file=sys.stderr)
    runs = []
    for _ in range(3):
        out = cached_generate(params, cfg, prompts, args.decode,
                              temperature=0.0, kv_dtype=jnp.int8)
        runs.append(out)
        print(f"steady: prefill {out.prefill_s*1e3:.1f} ms, "
              f"{out.decode_tokens_per_s:.1f} tok/s", file=sys.stderr)
    runs.sort(key=lambda o: o.decode_tokens_per_s)
    out = runs[len(runs) // 2]

    spec = get_device_spec()
    kv_bytes = (2 * cfg.num_layers * args.batch
                * (args.prompt + args.decode) * cfg.num_kv_heads
                * cfg.head_dim)
    floor_all = (total + kv_bytes) / spec.hbm_bandwidth
    floor_active = (active + kv_bytes) / spec.hbm_bandwidth
    sol_all = args.batch / floor_all
    sol_active = args.batch / floor_active
    print(json.dumps({
        "metric": "moe_decode_tokens_per_s_per_chip",
        "value": round(out.decode_tokens_per_s, 1),
        "unit": "tokens/s",
        "vs_all_expert_floor": round(out.decode_tokens_per_s / sol_all, 4),
        "vs_active_expert_floor": round(
            out.decode_tokens_per_s / sol_active, 4),
        "ttft_p50_ms": round(out.prefill_s * 1e3, 1),
        "total_params_b": round(total / 1e9, 2),
        "active_params_b": round(active / 1e9, 2),
    }))


if __name__ == "__main__":
    main()
