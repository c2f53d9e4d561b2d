"""Speculative decoding evidence at the 7B headline config.

Measures end-to-end tok/s and accepted-tokens/dispatch with
EngineConfig.speculative_k on vs off, on two prompt classes:

- repetitive: a repeated n-gram pattern the prompt-lookup drafter nails
  (upper bound — every draft accepted);
- realistic: random token prompts where a random-init model's greedy
  continuations almost never match a prompt n-gram (lower bound — measures
  the OVERHEAD of drafting + the (slots, k+1) verify forward when nothing
  accepts).

The two bracket the deployment question: prompt-lookup speculation pays
exactly in proportion to how much of the output restates the prompt
(extraction, quoting, code edit loops), and costs the verify-width
overhead when it doesn't. Ref: ch08 (multi-token-per-dispatch family).

Usage: python scripts/bench_speculative.py [--k 4] [--slots 8]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import jax
import numpy as np


def run_case(params, cfg, k, prompts, decode, label):
    from physics_llm_inference.serve.engine import (EngineConfig,
                                                        GenerationRequest,
                                                        InferenceEngine)

    eng = InferenceEngine(params, cfg, EngineConfig(
        num_slots=len(prompts), max_seq_len=512, kv_dtype="int8",
        speculative_k=k))
    rids = [eng.submit_request(GenerationRequest(
        prompt_tokens=p, max_tokens=decode, temperature=0.0))
        for p in prompts]
    t0 = time.time()
    eng.run_until_done(rids)
    wall = time.time() - t0
    toks = sum(len(eng.get_result(r).tokens) for r in rids)
    s = eng.stats()
    spec = s.get("speculative", {})
    row = {
        "case": label, "k": k, "wall_s": round(wall, 2),
        "tokens": toks, "tok_per_s": round(toks / wall, 1),
        "tokens_per_dispatch": round(spec.get("tokens_per_dispatch", 1.0), 3),
        "dispatches": spec.get("dispatches", 0),
    }
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--decode", type=int, default=64)
    args = ap.parse_args()

    from physics_llm_inference.models import ModelConfig
    from physics_llm_inference.models.quant import init_params_int8

    cfg = ModelConfig(vocab_size=32000, max_seq_len=512, dtype="bfloat16",
                      hidden_dim=4096, num_layers=32, num_heads=32,
                      num_kv_heads=8, intermediate_dim=11008)
    print("[spec] init 7B int8 params...", file=sys.stderr, flush=True)
    params = init_params_int8(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)

    # repetitive: the model's greedy output on a cycled pattern revisits
    # prompt n-grams, so prompt-lookup drafts hit
    pat = list(rng.integers(1, cfg.vocab_size, 16))
    rep = [(pat * (args.prompt // 16 + 1))[:args.prompt]
           for _ in range(args.slots)]
    rnd = [list(rng.integers(1, cfg.vocab_size, args.prompt))
           for _ in range(args.slots)]

    rows = []
    for label, prompts in (("repetitive", rep), ("realistic", rnd)):
        for k in (0, args.k):
            rows.append(run_case(params, cfg, k, prompts, args.decode,
                                 label))
    print(json.dumps({"metric": "speculative_7b", "rows": rows}))


if __name__ == "__main__":
    main()
