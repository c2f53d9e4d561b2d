"""Command-line entry points: serve / bench / generate.

The reference has no CLI (entry = `python -m chNN.script`, README.md:64-72);
this provides the operational surface a real framework needs:

  python -m physics_llm_inference.cli serve --port 8000 [--config small]
  python -m physics_llm_inference.cli bench [--config small] [--batch 8]
  python -m physics_llm_inference.cli generate --prompt "..." [--max-tokens N]

Configs are named presets (toy/small/1b/llama7b/qwen3); --ckpt loads a native
.npz checkpoint, --hf loads a safetensors directory; --int8 selects the native
format (INT8 weights and INT8 KV cache).
"""
from __future__ import annotations

import argparse
import json
import sys

import jax


def _named_config(name: str):
    from .models.config import (LLAMA_7B_CONFIG, ModelConfig, QWEN3_CONFIG,
                                TOY_CONFIG)

    presets = {
        "toy": TOY_CONFIG,
        "small": ModelConfig(vocab_size=8192, hidden_dim=512, num_layers=8,
                             num_heads=8, num_kv_heads=2,
                             intermediate_dim=1408, max_seq_len=1024,
                             dtype="bfloat16"),
        "1b": ModelConfig(vocab_size=32000, hidden_dim=2048, num_layers=16,
                          num_heads=16, num_kv_heads=4,
                          intermediate_dim=5632, max_seq_len=2048,
                          dtype="bfloat16"),
        "llama7b": LLAMA_7B_CONFIG,
        "qwen3": QWEN3_CONFIG,
    }
    if name not in presets:
        raise SystemExit(f"unknown config '{name}'; choose from "
                         f"{sorted(presets)}")
    return presets[name]


def _load_model(args):
    from .models import init_params
    from .models.loader import load_llama, load_params
    from .models.quant import init_params_int8

    cfg = _named_config(args.config)
    if args.hf:
        params = load_llama(args.hf, cfg, int8=args.int8)
    elif args.ckpt:
        params = load_params(args.ckpt)
    else:
        print(f"[cli] random-init {args.config} "
              f"({cfg.param_count()/1e6:.0f}M params)", file=sys.stderr)
        # random weights: sample the int8 format directly (no bf16 copy)
        init = init_params_int8 if args.int8 else init_params
        params = init(jax.random.PRNGKey(0), cfg)
    return params, cfg


def _add_model_args(p):
    p.add_argument("--config", default="small")
    p.add_argument("--ckpt", help="native .npz checkpoint")
    p.add_argument("--hf", help="HF safetensors directory")
    p.add_argument("--int8", action="store_true",
                   help="native format: INT8 weights and INT8 KV cache")


def cmd_serve(args):
    from .serve import EngineConfig, InferenceEngine
    from .serve.http_server import InferenceServer

    if args.tp > 1 and jax.default_backend() == "gpu":
        # scripts/tp_check.py reproduces the fault on four GPUs
        raise SystemExit("--tp > 1 is refused on GPUs: the tensor-parallel "
                         "engines emit wrong tokens there (ROADMAP.md, item "
                         "0). Serve on one GPU.")
    params, cfg = _load_model(args)
    kv_dtype = "int8" if args.int8 else None
    mesh = None
    if args.tp > 1 or args.dp > 1:
        # sharded serving: a (data, model) mesh over local devices — the
        # engine Megatron-shards the params and KV pools onto it
        # (parallel/tp.py) and every decode step executes the psums /
        # logits all-gather over the mesh
        from .parallel import make_mesh

        need = args.tp * args.dp
        have = len(jax.devices())
        if need > have:
            raise SystemExit(f"--tp {args.tp} x --dp {args.dp} needs {need} "
                             f"devices, have {have}")
        mesh = make_mesh(data=args.dp, model=args.tp)
        print(f"[cli] mesh data={args.dp} model={args.tp}", file=sys.stderr)
    if args.paged:
        from .serve.paged_engine import PagedEngineConfig, PagedInferenceEngine

        pc = PagedEngineConfig.for_context(args.slots, args.max_seq_len,
                                           kv_dtype=kv_dtype)
        engine = PagedInferenceEngine(params, cfg, pc, mesh=mesh)
    else:
        engine = InferenceEngine(params, cfg, EngineConfig(
            num_slots=args.slots, max_seq_len=args.max_seq_len,
            kv_dtype=kv_dtype), mesh=mesh)
    server = InferenceServer(engine, host=args.host, port=args.port,
                             model_name=args.config)
    print(f"[cli] serving on http://{args.host}:{server.port}",
          file=sys.stderr)
    if args.check:
        # config/mesh/engine validation mode: everything is constructed
        # (params sharded, server bound) but no request loop starts
        server.close()
        print("[cli] check ok", file=sys.stderr)
        return
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


def cmd_generate(args):
    from .runtime import cached_generate
    from .serve.tokenizer_pool import TokenizerPool

    params, cfg = _load_model(args)
    tok = TokenizerPool(num_workers=1)
    prompt = tok.tokenize(args.prompt)
    out = cached_generate(params, cfg, [prompt], args.max_tokens,
                          temperature=args.temperature,
                          kv_dtype="int8" if args.int8 else None)
    print(tok.detokenize([int(t) for t in out.tokens[0]]))
    print(f"[cli] ttft {out.prefill_s*1e3:.1f} ms, "
          f"{out.decode_tokens_per_s:.1f} tok/s", file=sys.stderr)


def cmd_bench(args):
    from .bench import BenchmarkConfig, run_benchmark
    from .runtime import cached_generate

    params, cfg = _load_model(args)

    def generate_fn(prompt, max_tokens):
        out = cached_generate(params, cfg, [prompt], max_tokens,
                              temperature=0.0,
                              kv_dtype="int8" if args.int8 else None)
        return {"tokens": list(out.tokens[0]), "ttft_s": out.prefill_s}

    res = run_benchmark(BenchmarkConfig(
        num_requests=args.requests, concurrency=1,
        prompt_len=args.prompt_len, max_tokens=args.max_tokens), generate_fn)
    print(res.summary(), file=sys.stderr)
    print(json.dumps(res.to_dict()))


def main(argv=None):
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="physics_llm_inference")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="run the OpenAI-compatible HTTP server")
    _add_model_args(s)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--slots", type=int, default=8)
    s.add_argument("--max-seq-len", type=int, default=1024)
    s.add_argument("--paged", action="store_true",
                   help="paged-KV engine with radix prefix cache")
    s.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (mesh 'model' axis)")
    s.add_argument("--dp", type=int, default=1,
                   help="data-parallel ways (mesh 'data' axis; slots "
                        "shard across it)")
    s.add_argument("--check", action="store_true",
                   help="construct engine+server (incl. mesh sharding), "
                        "then exit — config validation")
    s.set_defaults(fn=cmd_serve)

    g = sub.add_parser("generate", help="one-shot generation")
    _add_model_args(g)
    g.add_argument("--prompt", required=True)
    g.add_argument("--max-tokens", type=int, default=64)
    g.add_argument("--temperature", type=float, default=0.0)
    g.set_defaults(fn=cmd_generate)

    b = sub.add_parser("bench", help="serving benchmark")
    _add_model_args(b)
    b.add_argument("--requests", type=int, default=16)
    b.add_argument("--prompt-len", type=int, default=64)
    b.add_argument("--max-tokens", type=int, default=32)
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
