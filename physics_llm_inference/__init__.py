"""physics_llm_inference — a quantized LLM inference engine for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas framework covering the full capability arc
of the reference codebase (Infatoshi/physics-llm-inference): transformer ops,
KV-cached generation, roofline analysis, fused decode attention, continuous
batching with paged KV + radix prefix cache, chunked prefill, MoE routing,
tensor parallelism over a device mesh, and an OpenAI-compatible serving layer.

Subpackages (capability <-> reference chapter mapping in SURVEY.md §7):
  specs     device table, roofline, NVLink/network collective cost models (ch03/ch04/ch09)
  ops       pure-JAX model ops: attention, GQA, FFN, norms, RoPE, sampling (ch01)
  kernels   INT8 quantizers and the INT8-KV paged decode attention kernel (ch05/ch06)
  models    transformer/MoE model definitions, configs, quantization (ch01/ch09)
  runtime   KV caches (dense/paged/INT8), generation loops, decode step cache (ch02/ch07/ch08)
  sched     batchers, schedulers, chunked prefill, mixed batches (ch07/ch08)
  parallel  mesh construction, TP/EP sharding rules, collectives (ch09)
  serve     inference engine, tokenizer pool, OpenAI-compatible API (ch10)
  bench     benchmark harness with TTFT/latency percentiles (ch10)
  utils     timing/benchmark helpers
"""

__version__ = "0.1.0"
