"""Smoke test of the serving engine on NVIDIA GPUs, at full model width.

    python chip_smoke.py             # one GPU: every phase below
    python chip_smoke.py --cards 4   # four GPUs: the tensor-parallel serving
                                     # path only, against one GPU

Phases (one process; the only child is nvidia-smi, which stays off JAX):
  device    devices, card name and power limit, XLA_FLAGS, JAX version,
            compile-cache directory; exits non-zero without a GPU
  kernels   the INT8 paged decode kernel compiled for the card at the 7B
            widths: its error against the f32 reference, its time against
            the plain XLA path the models take off the GPU; the rate of
            a large bf16 matmul and of a large device copy, for scale
  generate  runtime.cached_generate on the llama7b preset (INT8 weights,
            INT8 KV, random weights from a seed): batch 8, prompt 128,
            64 new tokens, greedy; compile seconds, memory analysis, peak
            memory
  serve     the HTTP server over the slot engine, then over the paged
            engine (radix prefix reuse on): one plain and one streamed
            chat completion, then 4 concurrent ones, two of them sharing a
            cached prefix

Every generated token is checked by teacher forcing the sequence through the
plain uncached forward (dense attention, f32 compute, the same INT8
weights): the emitted token's reference logit must lie within LOGIT_BAND of
that position's maximum. Any failure raises, and the script exits non-zero.
The last line of stdout is the JSON result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

SEED = 0
# Decode-kernel tolerance, max-abs on unit-variance inputs: the kernel feeds
# q, dequantized K and the probabilities to the tensor cores in bf16 (~4e-3
# relative each), summed over up to 4k positions; the reference dequantizes
# exactly and attends in f32.
KERNEL_TOL = 2e-2
# Output band, in logit units: with random weights the logits have unit
# scale (rms-normed hidden state times a 1/sqrt(d)-scaled head), bf16
# compute plus INT8 KV move them by a few hundredths, while a token from a
# wrong cache or kernel lands ~4 units (the spread of 32k unit-variance
# logits) below the maximum.
LOGIT_BAND = 0.5


def log(*a):
    print(*a, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def median_seconds(fn, *args, iters: int = 20) -> float:
    """Median host time of fn(*args) to completion (block_until_ready),
    after one untimed call that compiles."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def per_call_seconds(fn, args, calls: int = 20) -> float:
    """Device-bound time of one fn(q, *rest) call: `calls` calls chained in
    one compiled loop (each output feeds the next query), so the host's
    dispatch cost is paid once rather than per call."""
    import jax
    from jax import lax

    def chained(q, *rest):
        step = lambda i, q: q + (1e-3 * fn(q, *rest)).astype(q.dtype)
        return lax.fori_loop(0, calls, step, q)

    return median_seconds(jax.jit(chained), *args, iters=5) / calls


# ---------------------------------------------------------------- device

def phase_device(cards: int):
    import jax

    from physics_llm_inference.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    log(f"[device] jax {jax.__version__}, devices {devs}")
    log(f"[device] platform {devs[0].platform}, kind {devs[0].device_kind!r},"
        f" count {len(devs)}")
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (platform "
                         f"{devs[0].platform!r}); nothing was measured")
    if len(devs) < cards:
        raise SystemExit(f"chip_smoke: --cards {cards} needs {cards} GPUs, "
                         f"found {len(devs)}")
    log(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[device] compile cache {cache}")
    log(f"[device] card (name, power limit): {card_info()}")
    return devs


# --------------------------------------------------------------- kernels

def _paged_case(key, *, b, hq, hkv, d, ctx, page, layers=2):
    """Random int8 pools with scattered page tables and ragged windows."""
    import jax
    import jax.numpy as jnp

    n = ctx // page
    pages = b * n + 8
    ks = jax.random.split(key, 6)
    shape = (layers, pages, page, hkv * d)
    kq = jax.random.randint(ks[0], shape, -127, 128, jnp.int8)
    vq = jax.random.randint(ks[1], shape, -127, 128, jnp.int8)
    # scales of unit-variance values quantized by absmax (~3σ / 127)
    sc = lambda k: jax.random.uniform(k, (layers, pages, page, hkv),
                                      jnp.float32, 0.015, 0.03)
    k_s, v_s = sc(ks[2]), sc(ks[3])
    perm = np.random.default_rng(SEED).permutation(pages)[:2 * b * n]
    kp = jnp.asarray(perm[:b * n].reshape(b, n), jnp.int32)
    vp = jnp.asarray(perm[b * n:].reshape(b, n) if 2 * b * n <= pages
                     else perm[:b * n][::-1].reshape(b, n), jnp.int32)
    q = jax.random.normal(ks[4], (b, hq, d), jnp.bfloat16)
    rng = np.random.default_rng(SEED + ctx + hkv)
    hi = rng.integers(ctx // 2, ctx + 1, b)
    hi[0] = ctx
    lo = np.zeros(b, np.int64)
    lo[1] = 7
    return (q, kq, k_s, vq, v_s, kp, vp, jnp.asarray(lo, jnp.int32),
            jnp.asarray(hi, jnp.int32), jnp.int32(layers - 1))


def phase_kernels(layers_per_step: int = 32):
    import jax
    import jax.numpy as jnp

    from physics_llm_inference.kernels.decode_attention import (
        int8_paged_decode_attention, int8_paged_decode_attention_reference,
        int8_paged_decode_attention_xla)

    kernel = jax.jit(partial(int8_paged_decode_attention, interpret=False))
    plain = jax.jit(int8_paged_decode_attention_xla)
    reference = jax.jit(int8_paged_decode_attention_reference)
    key = jax.random.PRNGKey(SEED)
    for hkv in (32, 8):
        for ctx in (1024, 4096):
            args = _paged_case(key, b=8, hq=32, hkv=hkv, d=128, ctx=ctx,
                               page=128)
            text = kernel.lower(*args).as_text()
            if "int8_paged_decode_attention" not in text:
                raise AssertionError("decode kernel missing from the "
                                     "lowered program")
            t0 = time.perf_counter()
            got = jax.block_until_ready(kernel(*args))
            compile_s = time.perf_counter() - t0
            ref = jax.block_until_ready(reference(*args))
            err = float(jnp.max(jnp.abs(got.astype(jnp.float32)
                                        - ref.astype(jnp.float32))))
            if not (np.isfinite(err) and err <= KERNEL_TOL):
                raise AssertionError(
                    f"decode kernel hkv={hkv} ctx={ctx}: max|err| {err} > "
                    f"{KERNEL_TOL}")
            xla_err = float(jnp.max(jnp.abs(
                plain(*args).astype(jnp.float32) - ref.astype(jnp.float32))))
            tk = per_call_seconds(kernel, args)
            tx = per_call_seconds(plain, args)
            log(f"[kernels] int8 paged decode B=8 Hq=32 Hkv={hkv} d=128 "
                f"ctx={ctx} (ragged, scattered pages): kernel {tk*1e6:.1f} "
                f"us, XLA {tx*1e6:.1f} us per layer; x{layers_per_step} "
                f"layers: kernel {tk*layers_per_step*1e3:.3f} ms, XLA "
                f"{tx*layers_per_step*1e3:.3f} ms per decode step; max|err| "
                f"{err:.3e} (tol {KERNEL_TOL}; XLA path {xla_err:.3e}); first "
                f"call {compile_s:.1f} s")

    n = 8192
    a = jax.random.normal(key, (n, n), jnp.bfloat16)
    mm = jax.jit(lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.bfloat16))
    t = median_seconds(mm, a, a, iters=10)
    log(f"[kernels] bf16 matmul {n}^3: {2 * n**3 / t / 1e12:.1f} TFLOP/s")
    x = jnp.ones((1 << 30,), jnp.float32)   # 4 GiB
    cp = jax.jit(lambda x: x + 1.0)
    t = median_seconds(cp, x, iters=10)
    log(f"[kernels] device copy 4 GiB -> 4 GiB: {2 * x.nbytes / t / 1e9:.1f}"
        f" GB/s")


# ------------------------------------------------------- reference check

def check_band(params, cfg, seqs):
    """seqs: list of (prompt token ids, generated token ids). Teacher-force
    every sequence through the plain uncached forward (dense attention, f32
    compute) and require each generated token's reference logit to lie
    within LOGIT_BAND of its position's maximum. Returns (max gap, share of
    tokens equal to the reference argmax)."""
    import jax
    import jax.numpy as jnp

    from physics_llm_inference.models import forward

    ref_cfg = dataclasses.replace(cfg, dtype="float32")
    length = max(len(p) + len(g) for p, g in seqs)
    length = -(-length // 64) * 64     # one compile for every run's shapes
    ids = np.zeros((len(seqs), length), np.int32)   # right padding: causal
    for i, (p, g) in enumerate(seqs):
        ids[i, :len(p) + len(g)] = list(p) + list(g)

    @jax.jit
    def logits_of(params, ids):
        with jax.default_matmul_precision("highest"):
            return forward(params, ids, ref_cfg)[0]

    logits = np.asarray(logits_of(params, jnp.asarray(ids)))
    gaps, agree, total = [], 0, 0
    for i, (p, g) in enumerate(seqs):
        for j, tok in enumerate(g):
            row = logits[i, len(p) - 1 + j]
            gap = float(row.max() - row[tok])
            gaps.append(gap)
            agree += int(row.argmax() == tok)
            total += 1
    worst = max(gaps)
    if worst > LOGIT_BAND:
        raise AssertionError(
            f"{sum(x > LOGIT_BAND for x in gaps)} of {total} emitted tokens "
            f"lie more than {LOGIT_BAND} below the reference maximum "
            f"(worst {worst:.3f})")
    return worst, agree / total


# -------------------------------------------------------------- generate

def load_model():
    import jax

    from physics_llm_inference.models.config import LLAMA_7B_CONFIG
    from physics_llm_inference.models.quant import init_params_int8

    t0 = time.perf_counter()
    params = jax.block_until_ready(
        init_params_int8(jax.random.PRNGKey(SEED), LLAMA_7B_CONFIG))
    log(f"[model] llama7b widths, INT8 weights, random init from seed "
        f"{SEED}: {LLAMA_7B_CONFIG.param_count() / 1e9:.2f}B params, "
        f"{time.perf_counter() - t0:.1f} s")
    return params, LLAMA_7B_CONFIG


def phase_generate(params, cfg):
    import jax
    import jax.numpy as jnp

    from physics_llm_inference.runtime import KVCache, cached_generate
    from physics_llm_inference.runtime.generate import (_decode_jit,
                                                        _prefill_jit,
                                                        cache_len,
                                                        pad_and_stack)

    b, p, n = 8, 128, 64
    rng = np.random.default_rng(SEED)
    prompts = [list(rng.integers(1, cfg.vocab_size, p)) for _ in range(b)]

    # compile both programs explicitly, for their compile time and memory
    ids, lens = pad_and_stack(prompts)
    cache = KVCache.create(cfg, b, cache_len(p, n), dtype=jnp.int8).as_slice()
    f32, i32 = jnp.float32(0), jnp.zeros((b,), jnp.int32)
    lowered = {
        "prefill": _prefill_jit.lower(params, cfg, ids, lens, cache),
        "decode": _decode_jit.lower(
            params, cfg, cache, i32, lens, i32, jax.random.PRNGKey(0), n,
            f32, 0, f32, jnp.zeros((1,), jnp.int32), 0, False, False,
            greedy=True, prompt_bucket=p),
    }
    if "int8_paged_decode_attention" not in lowered["decode"].as_text():
        raise AssertionError("the decode program does not call the INT8 "
                             "decode kernel")
    for name, lw in lowered.items():
        t0 = time.perf_counter()
        compiled = lw.compile()
        log(f"[generate] compile {name}: {time.perf_counter() - t0:.1f} s; "
            f"memory_analysis: {compiled.memory_analysis()}")

    out = cached_generate(params, cfg, prompts, n, temperature=0.0,
                          kv_dtype=jnp.int8)
    steady = cached_generate(params, cfg, prompts, n, temperature=0.0,
                             kv_dtype=jnp.int8)
    if not np.array_equal(out.tokens, steady.tokens):
        raise AssertionError("two greedy runs emitted different tokens")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[generate] B={b} prompt={p} new={n} greedy: prefill "
        f"{steady.prefill_s * 1e3:.1f} ms, decode {steady.decode_s * 1e3:.1f}"
        f" ms ({steady.decode_tokens_per_s:.1f} tok/s, host clock around "
        f"block_until_ready); peak_bytes_in_use {peak}")
    worst, agree = check_band(params, cfg, [(pr, list(t)) for pr, t in
                                            zip(prompts, out.tokens)])
    log(f"[generate] reference check: {b * n} tokens within {LOGIT_BAND} "
        f"of the reference max (worst gap {worst:.4f}, argmax agreement "
        f"{agree:.3f})")


# ----------------------------------------------------------------- serve

class IdTokenizer:
    """Text → byte-valued ids; ids → their decimal text, so a response
    carries the exact token ids the engine emitted."""

    def encode(self, text: str) -> list[int]:
        return [ord(c) % 256 for c in text]

    def decode(self, ids) -> str:
        return "".join(f"{int(i)} " for i in ids)


SYSTEM = ("system: You are a careful assistant for a physics course. Answer "
          "in short sentences, cite the relevant conservation law, give "
          "units for every quantity, and state each assumption you make "
          "about friction, air resistance and the reference frame before "
          "you compute anything. ")


def _post(port: int, prompt: str, stream: bool, max_tokens: int) -> list:
    body = json.dumps({"messages": [{"role": "user", "content": prompt}],
                       "max_tokens": max_tokens, "temperature": 0.0,
                       "stream": stream}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        raw = r.read().decode()
    if not stream:
        text = json.loads(raw)["choices"][0]["message"]["content"]
    else:
        events = [e[len("data: "):] for e in raw.split("\n\n")
                  if e.startswith("data: ")]
        if events[-1] != "[DONE]":
            raise AssertionError("SSE stream did not end with [DONE]")
        text = "".join(json.loads(e)["choices"][0]["delta"].get("content", "")
                       for e in events[:-1])
    toks = [int(t) for t in text.split()]
    if len(toks) != max_tokens:
        raise AssertionError(f"expected {max_tokens} tokens, got {len(toks)}")
    return toks


def serve_requests(engine, max_tokens: int = 16):
    """Drive one engine through the HTTP server; returns (seqs, seconds)."""
    from physics_llm_inference.serve import TokenizerPool
    from physics_llm_inference.serve.http_server import InferenceServer

    tok = IdTokenizer()
    server = InferenceServer(
        engine, port=0,
        tokenizer=TokenizerPool(num_workers=1, tokenizer_factory=IdTokenizer))
    server.start_background()
    prompts = [SYSTEM + "How far does a dropped stone fall in 2 s?",
               "Why does a spinning skater speed up when pulling in arms?"]
    concurrent = [SYSTEM + "What is the period of a 1 m pendulum?",
                  SYSTEM + "How much energy does a 2 kg ball gain at 3 m?",
                  "Explain why the sky is blue in two sentences.",
                  "A car brakes from 20 m/s in 40 m. What is its deceleration?"]
    seqs = []
    t0 = time.perf_counter()
    try:
        for prompt, stream in zip(prompts, (False, True)):
            seqs.append((prompt, _post(server.port, prompt, stream,
                                       max_tokens)))
        with ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(_post, server.port, p, i % 2 == 1,
                                max_tokens) for i, p in enumerate(concurrent)]
            seqs += [(p, f.result()) for p, f in zip(concurrent, futs)]
    finally:
        server.shutdown()
    seconds = time.perf_counter() - t0
    return ([(tok.encode(f"user: {p}"), g) for p, g in seqs], seconds)


def slot_engine(params, cfg, mesh=None):
    from physics_llm_inference.serve import EngineConfig, InferenceEngine

    return InferenceEngine(params, cfg, EngineConfig(
        num_slots=4, max_seq_len=640, prompt_buckets=(512,),
        max_prefill_chunk=512, decode_horizon=1, kv_dtype="int8"), mesh=mesh)


def paged_engine(params, cfg, mesh=None):
    from physics_llm_inference.serve.paged_engine import (PagedEngineConfig,
                                                          PagedInferenceEngine)

    return PagedInferenceEngine(params, cfg, PagedEngineConfig(
        num_blocks=4 * 10 + 16, block_size=64, max_batch=4,
        max_blocks_per_request=10, prompt_buckets=(512,),
        max_prefill_chunk=512, decode_horizon=1, decode_horizon_pressured=1,
        kv_dtype="int8"), mesh=mesh)


def report_engine(name, engine, seconds):
    stats = engine.stats()
    line = (f"[serve] {name}: 6 chat completions (1 plain, 1 SSE, 4 "
            f"concurrent) answered in {seconds:.1f} s from a cold start")
    if "radix_hit_tokens" in stats:
        hits = stats["radix_hit_tokens"]
        line += (f"; radix hit tokens {hits} (radix backend "
                 f"{stats['radix'].get('backend', 'python')})")
        if hits <= 0:
            raise AssertionError("the shared prefix was not reused")
    log(line)


def phase_serve(params, cfg):
    seqs = []
    for name, make in (("slot engine", slot_engine),
                       ("paged engine", paged_engine)):
        engine = make(params, cfg)
        got, seconds = serve_requests(engine)
        report_engine(name, engine, seconds)
        seqs += got
        del engine
    worst, agree = check_band(params, cfg, seqs)
    log(f"[serve] reference check: {sum(len(g) for _, g in seqs)} tokens "
        f"within {LOGIT_BAND} of the reference max (worst gap {worst:.4f}, "
        f"argmax agreement {agree:.3f})")


def phase_tensor_parallel(params, cfg, cards: int):
    """The `cli serve --tp N` path: both engines on a model=N mesh, and the
    same requests on one card in this process, as the comparison."""
    from physics_llm_inference.parallel import make_mesh

    mesh = make_mesh(data=1, model=cards)
    seqs = []
    for name, make in (("slot engine", slot_engine),
                       ("paged engine", paged_engine)):
        runs = {}
        for label, m in ((f"tp={cards}", mesh), ("1 card", None)):
            engine = make(params, cfg, mesh=m)
            runs[label], seconds = serve_requests(engine)
            report_engine(f"{name} {label}", engine, seconds)
            del engine
        same = sum(a[1] == b[1] for a, b in zip(*runs.values()))
        log(f"[tp] {name}: {same} of {len(runs['1 card'])} responses "
            f"token-identical between tp={cards} and 1 card")
        seqs += runs[f"tp={cards}"] + runs["1 card"]
    worst, agree = check_band(params, cfg, seqs)
    log(f"[tp] reference check: {sum(len(g) for _, g in seqs)} tokens within"
        f" {LOGIT_BAND} of the reference max (worst gap {worst:.4f}, argmax "
        f"agreement {agree:.3f})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the tensor-parallel serving path")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    devs = phase_device(args.cards)
    if args.cards == 1:
        phase_kernels()
        params, cfg = load_model()
        phase_generate(params, cfg)
        phase_serve(params, cfg)
    else:
        params, cfg = load_model()
        phase_tensor_parallel(params, cfg, args.cards)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; "
        f"card (name, power limit): {card_info()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
