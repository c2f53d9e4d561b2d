"""Tensor-parallel model code against one device, stage by stage.

    python scripts/tp_check.py --cards 4            # llama7b widths, 1 layer
    python scripts/tp_check.py --cards 4 --layers 4
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python scripts/tp_check.py --cards 4 --tiny   # rehearsal on the CPU

Lays the model out for a model=N mesh exactly as the serving engines do
(parallel/tp.py: fused-column permutation, Megatron shardings, per-shard
config) and runs each stage of the forward pass under shard_map, against the
same function on one device with the same input:

  collectives  psum (bf16, f32) and a tiled all_gather at the engine's sizes
  embed        the vocab-sharded embedding lookup (one psum)
  ffn          norm + SwiGLU of layer 0 (column/row split, one psum)
  block        layer 0: attention + FFN (two psums)
  head         final norm + vocab-sharded head (one all_gather)
  forward      the whole model (layer scan)
  engine       the slot engine at tp=N and on one device, greedy, INT8 KV,
               for short random-id prompts and for chip_smoke's serving
               prompts and geometry: every emitted token checked against an
               f32 reference

Weights are random INT8 from a seed. Prints each stage's max abs error
(hidden states relative to their max) and, for logits, argmax agreement.
Exits 1 if any stage is off.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

# bf16 compute on both sides; the TP side sums N bf16 partial products where
# one device rounds once, so hidden states differ by ~1e-2 of their range
HIDDEN_TOL = 5e-2
LOGIT_TOL = 0.25
AGREE_MIN = 0.9
# the serving check's band, as in chip_smoke.py
ENGINE_BAND = 0.5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--tokens", type=int, default=512,
                    help="prompt length (the engines' prefill chunk)")
    ap.add_argument("--tiny", action="store_true",
                    help="a small model, for a rehearsal on CPU devices")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from physics_llm_inference.models import transformer as tm
    from physics_llm_inference.models.config import (LLAMA_7B_CONFIG,
                                                      ModelConfig)
    from physics_llm_inference.models.quant import init_params_int8
    from physics_llm_inference.ops.norms import rms_norm
    from physics_llm_inference.parallel import make_mesh
    from physics_llm_inference.parallel.tp import (tp_local_config,
                                                   tp_param_spec_tree,
                                                   tp_prepare_params)

    n = args.cards
    print(f"devices {jax.devices()}", flush=True)
    if args.tiny:
        cfg = ModelConfig(vocab_size=512, hidden_dim=256, num_layers=args.layers,
                          num_heads=8, num_kv_heads=8, intermediate_dim=344,
                          max_seq_len=1024)
    else:
        cfg = dataclasses.replace(LLAMA_7B_CONFIG, num_layers=args.layers)
    mesh = make_mesh(data=1, model=n)
    failed = []

    def report(stage, ref, got, logits=False):
        ref = np.asarray(ref, np.float32)
        got = np.asarray(got, np.float32)
        err = float(np.max(np.abs(ref - got)))
        line = f"[{stage}] shape {ref.shape}: max|err| {err:.4g}"
        if logits:
            agree = float(np.mean(ref.argmax(-1) == got.argmax(-1)))
            line += f", argmax agreement {agree:.3f}"
            bad = not (err <= LOGIT_TOL and agree >= AGREE_MIN)
        else:
            rel = err / max(float(np.max(np.abs(ref))), 1e-30)
            line += f", relative to max|ref| {rel:.4g}"
            bad = not rel <= HIDDEN_TOL
        print(line + (" FAIL" if bad else " ok"), flush=True)
        if bad:
            failed.append(stage)

    # ---- collectives at the engine's sizes
    rng = np.random.default_rng(0)
    for dtype, shape in ((jnp.bfloat16, (4, 1, cfg.hidden_dim)),
                         (jnp.bfloat16, (1, args.tokens, cfg.hidden_dim)),
                         (jnp.float32, (1, args.tokens, cfg.hidden_dim)),
                         (jnp.float32, (16, args.tokens, cfg.hidden_dim))):
        parts = rng.standard_normal((n,) + shape).astype(np.float32)
        x = jax.device_put(jnp.asarray(parts, dtype),
                           NamedSharding(mesh, P("model")))
        fn = jax.jit(jax.shard_map(
            lambda a: jax.lax.psum(a[0], "model"), mesh=mesh,
            in_specs=P("model"), out_specs=P(), check_vma=False))
        ref = np.asarray(jnp.asarray(parts, dtype), np.float32).sum(0)
        report(f"collectives psum {jnp.dtype(dtype).name}", ref, fn(x))
    for shape in ((4, 1, cfg.vocab_size), (1, args.tokens, cfg.vocab_size)):
        full = rng.standard_normal(shape).astype(np.float32)
        x = jax.device_put(jnp.asarray(full),
                           NamedSharding(mesh, P(None, None, "model")))
        fn = jax.jit(jax.shard_map(
            lambda a: jax.lax.all_gather(a, "model", axis=2, tiled=True),
            mesh=mesh, in_specs=P(None, None, "model"), out_specs=P(),
            check_vma=False))
        report("collectives all_gather f32", full, fn(x))

    # ---- the model, stage by stage
    params = init_params_int8(jax.random.PRNGKey(0), cfg)
    tparams = tp_prepare_params(params, cfg, mesh)
    specs = tp_param_spec_tree(tparams)
    lcfg = tp_local_config(cfg, n)

    def sharded(fn):
        """fn(params, cfg, *args) under shard_map with the engine's specs;
        activations replicated."""
        def body(p, *a):
            return fn(p, lcfg, *a)
        return jax.jit(lambda p, *a: jax.shard_map(
            body, mesh=mesh, in_specs=(specs,) + (P(),) * len(a),
            out_specs=P(), check_vma=False)(p, *a))

    def single(fn):
        return jax.jit(lambda p, *a: fn(p, cfg, *a))

    b, s = 2, args.tokens
    ids = jnp.asarray(rng.integers(0, cfg.vocab_size, (b, s)), jnp.int32)
    positions = jnp.broadcast_to(jnp.arange(s)[None], (b, s))

    def embed(p, c, ids):
        return tm.embed_lookup(p, ids, c)

    def ffn(p, c, x):
        bp = tm.layer_view(p["blocks"], 0)
        return x + tm._ffn(bp, rms_norm(x, bp["ln2"], c.norm_eps), c)

    def block(p, c, x):
        cos, sin = tm.rope_frequencies(c.head_dim, c.max_seq_len, c.rope_theta)
        return tm.block_forward(tm.layer_view(p["blocks"], 0), x, c, cos, sin,
                                positions)[0]

    def head(p, c, x):
        return tm.lm_logits(x, p, c)

    def forward(p, c, ids):
        return tm.forward(p, ids, c)[0]

    x0 = single(embed)(params, ids)
    report("embed", x0, sharded(embed)(tparams, ids))
    report("ffn", single(ffn)(params, x0), sharded(ffn)(tparams, x0))
    x1 = single(block)(params, x0)
    report("block", x1, sharded(block)(tparams, x0))
    report("head", single(head)(params, x1), sharded(head)(tparams, x1),
           logits=True)
    report("forward", single(forward)(params, ids),
           sharded(forward)(tparams, ids), logits=True)

    # ---- the slot engine (`cli serve --tp N`), greedy, INT8 KV: every
    # emitted token's f32 reference logit within ENGINE_BAND of the maximum.
    # Two request sets: short prompts of random ids in a small engine, and
    # chip_smoke's serving prompts (byte-valued ids, up to ~380 tokens) in
    # chip_smoke's slot engine geometry
    import chip_smoke
    from physics_llm_inference.serve.engine import (EngineConfig,
                                                    GenerationRequest,
                                                    InferenceEngine)
    tok = chip_smoke.IdTokenizer()
    cases = {
        "random ids, 128-slot cache": (
            [[int(t) for t in rng.integers(1, cfg.vocab_size, 24 + 8 * i)]
             for i in range(4)],
            dict(max_seq_len=128, prompt_buckets=(64,), max_prefill_chunk=64)),
        "chip_smoke prompts, 640-slot cache": (
            [tok.encode(f"user: {t}") for t in (
                chip_smoke.SYSTEM + "What is the period of a 1 m pendulum?",
                "Explain why the sky is blue in two sentences.")],
            dict(max_seq_len=640, prompt_buckets=(512,),
                 max_prefill_chunk=512)),
    }
    new = 8
    ref_cfg = dataclasses.replace(cfg, dtype="float32")

    @jax.jit
    def ref_logits(p, ids):
        with jax.default_matmul_precision("highest"):
            return tm.forward(p, ids, ref_cfg)[0]

    for case, (prompts, geometry) in cases.items():
        for label, m in ((f"tp={n}", mesh), ("1 device", None)):
            eng = InferenceEngine(params, cfg, EngineConfig(
                num_slots=4, decode_horizon=1, kv_dtype="int8", **geometry),
                mesh=m)
            rids = [eng.submit_request(GenerationRequest(
                prompt_tokens=p, max_tokens=new, temperature=0.0))
                for p in prompts]
            eng.run_until_done(rids)
            seqs = [(p, list(eng.get_result(r).tokens)) for p, r in
                    zip(prompts, rids)]
            del eng
            ids = np.zeros((len(seqs), geometry["max_seq_len"]), np.int32)
            for i, (p, g) in enumerate(seqs):
                ids[i, :len(p) + len(g)] = p + g
            logits = np.asarray(ref_logits(params, jnp.asarray(ids)))
            gaps = [float(logits[i, len(p) - 1 + j].max()
                          - logits[i, len(p) - 1 + j, t])
                    for i, (p, g) in enumerate(seqs)
                    for j, t in enumerate(g)]
            out = sum(g > ENGINE_BAND for g in gaps)
            stage = f"engine slot {label}, {case}"
            print(f"[{stage}] {out} of {len(gaps)} tokens more than "
                  f"{ENGINE_BAND} below the reference max (worst "
                  f"{max(gaps):.4f}; first tokens "
                  f"{[g[:3] for _, g in seqs]})" + (" FAIL" if out else " ok"),
                  flush=True)
            if out:
                failed.append(stage)

    print(f"tp_check cards={n} layers={cfg.num_layers}: "
          + (f"FAILED {failed}" if failed else "all stages ok"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
