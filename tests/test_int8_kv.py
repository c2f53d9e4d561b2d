"""INT8 KV cache tests: quantized-cache generation stays close to the fp32
cache (BASELINE configs 2: GQA + INT8 KV decode path)."""
import jax
import jax.numpy as jnp
import numpy as np

from physics_llm_inference.models import ModelConfig, init_params, forward
from physics_llm_inference.models.transformer import KVSlice, QuantKV
from physics_llm_inference.runtime import KVCache, cached_generate

CFG = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_dim=128, max_seq_len=128,
                  dtype="float32")


def test_int8_cache_memory_half_plus_scales():
    fp = KVCache.create(CFG, 1, 64, dtype=jnp.float32)
    q8 = KVCache.create(CFG, 1, 64, dtype=jnp.int8)
    assert isinstance(q8.k, QuantKV)
    # int8 values are 1/4 the fp32 bytes; scales add 1/head_dim overhead
    assert q8.memory_bytes() < fp.memory_bytes() / 3


def test_int8_cached_forward_close_to_fp32():
    params = init_params(jax.random.PRNGKey(0), CFG)
    ids = (jnp.arange(16).reshape(2, 8) * 3) % 100
    ref, _ = forward(params, ids, CFG)

    cache = KVCache.create(CFG, 2, 16, dtype=jnp.int8)
    out, kv = forward(params, ids, CFG, kv=cache.as_slice())
    rel = float(jnp.linalg.norm(out - ref) / jnp.linalg.norm(ref))
    assert rel < 0.02
    agree = float(jnp.mean(jnp.argmax(out, -1) == jnp.argmax(ref, -1)))
    assert agree >= 0.85
    assert isinstance(kv.k, QuantKV)


def test_int8_kv_generation_matches_fp32_greedy_mostly():
    params = init_params(jax.random.PRNGKey(0), CFG)
    prompt = [[5, 17, 3, 42, 8, 11, 2, 9]]
    fp = cached_generate(params, CFG, prompt, 12, temperature=0.0)
    q8 = cached_generate(params, CFG, prompt, 12, temperature=0.0,
                         kv_dtype=jnp.int8)
    # random-init toy logits are nearly flat → a few argmax flips are expected;
    # the sequences must still largely agree
    agree = float(np.mean(fp.tokens == q8.tokens))
    assert agree >= 0.5
    assert q8.tokens.shape == (1, 12)


def test_oneshot_prefill_attends_fresh_kv_exactly():
    """One-shot prefill (k_limit == s) attends the freshly computed K/V, not
    the quant-dequant cache round-trip — its logits must be BIT-IDENTICAL to
    the uncached forward (same ops, same order), even over an INT8 cache.
    Quantization noise enters at decode, where the cache is the real source
    """
    params = init_params(jax.random.PRNGKey(0), CFG)
    ids = (jnp.arange(16).reshape(2, 8) * 3) % 100
    ref, _ = forward(params, ids, CFG)
    cache = KVCache.create(CFG, 2, 16, dtype=jnp.int8)
    out, kv = forward(params, ids, CFG, kv=cache.as_slice(), k_limit=8)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    # the cache is still written for the decode steps that follow
    assert isinstance(kv.k, QuantKV)
    assert float(jnp.max(jnp.abs(kv.k.q[:, :, :8].astype(jnp.int32)))) > 0


def test_int8_kv_decode_steps_consistent():
    """Token-by-token int8-KV decode ≡ int8-KV prefill (internal consistency)."""
    params = init_params(jax.random.PRNGKey(0), CFG)
    ids = (jnp.arange(6)[None, :] * 3 + 1) % 100
    cache = KVCache.create(CFG, 1, 8, dtype=jnp.int8)
    full, _ = forward(params, ids, CFG, kv=cache.as_slice())

    cache2 = KVCache.create(CFG, 1, 8, dtype=jnp.int8)
    kv = cache2.as_slice()
    outs = []
    for t in range(6):
        logits, kv = forward(params, ids[:, t:t + 1], CFG, kv=kv)
        outs.append(logits[:, 0])
    step = jnp.stack(outs, axis=1)
    np.testing.assert_allclose(full, step, atol=1e-3)


class TestFlashModelPath:
    """The models' kernel path (the INT8 decode kernel, interpreted) must
    match the plain XLA path on the slot cache."""

    def test_uncached_forward_matches_dense(self, interpret_kernel):
        """A cached decode step (left-padded batch, per-request window)
        through the kernel ≡ the XLA path."""
        params = init_params(jax.random.PRNGKey(0), CFG)
        ids = (jnp.arange(16).reshape(2, 8) * 5) % 100
        out = {}
        for name, on in (("kernel", True), ("dense", False)):
            interpret_kernel(on)
            cfg = CFG
            cache = KVCache.create(cfg, 2, 12, dtype=jnp.int8)
            slots = jnp.broadcast_to(jnp.arange(8), (2, 8))
            vf = jnp.asarray([0, 3], jnp.int32)
            _, kv = forward(params, ids, cfg, kv=cache.as_slice(),
                            slots=slots, positions=slots, valid_from=vf)
            step = jnp.full((2, 1), 8)
            out[name], _ = forward(params, jnp.asarray([[7], [9]]), cfg,
                                   kv=kv, slots=step, positions=step,
                                   valid_from=vf)
        np.testing.assert_allclose(out["kernel"], out["dense"], atol=2e-2)

    def test_cached_generation_matches_dense(self, interpret_kernel):
        """Teacher-forced: the kernel path's logits along a dense-path
        generation stay within bf16 rounding of the dense path's."""
        params = init_params(jax.random.PRNGKey(0), CFG)
        prompts = [[5, 17, 3, 42, 8], [7, 1]]
        interpret_kernel(False)
        d = cached_generate(params, CFG, prompts, 6, temperature=0.0,
                            kv_dtype=jnp.int8)
        interpret_kernel(True)
        k = cached_generate(params, CFG, prompts, 6, temperature=0.0,
                            kv_dtype=jnp.int8)
        agree = float(np.mean(d.tokens == k.tokens))
        assert agree >= 0.8, (d.tokens, k.tokens)
        assert k.tokens.shape == (2, 6)


class TestStackedLayerKernel:
    """The stacked (L, B, S, ...) slot cache + layer index must match the
    per-layer slice exactly through the slot wrapper."""

    def test_stacked_matches_sliced(self, interpret_kernel):
        from physics_llm_inference.models.transformer import \
            _slot_decode_attention
        rng = np.random.default_rng(0)
        L, B, S, hq, hkv, d = 3, 2, 64, 4, 2, 64
        q = jnp.asarray(rng.normal(0, 1, (B, hq, d)), jnp.float32)
        cache = lambda: QuantKV(
            q=jnp.asarray(rng.integers(-127, 128, (L, B, S, hkv * d)),
                          jnp.int8),
            s=jnp.asarray(rng.uniform(0.01, 0.02, (L, B, S, hkv)),
                          jnp.float32))
        k, v = cache(), cache()
        qslot = jnp.asarray([40, 7], jnp.int32)
        vfrom = jnp.asarray([0, 2], jnp.int32)
        for l in range(L):
            stacked = _slot_decode_attention(q, k, v, qslot, vfrom,
                                             jnp.int32(l))
            sliced = _slot_decode_attention(
                q, QuantKV(k.q[l], k.s[l]), QuantKV(v.q[l], v.s[l]), qslot,
                vfrom, None)
            np.testing.assert_array_equal(np.asarray(stacked),
                                          np.asarray(sliced))
