"""Quantized formats through the model: INT4 weight-only (nibble-packed,
group scales) and the greedy INT8 head."""
import jax
import jax.numpy as jnp
import numpy as np

from physics_llm_inference.models import (ModelConfig, init_params,
                                          quantize_params_int8, forward)
from physics_llm_inference.models.transformer import KVSlice, _linear
from physics_llm_inference.ops.norms import rms_norm
from physics_llm_inference.runtime import KVCache, cached_generate

CFG = ModelConfig(vocab_size=256, hidden_dim=512, num_layers=2,
                  num_heads=4, num_kv_heads=2, intermediate_dim=768,
                  max_seq_len=64, dtype="bfloat16")


class TestInt4:
    def _setup4(self, B=8, P=12, S=32):
        from physics_llm_inference.models.quant import (
            QuantizedTensor4, quantize_params_int4)

        params = quantize_params_int4(init_params(jax.random.PRNGKey(0), CFG))
        assert isinstance(params["blocks"]["wqkv"], QuantizedTensor4)
        return params

    def test_int4_dequant_roundtrip(self):
        from physics_llm_inference.models.quant import (
            _quantize_stacked_int4)

        w = jax.random.normal(jax.random.PRNGKey(3), (2, 256, 128),
                              jnp.float32) * 0.05
        t4 = _quantize_stacked_int4(w, group=128)
        deq = t4.dequantize(jnp.float32)
        assert deq.shape == w.shape
        # int4 RTN with group-128 absmax scales: bounded relative error
        rel = float(jnp.linalg.norm(deq - w) / jnp.linalg.norm(w))
        assert rel < 0.12, rel
        # per-layer slice agrees with the full dequant
        np.testing.assert_allclose(
            np.asarray(t4.dequantize_layer(1, jnp.float32)),
            np.asarray(deq[1]), rtol=1e-6, atol=1e-6)

    def test_int4_group_matches_kernel_tiles(self):
        """Every INT4 leaf carries the group size int4_group_size picks,
        and the rule is the largest power of two dividing K whose packed
        slab fits 3 MiB."""
        from physics_llm_inference.models.quant import int4_group_size

        params = self._setup4()
        for name in ("wqkv", "wo", "w_gate_up", "w_down"):
            t4 = params["blocks"][name]
            l, k, n = t4.shape
            assert t4.group == int4_group_size(k, n), name
        assert int4_group_size(4096, 12288) == 512    # 512 * 6144 B = 3 MiB
        assert int4_group_size(4096, 22016) == 256
        assert int4_group_size(11008, 8192) == 256    # 11008 = 2^8 * 43
        assert int4_group_size(100, 64) == 100        # no power-of-two group

    def test_int4_generate_end_to_end(self):
        p4 = self._setup4()
        out = cached_generate(p4, CFG, [[5, 9, 2, 7]], 6, temperature=0.0,
                              kv_dtype=jnp.int8)
        assert out.tokens.shape == (1, 6)
        # int4 vs fp weights: same model family, tokens may diverge but the
        # run must be finite and in-vocab
        assert int(out.tokens.max()) < CFG.vocab_size


class TestLmHeadGreedy:
    def test_ineligible_geometry_falls_back(self):
        """forward(greedy_head=True) on a D % 128 != 0 model returns int32
        token ids."""
        cfg = ModelConfig(vocab_size=256, hidden_dim=320, num_layers=1,
                          num_heads=5, num_kv_heads=5, intermediate_dim=512,
                          max_seq_len=32)
        params = quantize_params_int8(init_params(jax.random.PRNGKey(0), cfg))
        B, S = 2, 8
        k = jnp.zeros((cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim),
                      jnp.bfloat16)
        kv = KVSlice(k, k, 0)
        tok, _ = forward(params, jnp.ones((B, 4), jnp.int32), cfg, kv=kv,
                         greedy_head=True)
        assert tok.shape == (B,) and tok.dtype == jnp.int32

    def test_matches_argmax_over_per_op_logits(self):
        """The greedy head ≡ argmax of norm → INT8 head logits."""
        params = quantize_params_int8(init_params(jax.random.PRNGKey(0), CFG))
        B, P = 16, 12
        ids = jnp.asarray(np.random.default_rng(0).integers(1, 256, (B, P)),
                          jnp.int32)
        cache = KVCache.create(CFG, B, 32, dtype=jnp.int8)
        got, _ = forward(params, ids, CFG, kv=cache.as_slice(),
                         last_only=True, greedy_head=True)
        logits, _ = forward(params, ids, CFG, kv=cache.as_slice(),
                            last_only=True)
        ref = jnp.argmax(logits[:, 0].astype(jnp.float32), -1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        # and the head itself: rms_norm → int8 matmul
        x = jax.random.normal(jax.random.PRNGKey(5), (B, 1, CFG.hidden_dim)
                              ).astype(jnp.bfloat16)
        xn = rms_norm(x, params["norm"], CFG.norm_eps)
        head = _linear(xn, params["lm_head"]).astype(jnp.float32)
        deq = params["lm_head"].dequantize(jnp.float32)
        np.testing.assert_allclose(
            np.asarray(head[:, 0]),
            np.asarray(xn[:, 0].astype(jnp.float32) @ deq), rtol=2e-2,
            atol=2e-2)

    def test_greedy_decode_path_matches_sampled_t0(self):
        """cached_generate at T=0 (greedy path) must emit the same tokens as
        a near-zero-temperature sampled run."""
        params = quantize_params_int8(init_params(jax.random.PRNGKey(0), CFG))
        prompts = [[5, 9, 2, 7, 11], [3, 4]]
        a = cached_generate(params, CFG, prompts, 8, temperature=0.0,
                            kv_dtype=jnp.int8)
        b = cached_generate(params, CFG, prompts, 8, temperature=1e-6,
                            kv_dtype=jnp.int8)
        assert np.array_equal(a.tokens, b.tokens)
