"""Runtime tests — ref ch02/test_ch02.py semantics (cache append/accounting,
cached-vs-naive parity) plus ragged-batch and stop-token behavior."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physics_llm_inference.models import ModelConfig, init_params
from physics_llm_inference.runtime import (
    KVCache, calculate_kv_cache_size,
    cached_generate, naive_generate, pad_and_stack,
    StepCache, bucket_for,
)

CFG = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_dim=128, max_seq_len=128,
                  dtype="float32")


@pytest.fixture(scope="module")
def params():
    return init_params(jax.random.PRNGKey(0), CFG)


class TestKVCacheAccounting:
    def test_bytes_per_token_per_layer(self):
        # ref ch02/test_ch02.py:106-119: 8 kv-heads × 128 dim × fp16 → 4096 B
        out = calculate_kv_cache_size(1, 1, 1, 8, 128, 2)
        assert out["bytes_per_token_per_layer"] == 4096

    def test_gqa_vs_mha_ratio(self):
        # ref :133-144: 8 kv vs 32 kv heads → 4× reduction
        mha = calculate_kv_cache_size(1, 2048, 32, 32, 128, 2)["total_bytes"]
        gqa = calculate_kv_cache_size(1, 2048, 32, 8, 128, 2)["total_bytes"]
        assert mha == 4 * gqa

    def test_cache_create_and_memory(self):
        c = KVCache.create(CFG, batch_size=2, max_seq_len=32)
        assert c.k.shape == (2, 2, 32, 2, 16)
        assert c.memory_bytes() == 2 * c.k.nbytes
        assert int(c.length) == 0


class TestBuckets:
    def test_bucket_rounds_up(self):
        assert bucket_for(5, (4, 8, 16)) == 8
        assert bucket_for(8, (4, 8, 16)) == 8

    def test_bucket_overflow_raises(self):
        with pytest.raises(ValueError):
            bucket_for(100, (4, 8, 16))

    def test_step_cache_memoizes(self):
        calls = []
        sc = StepCache(lambda *k: calls.append(k) or (lambda: k))
        f1 = sc.get(1, 16)
        f2 = sc.get(1, 16)
        assert f1 is f2 and len(calls) == 1
        sc.get(2, 16)
        assert sc.stats() == {"compiled_shapes": 2, "hits": 1, "misses": 2}


class TestPadding:
    def test_left_padding_layout(self):
        ids, lens = pad_and_stack([[1, 2, 3], [7]], pad_id=0, bucket=4)
        np.testing.assert_array_equal(ids, [[0, 1, 2, 3], [0, 0, 0, 7]])
        np.testing.assert_array_equal(lens, [3, 1])

    def test_bucket_auto(self):
        ids, _ = pad_and_stack([[1] * 20], pad_id=0)
        assert ids.shape[1] == 32  # next bucket above 20


class TestGeneration:
    def test_cached_greedy_matches_naive_greedy(self, params):
        """The core ch02 parity claim: cache changes cost, not outputs
        (ref ch02/benchmark_ch02.py:149-163)."""
        prompt = [[5, 17, 3, 42, 8, 11, 2, 9]]
        ids = jnp.asarray(prompt, jnp.int32)
        naive = naive_generate(params, CFG, ids, 8, temperature=0.0)
        out = cached_generate(params, CFG, prompt, 8, temperature=0.0)
        np.testing.assert_array_equal(naive[0], out.tokens[0])

    def test_ragged_batch_matches_single(self, params):
        """Left-padded ragged batch must generate exactly what each request
        generates alone (padding must be invisible)."""
        p1, p2 = [5, 17, 3, 42, 8], [7, 1]
        solo1 = cached_generate(params, CFG, [p1], 6, temperature=0.0)
        solo2 = cached_generate(params, CFG, [p2], 6, temperature=0.0)
        both = cached_generate(params, CFG, [p1, p2], 6, temperature=0.0)
        np.testing.assert_array_equal(both.tokens[0], solo1.tokens[0])
        np.testing.assert_array_equal(both.tokens[1], solo2.tokens[0])

    def test_stop_tokens_truncate(self, params):
        out_free = cached_generate(params, CFG, [[5, 17, 3]], 10,
                                   temperature=0.0)
        stop = int(out_free.tokens[0, 2])
        out = cached_generate(params, CFG, [[5, 17, 3]], 10, temperature=0.0,
                              stop_tokens=(stop,), pad_id=0)
        assert out.gen_lens[0] == 3
        assert (out.tokens[0, 3:] == 0).all()
        np.testing.assert_array_equal(out.tokens[0, :3], out_free.tokens[0, :3])

    def test_output_timing_fields(self, params):
        out = cached_generate(params, CFG, [[1, 2, 3]], 4, temperature=0.0)
        assert out.prefill_s > 0 and out.decode_s > 0
        assert out.decode_tokens_per_s > 0
        assert out.tokens.shape == (1, 4)

    def test_sampled_generation_in_vocab(self, params):
        out = cached_generate(params, CFG, [[1, 2, 3]], 8, temperature=1.0,
                              top_k=10, rng=jax.random.PRNGKey(7))
        assert ((out.tokens >= 0) & (out.tokens < 100)).all()

    def test_decode_is_deterministic_greedy(self, params):
        a = cached_generate(params, CFG, [[4, 4, 4, 4]], 6, temperature=0.0)
        b = cached_generate(params, CFG, [[4, 4, 4, 4]], 6, temperature=0.0)
        np.testing.assert_array_equal(a.tokens, b.tokens)
