"""Paged engine integration tests: paged continuous batching ≡ the slot
engine / cached_generate outputs, radix prefix reuse skips prefill work,
block-by-block growth, eviction + preemption under pool pressure."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physics_llm_inference.models import ModelConfig, init_params
from physics_llm_inference.runtime import cached_generate
from physics_llm_inference.serve import GenerationRequest
from physics_llm_inference.serve.paged_engine import (
    PagedEngineConfig, PagedInferenceEngine,
)

CFG = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_dim=128, max_seq_len=128,
                  dtype="float32")


@pytest.fixture(scope="module")
def params():
    return init_params(jax.random.PRNGKey(0), CFG)


def engine(params, **kw):
    kw.setdefault("num_blocks", 32)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_blocks_per_request", 8)
    kw.setdefault("prompt_buckets", (8, 16, 32))
    return PagedInferenceEngine(params, CFG, PagedEngineConfig(**kw))


class TestPagedParity:
    def test_greedy_matches_cached_generate(self, params):
        prompt = [5, 17, 3, 42, 8]
        ref = cached_generate(params, CFG, [prompt], 6, temperature=0.0)
        eng = engine(params)
        res = eng.generate(GenerationRequest(prompt_tokens=prompt,
                                             max_tokens=6, temperature=0.0))
        np.testing.assert_array_equal(res.tokens, ref.tokens[0])

    def test_multi_request_parity(self, params):
        prompts = [[5, 17, 3], [7, 1, 9, 2], [4]]
        eng = engine(params)
        rids = [eng.submit_request(GenerationRequest(
            prompt_tokens=p, max_tokens=5, temperature=0.0)) for p in prompts]
        eng.run_until_done(rids)
        for p, rid in zip(prompts, rids):
            solo = cached_generate(params, CFG, [p], 5, temperature=0.0)
            np.testing.assert_array_equal(eng.get_result(rid).tokens,
                                          solo.tokens[0])

    def test_long_prompt_spanning_blocks(self, params):
        prompt = [int(x) for x in (np.arange(30) % 97) + 1]  # 30 tokens, bs=8
        ref = cached_generate(params, CFG, [prompt], 5, temperature=0.0)
        eng = engine(params)
        res = eng.generate(GenerationRequest(prompt_tokens=prompt,
                                             max_tokens=5, temperature=0.0))
        np.testing.assert_array_equal(res.tokens, ref.tokens[0])
        # grew past the prompt reservation block-by-block
        assert eng.pool.stats()["used_blocks"] >= 0

    def test_decode_grows_blocks(self, params):
        eng = engine(params)
        res = eng.generate(GenerationRequest(prompt_tokens=[3, 1, 4, 1, 5],
                                             max_tokens=12, temperature=0.0))
        assert len(res.tokens) == 12
        # 5 prompt + 12 decode = 17 tokens → 3 blocks of 8 were needed
        ref = cached_generate(params, CFG, [[3, 1, 4, 1, 5]], 12,
                              temperature=0.0)
        np.testing.assert_array_equal(res.tokens, ref.tokens[0])


class TestPagedHorizon:
    def test_horizon_parity_with_single_step(self, params):
        """Multi-step paged decode ≡ single-step, incl. block growth across
        the horizon and stop-token trimming."""
        prompt = [5, 17, 3, 42, 8, 9, 1]
        ref = engine(params, decode_horizon=1).generate(
            GenerationRequest(prompt_tokens=prompt, max_tokens=10,
                              temperature=0.0))
        multi = engine(params, decode_horizon=8).generate(
            GenerationRequest(prompt_tokens=prompt, max_tokens=10,
                              temperature=0.0))
        np.testing.assert_array_equal(multi.tokens, ref.tokens)
        pos, stop = next((i, t) for i, t in enumerate(ref.tokens)
                         if ref.tokens.index(t) == i and i >= 2)
        res = engine(params, decode_horizon=8).generate(
            GenerationRequest(prompt_tokens=prompt, max_tokens=10,
                              temperature=0.0, stop_tokens=(stop,)))
        assert res.finish_reason == "stop"
        assert res.tokens == ref.tokens[:pos + 1]


class TestPagedInt8:
    def test_int8_pools_greedy_close(self, params):
        """kv_dtype='int8' builds QuantKV pools and generation stays close
        to the int8 dense-cache path."""
        from physics_llm_inference.models.transformer import QuantKV

        prompt = [5, 17, 3, 42, 8]
        eng = engine(params, kv_dtype="int8")
        assert isinstance(eng._k, QuantKV)
        res = eng.generate(GenerationRequest(prompt_tokens=prompt,
                                             max_tokens=6, temperature=0.0))
        ref = cached_generate(params, CFG, [prompt], 6, temperature=0.0,
                              kv_dtype=jnp.int8)
        agree = float(np.mean(np.asarray(res.tokens) == ref.tokens[0]))
        assert agree >= 0.5  # near-flat toy logits → few argmax flips ok
        assert len(res.tokens) == 6

    def test_int8_prefix_reuse_still_matches(self, params):
        """Radix prefix reuse composes with INT8 pools (the reused blocks
        are already-quantized values)."""
        p1 = list(range(1, 17))
        p2 = p1[:12] + [44, 45]
        eng = engine(params, kv_dtype="int8")
        a = eng.generate(GenerationRequest(prompt_tokens=p1, max_tokens=4,
                                           temperature=0.0))
        b = eng.generate(GenerationRequest(prompt_tokens=p2, max_tokens=4,
                                           temperature=0.0))
        eng2 = engine(params, kv_dtype="int8", enable_radix=False)
        b2 = eng2.generate(GenerationRequest(prompt_tokens=p2, max_tokens=4,
                                             temperature=0.0))
        assert b.tokens == b2.tokens
        assert len(a.tokens) == 4


class TestRadixReuse:
    def test_prefix_hit_skips_prefill_and_matches(self, params):
        shared = [int(x) for x in (np.arange(16) % 89) + 1]  # 2 full blocks
        eng = engine(params)
        r1 = eng.generate(GenerationRequest(prompt_tokens=shared + [7, 7],
                                            max_tokens=4, temperature=0.0))
        stats1 = eng.stats()
        assert stats1["radix"]["cached_tokens"] >= 16
        # same prefix, different tail — must hit the radix cache
        r2 = eng.generate(GenerationRequest(prompt_tokens=shared + [9],
                                            max_tokens=4, temperature=0.0))
        stats2 = eng.stats()
        assert stats2["radix_hit_tokens"] >= 16
        # and the output must equal a from-scratch run
        ref = cached_generate(params, CFG, [shared + [9]], 4, temperature=0.0)
        np.testing.assert_array_equal(r2.tokens, ref.tokens[0])

    def test_identical_prompt_reuses_all_full_blocks(self, params):
        prompt = [int(x) for x in (np.arange(17) % 89) + 1]
        eng = engine(params)
        a = eng.generate(GenerationRequest(prompt_tokens=prompt,
                                           max_tokens=3, temperature=0.0))
        b = eng.generate(GenerationRequest(prompt_tokens=prompt,
                                           max_tokens=3, temperature=0.0))
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert eng.stats()["radix_hit_tokens"] >= 16

    def test_radix_disabled_still_works(self, params):
        eng = engine(params, enable_radix=False)
        res = eng.generate(GenerationRequest(prompt_tokens=[1, 2, 3],
                                             max_tokens=4, temperature=0.0))
        assert len(res.tokens) == 4
        assert "radix" not in eng.stats()


class TestPoolPressure:
    def test_eviction_frees_radix_blocks_under_pressure(self, params):
        # tiny pool: radix-cached blocks must be evicted to admit new work
        eng = engine(params, num_blocks=10, max_batch=2)
        p1 = [int(x) for x in (np.arange(16) % 89) + 1]
        eng.generate(GenerationRequest(prompt_tokens=p1, max_tokens=3,
                                       temperature=0.0))
        assert eng.pool.stats()["used_blocks"] > 0  # radix pins blocks
        # a stream of distinct requests forces eviction of the cached prefix
        for i in range(4):
            p = [int(x) for x in (np.arange(16) % 83) + i + 2]
            res = eng.generate(GenerationRequest(prompt_tokens=p,
                                                 max_tokens=3,
                                                 temperature=0.0))
            assert len(res.tokens) == 3

    def test_oversubscribed_batch_completes(self, params):
        eng = engine(params, max_batch=2)
        rids = [eng.submit_request(GenerationRequest(
            prompt_tokens=[i + 1, i + 2], max_tokens=3, temperature=0.0))
            for i in range(5)]
        eng.run_until_done(rids)
        assert all(eng.get_result(r) is not None for r in rids)

    def test_capacity_check_rejects_oversized(self, params):
        eng = engine(params)
        with pytest.raises(ValueError):
            eng.submit_request(GenerationRequest(
                prompt_tokens=list(range(60)), max_tokens=30))


def test_paged_warmup(params):
    eng = engine(params)
    secs = eng.warmup()
    assert secs > 0
    compiled = eng._prefill_cache.stats()["compiled_shapes"]
    res = eng.generate(GenerationRequest(prompt_tokens=[1, 2, 3],
                                         max_tokens=3, temperature=0.0))
    assert len(res.tokens) == 3
    assert eng._prefill_cache.stats()["compiled_shapes"] == compiled


class TestFusedGeometry:
    """PagedEngineConfig.for_context: the geometry `cli serve --paged`
    derives from --slots and --max-seq-len."""

    def test_for_fused_preset_is_eligible(self, params):
        pc = PagedEngineConfig.for_context(64, 2048)
        assert pc.block_size == 128
        assert pc.block_size * pc.max_blocks_per_request >= 2048
        assert pc.num_blocks >= pc.max_batch * pc.max_blocks_per_request

    def test_for_fused_short_context_stays_lane_aligned(self):
        # every context is covered; short ones take one power-of-two block
        for s in (1, 5, 64, 100, 128, 640, 1000, 4096):
            pc = PagedEngineConfig.for_context(8, s)
            bs = pc.block_size
            assert bs & (bs - 1) == 0 and bs <= 128
            assert bs * pc.max_blocks_per_request >= s
            assert bs * (pc.max_blocks_per_request - 1) < s

    def test_for_fused_preset_serves(self, params):
        pc = PagedEngineConfig.for_context(8, 64, prompt_buckets=(8, 16, 32),
                                           enable_radix=False)
        eng = PagedInferenceEngine(params, CFG, pc)
        res = eng.generate(GenerationRequest(prompt_tokens=[5, 17, 3],
                                             max_tokens=6, temperature=0.0))
        ref = cached_generate(params, CFG, [[5, 17, 3]], 6, temperature=0.0)
        np.testing.assert_array_equal(res.tokens, ref.tokens[0])


class TestPagedKernelPath:
    def test_int8_pools_through_kernel_match_xla(self, params,
                                                 interpret_kernel):
        """The paged engine with INT8 pools, decode attention through the
        kernel (interpreted), stays close to the plain XLA path."""
        prompt = [int(x) for x in (np.arange(21) % 97) + 1]
        out = {}
        for impl, on in (("auto", True), ("dense", False)):
            interpret_kernel(on)
            eng = PagedInferenceEngine(params, CFG, PagedEngineConfig(
                num_blocks=32, block_size=8, max_batch=4,
                max_blocks_per_request=8, prompt_buckets=(8, 16, 32),
                kv_dtype="int8"))
            out[impl] = eng.generate(GenerationRequest(
                prompt_tokens=prompt, max_tokens=6, temperature=0.0)).tokens
        agree = float(np.mean(np.asarray(out["auto"])
                              == np.asarray(out["dense"])))
        assert agree >= 0.8, out
