"""Speculative decoding (prompt-lookup drafts + greedy verification).

The invariant: outputs are BIT-IDENTICAL to one-token greedy decoding —
speculation only changes how many model passes it takes."""
import jax
import jax.numpy as jnp
import numpy as np

from physics_llm_inference.models import ModelConfig, init_params
from physics_llm_inference.runtime import (cached_generate,
                                               ngram_propose,
                                               speculative_generate)

CFG = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_dim=128, max_seq_len=256,
                  dtype="float32")


class TestNgramPropose:
    def test_copies_continuation_of_match(self):
        hist = np.array([7, 1, 2, 3, 4, 9, 1, 2], dtype=np.int32)
        out = ngram_propose(hist, len(hist), k=3, ngram=2)
        # trailing bigram (1,2) matched at index 1 → continuation 3,4,9
        np.testing.assert_array_equal(out, [3, 4, 9])

    def test_most_recent_match_wins(self):
        hist = np.array([1, 2, 5, 1, 2, 8, 1, 2], dtype=np.int32)
        out = ngram_propose(hist, len(hist), k=2, ngram=2)
        np.testing.assert_array_equal(out, [8, 1])

    def test_no_match_pads_zero(self):
        hist = np.array([1, 2, 3, 4], dtype=np.int32)
        out = ngram_propose(hist, len(hist), k=3, ngram=2)
        np.testing.assert_array_equal(out, [0, 0, 0])


class TestSpeculativeParity:
    def test_identical_to_greedy(self):
        params = init_params(jax.random.PRNGKey(0), CFG)
        prompts = [[5, 17, 3, 42, 8, 11, 2], [7, 1, 9]]
        ref = cached_generate(params, CFG, prompts, 12, temperature=0.0)
        spec = speculative_generate(params, CFG, prompts, 12, draft_k=4)
        np.testing.assert_array_equal(spec.tokens, ref.tokens)
        np.testing.assert_array_equal(spec.gen_lens, ref.gen_lens)

    def test_identical_with_int8_kv(self):
        params = init_params(jax.random.PRNGKey(0), CFG)
        prompts = [[5, 17, 3, 42, 8]]
        ref = cached_generate(params, CFG, prompts, 10, temperature=0.0,
                              kv_dtype=jnp.int8)
        spec = speculative_generate(params, CFG, prompts, 10, draft_k=4,
                                    kv_dtype=jnp.int8)
        np.testing.assert_array_equal(spec.tokens, ref.tokens)

    def test_stop_tokens(self):
        params = init_params(jax.random.PRNGKey(0), CFG)
        prompts = [[5, 17, 3, 42, 8]]
        free = cached_generate(params, CFG, prompts, 10, temperature=0.0)
        toks = list(free.tokens[0])
        pos, stop = next((i, t) for i, t in enumerate(toks)
                         if toks.index(t) == i and i >= 2)
        spec = speculative_generate(params, CFG, prompts, 10, draft_k=4,
                                    stop_tokens=(int(stop),))
        assert int(spec.gen_lens[0]) == pos + 1
        np.testing.assert_array_equal(spec.tokens[0][:pos + 1],
                                      toks[:pos + 1])

    def test_repetitive_text_accepts_drafts(self):
        """A model decoding into a loop must accept >1 token per pass."""
        params = init_params(jax.random.PRNGKey(0), CFG)
        # greedy toy models fall into cycles quickly; long generation makes
        # the history self-matching, so prompt lookup should win passes
        prompts = [[5, 9, 5, 9, 5, 9, 5, 9]]
        spec = speculative_generate(params, CFG, prompts, 40, draft_k=4)
        assert spec.extras["model_passes"] < 40, spec.extras
        assert spec.extras["tokens_per_pass"] > 1.0


class TestEngineSpeculative:
    """Speculative decoding through InferenceEngine (EngineConfig
    .speculative_k): greedy outputs must be bit-identical to the plain
    engine, repetitive prompts must accept >1 token/dispatch, and mixed
    sampling iterations must fall back to the normal decode path."""

    def _mk(self, spec_k=0):
        import jax

        from physics_llm_inference.models import ModelConfig, init_params
        from physics_llm_inference.serve.engine import (EngineConfig,
                                                            InferenceEngine)

        cfg = ModelConfig(vocab_size=64, hidden_dim=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, intermediate_dim=128,
                          max_seq_len=128, dtype="float32")
        params = init_params(jax.random.PRNGKey(0), cfg)
        eng = InferenceEngine(params, cfg, EngineConfig(
            num_slots=4, max_seq_len=96, prompt_buckets=(16, 32),
            decode_horizon=1, speculative_k=spec_k))
        return eng

    def test_bit_identical_to_plain_engine(self):
        from physics_llm_inference.serve.engine import GenerationRequest

        # repetitive prompt → drafts accept; varied prompt → drafts miss
        prompts = [[7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8],
                   [3, 1, 4, 1, 5, 9, 2, 6],
                   [5, 5, 5, 5, 5, 5, 5]]
        ref = self._mk(0)
        spec = self._mk(4)
        for p in prompts:
            a = ref.generate(GenerationRequest(prompt_tokens=p,
                                               max_tokens=24,
                                               temperature=0.0))
            b = spec.generate(GenerationRequest(prompt_tokens=p,
                                                max_tokens=24,
                                                temperature=0.0))
            assert a.tokens == b.tokens, (p, a.tokens, b.tokens)
        st = spec.stats()["speculative"]
        assert st["dispatches"] > 0
        # greedy toy models loop quickly -> prompt-lookup must beat 1
        # token per dispatch on at least some of this workload
        assert st["tokens_per_dispatch"] > 1.0, st

    def test_sampled_requests_fall_back(self):
        from physics_llm_inference.serve.engine import GenerationRequest

        spec = self._mk(4)
        spec.dispatch_trace = []
        out = spec.generate(GenerationRequest(
            prompt_tokens=[1, 2, 3, 1, 2, 3], max_tokens=8,
            temperature=0.7))
        assert len(out.tokens) == 8
        kinds = {t[0] for t in spec.dispatch_trace}
        assert "spec" not in kinds    # sampled -> normal decode path
        assert "decode" in kinds
