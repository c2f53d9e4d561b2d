"""Engine integration tests — the wiring the reference never has (its engine
uses a dummy model and no cache, ch10/engine.py:64-70). Covers continuous
batching against the real model, greedy parity with cached_generate, slot
reuse, streaming, abort, and admission limits."""
import jax
import numpy as np
import pytest

from physics_llm_inference.models import ModelConfig, init_params
from physics_llm_inference.runtime import cached_generate
from physics_llm_inference.serve import (
    InferenceEngine, EngineConfig, GenerationRequest,
)

CFG = ModelConfig(vocab_size=100, hidden_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_dim=128, max_seq_len=128,
                  dtype="float32")


@pytest.fixture(scope="module")
def params():
    return init_params(jax.random.PRNGKey(0), CFG)


def engine(params, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("prompt_buckets", (8, 16, 32))
    return InferenceEngine(params, CFG, EngineConfig(**kw))


class TestSingleRequest:
    def test_greedy_matches_cached_generate(self, params):
        """Engine path (slot pool, per-slot offsets) ≡ batch generate path."""
        prompt = [5, 17, 3, 42, 8]
        ref = cached_generate(params, CFG, [prompt], 6, temperature=0.0)
        eng = engine(params)
        res = eng.generate(GenerationRequest(prompt_tokens=prompt,
                                             max_tokens=6, temperature=0.0))
        np.testing.assert_array_equal(res.tokens, ref.tokens[0])
        assert res.finish_reason == "length"
        assert res.ttft_s is not None and res.ttft_s >= 0

    def test_int8_kv_engine_greedy_close(self, params):
        """kv_dtype='int8' builds a real QuantKV slot pool (not truncated
        raw int8) and greedy output matches the int8 generate path."""
        import jax.numpy as jnp
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

    def test_stop_token(self, params):
        eng = engine(params)
        free = eng.generate(GenerationRequest(prompt_tokens=[1, 2, 3],
                                              max_tokens=8, temperature=0.0))
        stop = free.tokens[3]
        eng2 = engine(params)
        res = eng2.generate(GenerationRequest(prompt_tokens=[1, 2, 3],
                                              max_tokens=8, temperature=0.0,
                                              stop_tokens=(stop,)))
        assert res.finish_reason == "stop"
        assert res.tokens == free.tokens[:4]

    def test_decode_horizon_parity(self, params):
        """Multi-step decode (H tokens per dispatch) ≡ single-step greedy,
        including stop-token trimming mid-horizon."""
        prompt = [5, 17, 3, 42, 8]
        ref = engine(params, decode_horizon=1).generate(
            GenerationRequest(prompt_tokens=prompt, max_tokens=9,
                              temperature=0.0))
        multi = engine(params, decode_horizon=8).generate(
            GenerationRequest(prompt_tokens=prompt, max_tokens=9,
                              temperature=0.0))
        np.testing.assert_array_equal(multi.tokens, ref.tokens)
        # stop mid-horizon: output must be trimmed exactly at the stop
        # token's FIRST occurrence (toy models repeat tokens)
        pos, stop = next((i, t) for i, t in enumerate(ref.tokens)
                         if ref.tokens.index(t) == i and i >= 2)
        res = engine(params, decode_horizon=8).generate(
            GenerationRequest(prompt_tokens=prompt, max_tokens=9,
                              temperature=0.0, stop_tokens=(stop,)))
        assert res.finish_reason == "stop"
        assert res.tokens == ref.tokens[:pos + 1]

    def test_concurrent_generate_threads(self, params):
        """Blocking generate() from many threads: step() must serialize the
        schedule→prefill→decode iteration, or a request admitted by one
        caller's schedule() shows up in another's decode set before its
        prefill ran (regression: IndexError on empty output_tokens)."""
        from concurrent.futures import ThreadPoolExecutor

        eng = engine(params)
        rng = np.random.default_rng(0)
        prompts = [list(rng.integers(1, 100, 6)) for _ in range(12)]

        def one(p):
            return eng.generate(GenerationRequest(
                prompt_tokens=p, max_tokens=5, temperature=0.0)).tokens

        with ThreadPoolExecutor(max_workers=6) as ex:
            outs = list(ex.map(one, prompts))
        refs = cached_generate(params, CFG, prompts, 5, temperature=0.0)
        for out, ref in zip(outs, refs.tokens):
            np.testing.assert_array_equal(out, ref)

    def test_oversized_prompt_rejected(self, params):
        eng = engine(params)
        with pytest.raises(ValueError):
            eng.submit_request(GenerationRequest(
                prompt_tokens=list(range(60)), max_tokens=30))


class TestContinuousBatching:
    def test_multi_request_parity_with_solo(self, params):
        """Requests decoded together in the slot pool must match solo runs."""
        prompts = [[5, 17, 3], [7, 1, 9, 2], [4]]
        eng = engine(params)
        rids = [eng.submit_request(GenerationRequest(prompt_tokens=p,
                                                     max_tokens=5,
                                                     temperature=0.0))
                for p in prompts]
        eng.run_until_done(rids)
        for p, rid in zip(prompts, rids):
            solo = cached_generate(params, CFG, [p], 5, temperature=0.0)
            np.testing.assert_array_equal(eng.get_result(rid).tokens,
                                          solo.tokens[0])

    def test_late_arrival_joins_batch(self, params):
        """Continuous batching admits mid-stream (the Orca property)."""
        eng = engine(params)
        r1 = eng.submit_request(GenerationRequest(prompt_tokens=[5, 17, 3],
                                                  max_tokens=8,
                                                  temperature=0.0))
        eng.step()  # r1 prefilled
        eng.step()  # r1 decoding
        r2 = eng.submit_request(GenerationRequest(prompt_tokens=[7, 1],
                                                  max_tokens=4,
                                                  temperature=0.0))
        eng.run_until_done([r1, r2])
        solo1 = cached_generate(params, CFG, [[5, 17, 3]], 8, temperature=0.0)
        solo2 = cached_generate(params, CFG, [[7, 1]], 4, temperature=0.0)
        np.testing.assert_array_equal(eng.get_result(r1).tokens,
                                      solo1.tokens[0])
        np.testing.assert_array_equal(eng.get_result(r2).tokens,
                                      solo2.tokens[0])

    def test_more_requests_than_slots(self, params):
        """Queueing past pool capacity: all finish, slots are reused."""
        eng = engine(params, num_slots=2)
        rids = [eng.submit_request(GenerationRequest(
            prompt_tokens=[i + 1, i + 2], max_tokens=3, temperature=0.0))
            for i in range(5)]
        eng.run_until_done(rids)
        for rid in rids:
            res = eng.get_result(rid)
            assert res is not None and len(res.tokens) == 3

    def test_single_decode_dispatch_per_step(self, params):
        """All running requests decode in ONE fixed-shape dispatch."""
        eng = engine(params)
        for i in range(3):
            eng.submit_request(GenerationRequest(prompt_tokens=[i + 1],
                                                 max_tokens=4,
                                                 temperature=0.0))
        eng.step()  # prefills
        emitted = eng.step()  # one decode covering all three
        assert len(emitted) == 3


class TestStreamingAndAbort:
    def test_stream_yields_all_tokens(self, params):
        eng = engine(params)
        toks = list(eng.generate_stream(GenerationRequest(
            prompt_tokens=[5, 17], max_tokens=5, temperature=0.0)))
        assert len(toks) == 5
        solo = cached_generate(params, CFG, [[5, 17]], 5, temperature=0.0)
        np.testing.assert_array_equal(toks, solo.tokens[0])

    def test_abort_waiting_request(self, params):
        eng = engine(params)
        # fill all slots so the next request waits
        for i in range(4):
            eng.submit_request(GenerationRequest(prompt_tokens=[i + 1],
                                                 max_tokens=20,
                                                 temperature=0.0))
        eng.step()
        victim = eng.submit_request(GenerationRequest(prompt_tokens=[9],
                                                      max_tokens=4))
        assert eng.abort_request(victim)
        res = eng.get_result(victim)
        assert res is not None and res.finish_reason == "aborted"

    def test_abort_running_request(self, params):
        eng = engine(params)
        rid = eng.submit_request(GenerationRequest(prompt_tokens=[3, 4],
                                                   max_tokens=50,
                                                   temperature=0.0))
        eng.step()
        assert eng.abort_request(rid)
        eng.run_until_done([rid])
        assert eng.get_result(rid).finish_reason == "aborted"


class TestStats:
    def test_stats_accumulate(self, params):
        eng = engine(params)
        eng.generate(GenerationRequest(prompt_tokens=[1, 2], max_tokens=3,
                                       temperature=0.0))
        s = eng.stats()
        assert s["total_requests"] == 1
        assert s["total_tokens"] == 3
        assert s["scheduler"]["finished"] == 1
        assert s["prefill_compile"]["compiled_shapes"] >= 1


class TestChunkedPrefill:
    def test_long_prompt_chunked_matches_whole(self, params):
        """Prompt prefilled in chunks ≡ single-shot prefill (greedy)."""
        prompt = [int(x) for x in np.arange(1, 41) % 99 + 1]  # 40 tokens
        whole = engine(params, max_seq_len=64, prompt_buckets=(8, 16, 32, 64),
                       max_prefill_chunk=64)
        chunked = engine(params, max_seq_len=64,
                         prompt_buckets=(8, 16, 32, 64), max_prefill_chunk=16)
        a = whole.generate(GenerationRequest(prompt_tokens=prompt,
                                             max_tokens=5, temperature=0.0))
        b = chunked.generate(GenerationRequest(prompt_tokens=prompt,
                                               max_tokens=5, temperature=0.0))
        np.testing.assert_array_equal(a.tokens, b.tokens)
        # chunked path compiled the 16-bucket prefill, not the 64 one
        assert chunked._prefill_cache.stats()["compiled_shapes"] >= 1


class TestWarmup:
    def test_warmup_precompiles_all_buckets(self, params):
        eng = engine(params)
        secs = eng.warmup()
        assert secs > 0
        stats = eng._prefill_cache.stats()
        assert stats["compiled_shapes"] == 3  # (8, 16, 32)
        # a real request now only hits caches
        res = eng.generate(GenerationRequest(prompt_tokens=[1, 2, 3],
                                             max_tokens=3, temperature=0.0))
        assert len(res.tokens) == 3
        assert eng._prefill_cache.stats()["compiled_shapes"] == 3


class TestTopK:
    def test_top_k_1_matches_greedy(self, params):
        """top_k=1 with temperature>0 must select the argmax token — the
        per-request dynamic top-k path through the compiled decode step."""
        prompt = [5, 17, 3, 42, 8]
        eng = engine(params)
        greedy = eng.generate(GenerationRequest(prompt_tokens=prompt,
                                                max_tokens=6,
                                                temperature=0.0))
        eng2 = engine(params)
        topk1 = eng2.generate(GenerationRequest(prompt_tokens=prompt,
                                                max_tokens=6,
                                                temperature=0.8, top_k=1))
        np.testing.assert_array_equal(topk1.tokens, greedy.tokens)

    def test_mixed_filter_batch(self, params):
        """A batch mixing filtered (top_k) and unfiltered requests uses the
        filtered variant and leaves unfiltered rows untouched (k<=0 rows
        keep full distributions; greedy rows unchanged)."""
        eng = engine(params)
        eng.dispatch_trace = []
        r1 = eng.submit_request(GenerationRequest(
            prompt_tokens=[5, 17, 3], max_tokens=5, temperature=0.0))
        r2 = eng.submit_request(GenerationRequest(
            prompt_tokens=[9, 1, 4], max_tokens=5, temperature=0.9,
            top_k=3))
        eng.run_until_done([r1, r2])
        ref = engine(params).generate(GenerationRequest(
            prompt_tokens=[5, 17, 3], max_tokens=5, temperature=0.0))
        assert eng.get_result(r1).tokens == ref.tokens
        decodes = [t for t in eng.dispatch_trace if t[0] == "decode"]
        assert decodes and all(t[2] is True for t in decodes)

    def test_unfiltered_batch_takes_fast_variant(self, params):
        eng = engine(params)
        eng.dispatch_trace = []
        rid = eng.submit_request(GenerationRequest(
            prompt_tokens=[5, 17, 3], max_tokens=4, temperature=0.7))
        eng.run_until_done([rid])
        decodes = [t for t in eng.dispatch_trace if t[0] == "decode"]
        assert decodes and all(t[2] is False for t in decodes)


class TestMixedIterations:
    """ch08/mixed_batch.py behavior, integrated: a long admission prefills
    under a per-iteration token budget, so running decodes get dispatches
    BETWEEN its chunks instead of stalling for the whole prompt."""

    def test_decode_interleaves_long_prefill(self, params):
        eng = engine(params, max_seq_len=128, prompt_buckets=(8, 16, 32),
                     max_prefill_chunk=8, prefill_tokens_per_iter=8,
                     num_slots=4)
        eng.dispatch_trace = []
        short = eng.submit_request(GenerationRequest(
            prompt_tokens=[5, 17, 3], max_tokens=20, temperature=0.0))
        eng.step()  # short request prefilled, decoding
        long = eng.submit_request(GenerationRequest(
            prompt_tokens=list(range(1, 33)), max_tokens=4,
            temperature=0.0))
        eng.run_until_done([short, long])
        tr = eng.dispatch_trace
        # the 32-token prompt needs 4 chunks of 8; with an 8-token budget
        # each lands in its own iteration, with a decode dispatch between
        long_chunks = [i for i, t in enumerate(tr)
                       if t[0] == "prefill" and t[4] == 8 and t[1] == 8]
        assert len(long_chunks) == 4
        for a, b in zip(long_chunks, long_chunks[1:]):
            assert any(tr[i][0] == "decode" for i in range(a + 1, b)), \
                f"no decode between prefill chunks at {a}..{b}"
        # outputs still correct (greedy parity with the batch path)
        ref = cached_generate(params, CFG, [list(range(1, 33))], 4,
                              temperature=0.0)
        assert eng.get_result(long).tokens == list(ref.tokens[0])

    def test_paged_decode_interleaves_long_prefill(self, params):
        from physics_llm_inference.serve.paged_engine import (
            PagedEngineConfig, PagedInferenceEngine)

        eng = PagedInferenceEngine(params, CFG, PagedEngineConfig(
            num_blocks=64, block_size=8, max_batch=4,
            max_blocks_per_request=16, prompt_buckets=(8, 16, 32),
            max_prefill_chunk=8, prefill_tokens_per_iter=8,
            enable_radix=False))
        eng.dispatch_trace = []
        short = eng.submit_request(GenerationRequest(
            prompt_tokens=[5, 17, 3], max_tokens=20, temperature=0.0))
        eng.step()
        long = eng.submit_request(GenerationRequest(
            prompt_tokens=list(range(1, 33)), max_tokens=4,
            temperature=0.0))
        eng.run_until_done([short, long])
        tr = eng.dispatch_trace
        # round-4 batched-prefill trace rows: (kind, cb, rows, positions,
        # nvalids) with tuple payloads — the long prompt's chunks are the
        # n=8 entries in the cb=8 bucket
        long_chunks = [i for i, t in enumerate(tr)
                       if t[0] == "prefill" and t[1] == 8 and 8 in t[4]]
        assert len(long_chunks) == 4
        for a, b in zip(long_chunks, long_chunks[1:]):
            assert any(tr[i][0] == "decode" for i in range(a + 1, b))
        assert len(eng.get_result(long).tokens) == 4
