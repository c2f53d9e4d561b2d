"""Serving layer tests — ref ch10/test_ch10.py semantics (API schema
round-trips, SSE framing, tokenizer pool balance, benchmark harness with
mock generate) plus real HTTP server tests the reference can't have (it has
no server)."""
import json
import threading
import urllib.request

import jax
import pytest

from physics_llm_inference.bench import (
    BenchmarkConfig, run_benchmark, percentile,
)
from physics_llm_inference.serve import (
    ChatCompletionRequest, ChatCompletionResponse, ChatCompletionChunk,
    TokenizerPool,
)


class TestApiTypes:
    def test_request_from_dict(self):
        # ref ch10/api_types.py:48-63
        req = ChatCompletionRequest.from_dict({
            "model": "m", "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 5, "temperature": 0.2, "stream": True,
            "stop": "END"})
        assert req.messages[0].content == "hi"
        assert req.stop == ["END"] and req.stream
        assert "user: hi" in req.prompt_text()

    def test_response_usage_accounting(self):
        # ref :89-115
        resp = ChatCompletionResponse.create("m", "out", "stop", 10, 5)
        d = resp.to_dict()
        assert d["usage"]["total_tokens"] == 15
        assert d["choices"][0]["message"]["content"] == "out"
        assert d["id"].startswith("chatcmpl-")

    def test_chunk_sse_framing(self):
        # ref :158-177
        sse = ChatCompletionChunk(id="x", model="m", delta="tok").to_sse()
        assert sse.startswith("data: ") and sse.endswith("\n\n")
        payload = json.loads(sse[len("data: "):])
        assert payload["choices"][0]["delta"]["content"] == "tok"


class TestTokenizerPool:
    def test_round_robin_balance(self):
        # ref ch10/tokenizer_pool.py:90-99
        pool = TokenizerPool(num_workers=3)
        for _ in range(9):
            pool.tokenize("abc")
        s = pool.stats()
        assert s["requests_per_worker"] == [3, 3, 3]
        assert s["balance"] == 1.0

    def test_dummy_tokenizer_roundtrip(self):
        pool = TokenizerPool(num_workers=1)
        ids = pool.tokenize("hi")
        assert ids == [ord("h"), ord("i")]
        assert pool.detokenize(ids) == "hi"

    def test_batch_parallel(self):
        pool = TokenizerPool(num_workers=2)
        outs = pool.tokenize_batch(["a", "bb", "ccc"])
        assert [len(o) for o in outs] == [1, 2, 3]

    def test_async_callback(self):
        pool = TokenizerPool(num_workers=1)
        done = threading.Event()
        result = []
        pool.tokenize_async("xy", lambda ids: (result.append(ids), done.set()))
        assert done.wait(2)
        assert result[0] == [ord("x"), ord("y")]


class TestBenchHarness:
    def test_percentiles(self):
        vals = [float(i) for i in range(1, 101)]
        assert percentile(vals, 50) == pytest.approx(50, abs=1)
        assert percentile(vals, 99) == pytest.approx(99, abs=1)
        assert percentile([], 50) == 0.0

    def test_run_with_mock_generate(self):
        # ref ch10/test_ch10.py:262-269 mock_generate idiom
        def mock_generate(prompt, max_tokens):
            return {"tokens": list(range(max_tokens)), "ttft_s": 0.001}

        res = run_benchmark(BenchmarkConfig(num_requests=10, max_tokens=4),
                            mock_generate)
        d = res.to_dict()
        assert d["num_requests"] == 10
        assert res.total_tokens == 40
        assert d["ttft"]["p50_ms"] == pytest.approx(1.0, rel=0.5)
        assert "P99" in res.summary()

    def test_concurrent_load(self):
        def gen(prompt, n):
            return {"tokens": [1] * n}

        res = run_benchmark(BenchmarkConfig(num_requests=8, concurrency=4),
                            gen)
        assert res.num_requests == 8


@pytest.fixture(scope="module")
def server():
    from physics_llm_inference.models import ModelConfig, init_params
    from physics_llm_inference.serve import InferenceEngine, EngineConfig
    from physics_llm_inference.serve.http_server import InferenceServer

    cfg = ModelConfig(vocab_size=256, hidden_dim=64, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_dim=128,
                      max_seq_len=128, dtype="float32")
    params = init_params(jax.random.PRNGKey(0), cfg)
    eng = InferenceEngine(params, cfg, EngineConfig(
        num_slots=4, max_seq_len=96, prompt_buckets=(16, 32, 64)))
    srv = InferenceServer(eng, port=0).start_background()
    yield srv
    srv.shutdown()


def _post(server, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


class TestHTTPServer:
    def test_health_and_models(self, server):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/health", timeout=10) as r:
            assert json.load(r)["status"] == "ok"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/v1/models", timeout=10) as r:
            assert json.load(r)["data"][0]["id"] == "default"

    def test_chat_completion(self, server):
        with _post(server, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "hello"}],
                "max_tokens": 5, "temperature": 0.0}) as r:
            d = json.load(r)
        assert d["object"] == "chat.completion"
        assert d["usage"]["completion_tokens"] == 5
        assert isinstance(d["choices"][0]["message"]["content"], str)

    def test_streaming_sse(self, server):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/chat/completions",
            data=json.dumps({
                "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 4, "temperature": 0.0, "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read().decode()
        events = [e for e in body.split("\n\n") if e.startswith("data: ")]
        assert events[-1] == "data: [DONE]"
        deltas = [json.loads(e[6:]) for e in events[:-1]]
        contents = [d["choices"][0]["delta"].get("content", "")
                    for d in deltas]
        assert sum(1 for c in contents if c) == 4
        assert deltas[-1]["choices"][0]["finish_reason"] is not None

    def test_metrics_endpoint(self, server):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics", timeout=10) as r:
            m = json.load(r)
        assert "total_requests" in m and "scheduler" in m

    def test_bad_json_400(self, server):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/chat/completions",
            data=b"{not json", headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400

    def test_missing_messages_400(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/v1/chat/completions", {"max_tokens": 4})
        assert e.value.code == 400

    def test_unknown_route_404(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/v1/nope", {})
        assert e.value.code == 404

    def test_oversized_prompt_400(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "x" * 200}],
                "max_tokens": 50})
        assert e.value.code == 400


class TestRealTokenizerPool:
    def test_trained_bpe_through_pool(self, tmp_path):
        """The real-tokenizer factory hook with an actual trained BPE
        (`tokenizers` library) — encode returns Encoding objects, the pool
        adapts, and round-trips are exact (VERDICT: the factory was never
        exercised with a non-dummy tokenizer)."""
        tokenizers = pytest.importorskip("tokenizers")
        from tokenizers import (Tokenizer, decoders, models, pre_tokenizers,
                                trainers)

        tok = Tokenizer(models.BPE(unk_token=None))
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()
        trainer = trainers.BpeTrainer(
            vocab_size=400,
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
        corpus = ["def f(x):\n    return x + 1\n" * 50,
                  "class A:\n    pass\n" * 50]
        tok.train_from_iterator(corpus, trainer=trainer)
        path = str(tmp_path / "tok.json")
        tok.save(path)

        from physics_llm_inference.serve.tokenizer_pool import \
            TokenizerPool
        pool = TokenizerPool(
            num_workers=2,
            tokenizer_factory=lambda: Tokenizer.from_file(path))
        text = "def g(y):\n    return y + 2\n"
        ids = pool.tokenize(text)
        assert isinstance(ids, list) and all(isinstance(i, int) for i in ids)
        assert pool.detokenize(ids) == text
        batch = pool.tokenize_batch([text, text * 2])
        assert batch[0] == ids


@pytest.fixture(scope="module")
def paged_server():
    """HTTP server over the PAGED engine (round-2 gap: the server was only
    ever tested with the slot engine)."""
    from physics_llm_inference.models import ModelConfig, init_params
    from physics_llm_inference.serve.http_server import InferenceServer
    from physics_llm_inference.serve.paged_engine import (
        PagedEngineConfig, PagedInferenceEngine)

    cfg = ModelConfig(vocab_size=256, hidden_dim=64, num_layers=2,
                      num_heads=4, num_kv_heads=2, intermediate_dim=128,
                      max_seq_len=128, dtype="float32")
    params = init_params(jax.random.PRNGKey(0), cfg)
    eng = PagedInferenceEngine(params, cfg, PagedEngineConfig(
        max_batch=4, num_blocks=64, block_size=16,
        max_blocks_per_request=6, prompt_buckets=(16, 32)))
    srv = InferenceServer(eng, port=0).start_background()
    yield srv
    srv.shutdown()


class TestHTTPServerPagedEngine:
    def test_chat_completion_paged(self, paged_server):
        body = {"model": "paged", "max_tokens": 6,
                "messages": [{"role": "user", "content": "hi there"}]}
        with _post(paged_server, "/v1/chat/completions", body) as r:
            out = json.loads(r.read())
        assert out["choices"][0]["message"]["content"]
        assert out["usage"]["completion_tokens"] >= 1

    def test_streaming_sse_paged(self, paged_server):
        body = {"model": "paged", "max_tokens": 4, "stream": True,
                "messages": [{"role": "user", "content": "stream me"}]}
        with _post(paged_server, "/v1/chat/completions", body) as r:
            raw = r.read().decode()
        assert raw.rstrip().endswith("data: [DONE]")

    def test_metrics_paged(self, paged_server):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{paged_server.port}/metrics",
                timeout=10) as r:
            m = json.loads(r.read())
        assert "pool" in m and "radix" in m


@pytest.mark.slow
class TestHTTPServerTP:
    def test_chat_completion_over_tp_mesh(self):
        """Server driving a TP-sharded slot engine on the virtual mesh."""
        from physics_llm_inference.models import (ModelConfig,
                                                      init_params)
        from physics_llm_inference.parallel import make_mesh
        from physics_llm_inference.serve import (EngineConfig,
                                                     InferenceEngine)
        from physics_llm_inference.serve.http_server import \
            InferenceServer

        cfg = ModelConfig(vocab_size=256, hidden_dim=64, num_layers=2,
                          num_heads=8, num_kv_heads=4, intermediate_dim=128,
                          max_seq_len=128, dtype="float32")
        params = init_params(jax.random.PRNGKey(0), cfg)
        eng = InferenceEngine(params, cfg,
                              EngineConfig(num_slots=4, max_seq_len=96,
                                           prompt_buckets=(16, 32)),
                              mesh=make_mesh(data=2, model=4))
        srv = InferenceServer(eng, port=0).start_background()
        try:
            body = {"model": "tp", "max_tokens": 5,
                    "messages": [{"role": "user", "content": "hello tp"}]}
            with _post(srv, "/v1/chat/completions", body) as r:
                out = json.loads(r.read())
            assert out["choices"][0]["message"]["content"]
        finally:
            srv.shutdown()


class TestCLISharding:
    def test_serve_tp_check(self, capsys):
        """`pli serve --tp 4 --dp 2 --check` builds the sharded engine
        + server on the virtual 8-device mesh and exits cleanly."""
        from physics_llm_inference.cli import main

        main(["serve", "--config", "toy", "--tp", "4", "--dp", "2",
              "--port", "0", "--check"])

    def test_serve_tp_too_many_devices(self):
        from physics_llm_inference.cli import main

        with pytest.raises(SystemExit):
            main(["serve", "--config", "toy", "--tp", "64", "--port", "0",
                  "--check"])


class TestWaitResult:
    """wait_result: condition-variable blocking wait (r4) — the polling
    alternative cost 32k GIL wakeups/s at the serving bench's concurrency."""

    def test_blocks_until_finish_and_times_out(self):
        from physics_llm_inference.models import ModelConfig, init_params
        from physics_llm_inference.serve import (EngineConfig,
                                                     GenerationRequest,
                                                     InferenceEngine)
        from physics_llm_inference.serve.http_server import ServingLoop

        cfg = ModelConfig(vocab_size=256, hidden_dim=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, intermediate_dim=128,
                          max_seq_len=128, dtype="float32")
        eng = InferenceEngine(init_params(jax.random.PRNGKey(0), cfg), cfg,
                              EngineConfig(num_slots=4, max_seq_len=96,
                                           prompt_buckets=(16, 32)))
        # timeout path first: no engine loop is running yet
        assert eng.wait_result("no-such-request", timeout=0.05) is None
        loop = ServingLoop(eng)
        try:
            rid = eng.submit_request(GenerationRequest(
                prompt_tokens=[3, 5, 7], max_tokens=4, temperature=0.0))
            loop.notify()
            res = eng.wait_result(rid, timeout=120)
            assert res is not None and len(res.tokens) == 4
            # already-finished requests return immediately
            again = eng.wait_result(rid, timeout=0.01)
            assert again is res
        finally:
            loop.shutdown()
