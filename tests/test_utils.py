"""Utils tests: timing harness, structured logging, profiling helpers."""
import io
import json

import jax.numpy as jnp

from physics_llm_inference.utils import benchmark_fn
from physics_llm_inference.utils.logging import get_logger
from physics_llm_inference.utils.profiling import (
    dispatch_overhead, fusion_benefit, device_memory_stats,
)


class TestTiming:
    def test_benchmark_fn_schema(self):
        r = benchmark_fn(lambda x: x + 1, jnp.ones((8, 8)), warmup=1,
                         iters=3, name="add")
        assert r.iters == 3 and r.mean_ms > 0
        d = r.to_dict()
        assert {"name", "mean_ms", "std_ms", "min_ms", "max_ms"} <= set(d)
        assert "add" in str(r)


class TestLogging:
    def test_json_lines(self):
        buf = io.StringIO()
        log = get_logger("engine", stream=buf)
        log.info("request_done", rid="r1", tokens=5)
        rec = json.loads(buf.getvalue())
        assert rec["component"] == "engine" and rec["tokens"] == 5

    def test_level_filtering(self):
        buf = io.StringIO()
        log = get_logger("x", level="warn", stream=buf)
        log.info("hidden")
        log.error("shown")
        lines = buf.getvalue().strip().splitlines()
        assert len(lines) == 1 and json.loads(lines[0])["event"] == "shown"

    def test_text_mode(self):
        buf = io.StringIO()
        log = get_logger("x", json_mode=False, stream=buf)
        log.info("hello", a=1)
        assert "hello a=1" in buf.getvalue()


class TestProfiling:
    def test_dispatch_overhead_schema(self):
        out = dispatch_overhead(iters=5)
        assert out["synced_us_per_dispatch"] > 0
        assert out["pipelined_us_per_dispatch"] > 0

    def test_fusion_benefit_schema(self):
        out = fusion_benefit(n_ops=4, size=1 << 14, iters=3)
        assert out["fused_ms"] > 0 and out["unfused_ms"] > 0

    def test_memory_stats_no_crash(self):
        out = device_memory_stats()
        assert "available" in out
