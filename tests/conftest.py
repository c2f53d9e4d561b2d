"""Test configuration: run everything on a simulated 8-device CPU mesh.

The reference tests run on CPU by default with CUDA-gated GPU tests
(ref: pyproject.toml:36-39, ch05/test_ch05.py:114). We go further: a virtual
8-device CPU platform lets the multi-chip sharding paths (TP/EP/DP via
jax.sharding.Mesh) execute for real in every test run, which the reference
never does (SURVEY.md §4).

Must run before jax is imported anywhere.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

# Force CPU even when the ambient environment points JAX at an accelerator:
# unit tests must be fast, deterministic fp32, and able to build an 8-device
# mesh. Checks that need the card run in chip_smoke.py, in its own process.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

# ---------------------------------------------------------------- slow split
# Most of the suite's wall time is XLA compiles of whole-model graphs.
# Tests matching these nodeid substrings get the `slow` marker so
# `pytest -m "not slow"` is the fast path; `pytest` (no -m) still runs
# everything.
SLOW_PATTERNS = (
    "test_parallel.py::TestRingAttention",
    "test_engine.py::TestWarmup",
    "test_parallel.py::test_graft_entry",
    "test_moe_inference.py::TestExpertParallel",
    "test_engine.py::TestSingleRequest",
    "test_engine.py::TestContinuousBatching",
    "test_engine.py::TestChunkedPrefill",
    "test_paged_engine.py::TestPagedHorizon",
    "test_paged_engine.py::test_paged_warmup",
    "test_int8_kv.py::test_int8_kv_decode_steps_consistent",
    "test_loader_eval.py::TestCheckpointRoundtrip",
    "test_paged_attention.py::TestPagedDecode",
    "test_paged_attention.py::TestInt8KVDecodeKernel",
    "test_parallel.py::TestScalingBench",
    "test_speculative.py",
    "test_serve.py::TestHTTPServer",
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(p in item.nodeid for p in SLOW_PATTERNS):
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs these checks there")


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Route the models' INT8 decode attention through the GPU kernel, run
    in the Pallas interpreter: the kernel path of the model code, on the
    CPU. Yields use_kernel(on): on=False switches back to the plain XLA
    path. Compiled programs are cleared at each switch so no trace of the
    other path is reused."""
    from physics_llm_inference.kernels import decode_attention as da

    kernel = da.int8_paged_decode_attention

    def interpreted(*args, interpret):
        return kernel(*args, interpret=True)

    def use_kernel(on: bool):
        monkeypatch.setattr(da, "use_decode_kernel", lambda: on)
        jax.clear_caches()

    monkeypatch.setattr(da, "int8_paged_decode_attention", interpreted)
    use_kernel(True)
    yield use_kernel
    jax.clear_caches()
