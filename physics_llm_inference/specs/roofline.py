"""Roofline model for inference workloads.

The analysis the reference builds for GPUs (ref: ch03/roofline.py:36-72 —
arithmetic intensity, attainable throughput, ridge point, GEMM/GEMV/batched-GEMV
AI formulas; ch03/batching_benchmark.py:61-81 — decode transition batch size),
parameterized by a DeviceSpec from the device table (specs/device.py). Used to
attribute measured kernel throughput to compute- vs memory-bounds.
"""
from __future__ import annotations

from .device import DeviceSpec

_BYTES = {"fp32": 4, "f32": 4, "bf16": 2, "fp16": 2, "int8": 1, "fp8": 1}


def dtype_bytes(dtype: str) -> int:
    return _BYTES[dtype]


def arithmetic_intensity_gemm(m: int, n: int, k: int, dtype: str = "bf16") -> float:
    """FLOP/byte of an (m,k)@(k,n) GEMM. Prefill-shaped work.

    FLOPs = 2mnk; bytes = inputs + output at `dtype` width.
    Ref formula: ch03/roofline.py:57-60.
    """
    b = dtype_bytes(dtype)
    flops = 2.0 * m * n * k
    traffic = b * (m * k + k * n + m * n)
    return flops / traffic


def arithmetic_intensity_gemv(n: int, k: int, dtype: str = "bf16") -> float:
    """FLOP/byte of a (k,)@(k,n) GEMV. Decode-shaped work: weight-streaming bound.

    Ref formula: ch03/roofline.py:63-66.
    """
    return arithmetic_intensity_gemm(1, n, k, dtype)


def arithmetic_intensity_batched_gemv(
    batch: int, n: int, k: int, dtype: str = "bf16"
) -> float:
    """FLOP/byte of a batched decode matmul (batch, k) @ (k, n).

    The weight matrix is read once and amortized over the batch — the entire
    reason continuous batching works (ref: ch03/batching_benchmark.py:16-58).
    """
    return arithmetic_intensity_gemm(batch, n, k, dtype)


def ridge_point(spec: DeviceSpec, dtype: str = "bf16") -> float:
    """FLOP/byte where the chip goes memory- -> compute-bound (ref: ch03/roofline.py:53-54)."""
    return spec.ridge_point(dtype)


def roofline_throughput(
    ai: float, spec: DeviceSpec, dtype: str = "bf16"
) -> float:
    """Attainable FLOP/s = min(AI * BW, peak). Ref: ch03/roofline.py:36-51."""
    return min(ai * spec.hbm_bandwidth, spec.peak(dtype))


def is_compute_bound(ai: float, spec: DeviceSpec, dtype: str = "bf16") -> bool:
    return ai >= ridge_point(spec, dtype)


def find_transition_batch_size(
    n: int, k: int, spec: DeviceSpec, dtype: str = "bf16", max_batch: int = 8192
) -> int | None:
    """Smallest power-of-2 batch at which batched decode GEMV goes compute-bound.

    Ref: ch03/batching_benchmark.py:61-81 (power-of-2 search capped at 1024; we
    cap at 8192 because an H100's ridge point is higher than the 3090's).
    Returns None if no batch <= max_batch crosses the ridge.
    """
    batch = 1
    while batch <= max_batch:
        if is_compute_bound(arithmetic_intensity_batched_gemv(batch, n, k, dtype), spec, dtype):
            return batch
        batch *= 2
    return None


def decode_step_time_lower_bound(
    num_params: int, kv_bytes: int, batch: int, spec: DeviceSpec,
    weight_dtype: str = "int8",
) -> float:
    """Memory-bound lower bound (seconds) for one decode step.

    At decode, every weight byte and every live KV byte must cross device memory
    once per step; this is the "physics" floor that tokens/s is measured
    against.
    """
    weight_bytes = num_params * dtype_bytes(weight_dtype)
    return (weight_bytes + kv_bytes) / spec.hbm_bandwidth
