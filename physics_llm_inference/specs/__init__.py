"""Hardware model & performance analysis (reference layer L0: ch03, ch04, ch09/nccl).

The device table the benchmark divides by (published peaks keyed by
`device_kind`), the roofline analytics of ch03/roofline.py and the NCCL-style
collective cost models of ch09/nccl_primitives.py. Pure Python.
"""
from .device import (
    DeviceSpec,
    DEVICE_SPECS,
    H100_SXM,
    H200_SXM,
    get_device_spec,
)
from .roofline import (
    arithmetic_intensity_gemm,
    arithmetic_intensity_gemv,
    arithmetic_intensity_batched_gemv,
    roofline_throughput,
    ridge_point,
    is_compute_bound,
    find_transition_batch_size,
)
from .collectives import (
    CollectiveCostModel,
    all_reduce_bytes,
    all_gather_bytes,
    reduce_scatter_bytes,
    all_to_all_bytes,
    ring_all_reduce_time,
    overlap_potential,
)

__all__ = [
    "DeviceSpec", "DEVICE_SPECS", "H100_SXM", "H200_SXM", "get_device_spec",
    "arithmetic_intensity_gemm", "arithmetic_intensity_gemv",
    "arithmetic_intensity_batched_gemv", "roofline_throughput", "ridge_point",
    "is_compute_bound", "find_transition_batch_size",
    "CollectiveCostModel", "all_reduce_bytes", "all_gather_bytes",
    "reduce_scatter_bytes", "all_to_all_bytes", "ring_all_reduce_time",
    "overlap_potential",
]
