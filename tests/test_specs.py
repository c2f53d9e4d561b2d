"""Tests for the specs layer — mirrors ref ch03/test_ch03.py + ch04/test_ch04.py
semantics (AI formulas, ridge-point ranges, compute/memory-bound predicates)
with the device table's constants."""
from types import SimpleNamespace

import pytest

from physics_llm_inference.specs import (
    DEVICE_SPECS, H100_SXM, H200_SXM, get_device_spec,
    arithmetic_intensity_gemm, arithmetic_intensity_gemv,
    arithmetic_intensity_batched_gemv, roofline_throughput, ridge_point,
    is_compute_bound, find_transition_batch_size,
    all_reduce_bytes, all_gather_bytes, ring_all_reduce_time,
    overlap_potential, CollectiveCostModel,
)


class TestRoofline:
    def test_gemm_4096_compute_bound(self):
        # Ref asserts GEMM 4096^3 AI > 100 and compute-bound (ch03/test_ch03.py:62-64).
        ai = arithmetic_intensity_gemm(4096, 4096, 4096, "bf16")
        assert ai > 100
        # H100 ridge ~295 FLOP/B: a 4096³ bf16 GEMM (AI ~1365) is above it
        assert is_compute_bound(ai, H100_SXM, "bf16")

    def test_gemv_memory_bound(self):
        ai = arithmetic_intensity_gemv(4096, 4096, "bf16")
        assert ai < 2
        assert not is_compute_bound(ai, H100_SXM, "bf16")

    def test_ridge_points_in_range(self):
        # H100: 989e12 / 3.35e12 ≈ 295 FLOP/B; H200: 989e12 / 4.8e12 ≈ 206
        assert 280 < ridge_point(H100_SXM, "bf16") < 310
        assert 190 < ridge_point(H200_SXM, "bf16") < 220
        assert ridge_point(H100_SXM, "int8") == pytest.approx(
            2 * ridge_point(H100_SXM, "bf16"), rel=0.01)

    def test_roofline_throughput_clamps_at_peak(self):
        assert roofline_throughput(1e9, H100_SXM) == H100_SXM.peak_flops
        low = roofline_throughput(1.0, H100_SXM)
        assert low == pytest.approx(H100_SXM.hbm_bandwidth)

    def test_batched_gemv_ai_grows_with_batch(self):
        a1 = arithmetic_intensity_batched_gemv(1, 4096, 4096)
        a64 = arithmetic_intensity_batched_gemv(64, 4096, 4096)
        assert a64 > a1

    def test_transition_batch_size(self):
        # Ref finds ~512 on a 3090 (ridge ~38); the H100's ridge ~295 → larger.
        b = find_transition_batch_size(4096, 4096, H100_SXM, "bf16")
        assert b is not None
        assert b >= 256
        assert not is_compute_bound(
            arithmetic_intensity_batched_gemv(b // 2, 4096, 4096), H100_SXM)


class TestDeviceTable:
    def test_h100_entry(self):
        spec = get_device_spec(SimpleNamespace(
            device_kind="NVIDIA H100 80GB HBM3"))
        assert spec is H100_SXM
        assert spec.peak_flops == 989e12
        assert spec.hbm_bandwidth == 3.35e12
        assert spec.nvlink_gbps == 450.0

    def test_unknown_device_raises(self):
        with pytest.raises(ValueError, match="no device-table entry"):
            get_device_spec(SimpleNamespace(device_kind="cpu"))

    def test_default_device_here_is_not_in_table(self):
        # the tests run on the CPU backend: no default, no fallback
        with pytest.raises(ValueError):
            get_device_spec()

    def test_every_entry_keyed_by_its_kind(self):
        for kind, spec in DEVICE_SPECS.items():
            assert get_device_spec(SimpleNamespace(device_kind=kind)) is spec


class TestCollectives:
    def test_all_reduce_bytes_formula(self):
        # 2·D·(N-1)/N — ref ch09/test_ch09.py:208-245 semantics.
        assert all_reduce_bytes(1000, 4) == pytest.approx(2 * 1000 * 3 / 4)
        assert all_reduce_bytes(1000, 1) == 0.0

    def test_all_gather_less_than_all_reduce(self):
        assert all_gather_bytes(1000, 8) < all_reduce_bytes(1000, 8)

    def test_ring_time_increases_with_devices_at_fixed_latency(self):
        t2 = ring_all_reduce_time(1 << 20, 2, 450e9)
        t8 = ring_all_reduce_time(1 << 20, 8, 450e9)
        assert t8 > t2 > 0

    def test_overlap_potential(self):
        assert overlap_potential(1.0, 0.3) == 1.0
        assert overlap_potential(0.3, 1.0) == pytest.approx(0.3)

    def test_cost_model_network_slower_than_nvlink(self):
        m = CollectiveCostModel(H100_SXM)
        nvlink = m.all_reduce_time(1 << 24, 4, across_hosts=False)
        network = m.all_reduce_time(1 << 24, 4, across_hosts=True)
        assert network > nvlink

    def test_nvlink_ring_step_runs_at_one_direction_rate(self):
        m = CollectiveCostModel(H100_SXM)
        d, n = 1 << 30, 4
        t = m.all_reduce_time(d, n)
        steps = 2 * (n - 1)
        assert t == pytest.approx(steps * (1e-6 + d / (n * 450e9)))

    def test_scaling_efficiency_bounds(self):
        m = CollectiveCostModel(H100_SXM)
        eff = m.scaling_efficiency(compute_time=1e-3, data_bytes=1 << 20, n=4)
        assert 0 < eff <= 1.0
