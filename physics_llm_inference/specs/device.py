"""Device table: published peaks of the accelerators this program runs on.

Keyed by JAX's `device_kind`. A device that is not in the table is an error:
a roofline share divided by some other card's peak would be a wrong number,
not an approximate one.

Figures are dense rates (no sparsity) at the card's full power limit, from
NVIDIA's H100 Tensor Core GPU data sheet (SXM column) and H200 data sheet
(SXM column); SM count, shared memory and L2 from the Hopper architecture
white paper. A card set below its full power limit cannot hold its top clock
under matrix-heavy load, so measured shares are reported beside the card's
power limit.
"""
from __future__ import annotations

from dataclasses import dataclass

GB = 10**9


@dataclass(frozen=True)
class DeviceSpec:
    """Per-card peaks used by the roofline and collective cost models."""

    name: str
    bf16_tflops: float          # tensor cores, dense
    fp8_tflops: float
    int8_tops: float
    tf32_tflops: float
    fp32_tflops: float          # outside the tensor cores
    hbm_bytes: int
    hbm_gbps: float             # device memory bandwidth, GB/s (1e9 B/s)
    nvlink_gbps: float          # per direction, to the other cards of the host
    num_sms: int
    smem_per_block_bytes: int
    l2_bytes: int

    @property
    def peak_flops(self) -> float:
        """Peak bf16 FLOP/s."""
        return self.bf16_tflops * 1e12

    @property
    def hbm_bandwidth(self) -> float:
        """Device memory bandwidth in bytes/s."""
        return self.hbm_gbps * 1e9

    def peak(self, dtype: str = "bf16") -> float:
        """Peak operations/s for a matmul input dtype."""
        return {"bf16": self.bf16_tflops, "fp16": self.bf16_tflops,
                "fp8": self.fp8_tflops, "int8": self.int8_tops,
                "tf32": self.tf32_tflops,
                "fp32": self.fp32_tflops}[dtype] * 1e12

    def ridge_point(self, dtype: str = "bf16") -> float:
        """FLOP/byte at which the card turns from memory- to compute-bound."""
        return self.peak(dtype) / self.hbm_bandwidth


H100_SXM = DeviceSpec(
    name="H100 SXM",
    bf16_tflops=989.0, fp8_tflops=1979.0, int8_tops=1979.0,
    tf32_tflops=495.0, fp32_tflops=67.0,
    hbm_bytes=80 * GB, hbm_gbps=3350.0, nvlink_gbps=450.0,
    num_sms=132, smem_per_block_bytes=227 * 1024, l2_bytes=50 * 1024**2,
)

H200_SXM = DeviceSpec(
    name="H200 SXM",
    bf16_tflops=989.0, fp8_tflops=1979.0, int8_tops=1979.0,
    tf32_tflops=495.0, fp32_tflops=67.0,
    hbm_bytes=141 * GB, hbm_gbps=4800.0, nvlink_gbps=450.0,
    num_sms=132, smem_per_block_bytes=227 * 1024, l2_bytes=50 * 1024**2,
)

DEVICE_SPECS: dict[str, DeviceSpec] = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
    "NVIDIA H200": H200_SXM,
}


def get_device_spec(device=None) -> DeviceSpec:
    """The table entry for `device` (default: JAX's first device). Raises
    ValueError for a device_kind the table does not hold."""
    if device is None:
        import jax

        device = jax.devices()[0]
    kind = getattr(device, "device_kind", "")
    try:
        return DEVICE_SPECS[kind]
    except KeyError:
        raise ValueError(
            f"no device-table entry for device_kind {kind!r}; known: "
            f"{sorted(DEVICE_SPECS)}") from None
