"""Collective cost models: NVLink inside a host, the network across hosts.

Port of the reference's analytic NCCL cost models (ref:
ch09/nccl_primitives.py:20-107 — all-reduce/all-gather byte counts, ring
all-reduce step model, compute/comm overlap potential; constants at :143-145).
The executable collectives live in `parallel/` (psum/all_gather/ppermute inside
shard_map, which XLA hands to NCCL); this module predicts their cost so the
scaling benches can compute expected efficiency.

The cards of one host are joined all to all through NVSwitch: every card
reaches every other at its full NVLink rate (450 GB/s each way on an H100
SXM), so a ring step runs at one card's per-direction NVLink bandwidth and
the device order in a mesh does not matter. Across hosts each card has one
400 Gb/s NIC (50 GB/s each way, NVIDIA DGX H100 data sheet).

A ring moving D bytes across N devices sends 2D(N-1)/N bytes per device for
all-reduce.
"""
from __future__ import annotations

from dataclasses import dataclass

from .device import DeviceSpec, H100_SXM

# Per-hop latency, order of magnitude.
NVLINK_LATENCY_S = 1e-6
NETWORK_LATENCY_S = 10e-6
NETWORK_GBPS = 50.0   # one 400 Gb/s NIC per card, each way


def all_reduce_bytes(data_bytes: int, num_devices: int) -> float:
    """Bytes each device sends for a ring all-reduce: 2·D·(N-1)/N.

    Same formula the reference derives for NCCL (ch09/nccl_primitives.py:20-42);
    (reduce-scatter + all-gather phases).
    """
    if num_devices <= 1:
        return 0.0
    return 2.0 * data_bytes * (num_devices - 1) / num_devices


def all_gather_bytes(data_bytes: int, num_devices: int) -> float:
    """Bytes each device sends to all-gather D bytes per device (ref :45-67)."""
    if num_devices <= 1:
        return 0.0
    return data_bytes * (num_devices - 1) / num_devices


def reduce_scatter_bytes(data_bytes: int, num_devices: int) -> float:
    if num_devices <= 1:
        return 0.0
    return data_bytes * (num_devices - 1) / num_devices


def all_to_all_bytes(data_bytes: int, num_devices: int) -> float:
    """Bytes each device sends in an all-to-all of D bytes total per device.

    MoE expert dispatch cost (ref ch09/moe_inference.py:141-144 describes it;
    never implemented there).
    """
    if num_devices <= 1:
        return 0.0
    return data_bytes * (num_devices - 1) / num_devices


def ring_all_reduce_time(
    data_bytes: int, num_devices: int,
    link_bandwidth: float, latency: float = NVLINK_LATENCY_S,
) -> float:
    """Ring all-reduce wall time: 2(N-1) steps of (latency + D/(N·BW)).

    Ref model: ch09/nccl_primitives.py:70-86.
    """
    if num_devices <= 1:
        return 0.0
    steps = 2 * (num_devices - 1)
    per_step = latency + data_bytes / (num_devices * link_bandwidth)
    return steps * per_step


def overlap_potential(compute_time: float, comm_time: float) -> float:
    """Fraction of comm hideable under compute (ref :89-107).

    1.0 = fully hidden; 0.0 = fully exposed.
    """
    if comm_time <= 0:
        return 1.0
    return min(compute_time, comm_time) / comm_time


@dataclass
class CollectiveCostModel:
    """Predicts collective times on a mesh of `spec` cards: inside one host
    over NVLink, or across hosts over the network (`across_hosts=True`).
    Used by the scaling-efficiency bench."""

    spec: DeviceSpec = H100_SXM
    network_gbps: float = NETWORK_GBPS

    def _bw(self, across_hosts: bool) -> float:
        if across_hosts:
            return self.network_gbps * 1e9
        return self.spec.nvlink_gbps * 1e9

    def _lat(self, across_hosts: bool) -> float:
        return NETWORK_LATENCY_S if across_hosts else NVLINK_LATENCY_S

    def all_reduce_time(self, data_bytes: int, n: int, across_hosts: bool = False) -> float:
        return ring_all_reduce_time(data_bytes, n, self._bw(across_hosts), self._lat(across_hosts))

    def all_gather_time(self, data_bytes: int, n: int, across_hosts: bool = False) -> float:
        if n <= 1:
            return 0.0
        steps = n - 1
        return steps * (self._lat(across_hosts) + data_bytes / (n * self._bw(across_hosts)))

    def all_to_all_time(self, data_bytes: int, n: int, across_hosts: bool = False) -> float:
        if n <= 1:
            return 0.0
        # Each device exchanges (n-1)/n of its data with all others at once
        # (all-to-all fabric): one bandwidth-bound shuffle + hop latencies.
        return (self._lat(across_hosts) * (n - 1)
                + all_to_all_bytes(data_bytes, n) / self._bw(across_hosts))

    def tp_layer_comm_time(self, hidden: int, batch_tokens: int, n: int,
                           dtype_bytes: int = 2) -> float:
        """Per-transformer-block TP cost: 2 all-reduces of the activations
        (attention o_proj + MLP down_proj), the Megatron pattern our
        row-parallel layers implement with psum (parallel/tp.py)."""
        act_bytes = batch_tokens * hidden * dtype_bytes
        return 2 * self.all_reduce_time(act_bytes, n)

    def scaling_efficiency(self, compute_time: float, data_bytes: int, n: int,
                           across_hosts: bool = False, overlapped: bool = True) -> float:
        """Predicted efficiency of scaling a step across n devices."""
        comm = self.all_reduce_time(data_bytes, n, across_hosts)
        if overlapped:
            exposed = max(0.0, comm - compute_time)
        else:
            exposed = comm
        return compute_time / (compute_time + exposed) if compute_time > 0 else 0.0
