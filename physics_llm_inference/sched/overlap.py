"""Compute/transfer overlap planner (ref ch08/overlap_scheduler.py:28-117).

A discrete-event simulator of concurrent compute and transfer/prefetch
streams. On the device the real overlap is done by XLA async collectives and JAX
async dispatch (host enqueues step N+1 while N runs); this simulator is the
planning tool — the engine uses it to predict whether weight-prefetch or
collective time will be exposed, and the scaling bench compares its bound to
measurement (ref simulate_overlap_vs_sequential :159-182).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class _Op:
    name: str
    duration: float
    start: float = 0.0
    end: float = 0.0


class OverlapScheduler:
    """Two streams (compute, transfer) with async completion (ref :28-117)."""

    def __init__(self):
        self.time = 0.0
        self._compute_free = 0.0
        self._transfer_free = 0.0
        self.completed: list[_Op] = []
        self.busy_compute = 0.0
        self.busy_transfer = 0.0

    def schedule_compute(self, name: str, duration: float) -> float:
        """Ref schedule_compute :36-46. Returns completion time."""
        start = max(self.time, self._compute_free)
        self._compute_free = start + duration
        self.busy_compute += duration
        self.completed.append(_Op(name, duration, start, self._compute_free))
        return self._compute_free

    def schedule_transfer(self, name: str, duration: float) -> float:
        """Ref schedule_transfer/prefetch :48-67."""
        start = max(self.time, self._transfer_free)
        self._transfer_free = start + duration
        self.busy_transfer += duration
        self.completed.append(_Op(name, duration, start, self._transfer_free))
        return self._transfer_free

    schedule_prefetch = schedule_transfer

    def advance_time(self, to: float | None = None) -> float:
        """Advance the clock to `to` (default: all streams drained)
        (ref advance_time :69-86)."""
        self.time = max(self._compute_free, self._transfer_free) \
            if to is None else max(self.time, to)
        return self.time

    @property
    def makespan(self) -> float:
        return max(self._compute_free, self._transfer_free)

    def compute_overlap_ratio(self) -> float:
        """Fraction of transfer hidden under compute (ref :102-117)."""
        if self.busy_transfer == 0:
            return 1.0
        exposed = self.makespan - self.busy_compute
        hidden = self.busy_transfer - max(0.0, exposed)
        return max(0.0, min(1.0, hidden / self.busy_transfer))


def simulate_overlap_vs_sequential(compute_times: list[float],
                                   transfer_times: list[float]) -> dict:
    """Pipelined vs sequential makespan (ref :159-182: compute 1.0/transfer
    0.3 per step → ~1.23x bound)."""
    sched = OverlapScheduler()
    for c, t in zip(compute_times, transfer_times):
        # transfer for step i+1 overlaps compute of step i
        sched.schedule_compute("c", c)
        sched.schedule_transfer("t", t)
    sequential = sum(compute_times) + sum(transfer_times)
    overlapped = sched.makespan
    return {
        "sequential_time": sequential,
        "overlapped_time": overlapped,
        "speedup": sequential / overlapped if overlapped else 1.0,
        "overlap_ratio": sched.compute_overlap_ratio(),
    }
