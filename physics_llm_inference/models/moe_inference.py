"""MoE inference management: LRU expert cache + execution planning + stats.

Capability parity: ref ch09/moe_inference.py (ExpertCache L16-54: OrderedDict
LRU over in-memory experts, hit/miss stats; MoEInferenceEngine L65-126:
plan_expert_execution split into cached vs need-load, routing stats,
load-balance metrics).

Context: with experts sharded over the mesh (parallel/ep.py) all experts
are resident and the cache models *host-offload* serving — a single card
holding a subset of experts in device memory and paging the rest from host
RAM. The planner decides which experts to copy in before the batch's expert GEMMs run.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field


class ExpertCache:
    """LRU cache of resident expert weights (ref ch09/moe_inference.py:16-54)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._cache: OrderedDict[int, object] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __contains__(self, expert_id: int) -> bool:
        return expert_id in self._cache

    def get_expert(self, expert_id: int, load_fn=None):
        """Hit → move_to_end (ref :29-36); miss → load + maybe evict (ref :41-44)."""
        if expert_id in self._cache:
            self.hits += 1
            self._cache.move_to_end(expert_id)
            return self._cache[expert_id]
        self.misses += 1
        value = load_fn(expert_id) if load_fn else None
        self.put(expert_id, value)
        return value

    def put(self, expert_id: int, value) -> None:
        if expert_id in self._cache:
            self._cache.move_to_end(expert_id)
            self._cache[expert_id] = value
            return
        if len(self._cache) >= self.capacity:
            self._cache.popitem(last=False)
            self.evictions += 1
        self._cache[expert_id] = value

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "capacity": self.capacity,
            "resident": len(self._cache),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hits / total if total else 0.0,
        }


@dataclass
class MoEInferencePlanner:
    """Batch-level expert planning (ref MoEInferenceEngine ch09/moe_inference.py:65-126)."""

    num_experts: int
    cache: ExpertCache
    expert_counts: list[int] = field(default=None)

    def __post_init__(self):
        if self.expert_counts is None:
            self.expert_counts = [0] * self.num_experts

    def plan_expert_execution(self, expert_ids) -> dict:
        """Split the batch's unique experts into cached vs need-load
        (ref :73-93)."""
        unique = sorted(set(int(e) for e in expert_ids))
        cached = [e for e in unique if e in self.cache]
        need_load = [e for e in unique if e not in self.cache]
        return {"cached": cached, "need_load": need_load,
                "num_unique": len(unique)}

    def record_routing(self, expert_ids) -> None:
        """Accumulate routing stats (ref :95-105)."""
        for e in expert_ids:
            self.expert_counts[int(e)] += 1

    def load_balance_metrics(self) -> dict:
        """min/max/std and balance ratio (ref :107-126)."""
        counts = self.expert_counts
        total = sum(counts)
        if total == 0:
            return {"total": 0, "min": 0, "max": 0, "std": 0.0,
                    "balance_ratio": 1.0}
        mean = total / len(counts)
        var = sum((c - mean) ** 2 for c in counts) / len(counts)
        mx = max(counts)
        return {
            "total": total,
            "min": min(counts),
            "max": mx,
            "std": var ** 0.5,
            "balance_ratio": min(counts) / mx if mx else 1.0,
        }
